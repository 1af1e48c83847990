"""Waveform -> log-power STFT frontend (port of avvad_tpu/ops/stft.py:34-300).

Direct path only: frames are cut with ``unfold`` and the windowed real DFT
is one fp32 ``torch.matmul`` against cos/sin bases with the periodic Hann
window folded in, as the JAX package computes it outside any Pallas kernel.
Computation is fp32 throughout. On the card the matmul must not run in
TF32 (the JAX package pins Precision.HIGHEST here: lower precision costs
whole log-units on quiet bins); ``export.make_waveform_serving_fn`` turns
TF32 off, and ``torch.backends.cuda.matmul.allow_tf32`` is False by default.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(nfft: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window."""
    n = np.arange(nfft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft)).astype(dtype)


@functools.lru_cache(maxsize=8)
def _windowed_dft_bases(nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """(nfft, n_freq) cos/sin DFT bases with the Hann window pre-multiplied."""
    n = np.arange(nfft, dtype=np.float64)[:, None]
    k = np.arange(nfft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    w = hann_window(nfft, dtype=np.float64)[:, None]
    return (
        (w * np.cos(ang)).astype(np.float32),
        (-(w * np.sin(ang))).astype(np.float32),
    )


@functools.lru_cache(maxsize=8)
def _device_bases(nfft: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    cos_b, sin_b = _windowed_dft_bases(nfft)
    return (torch.from_numpy(cos_b).to(device),
            torch.from_numpy(sin_b).to(device))


def _needs_end_pad(n_samples: int, fs: float, wlen_sec: float, hop_percent: float) -> bool:
    utt_len = n_samples / fs
    ratio = utt_len / wlen_sec / hop_percent
    return math.ceil(ratio) != int(ratio)


def frame_signal(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """Frame a (..., n) signal into (..., n_frames, nfft) windows (a view)."""
    return x.unfold(-1, nfft, hop)


def _pad_signal(x: torch.Tensor, nfft: int, hop: int, fs: int, wlen_sec: float,
                hop_percent: float, center: bool, pad_at_end: bool) -> torch.Tensor:
    n = x.shape[-1]
    if pad_at_end and _needs_end_pad(n, fs, wlen_sec, hop_percent):
        x = F.pad(x, (0, hop))
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (nfft // 2, nfft // 2),
                  mode="reflect").reshape(*lead, -1)
    return x


def stft_frames(x: torch.Tensor, fs: int = 16000, wlen_sec: float = 64e-3,
                hop_percent: float = 0.25, center: bool = False,
                pad_at_end: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of a (..., n_samples) batch -> (re, im), each (..., n_frames, n_freq)."""
    nfft = int(wlen_sec * fs)
    hop = int(hop_percent * nfft)
    x = _pad_signal(x.float(), nfft, hop, fs, wlen_sec, hop_percent, center,
                    pad_at_end)
    frames = frame_signal(x, nfft, hop)
    cos_b, sin_b = _device_bases(nfft, x.device)
    return torch.matmul(frames, cos_b), torch.matmul(frames, sin_b)


def log_power_frontend(x: torch.Tensor, fs: int = 16000, wlen_sec: float = 64e-3,
                       hop_percent: float = 0.25, center: bool = False,
                       pad_at_end: bool = True, eps: float = 1e-8,
                       peak_norm: bool = True) -> torch.Tensor:
    """Waveform -> log(|STFT|^2 + eps), (..., T, F) float32, after the
    per-utterance peak normalisation."""
    x = x.float()
    if peak_norm:
        x = x / x.abs().amax(dim=-1, keepdim=True)
    re, im = stft_frames(x, fs=fs, wlen_sec=wlen_sec, hop_percent=hop_percent,
                         center=center, pad_at_end=pad_at_end)
    return torch.log(re * re + im * im + eps)
