"""Waveform -> log-power STFT frontend, its inverse and the frame-energy
VAD (port of avvad_tpu/ops/stft.py).

Three routes to the windowed real DFT, all fp32 ``torch.matmul`` /
``einsum`` against cos/sin bases, as the JAX package computes them outside
any Pallas kernel:

- direct (the default): frames are cut with ``unfold`` and multiplied by
  (nfft, n_freq) bases with the periodic Hann window folded in;
- ``split_radix``: the Cooley-Tukey split nfft = inner * 8 of the windowed
  frames (``_dft_split_radix``), the same sums in another order;
- ``hop_dft``: one K=hop matmul per hop block of the unframed signal, the
  frame's spectrum assembled from its nfft/hop block spectra with constant
  twiddles, and the Hann window applied exactly as a 3-tap convolution in
  frequency (``_dft_hop_blocks``). The streaming servers run it on the
  span wire.

Computation is fp32 throughout. On the card the matmul must not run in
TF32 (the JAX package pins Precision.HIGHEST here: lower precision costs
whole log-units on quiet bins); ``export.make_waveform_serving_fn`` turns
TF32 off, and ``torch.backends.cuda.matmul.allow_tf32`` is False by default.

``istft_frames`` inverts (re, im) spectra by two fp32 products with the
inverse real-DFT bases, the windowed overlap-add and the division by the
summed squared window; ``frame_energy_vad`` is the oracle energy VAD of
``processing.targets.clean_speech_VAD`` on the card.
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
def _split_radix_bases(nfft: int, outer: int = 8):
    """Cooley-Tukey bases for a real-input DFT split as nfft = inner*outer.

    With n = n2*outer + n1 and k = k1*inner + k2:
      A[n1, k2] = DFT_inner of the n1-th polyphase component   (real input)
      X[k1*inner + k2] = DFT_outer over n1 of A[n1,k2] * e^{-2pi i n1 k2/N}
    Only k1 in [0, k1_max) is computed: enough to cover the nfft//2+1
    real-DFT bins."""
    inner = nfft // outer
    n_freq = nfft // 2 + 1
    n2 = np.arange(inner, dtype=np.float64)
    k2 = np.arange(inner, dtype=np.float64)
    ang_in = 2.0 * np.pi * np.outer(n2, k2) / inner        # (inner, inner)
    n1 = np.arange(outer, dtype=np.float64)
    tw = 2.0 * np.pi * np.outer(n1, k2) / nfft             # (outer, inner)
    k1_max = (n_freq - 1) // inner + 1
    ang_out = 2.0 * np.pi * np.outer(
        n1, np.arange(k1_max, dtype=np.float64)) / outer   # (outer, k1_max)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f(np.cos(ang_in)), f(-np.sin(ang_in)),
            f(np.cos(tw)), f(-np.sin(tw)),
            f(np.cos(ang_out)), f(-np.sin(ang_out)), k1_max)


@functools.lru_cache(maxsize=8)
def _hop_dft_bases(nfft: int, hop: int):
    """Bases for the hop-block DFT (see _dft_hop_blocks): the UNWINDOWED
    (hop, n_freq) cos/sin bases on the frame-length frequency grid, and the
    (r, n_freq) twiddles e^{-2pi i k s hop / nfft} that assemble a frame's
    DFT from its r = nfft // hop consecutive hop-block DFTs (for
    hop = nfft/4 exactly {1, -i, -1, i})."""
    r = nfft // hop
    n_freq = nfft // 2 + 1
    n = np.arange(hop, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / nfft                       # (hop, n_freq)
    s = np.arange(r, dtype=np.float64)[:, None]
    tw = 2.0 * np.pi * s * k * hop / nfft                  # (r, n_freq)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f(np.cos(ang)), f(-np.sin(ang)),
            f(np.cos(tw)), f(-np.sin(tw)))


def _hann(nfft: int) -> tuple[np.ndarray]:
    return (hann_window(nfft),)


@functools.lru_cache(maxsize=16)
def _on(device: torch.device, make, *args) -> tuple:
    """The numpy arrays of ``make(*args)`` as tensors on ``device``
    (integers among them pass through), cached per device."""
    return tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a
                 for a in make(*args))


def _dft_split_radix(frames: torch.Tensor, nfft: int,
                     outer: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed real DFT of (..., nfft) frames via the split above."""
    c_in, s_in, t_re, t_im, o_re, o_im, k1m = _on(frames.device,
                                                  _split_radix_bases, nfft, outer)
    inner = nfft // outer
    n_freq = nfft // 2 + 1
    xw = frames * _on(frames.device, _hann, nfft)[0]
    x2 = xw.reshape(*xw.shape[:-1], inner, outer)          # [n2][n1]
    a_re = torch.einsum("...ab,ak->...bk", x2, c_in)       # (..., outer, inner)
    a_im = torch.einsum("...ab,ak->...bk", x2, s_in)
    b_re = a_re * t_re - a_im * t_im
    b_im = a_re * t_im + a_im * t_re
    re = (torch.einsum("...nk,nj->...jk", b_re, o_re)
          - torch.einsum("...nk,nj->...jk", b_im, o_im))
    im = (torch.einsum("...nk,nj->...jk", b_re, o_im)
          + torch.einsum("...nk,nj->...jk", b_im, o_re))
    re = re.reshape(*re.shape[:-2], k1m * inner)[..., :n_freq]
    im = im.reshape(*im.shape[:-2], k1m * inner)[..., :n_freq]
    return re, im


def _dft_hop_blocks(x: torch.Tensor, nfft: int, hop: int,
                    n_frames: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed real DFT of all frames of a (..., n) signal: frames a hop
    apart share their samples, so the DFT matmul runs once per length-hop
    BLOCK (a K=hop contraction) and each frame's spectrum is assembled from
    its r = nfft/hop block spectra with constant twiddles.

    The periodic Hann window (0.5 - 0.5 cos(2pi n/N)) spans the whole frame
    and cannot be folded into the block bases, but its DFT is three
    integer-bin taps, so it is applied EXACTLY in frequency:
      Xw(k) = 0.5 X(k) - 0.25 X(k-1) - 0.25 X(k+1)   (circular),
    with the k=-1 / k=nfft/2+1 neighbours from real-input conjugate
    symmetry."""
    r = nfft // hop
    c_b, s_b, t_re, t_im = _on(x.device, _hop_dft_bases, nfft, hop)
    nb = n_frames - 1 + r
    blocks = x[..., : nb * hop].reshape(*x.shape[:-1], nb, hop)
    b_re = torch.matmul(blocks, c_b)                       # (..., nb, F)
    b_im = torch.matmul(blocks, s_b)
    re = im = 0.0
    for si in range(r):
        sr = b_re[..., si: si + n_frames, :]
        sim = b_im[..., si: si + n_frames, :]
        re = re + (sr * t_re[si] - sim * t_im[si])
        im = im + (sr * t_im[si] + sim * t_re[si])
    # X(-1) = conj(X(1)), X(nfft/2 + 1) = conj(X(nfft/2 - 1))
    re_l = torch.cat([re[..., 1:2], re[..., :-1]], dim=-1)
    re_r = torch.cat([re[..., 1:], re[..., -2:-1]], dim=-1)
    im_l = torch.cat([-im[..., 1:2], im[..., :-1]], dim=-1)
    im_r = torch.cat([im[..., 1:], -im[..., -2:-1]], dim=-1)
    return (0.5 * re - 0.25 * (re_l + re_r),
            0.5 * im - 0.25 * (im_l + im_r))


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
                pad_at_end: bool = True, split_radix: bool = False,
                hop_dft: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """STFT of a (..., n_samples) batch -> (re, im), each (..., n_frames, n_freq).
    ``split_radix`` (where 8 divides nfft) and ``hop_dft`` (where hop
    divides nfft; it wins over ``split_radix``) pick the other routes of
    the module docstring; otherwise the direct one runs."""
    nfft = int(wlen_sec * fs)
    hop = int(hop_percent * nfft)
    x = _pad_signal(x.float(), nfft, hop, fs, wlen_sec, hop_percent, center,
                    pad_at_end)
    if hop_dft and nfft % hop == 0:
        n_frames = 1 + (x.shape[-1] - nfft) // hop
        return _dft_hop_blocks(x, nfft, hop, n_frames)
    frames = frame_signal(x, nfft, hop)
    if split_radix and nfft % 8 == 0:
        return _dft_split_radix(frames, nfft)
    cos_b, sin_b = _on(x.device, _windowed_dft_bases, nfft)
    return torch.matmul(frames, cos_b), torch.matmul(frames, sin_b)


def log_power_frontend(x: torch.Tensor, fs: int = 16000, wlen_sec: float = 64e-3,
                       hop_percent: float = 0.25, center: bool = False,
                       pad_at_end: bool = True, eps: float = 1e-8,
                       peak_norm: bool = True, split_radix: bool = False,
                       hop_dft: bool = False) -> torch.Tensor:
    """Waveform -> log(|STFT|^2 + eps), (..., T, F) float32, after the
    per-utterance peak normalisation. ``split_radix`` / ``hop_dft``: see
    ``stft_frames``."""
    x = x.float()
    if peak_norm:
        x = x / x.abs().amax(dim=-1, keepdim=True)
    re, im = stft_frames(x, fs=fs, wlen_sec=wlen_sec, hop_percent=hop_percent,
                         center=center, pad_at_end=pad_at_end,
                         split_radix=split_radix, hop_dft=hop_dft)
    return torch.log(re * re + im * im + eps)


@functools.lru_cache(maxsize=8)
def _inverse_dft_bases(nfft: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_freq, nfft) bases: time_frame = re @ Mr + im @ Mi (window applied
    separately); the Hermitian-symmetric inverse real DFT (numpy irfft)."""
    f = nfft // 2 + 1
    k = np.arange(f, dtype=np.float64)[:, None]
    n = np.arange(nfft, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / nfft
    w = np.full((f, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0  # nfft even
    mr = (w * np.cos(ang) / nfft).astype(np.float32)
    mi = (-(w * np.sin(ang)) / nfft).astype(np.float32)
    mi[0] = 0.0
    mi[-1] = 0.0
    return mr, mi


@functools.lru_cache(maxsize=8)
def _overlap_add_scale(nfft: int, hop: int, t: int) -> np.ndarray:
    """1 / the summed squared window at each output sample (0 where it is
    0): the NOLA normalisation, which depends only on the shapes."""
    n_out = nfft + hop * (t - 1)
    win_sq = np.zeros(n_out, dtype=np.float64)
    win64 = hann_window(nfft).astype(np.float64)
    for f_i in range(t):
        win_sq[f_i * hop:f_i * hop + nfft] += win64 * win64
    tiny = np.finfo(np.float64).tiny
    return np.where(win_sq > tiny, 1.0 / np.maximum(win_sq, tiny), 0.0).astype(np.float32)


def istft_frames(re: torch.Tensor, im: torch.Tensor, fs: int = 16000,
                 wlen_sec: float = 64e-3, hop_percent: float = 0.25,
                 center: bool = False) -> torch.Tensor:
    """(T, F) real and imaginary spectra -> (n_samples,) float32: the
    inverse of ``stft_frames`` for one signal (``processing.stft.istft`` on
    the card)."""
    nfft = int(wlen_sec * fs)
    hop = int(hop_percent * nfft)
    t = re.shape[0]
    mr, mi = _on(re.device, _inverse_dft_bases, nfft)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        frames = torch.matmul(re.float(), mr) + torch.matmul(im.float(), mi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (w,) = _on(re.device, _hann, nfft)
    wf = frames * w
    n_out = nfft + hop * (t - 1)
    idx = (torch.arange(t, device=re.device)[:, None] * hop
           + torch.arange(nfft, device=re.device)[None, :]).reshape(-1)
    x = torch.zeros(n_out, dtype=torch.float32, device=re.device).index_add_(
        0, idx, wf.reshape(-1))
    x = x * torch.as_tensor(_overlap_add_scale(nfft, hop, t), device=re.device)
    if center:
        x = x[nfft // 2:-(nfft // 2)]
    return x


def frame_energy_vad(x: torch.Tensor, fs: int = 16000, wlen_sec: float = 64e-3,
                     hop_percent: float = 0.25, pad_at_end: bool = True,
                     vad_threshold: float = 1.70) -> torch.Tensor:
    """(n_samples,) -> (n_frames,) float32 of 0 / 1: a frame is speech where
    its energy exceeds 10 ** vad_threshold times the quietest frame's."""
    nfft = int(wlen_sec * fs)
    hop = int(hop_percent * nfft)
    if pad_at_end and _needs_end_pad(x.shape[-1], fs, wlen_sec, hop_percent):
        x = F.pad(x, (0, hop))
    frames = frame_signal(x, nfft, hop)
    power = torch.sum(frames * frames, dim=-1)
    return (power > (10.0 ** vad_threshold) * torch.min(power)).float()
