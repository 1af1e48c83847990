"""Host-side STFT / iSTFT (numpy).

Matches the semantics of the reference's dual librosa/torch STFTs
(the reference's packages/processing/stft.py:13-152): 64 ms periodic Hann
window, hop = hop_percent * nfft, optional centering with reflect padding,
and the end-padding rule that appends `hopsamp` zeros whenever the utterance
length is not an exact multiple of the hop (so STFT -> iSTFT round-trips the
signal length). The reference cross-checked its librosa and torch variants
against each other (the reference's scripts/visualization_audio.py:97-133);
here a single numpy implementation serves both roles and the test suite pins
it against the reference's committed `data/subset/processed` artifacts.
"""

from __future__ import annotations

import math

import numpy as np


def hann_window(nfft: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(nfft) and
    scipy.signal.get_window('hann', nfft, fftbins=True)."""
    n = np.arange(nfft, dtype=dtype)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / nfft)


def _needs_end_pad(n_samples: int, fs: float, wlen_sec: float, hop_percent: float) -> bool:
    # Reproduces the reference's float-arithmetic test
    # (the reference's packages/processing/stft.py:45-50) exactly, including
    # its use of seconds rather than samples.
    utt_len = n_samples / fs
    ratio = utt_len / wlen_sec / hop_percent
    return math.ceil(ratio) != int(ratio)


def pad_for_stft(
    x: np.ndarray,
    fs: float = 16000,
    wlen_sec: float = 64e-3,
    hop_percent: float = 0.25,
    center: bool = False,
    pad_mode: str = "reflect",
    pad_at_end: bool = True,
) -> np.ndarray:
    """Apply the reference's padding pipeline: optional hop-size end pad,
    then (if center) nfft//2 reflect padding on both sides."""
    nfft = int(wlen_sec * fs)
    hopsamp = int(hop_percent * nfft)
    y = x
    if pad_at_end and _needs_end_pad(len(x), fs, wlen_sec, hop_percent):
        y = np.pad(y, (0, hopsamp), mode="constant")
    if center:
        y = np.pad(y, nfft // 2, mode=pad_mode)
    return y


def frame(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Frame a 1-D signal into overlapping columns, shape (frame_length, n_frames).

    Same layout as the librosa.util.frame call used by the VAD label
    generator (the reference's packages/processing/target.py:45)."""
    n_frames = 1 + (len(x) - frame_length) // hop_length
    if n_frames < 1:
        raise ValueError(
            f"signal of length {len(x)} too short for frame_length {frame_length}"
        )
    stride = x.strides[0]
    frames = np.lib.stride_tricks.as_strided(
        x,
        shape=(frame_length, n_frames),
        strides=(stride, hop_length * stride),
        writeable=False,
    )
    return frames


def stft(
    x: np.ndarray,
    fs: float = 16000,
    wlen_sec: float = 64e-3,
    win: str = "hann",
    hop_percent: float = 0.25,
    center: bool = False,
    pad_mode: str = "reflect",
    pad_at_end: bool = True,
    dtype: str = "complex64",
) -> np.ndarray:
    """Forward STFT. Returns (n_freq, n_frames) complex, DC bin included."""
    if wlen_sec * fs != int(wlen_sec * fs):
        raise ValueError("wlen_sample of STFT is not an integer.")
    nfft = int(wlen_sec * fs)
    hopsamp = int(hop_percent * nfft)
    if win != "hann":
        raise ValueError(f"unsupported window: {win}")

    y = pad_for_stft(
        np.asarray(x, dtype=np.float64),
        fs=fs,
        wlen_sec=wlen_sec,
        hop_percent=hop_percent,
        center=center,
        pad_mode=pad_mode,
        pad_at_end=pad_at_end,
    )
    w = hann_window(nfft)
    frames = frame(y, nfft, hopsamp)  # (nfft, T)
    sxx = np.fft.rfft(frames * w[:, None], n=nfft, axis=0)
    return sxx.astype(dtype)


def istft(
    sxx: np.ndarray,
    fs: float = 16000,
    wlen_sec: float = 64e-3,
    win: str = "hann",
    hop_percent: float = 0.25,
    center: bool = False,
    dtype: str = "float32",
    max_len: float | None = None,
) -> np.ndarray:
    """Inverse STFT with NOLA window-square normalization (librosa.istft
    semantics, the reference's packages/processing/stft.py:63-99).

    `max_len` is in seconds, mirroring the reference's odd contract of
    slicing `x[:int(max_len * fs)]`.
    """
    nfft = int(wlen_sec * fs)
    hopsamp = int(hop_percent * nfft)
    w = hann_window(nfft)

    n_frames = sxx.shape[-1]
    expected_len = nfft + hopsamp * (n_frames - 1)
    x = np.zeros(expected_len, dtype=np.float64)
    win_sum = np.zeros(expected_len, dtype=np.float64)

    frames_t = np.fft.irfft(sxx, n=nfft, axis=0).real  # (nfft, T)
    for t in range(n_frames):
        s = t * hopsamp
        x[s : s + nfft] += w * frames_t[:, t]
        win_sum[s : s + nfft] += w * w

    nz = win_sum > np.finfo(np.float64).tiny
    x[nz] /= win_sum[nz]

    if center:
        x = x[nfft // 2 : -(nfft // 2) or None]
    if max_len:
        x = x[: int(max_len * fs)]
    return x.astype(dtype)


def log_power_spectrogram(sxx: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """log(|S|^2 + eps), the model's audio feature
    (the reference's packages/data_handling.py:298-301)."""
    power = sxx.real.astype(np.float64) ** 2 + sxx.imag.astype(np.float64) ** 2
    return np.log(power + eps).astype(np.float32)


def n_stft_frames(
    n_samples: int,
    fs: float = 16000,
    wlen_sec: float = 64e-3,
    hop_percent: float = 0.25,
    center: bool = False,
    pad_at_end: bool = True,
) -> int:
    """Number of frames stft() will produce for an n_samples signal."""
    nfft = int(wlen_sec * fs)
    hopsamp = int(hop_percent * nfft)
    n = n_samples
    if pad_at_end and _needs_end_pad(n_samples, fs, wlen_sec, hop_percent):
        n += hopsamp
    if center:
        n += 2 * (nfft // 2)
    return 1 + (n - nfft) // hopsamp
