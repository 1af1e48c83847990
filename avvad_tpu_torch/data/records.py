"""Per-utterance feature loading (host-side numpy; a copy of
avvad_tpu/data/records.py, HDF5 read by the port's own ``hdf5``).

One function per modality; all return TIME-MAJOR arrays — (T, ...) — the
layout the models take (features last), unlike the reference's
feature-major (F, T) h5 layout which it transposes inside collate
(the reference's packages/utils.py:96-102). Truncation of the modalities to
their common frame count mirrors data_handling.py:482-486.
"""

from __future__ import annotations

import os

import numpy as np

from .. import hdf5
from ..config import STFTConfig
from ..processing.audio_io import peak_normalize, read_wav
from ..processing.stft import log_power_spectrogram, stft


def load_waveform(path: str) -> np.ndarray:
    """Raw peak-normalized waveform, (n_samples,) float32."""
    x, _fs = read_wav(path)
    return peak_normalize(x).astype(np.float32)


def load_audio_logspec(path: str, stft_cfg: STFTConfig = STFTConfig()) -> np.ndarray:
    """noisy wav -> log-power spectrogram, (T, 513) float32.

    Same math as the reference's in-__getitem__ pipeline
    (the reference's packages/data_handling.py:436-457): peak-normalize,
    STFT, power, log(+eps).
    """
    x, fs = read_wav(path)
    if fs != stft_cfg.fs:
        raise ValueError(f"{path}: expected fs={stft_cfg.fs}, got {fs}")
    sxx = stft(
        peak_normalize(x),
        fs=fs,
        wlen_sec=stft_cfg.wlen_sec,
        win=stft_cfg.win,
        hop_percent=stft_cfg.hop_percent,
        center=stft_cfg.center,
        pad_mode=stft_cfg.pad_mode,
        pad_at_end=stft_cfg.pad_at_end,
    )
    return np.ascontiguousarray(log_power_spectrogram(sxx, eps=stft_cfg.eps).T)


def load_video(path: str) -> np.ndarray:
    """Processed lip video h5 ("X", (67, 67, T)) -> (T, 67, 67) float32."""
    with hdf5.File(path, "r") as f:
        x = f["X"][:]
    return np.ascontiguousarray(np.moveaxis(x, -1, 0).astype(np.float32))


def load_label(path: str) -> np.ndarray:
    """Label h5 ("Y", (y_dim, T)) -> (T, y_dim) float32."""
    with hdf5.File(path, "r") as f:
        y = f["Y"][:]
    return np.ascontiguousarray(y.T.astype(np.float32))


def truncate_common(*arrays: np.ndarray) -> tuple[np.ndarray, ...]:
    """Truncate time-major arrays to their common (minimum) frame count."""
    t = min(a.shape[0] for a in arrays)
    return tuple(a[:t] for a in arrays)


def video_path_for_label(label_path: str, labels: str, upsampled: bool,
                         video_variant: str = "auto") -> str:
    """Label h5 path -> sibling processed-video h5 path.

    Mirrors the reference's path rewrite (data_handling.py:460-466):
    Clean -> matlab_raw, strip the label suffix, choose the video variant.
    With `video_variant="auto"`, reproduces the reference exactly: upsampled
    labels pair with `*_upsampled.h5` videos, non-upsampled with
    `*_normvideo.h5`. Explicit variants ("upsampled" / "normvideo" /
    "plain") decouple the choice from the label naming, which is needed for
    corpora (like the reference's own subset fixture) whose labels predate
    the `_upsampled` label-file suffix.
    """
    p = label_path.replace("Clean", "matlab_raw").replace("_" + labels, "")
    stem = os.path.splitext(p)[0]
    if video_variant == "auto":
        return stem + (".h5" if upsampled else "_normvideo.h5")
    if video_variant == "upsampled":
        if not stem.endswith("_upsampled"):
            stem += "_upsampled"
        return stem + ".h5"
    if video_variant == "normvideo":
        return stem + "_normvideo.h5"
    if video_variant == "plain":
        return stem + ".h5"
    raise ValueError(f"unknown video_variant: {video_variant}")
