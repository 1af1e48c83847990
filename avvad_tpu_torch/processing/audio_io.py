"""WAV I/O without librosa/torchaudio/soundfile.

The reference reads audio through torchaudio.load, which scales integer PCM
to [-1, 1] (the reference's packages/data_handling.py:280). Every consumer
immediately peak-normalizes (`x / max(|x|)`), so any consistent linear scale
is parity-equivalent; we still match torchaudio's 1/32768 scaling for int16
so intermediate values agree too.

A copy of avvad_tpu/processing/audio_io.py. With ``AVVAD_NATIVE=1``
``read_wav`` decodes through the port's C++ library (``native.read_wav``,
built from ``csrc/avvad_io.cpp`` at first use); where that library cannot
be built the call raises, where the JAX package falls back to scipy.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile


_INT_SCALE = {
    np.dtype(np.int16): 1.0 / 32768.0,
    np.dtype(np.int32): 1.0 / 2147483648.0,
    np.dtype(np.uint8): None,  # handled specially (offset binary)
}


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono signal in [-1, 1], sample_rate).

    Multi-channel files return channel 0, mirroring the reference's
    `speech[0]` convention."""
    if os.environ.get("AVVAD_NATIVE") == "1":
        from .. import native

        return native.read_wav(path)
    fs, data = wavfile.read(path)
    if data.ndim == 2:
        data = data[:, 0]
    dt = data.dtype
    if dt == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    elif dt in (np.dtype(np.int16), np.dtype(np.int32)):
        x = data.astype(np.float32) * _INT_SCALE[dt]
    else:  # already float
        x = data.astype(np.float32)
    return x, int(fs)


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """x / max(|x|) (the reference's packages/data_handling.py:285)."""
    return x / np.max(np.abs(x))


def write_wav(path: str, x: np.ndarray, fs: int) -> None:
    """Write float signal as 16-bit PCM."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        x = np.clip(x, -1.0, 1.0)
        x = (x * 32767.0).astype(np.int16)
    wavfile.write(path, fs, x)
