"""STFT frontend parameters (own copy of avvad_tpu/config.py:19-55,
``STFTConfig``: what the streaming servers need, no more)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class STFTConfig:
    """Defaults are the reference training configuration: 16 kHz, 64 ms
    Hann window (1024 samples -> 513 bins), hop 25 % (256 samples = 62.5
    frames a second), center=False, end padding."""

    fs: int = 16000
    wlen_sec: float = 64e-3
    hop_percent: float = 0.25
    win: str = "hann"
    center: bool = False
    pad_mode: str = "reflect"
    pad_at_end: bool = True
    eps: float = 1e-8

    @property
    def nfft(self) -> int:
        n = self.wlen_sec * self.fs
        if n != int(n):
            raise ValueError("wlen_sample of STFT is not an integer.")
        return int(n)

    @property
    def hopsamp(self) -> int:
        return int(self.hop_percent * self.nfft)

    @property
    def n_freq(self) -> int:
        return self.nfft // 2 + 1

    @property
    def frame_rate(self) -> float:
        return self.fs / self.hopsamp
