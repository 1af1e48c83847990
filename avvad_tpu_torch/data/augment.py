"""On-the-fly noise augmentation emulating the NTCD-TIMIT noise grid.

The reference trains on a pre-rendered grid of 6 noise types x 3 SNRs
(Babble, Cafe, Car, LR, Street, White at -5/0/5 dB —
the reference's packages/dataset/ntcd_timit.py:330-334). The in-repo
subset fixture ships only ONE condition (Babble @ -5 dB), which starves
training diversity: a model that only ever sees one noise at one SNR has
nothing to learn robustness from. This module remixes the subset's CLEAN
wavs with synthesized noise across the full 6x3 grid at load time, so an
epoch covers 18 conditions per utterance with fresh noise realizations
every epoch — the closest reachable emulation of the corpus recipe in
this environment (the real corpus noises are not shipped).

Noise families (deterministic per (seed, epoch, item)):
- white:  flat gaussian
- babble: overlap-add of K time-shifted copies drawn from the split's own
          clean-speech pool (the classic babble construction)
- cafe:   babble + pink bed
- street: pink (1/f) noise
- car:    brown (1/f^2) noise — low-frequency dominated, like cabin noise
- lr:     deep-red (1/f^3) rumble ("living room" hum/rumble band)

SNR is defined on the full-utterance clean power vs noise power, applied
BEFORE the pipeline's peak normalization (matching where the corpus mixes
live: the noisy wav on disk is normalized at load,
packages/data_handling.py:436-457).

A copy of avvad_tpu/data/augment.py.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import STFTConfig
from ..processing.audio_io import peak_normalize, read_wav
from ..processing.stft import log_power_spectrogram, stft
from .records import load_label, load_video, truncate_common, \
    video_path_for_label

NOISE_KINDS = ("Babble", "Cafe", "Car", "LR", "Street", "White")
SNRS_DB = (-5.0, 0.0, 5.0)


def _colored_noise(n: int, rng: np.random.Generator, slope: float) -> np.ndarray:
    """Gaussian noise with power spectrum ~ 1/f^slope (FFT shaping)."""
    white = rng.normal(size=n).astype(np.float32)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n)
    f[0] = f[1] if n > 1 else 1.0  # avoid div0; DC gets the lowest bin's gain
    spec *= f ** (-slope / 2.0)
    out = np.fft.irfft(spec, n).astype(np.float32)
    return out / (np.std(out) + 1e-12)


def _babble(n: int, rng: np.random.Generator, pool: list,
            k: int = 6) -> np.ndarray:
    """Overlap-add of k randomly-offset clean-speech segments."""
    out = np.zeros(n, np.float32)
    for _ in range(k):
        src = pool[rng.integers(len(pool))]
        reps = int(np.ceil((n + len(src)) / len(src)))
        tiled = np.tile(src, reps)
        off = int(rng.integers(len(src)))
        out += tiled[off:off + n]
    return out / (np.std(out) + 1e-12)


def synth_noise(kind: str, n: int, rng: np.random.Generator,
                speech_pool: Optional[list] = None) -> np.ndarray:
    """Unit-variance noise of the requested family."""
    if kind == "White":
        return rng.normal(size=n).astype(np.float32)
    if kind == "Street":
        return _colored_noise(n, rng, slope=1.0)
    if kind == "Car":
        return _colored_noise(n, rng, slope=2.0)
    if kind == "LR":
        return _colored_noise(n, rng, slope=3.0)
    if kind == "Babble":
        if not speech_pool:
            raise ValueError("babble noise needs a clean-speech pool")
        return _babble(n, rng, speech_pool)
    if kind == "Cafe":
        if not speech_pool:
            raise ValueError("cafe noise needs a clean-speech pool")
        b = _babble(n, rng, speech_pool, k=4)
        p = _colored_noise(n, rng, slope=1.0)
        out = 0.7 * b + 0.3 * p
        return out / (np.std(out) + 1e-12)
    raise ValueError(f"unknown noise kind {kind!r}")


def mix_at_snr(clean: np.ndarray, noise: np.ndarray,
               snr_db: float) -> np.ndarray:
    """clean + scaled noise at the requested SNR (full-utterance power)."""
    p_clean = float(np.mean(clean ** 2))
    p_noise = float(np.mean(noise ** 2))
    if p_noise <= 0 or p_clean <= 0:
        return clean.astype(np.float32)
    gain = np.sqrt(p_clean / (p_noise * 10.0 ** (snr_db / 10.0)))
    return (clean + gain * noise).astype(np.float32)


def clean_rel_from_noisy(noisy_rel: str) -> str:
    """'ntcd_timit/Noisy/<noise>/<snr>/<split>/<spk>/<utt>.wav' ->
    'ntcd_timit/Clean/<split>/<spk>/<utt>.wav'."""
    parts = noisy_rel.replace("\\", "/").split("/")
    i = parts.index("Noisy")
    return "/".join(parts[:i] + ["Clean"] + parts[i + 3:])


@dataclass
class AugmentingSource:
    """Wrap an AudioSequenceSource / AudioVisualSource: each utterance is
    expanded over the 6-noise x 3-SNR grid with fresh noise realizations
    per epoch. Video and labels pass through untouched.

    set_epoch(e) re-seeds the realizations (DataLoader calls it when the
    source exposes it), so the grid coverage is deterministic per epoch
    but noise is never repeated across epochs.
    """

    inner: object
    seed: int = 0
    kinds: tuple = NOISE_KINDS
    snrs: tuple = SNRS_DB
    epoch: int = field(default=0, init=False)

    def __post_init__(self):
        self._pool = None
        self._pool_lock = threading.Lock()
        self._is_av = hasattr(self.inner, "video_variant") and \
            "Visual" in type(self.inner).__name__

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.inner) * len(self.kinds) * len(self.snrs)

    def _split(self, i: int):
        n_cond = len(self.kinds) * len(self.snrs)
        utt, cond = divmod(i, n_cond)
        kind_i, snr_i = divmod(cond, len(self.snrs))
        return utt, self.kinds[kind_i], self.snrs[snr_i]

    def probe_length(self, i: int) -> int:
        return self.inner.probe_length(self._split(i)[0])

    def _speech_pool(self) -> list:
        # Built under a lock and published atomically only once complete:
        # the DataLoader calls __getitem__ from worker THREADS, and a
        # reader observing a partially built pool would draw babble noise
        # from a nondeterministic subset (or crash on an empty pool),
        # violating the documented determinism per (seed, epoch, item).
        if self._pool is None:
            with self._pool_lock:
                if self._pool is None:
                    pool = []
                    for noisy_rel, _ in self.inner.pairs:
                        x, _fs = read_wav(
                            self.inner.root + clean_rel_from_noisy(noisy_rel))
                        pool.append(x.astype(np.float32))
                    self._pool = pool
        return self._pool

    def _clean_wav(self, utt: int) -> tuple:
        """Clean signal for an utterance — from the in-memory pool (it
        holds exactly these arrays) rather than a fresh disk read."""
        return self._speech_pool()[utt], self.inner.stft_cfg.fs

    def _augmented_logspec(self, utt: int, kind: str, snr: float,
                           rng: np.random.Generator) -> np.ndarray:
        cfg: STFTConfig = self.inner.stft_cfg
        clean, fs = self._clean_wav(utt)
        pool = self._speech_pool() if kind in ("Babble", "Cafe") else None
        noise = synth_noise(kind, len(clean), rng, pool)
        mixed = peak_normalize(mix_at_snr(clean, noise, snr))
        sxx = stft(mixed, fs=fs, wlen_sec=cfg.wlen_sec, win=cfg.win,
                   hop_percent=cfg.hop_percent, center=cfg.center,
                   pad_mode=cfg.pad_mode, pad_at_end=cfg.pad_at_end)
        return np.ascontiguousarray(
            log_power_spectrogram(sxx, eps=cfg.eps).T)

    def __getitem__(self, i: int) -> dict:
        utt, kind, snr = self._split(i)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, i]))
        noisy_rel, label_rel = self.inner.pairs[utt]
        audio = self._augmented_logspec(utt, kind, snr, rng)
        label = load_label(self.inner.root + label_rel)
        meta = dict(self.inner.metadata(utt))
        meta["noise_type"] = kind
        meta["snr_db"] = str(int(snr))
        if self._is_av:
            video = load_video(self.inner.root + video_path_for_label(
                label_rel, self.inner.labels, self.inner.upsampled,
                self.inner.video_variant))
            audio, video, label = truncate_common(audio, video, label)
            return {"audio": audio, "video": video, "label": label,
                    "length": audio.shape[0], **meta}
        audio, label = truncate_common(audio, label)
        return {"audio": audio, "label": label, "length": audio.shape[0],
                **meta}

    def feature_item(self, i: int) -> np.ndarray:
        """Audio features only — the statistics-pass fast path, skipping
        the video load that `__getitem__` pays for. Truncates to the label
        length like `__getitem__` does (at 30 fps labels that halves the
        frame count, so skipping it would put the stats on frames the
        model never sees); the remaining difference vs `__getitem__` is
        only the AV video-length truncation, a frame or two of tail. Same
        (seed, epoch, item) noise realization as `__getitem__`."""
        utt, kind, snr = self._split(i)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, i]))
        audio = self._augmented_logspec(utt, kind, snr, rng)
        label = load_label(self.inner.root + self.inner.pairs[utt][1])
        return audio[: min(audio.shape[0], label.shape[0])]


def feature_stats(source, key: str = "audio", max_items: int = 0):
    """Per-bin mean/std over one pass of a source (for --std-norm when the
    pre-rendered statistics h5 does not describe the augmented mix).

    Matches the reference's dataset-statistics math: per-frequency-bin
    mean/std of the log-power spectrogram over all frames
    (the reference's scripts/create_audio_train_files.py:343-368)."""
    n = 0
    s1 = None
    s2 = None
    count = len(source) if not max_items else min(len(source), max_items)
    fast = key == "audio" and hasattr(source, "feature_item")
    for i in range(count):
        x = (source.feature_item(i) if fast
             else source[i][key]).astype(np.float64)
        if s1 is None:
            s1 = np.zeros(x.shape[-1])
            s2 = np.zeros(x.shape[-1])
        n += x.shape[0]
        s1 += x.sum(axis=0)
        s2 += (x ** 2).sum(axis=0)
    mean = s1 / n
    var = np.maximum(s2 / n - mean ** 2, 0.0)
    return mean.astype(np.float32), np.sqrt(var).astype(np.float32)
