"""Offline dataset builders: raw corpus -> processed features/labels/stats.

Covers the reference's create_video_train_files_upsampled.py and
create_audio_train_files.py (L5): decode+upsample lip video, generate
VAD/IBM labels from clean speech, copy noisy wavs into the processed tree,
and accumulate train-set normalization statistics — writing the same h5
datasets (X (67,67,T) / Y (y_dim,T); statistics with X_train_mean/std)
so artifacts interoperate with the reference. The JAX builders compress
with LZF in per-frame chunks; the port's own ``hdf5`` writes the same
arrays contiguous and uncompressed (other bytes, the same datasets).

Differences by design: no ffmpeg round trip (the fps-filter schedule is
computed exactly; see processing.video), process-pool fan-out is built in,
and every step is a pure function usable from tests.

A copy of avvad_tpu/builders.py, writing and reading HDF5 through the
port's own ``hdf5``.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from shutil import copyfile

import numpy as np

from . import hdf5
from .config import LabelConfig, STFTConfig, VideoConfig
from .data.statistics import save_statistics, welford_merge
from .datasets import ntcd_timit as catalog
from .processing import clean_speech_IBM, clean_speech_VAD, read_wav, stft
from .processing.audio_io import peak_normalize
from .processing.stft import log_power_spectrogram
from .processing.video import decode_and_upsample


def _write_h5(path: str, key: str, data: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    with hdf5.File(path, "w") as f:
        f.create_dataset(key, data=np.asarray(data, dtype=np.float32))


def make_label(x: np.ndarray, fs: int, stft_cfg: STFTConfig,
               label_cfg: LabelConfig) -> np.ndarray:
    """Clean waveform -> (y_dim, T) label matrix."""
    if label_cfg.kind == "vad_labels":
        return clean_speech_VAD(
            x, fs=fs, wlen_sec=stft_cfg.wlen_sec,
            hop_percent=stft_cfg.hop_percent, center=stft_cfg.center,
            pad_mode=stft_cfg.pad_mode, pad_at_end=stft_cfg.pad_at_end,
            vad_threshold=label_cfg.vad_threshold,
        )
    if label_cfg.kind == "ibm_labels":
        sxx = stft(x, fs=fs, wlen_sec=stft_cfg.wlen_sec, win=stft_cfg.win,
                   hop_percent=stft_cfg.hop_percent, center=stft_cfg.center,
                   pad_mode=stft_cfg.pad_mode, pad_at_end=stft_cfg.pad_at_end)
        return clean_speech_IBM(sxx, eps=label_cfg.eps,
                                ibm_threshold=label_cfg.ibm_threshold)
    raise ValueError(f"unknown label kind: {label_cfg.kind}")


@dataclass
class BuildConfig:
    raw_dir: str
    processed_dir: str
    dataset_size: str = "subset"
    stft: STFTConfig = field(default_factory=STFTConfig)
    label: LabelConfig = field(default_factory=LabelConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    upsampled_suffix: bool = False  # name labels *_<labels>_upsampled.h5
    max_workers: int | None = None


# --- per-utterance workers (module-level for ProcessPoolExecutor pickling) --


def build_video_utterance(args):
    """Decode+upsample one .mat, build its label from clean speech, write
    X/Y h5 pair; returns (n, sum, sum_sq) video stats for train split."""
    cfg, mat_rel, clean_rel, out_clean_rel, is_train = args

    video = decode_and_upsample(
        os.path.join(cfg.raw_dir, mat_rel),
        width=cfg.video.width, height=cfg.video.height,
        rate_in=cfg.video.frame_rate_in, rate_out=cfg.video.frame_rate_out,
    )  # (h, w, T)

    x, fs = read_wav(os.path.join(cfg.raw_dir, clean_rel))
    if fs != cfg.stft.fs:
        raise ValueError(f"{clean_rel}: fs {fs} != {cfg.stft.fs}")
    x = peak_normalize(x)
    label = make_label(x, fs, cfg.stft, cfg.label)  # (y, T)

    t = min(video.shape[-1], label.shape[-1])
    video, label = video[..., :t], label[..., :t]

    video_out = os.path.join(cfg.processed_dir,
                             os.path.splitext(mat_rel)[0] + "_upsampled.h5")
    _write_h5(video_out, "X", video)

    # The video builder always writes the PLAIN label name (the reference's
    # create_video_train_files_upsampled.py:272 does too); the audio builder
    # adds the `_upsampled` variant when configured. Both files coexist in a
    # fully built tree, serving the video-only and AV pairings respectively.
    label_out = os.path.join(cfg.processed_dir,
                             os.path.splitext(out_clean_rel)[0]
                             + f"_{cfg.label.kind}.h5")
    _write_h5(label_out, "Y", label)

    if is_train:
        return float(video.size), float(video.sum()), float((video ** 2).sum())
    return None


def build_audio_utterance(args):
    """Copy one clean wav into processed/, (re)write its label h5."""
    cfg, clean_rel, out_clean_rel = args
    dst = os.path.join(cfg.processed_dir, out_clean_rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    copyfile(os.path.join(cfg.raw_dir, clean_rel), dst)

    x, fs = read_wav(os.path.join(cfg.raw_dir, clean_rel))
    x = peak_normalize(x)
    label = make_label(x, fs, cfg.stft, cfg.label)
    suffix = f"_{cfg.label.kind}_upsampled.h5" if cfg.upsampled_suffix \
        else f"_{cfg.label.kind}.h5"
    _write_h5(os.path.join(cfg.processed_dir,
                           os.path.splitext(out_clean_rel)[0] + suffix),
              "Y", label)


def build_noisy_utterance(args):
    """Copy one noisy wav into processed/; return its log-power-spec stats
    partial (train split only)."""
    cfg, noisy_rel, out_noisy_rel, is_train = args
    dst = os.path.join(cfg.processed_dir, out_noisy_rel)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    copyfile(os.path.join(cfg.raw_dir, noisy_rel), dst)

    if not is_train:
        return None
    x, fs = read_wav(os.path.join(cfg.raw_dir, noisy_rel))
    x = peak_normalize(x)
    spec = log_power_spectrogram(
        stft(x, fs=fs, wlen_sec=cfg.stft.wlen_sec, win=cfg.stft.win,
             hop_percent=cfg.stft.hop_percent, center=cfg.stft.center,
             pad_mode=cfg.stft.pad_mode, pad_at_end=cfg.stft.pad_at_end),
        eps=cfg.stft.eps,
    )  # (513, T)
    return (float(spec.shape[-1]), spec.sum(axis=-1), (spec ** 2).sum(axis=-1))


_POOL: ProcessPoolExecutor | None = None


def _spawn_pool(max_workers) -> ProcessPoolExecutor:
    # spawned, not forked: the caller may hold CUDA state and threads
    return ProcessPoolExecutor(max_workers=max_workers,
                               mp_context=multiprocessing.get_context("spawn"))


@contextlib.contextmanager
def worker_pool(max_workers):
    """One pool of spawned workers for every split built inside the block
    (a spawned worker imports torch and the package, seconds each, which a
    pool a split would pay again for each of its three maps)."""
    global _POOL
    if max_workers == 0 or _POOL is not None:
        yield
        return
    with _spawn_pool(max_workers) as pool:
        _POOL = pool
        try:
            yield
        finally:
            _POOL = None


def _run_pool(fn, args_list, max_workers):
    if max_workers == 0:  # serial (tests / small builds)
        return [fn(a) for a in args_list]
    if _POOL is not None:
        return list(_POOL.map(fn, args_list))
    with _spawn_pool(max_workers) as pool:
        return list(pool.map(fn, args_list))


def build_video_split(cfg: BuildConfig, dataset_type: str) -> int:
    """Build all video/label pairs of a split; writes video statistics for
    the train split. Returns number of utterances processed."""
    mats = catalog.video_list(cfg.raw_dir, dataset_type)
    clean_in, clean_out = catalog.speech_list(cfg.raw_dir, dataset_type)
    is_train = dataset_type == "train"
    args = [(cfg, m, ci, co, is_train)
            for m, ci, co in zip(mats, clean_in, clean_out)]
    results = _run_pool(build_video_utterance, args, cfg.max_workers)

    if is_train:
        partials = [r for r in results if r is not None]
        if partials:
            mean, std = welford_merge(partials)
            save_statistics(
                os.path.join(cfg.processed_dir,
                             "ntcd_timit/matlab_raw/ntcd_timit_upsampled_statistics.h5"),
                mean, std,
            )
    return len(args)


def build_frame_store(cfg: BuildConfig, dataset_type: str,
                      out_path: str) -> int:
    """Pack a split's noisy log-power frames + labels into one h5 frame
    store (`X_<split>` (513, N), `Y_<split>` (y_dim, N)) — the storage
    scheme consumed by the legacy framewise/windowed sources
    (data/sources.py FrameStore family). Returns total frames packed."""
    pairs = catalog.proc_noisy_clean_pair_dict(
        cfg.processed_dir, dataset_type, cfg.dataset_size, cfg.label.kind,
        upsampled=cfg.upsampled_suffix)
    xs, ys = [], []
    for noisy_rel, label_rel in pairs.items():
        x, fs = read_wav(os.path.join(cfg.processed_dir, noisy_rel))
        spec = log_power_spectrogram(
            stft(peak_normalize(x), fs=fs, wlen_sec=cfg.stft.wlen_sec,
                 win=cfg.stft.win, hop_percent=cfg.stft.hop_percent,
                 center=cfg.stft.center, pad_mode=cfg.stft.pad_mode,
                 pad_at_end=cfg.stft.pad_at_end),
            eps=cfg.stft.eps)
        with hdf5.File(os.path.join(cfg.processed_dir, label_rel), "r") as f:
            label = f["Y"][:]
        t = min(spec.shape[-1], label.shape[-1])
        xs.append(spec[:, :t])
        ys.append(label[:, :t])
    x_all = np.concatenate(xs, axis=-1) if xs else np.zeros((513, 0), np.float32)
    y_all = np.concatenate(ys, axis=-1) if ys else np.zeros((1, 0), np.float32)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with hdf5.File(out_path, "w") as f:
        f.create_dataset(f"X_{dataset_type}", data=x_all)
        f.create_dataset(f"Y_{dataset_type}", data=y_all)
    return int(x_all.shape[-1])


def build_audio_split(cfg: BuildConfig, dataset_type: str) -> int:
    """Copy clean+noisy wavs into processed/, write labels, accumulate the
    noisy log-power-spec statistics on the train split."""
    clean_in, clean_out = catalog.speech_list(cfg.raw_dir, dataset_type)
    _run_pool(build_audio_utterance,
              [(cfg, ci, co) for ci, co in zip(clean_in, clean_out)],
              cfg.max_workers)

    noisy_pairs = catalog.noisy_speech_dict(cfg.raw_dir, dataset_type,
                                            cfg.dataset_size)
    is_train = dataset_type == "train"
    results = _run_pool(
        build_noisy_utterance,
        [(cfg, src, dst, is_train) for src, dst in noisy_pairs.items()],
        cfg.max_workers,
    )

    if is_train:
        partials = [r for r in results if r is not None]
        if partials:
            mean, std = welford_merge(partials)
            # the reference's live config reads the *_upsampled statistics
            # name (train_AV_net.py:121)
            save_statistics(
                os.path.join(cfg.processed_dir, "ntcd_timit/Noisy",
                             "ntcd_timit_log_power_spec_upsampled_statistics.h5"),
                mean, std,
            )
    return len(clean_in) + len(noisy_pairs)
