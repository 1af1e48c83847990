"""Utterance sources — the capability set of the reference's eight torch
Dataset classes (the reference's packages/data_handling.py:19-497), as plain
indexable numpy sources.

Whole-utterance sources (the live training paths):
  AudioSequenceSource          <- NoisyWavWholeSequenceSpectrogramLabeledFrames (:231)
  AudioWaveformSource          <- NoisyWavWholeSequenceWavLabeledFrames (:326)
  VideoSequenceSource          <- WavWholeSequenceSpectrogramLabeledFrames (:192)
  AudioVisualSource            <- AudioVisualSequenceLabeledFrames (:387)
  AudioVisualWaveformSource    <- AudioVisualSequenceWavLabeledFrames (:497)

Legacy fixed-window sources over packed h5 frame stores:
  SpectrogramFrameSource       <- HDF5SpectrogramLabeledFrames (:51)
  SpectrogramWindowSource      <- HDF5SequenceSpectrogramLabeledFrames (:82)
  SpectrogramChunkSource       <- HDF5WholeSequenceSpectrogramLabeledFrames (:140)
  VideoClipSource              <- VideoFrames (:19)

Each item is a dict of time-major numpy arrays plus metadata; batching
lives in `avvad_tpu_torch.data.batching`.

A copy of avvad_tpu/data/sources.py; HDF5 is read by the port's own
``hdf5``. The two waveform sources are data only:
the port does not have the model they feed (``RawAudioVAD``) yet.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
import numpy as np

from .. import hdf5
from ..config import STFTConfig
from ..datasets import ntcd_timit as catalog
from ..processing.video import decode_dct_frames, read_mat_dct
from .records import (
    load_audio_logspec,
    load_label,
    load_video,
    load_waveform,
    truncate_common,
    video_path_for_label,
)


def parse_utt_metadata(noisy_rel_path: str) -> dict:
    """noise type / SNR / speaker / utt id from a processed-noisy path,
    e.g. 'ntcd_timit/Noisy/Babble/-5/test/34M/sa1.wav'
    (mirrors run_metrics_dnn_classif.py:107-109)."""
    parts = noisy_rel_path.replace(os.sep, "/").split("/")
    return {
        "noise_type": parts[-5],
        "snr_db": parts[-4],
        "split": parts[-3],
        "speaker": parts[-2],
        "utt_id": os.path.splitext(parts[-1])[0],
    }


@dataclass
class _PairSource:
    """Base: resolves (processed-noisy wav, label h5) pairs for a split."""

    root: str
    dataset_type: str = "train"
    dataset_size: str = "subset"
    labels: str = "vad_labels"
    upsampled: bool = True
    stft_cfg: STFTConfig = field(default_factory=STFTConfig)
    video_variant: str = "auto"  # see records.video_path_for_label

    def __post_init__(self):
        pairs = catalog.proc_noisy_clean_pair_dict(
            input_speech_dir=self.root,
            dataset_type=self.dataset_type,
            dataset_size=self.dataset_size,
            labels=self.labels,
            upsampled=self.upsampled,
        )
        self.pairs = list(pairs.items())

    def __len__(self):
        return len(self.pairs)

    def rel_path(self, i: int) -> str:
        """Catalog-relative path identifying utterance i (for writers)."""
        return self.pairs[i][0]

    def label_rel_path(self, i: int) -> str:
        return self.pairs[i][1]

    def probe_length(self, i: int) -> int:
        """Approximate frame count of utterance i from the WAV header only —
        no sample data or feature computation. Used for length-sorted batch
        packing, where the (rare) off-by-few from label/video truncation
        only affects packing efficiency, never correctness (pad_batch uses
        the true per-item lengths)."""
        import wave

        from ..processing.stft import n_stft_frames

        with wave.open(self.root + self.pairs[i][0], "rb") as w:
            n = w.getnframes()
            fs = w.getframerate()
        return n_stft_frames(
            n, fs=fs, wlen_sec=self.stft_cfg.wlen_sec,
            hop_percent=self.stft_cfg.hop_percent,
            center=self.stft_cfg.center, pad_at_end=self.stft_cfg.pad_at_end,
        )

    def metadata(self, i: int) -> dict:
        return parse_utt_metadata(self.pairs[i][0])


class AudioSequenceSource(_PairSource):
    """noisy wav -> {audio (T,513), label (T,y), length}."""

    def __getitem__(self, i: int) -> dict:
        noisy_rel, label_rel = self.pairs[i]
        audio = load_audio_logspec(self.root + noisy_rel, self.stft_cfg)
        label = load_label(self.root + label_rel)
        audio, label = truncate_common(audio, label)
        return {"audio": audio, "label": label, "length": audio.shape[0],
                **self.metadata(i)}


class AudioWaveformSource(_PairSource):
    """noisy wav -> {waveform (n,), label (T,y), length, time_length}.

    Raw-waveform variant feeding the WaveNet frontend."""

    def __getitem__(self, i: int) -> dict:
        noisy_rel, label_rel = self.pairs[i]
        wav = load_waveform(self.root + noisy_rel)
        label = load_label(self.root + label_rel)
        return {"waveform": wav, "label": label, "length": label.shape[0],
                "time_length": wav.shape[0], **self.metadata(i)}


class AudioVisualSource(_PairSource):
    """noisy wav + video h5 -> {audio (T,513), video (T,67,67), label (T,y), length}."""

    def __getitem__(self, i: int) -> dict:
        noisy_rel, label_rel = self.pairs[i]
        audio = load_audio_logspec(self.root + noisy_rel, self.stft_cfg)
        video = load_video(self.root + video_path_for_label(
            label_rel, self.labels, self.upsampled, self.video_variant))
        label = load_label(self.root + label_rel)
        audio, video, label = truncate_common(audio, video, label)
        return {"audio": audio, "video": video, "label": label,
                "length": audio.shape[0], **self.metadata(i)}


class AudioVisualWaveformSource(_PairSource):
    """Raw waveform + video: {waveform, video, label, length, time_length}."""

    def __getitem__(self, i: int) -> dict:
        noisy_rel, label_rel = self.pairs[i]
        wav = load_waveform(self.root + noisy_rel)
        video = load_video(self.root + video_path_for_label(
            label_rel, self.labels, self.upsampled, self.video_variant))
        label = load_label(self.root + label_rel)
        video, label = truncate_common(video, label)
        return {"waveform": wav, "video": video, "label": label,
                "length": label.shape[0], "time_length": wav.shape[0],
                **self.metadata(i)}


@dataclass
class VideoSequenceSource:
    """Processed video h5 + label h5 -> {video (T,67,67), label (T,y), length}.

    Pure file reads, no DSP (the video-only training path)."""

    root: str
    dataset_type: str = "train"
    labels: str = "vad_labels"
    upsampled: bool = True
    dct: bool = False
    norm_video: bool = False

    def __post_init__(self):
        self.video_paths, self.label_paths = catalog.proc_video_audio_pair_dict(
            input_video_dir=self.root,
            dataset_type=self.dataset_type,
            labels=self.labels,
            upsampled=self.upsampled,
            dct=self.dct,
            norm_video=self.norm_video,
        )
        if len(self.video_paths) != len(self.label_paths):
            raise ValueError(
                f"video/label catalog mismatch under {self.root} "
                f"({self.dataset_type}): {len(self.video_paths)} videos vs "
                f"{len(self.label_paths)} '{self.labels}' label files — the "
                f"processed tree is incomplete (run scripts/create_train_files.py)"
            )

    def __len__(self):
        return len(self.video_paths)

    def rel_path(self, i: int) -> str:
        return self.video_paths[i]

    def label_rel_path(self, i: int) -> str:
        return self.label_paths[i]

    def probe_length(self, i: int) -> int:
        """Frame count from h5 metadata only (no data read)."""
        with hdf5.File(self.root + self.video_paths[i], "r") as f:
            return int(f["X"].shape[-1])

    def __getitem__(self, i: int) -> dict:
        video = load_video(self.root + self.video_paths[i])
        label = load_label(self.root + self.label_paths[i])
        video, label = truncate_common(video, label)
        return {"video": video, "label": label, "length": video.shape[0]}


class FrameStore:
    """Packed h5 frame store with `X_<split>` / `Y_<split>` feature-major
    datasets — the storage scheme of the legacy framewise datasets."""

    def __init__(self, path: str, dataset_type: str):
        self.path = path
        self.dataset_type = dataset_type
        self._f = None  # an open hdf5.File, once _handles() has run
        with hdf5.File(path, "r") as f:
            self.n_frames = f["X_" + dataset_type].shape[-1]

    def _handles(self):
        if self._f is None:
            self._f = hdf5.File(self.path, "r")
        return self._f["X_" + self.dataset_type], self._f["Y_" + self.dataset_type]

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class SpectrogramFrameSource(FrameStore):
    """Single frames: {audio (513,), label (y,)}."""

    def __len__(self):
        return self.n_frames

    def __getitem__(self, i: int) -> dict:
        x, y = self._handles()
        return {"audio": x[:, i], "label": y[:, i]}


class SpectrogramWindowSource(FrameStore):
    """Trailing window ending at frame i (shorter near the start):
    {audio (t,513), label (1,y), length}."""

    def __init__(self, path: str, dataset_type: str, seq_length: int):
        super().__init__(path, dataset_type)
        self.seq_length = seq_length

    def __len__(self):
        return self.n_frames

    def __getitem__(self, i: int) -> dict:
        x, y = self._handles()
        start = max(0, i + 1 - self.seq_length)
        audio = np.asarray(x[..., start : i + 1]).T
        label = np.asarray(y[..., i : i + 1]).T
        return {"audio": audio, "label": label, "length": audio.shape[0]}


class SpectrogramChunkSource(FrameStore):
    """Disjoint chunks of seq_length frames: {audio (t,513), label (t,y), length}."""

    def __init__(self, path: str, dataset_type: str, seq_length: int):
        super().__init__(path, dataset_type)
        self.seq_length = seq_length

    def __len__(self):
        return math.ceil(self.n_frames / self.seq_length)

    def __getitem__(self, i: int) -> dict:
        x, y = self._handles()
        s = i * self.seq_length
        audio = np.asarray(x[..., s : s + self.seq_length]).T
        label = np.asarray(y[..., s : s + self.seq_length]).T
        return {"audio": audio, "label": label, "length": audio.shape[0]}


@dataclass
class VideoClipSource:
    """Random fixed-length clip from each raw .mat video with the label at
    the clip's end frame: {video (seq_length,67,67), label}.

    The decode here normalizes by the global max only (the legacy variant
    at data_handling.py:38); seeding is explicit for reproducibility.
    """

    mat_dir: str
    items: list
    label_dir: str
    seq_length: int
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> dict:
        coeffs = read_mat_dct(os.path.join(self.mat_dir, self.items[i]) + ".mat")
        frames = decode_dct_frames(coeffs, norm="frame")
        start = int(self.rng.integers(0, frames.shape[0] - self.seq_length))
        clip = frames[start : start + self.seq_length]
        labels = np.load(os.path.join(self.label_dir, self.items[i]) + ".npy")
        return {"video": clip, "label": labels[start + self.seq_length]}
