"""Typed configuration (a copy of avvad_tpu/config.py).

The knobs of the reference's scripts as frozen dataclasses with a YAML
round trip; the reference's canonical hyperparameters are the defaults.
``yaml`` is imported inside the four functions that read or write YAML,
so that the package imports where PyYAML is not installed.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class STFTConfig:
    """STFT frontend parameters.

    Defaults match the reference training configuration
    (the reference's scripts/train_AV_net.py:37-44): 16 kHz, 64 ms Hann
    window (1024 samples -> 513 freq bins), hop 25% (256 samples = 62.5 fps),
    center=False, end-padding so STFT->iSTFT round-trips the signal length.
    """

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

    @staticmethod
    def video_rate_hop_percent(wlen_sec: float = 64e-3, video_fps: int = 30) -> float:
        """Hop that matches an STFT frame rate to `video_fps`.

        Mirrors the reference's commented-out recipe
        (the reference's scripts/create_video_train_files_upsampled.py:49):
        floor((1 / (wlen_sec * fps)) * 1e4) / 1e4  -> 0.5208 for 64 ms / 30 fps.
        """
        return math.floor((1 / (wlen_sec * video_fps)) * 1e4) / 1e4


@dataclass(frozen=True)
class VideoConfig:
    """Lip-video decode / upsampling parameters
    (the reference's scripts/create_video_train_files_upsampled.py:57-62)."""

    width: int = 67
    height: int = 67
    frame_rate_in: float = 30.0
    frame_rate_out: float = 62.5  # = 1 / (wlen_sec * hop_percent)


@dataclass(frozen=True)
class LabelConfig:
    """VAD / IBM label generation (the reference's packages/processing/target.py)."""

    kind: str = "vad_labels"  # or "ibm_labels"
    vad_threshold: float = 1.70
    ibm_threshold: float = 50.0
    eps: float = 1e-8

    @property
    def y_dim(self) -> int:
        return 1 if self.kind == "vad_labels" else 513


@dataclass(frozen=True)
class ModelConfig:
    """Model hyperparameters (the reference's scripts/train_AV_net.py:62-73)."""

    x_dim: int = 513
    y_dim: int = 1
    lstm_layers: int = 2
    lstm_hidden_size: int = 1024
    num_video_features: int = 512
    use_mcb: bool = True
    mcb_output_size: int = 1024
    dropout: float = 0.0
    eps: float = 1e-8
    dtype: str = "float32"  # compute dtype for the towers ("bfloat16" for speed)


@dataclass(frozen=True)
class TrainConfig:
    """Training loop parameters (the reference's scripts/train_AV_net.py:75-84)."""

    batch_size: int = 16
    learning_rate: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    start_epoch: int = 1
    end_epoch: int = 100
    log_interval: int = 1
    std_norm: bool = True
    seed: int = 0
    freeze_video_trunk: bool = True
    bucket_t: int = 128  # pad T up to a multiple of this (retrace-storm control)


@dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "ntcd_timit"
    dataset_size: str = "subset"  # or "complete"
    data_root: str = "data"
    labels: str = "vad_labels"
    upsampled: bool = True

    @property
    def processed_dir(self) -> str:
        import os

        return os.path.join(self.data_root, self.dataset_size, "processed/")

    @property
    def raw_dir(self) -> str:
        import os

        return os.path.join(self.data_root, self.dataset_size, "raw/")


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh axes for scale-out (replaces the reference's
    nn.DataParallel at the reference's scripts/train_AV_net.py:193)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all devices
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    stft: STFTConfig = field(default_factory=STFTConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    label: LabelConfig = field(default_factory=LabelConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def to_yaml(cfg: Config) -> str:
    import yaml

    return yaml.safe_dump(_asdict(cfg), sort_keys=False)


def save_yaml(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_yaml(cfg))


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str) and f.type in _SECTION_TYPES
        ):
            sub_cls = _SECTION_TYPES.get(f.type, f.type) if isinstance(f.type, str) else f.type
            kwargs[f.name] = _from_dict(sub_cls, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_SECTION_TYPES = {
    "STFTConfig": STFTConfig,
    "VideoConfig": VideoConfig,
    "LabelConfig": LabelConfig,
    "ModelConfig": ModelConfig,
    "TrainConfig": TrainConfig,
    "DataConfig": DataConfig,
    "MeshConfig": MeshConfig,
}


def from_yaml(text: str) -> Config:
    import yaml

    return _from_dict(Config, yaml.safe_load(text))


def load_yaml(path: str) -> Config:
    with open(path) as f:
        return from_yaml(f.read())
