"""The port's ResNet-18 trunk out in the reference's (PyTorch) naming
(port of avvad_tpu/utils/torch_export.py).

The inverse of ``utils.torch_import`` for the trunk: the
``features.N.*`` ``nn.Sequential`` names that DeepVAD_{video,AV} use for
the torchvision ResNet-18 (the reference's packages/models/AV_Net.py:25-28
strips the FC layer and wraps the children, so conv1 is ``features.0``,
bn1 ``features.1`` and layer1..4 ``features.4..7``), with a zero
``num_batches_tracked`` beside each BatchNorm so that strict torch loads
succeed. The layouts are torch's on both sides.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

# the port's module name -> torchvision-after-Sequential index
SEQ_IDX = {"conv1": 0, "bn1": 1, "layer1": 4, "layer2": 5, "layer3": 6, "layer4": 7}
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
TRUNK_KEY = "tower.features."


def _np(v) -> np.ndarray:
    return np.array(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                    dtype=np.float32, copy=True)


def _bn(out: dict, theirs: str, s: Mapping, ours: str) -> None:
    for leaf in BN_LEAVES:
        out[f"{theirs}.{leaf}"] = _np(s[f"{ours}.{leaf}"])
    out[f"{theirs}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def export_resnet18_trunk(trunk_state: Mapping, prefix: str = "features.") -> dict:
    """The port's ``ResNet18`` state dict (``conv1.weight``, ``layer1_0.*``,
    ...) -> flat {f'{prefix}N....': numpy array} in the reference's
    Sequential naming."""
    s = trunk_state
    out = {f"{prefix}{SEQ_IDX['conv1']}.weight": _np(s["conv1.weight"])}
    _bn(out, f"{prefix}{SEQ_IDX['bn1']}", s, "bn1")
    for stage in range(1, 5):
        seq = SEQ_IDX[f"layer{stage}"]
        for block in range(2):
            ours, t = f"layer{stage}_{block}", f"{prefix}{seq}.{block}"
            out[f"{t}.conv1.weight"] = _np(s[f"{ours}.conv1.weight"])
            out[f"{t}.conv2.weight"] = _np(s[f"{ours}.conv2.weight"])
            _bn(out, f"{t}.bn1", s, f"{ours}.bn1")
            _bn(out, f"{t}.bn2", s, f"{ours}.bn2")
            if f"{ours}.downsample_conv.weight" in s:
                out[f"{t}.downsample.0.weight"] = _np(s[f"{ours}.downsample_conv.weight"])
                _bn(out, f"{t}.downsample.1", s, f"{ours}.downsample_bn")
    return out


def export_video_trunk_pt(checkpoint: str, out_path: str) -> int:
    """Write ``out_path`` (a torch state dict of ``features.*`` tensors) from
    the trunk of a port ``VideoVAD`` / ``AVVAD`` checkpoint (a checkpoint
    directory, or a model directory: its best-vloss checkpoint) -> the
    number of tensors written."""
    from ..train.checkpoint import STATE_FILE, resolve_checkpoint

    path = os.path.abspath(resolve_checkpoint(checkpoint))
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    trunk = {k[len(TRUNK_KEY):]: v for k, v in payload["model"].items()
             if k.startswith(TRUNK_KEY)}
    if not trunk:
        raise ValueError(f"{path}: the checkpoint holds no {TRUNK_KEY}* trunk")
    flat = export_resnet18_trunk(trunk)
    sd = {k: torch.from_numpy(v) if v.dtype != np.int64 else torch.tensor(int(v))
          for k, v in flat.items()}
    torch.save(sd, out_path)
    return len(sd)
