"""Helpers shared by the command-line entry points."""

from __future__ import annotations

import argparse
import os

import torch

from .._device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which raises where no card is "
                        "visible; cpu runs the plain PyTorch versions of the kernels)")


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def processed_root(data_root: str, dataset_size: str) -> str:
    return os.path.join(data_root, dataset_size, "processed/")


def build_model(modality: str, y_dim: int = 1, lstm_hidden: int = 1024,
                lstm_layers: int = 2, mcb: bool = True, dtype: str = "float32",
                **options):
    """The port's model for a modality ("audio", "raw-audio", "video",
    "av"), its LSTM on the hand-written kernels (the plain versions on the
    CPU). ``options``: the model's own keyword arguments."""
    from ..models import AVVAD, AudioVAD, RawAudioVAD, VideoVAD

    kw = dict(y_dim=y_dim, lstm_hidden_size=lstm_hidden, lstm_layers=lstm_layers,
              dtype=DTYPES[dtype], use_kernel_lstm=True)
    if modality == "raw-audio":
        return RawAudioVAD(**kw, **options)
    if modality == "audio":
        return AudioVAD(**kw, **options)
    if modality == "video":
        return VideoVAD(**kw, **options)
    return AVVAD(**kw, use_mcb=mcb, **options)


def restore(checkpoint: str, model, device: torch.device):
    """``model`` on ``device`` with the checkpoint's weights ->
    (norm_stats, epoch)."""
    from ..train import restore_model

    model.to(device)
    return restore_model(checkpoint, model)


def hoist_mcb(model, make):
    """``make(mcb_folded_vars=True)`` (an AVVAD that stores its MCB sketches
    pre-folded) carrying ``model``'s weights, on its device: the JAX
    scripts' ``--mcb-hoist``."""
    from ..models import fold_sketch_state_dict

    folded = make(mcb_folded_vars=True)
    folded.load_state_dict(fold_sketch_state_dict(model.state_dict()))
    return folded.to(next(model.parameters()).device)


def data_parallel_mesh(args):
    """The data-axis mesh of a ``--data-parallel`` launch (one process a
    mesh position: a card each, or the CPU under ``--device cpu``) and this
    rank's device; the process group on nccl for a card, gloo for the CPU."""
    from ..parallel import initialize_multihost, make_multihost_mesh
    from ..parallel.mesh import world

    device = device_of(args)
    if not initialize_multihost(backend="nccl" if device.type == "cuda" else "gloo"):
        raise SystemExit("--data-parallel runs one process a mesh position: launch "
                         "with torchrun or parallel.spawn, which set MASTER_ADDR, "
                         "WORLD_SIZE and RANK")
    size, rank = world()
    if args.data_parallel not in (-1, size):
        raise SystemExit(f"--data-parallel {args.data_parallel} but {size} ranks")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return make_multihost_mesh(n_model=1, device=device), device
