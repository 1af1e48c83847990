"""Checkpoints: model, optimizer state, step and normalisation statistics
(port of avvad_tpu/train/checkpoint.py, with ``torch.save`` in place of
Orbax).

A checkpoint is a directory named ``epoch_{:03d}_vloss_{:.2f}`` (the
reference's naming) holding one ``state.pt``; it is written into a
``.tmp`` sibling and renamed, so a crashed save leaves only a ``.tmp``
directory, which ``prune_checkpoints`` sweeps (with the
``.orbax-checkpoint-tmp`` leftovers of a crashed Orbax save). Model
directories resolve to their best-vloss (ties: the later epoch) or latest
checkpoint.

Every reader here also takes the JAX package's Orbax checkpoints (a
directory with ``_CHECKPOINT_METADATA`` or ``manifest.ocdbt``), read by
``orbax_io`` without Orbax: the Flax variables become the model's state
dict (``convert.from_flax_variables``), optax's Adam state the
optimizer's (``convert.adam_from_optax``), so a model trained by the JAX
package resumes, evaluates and serves here. ``export_jax_checkpoint``
writes the other way: an Orbax checkpoint that the JAX package's
``restore_checkpoint`` restores.

Under a mesh (``mesh=``, one rank a mesh position) a checkpoint is the
full, unsharded state: every rank gathers the column-sharded weights and
their Adam moments, rank 0 writes, and all wait at a barrier; on restore
every rank reads the full state and keeps its own shards, as the JAX
package's process 0 writes and every host restores. A meshed checkpoint
restores into an unmeshed state and the other way round.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import convert, orbax_io
from ..parallel.mesh import (full_optimizer_state, full_state_dict,
                             load_full_optimizer_state, load_full_state_dict,
                             unsharded_name)

STATE_FILE = "state.pt"
TRUNK_PREFIX = "tower.features."
_CKPT_RE = re.compile(r"epoch_(\d+)_vloss_([-\d.]+)$")


def checkpoint_name(epoch: int, valid_loss: float) -> str:
    return f"epoch_{epoch:03d}_vloss_{valid_loss:.2f}"


def _barrier(mesh) -> None:
    if mesh is not None and dist.is_initialized():
        dist.barrier()


def save_checkpoint(model_dir: str, state, norm_stats: Optional[dict] = None,
                    epoch: int = 0, valid_loss: float = 0.0, mesh=None) -> str:
    """Save a full training checkpoint -> its directory's path. ``mesh``:
    collective; rank 0 writes the gathered state (module docstring)."""
    path = os.path.abspath(os.path.join(model_dir, checkpoint_name(epoch, valid_loss)))
    full = _full_state(state, mesh)
    if full is None:
        return path
    model_sd, opt_sd = full
    payload = {"model": model_sd, "optimizer": opt_sd, "step": state.step,
               "norm_stats": {k: torch.as_tensor(np.asarray(v))
                              for k, v in (norm_stats or {}).items() if v is not None}}
    _write(path, payload)
    _barrier(mesh)
    return path


def _full_state(state, mesh):
    """-> (model state dict, optimizer state dict), unsharded; under a mesh
    gathered (collective), and None on every rank but 0, which has waited
    at the barrier that closes the save."""
    if mesh is None:
        return state.model.state_dict(), state.optimizer.state_dict()
    model_sd = full_state_dict(state.model)
    opt_sd = full_optimizer_state(state.optimizer, mesh.group("model"))
    if mesh.rank != 0:
        _barrier(mesh)
        return None
    return model_sd, opt_sd


def _param_groups(state, model_sd: dict) -> list:
    """The optimizer's parameters, group by group, as (state_dict key of
    the unsharded model, full shape)."""
    names = {id(p): unsharded_name(n) for n, p in state.model.named_parameters()}
    return [[(names[id(p)], tuple(model_sd[names[id(p)]].shape)) for p in g["params"]]
            for g in state.optimizer.param_groups]


def _tensors(tree):
    """numpy leaves -> torch tensors (which Orbax restores as jax.Array)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def export_jax_checkpoint(model_dir: str, state, norm_stats: Optional[dict] = None,
                          epoch: int = 0, valid_loss: float = 0.0, mesh=None) -> str:
    """Write ``state`` as the JAX package's ``save_checkpoint`` would: an
    Orbax checkpoint ``epoch_NNN_vloss_X.XX`` in ``model_dir`` holding
    ``params``, ``opt_state`` (optax's Adam, inside ``multi_transform``
    when the video trunk is frozen), ``step`` and, where the model has
    them, ``batch_stats``, ``sketch`` and ``quant``, and ``norm_stats`` ->
    its path. ``mesh``: collective, rank 0 writes (as ``save_checkpoint``)."""
    path = os.path.abspath(os.path.join(model_dir, checkpoint_name(epoch, valid_loss)))
    full = _full_state(state, mesh)
    if full is None:
        return path
    model_sd, opt_sd = full
    params = {unsharded_name(n) for n, _ in state.model.named_parameters()}
    variables = convert.to_flax_variables(model_sd, params)
    every = [(k, tuple(v.shape)) for k, v in model_sd.items() if k in params]
    payload = _tensors({
        **variables,
        "opt_state": convert.adam_to_optax(opt_sd, _param_groups(state, model_sd),
                                           every, model_sd),
        "step": np.asarray(state.step, np.int32)})
    if norm_stats:
        payload["norm_stats"] = {k: np.asarray(v) for k, v in norm_stats.items()
                                 if v is not None}
    orbax_io.write_checkpoint(path, payload)
    _barrier(mesh)
    return path


def _write(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _entries(model_dir: str) -> list:
    """-> [(epoch, vloss, name)] of the checkpoints in model_dir."""
    if not os.path.isdir(model_dir):
        return []
    return [(int(m.group(1)), float(m.group(2)), name)
            for name in os.listdir(model_dir) if (m := _CKPT_RE.match(name))]


def latest_checkpoint(model_dir: str) -> Optional[str]:
    """The checkpoint with the highest epoch number, or None."""
    entries = _entries(model_dir)
    return os.path.join(model_dir, max(entries)[2]) if entries else None


def best_checkpoint(model_dir: str) -> Optional[str]:
    """The checkpoint with the lowest validation loss (ties: the later
    epoch), or None."""
    entries = _entries(model_dir)
    if not entries:
        return None
    return os.path.join(model_dir, min(entries, key=lambda e: (e[1], -e[0]))[2])


def resolve_checkpoint(path: str, prefer: str = "best") -> str:
    """A checkpoint directory as given, or a model directory resolved to its
    best-vloss (or latest) checkpoint; unresolvable paths come back as
    given."""
    if _CKPT_RE.match(os.path.basename(os.path.normpath(path))):
        return path
    resolved = best_checkpoint(path) if prefer == "best" else latest_checkpoint(path)
    return path if resolved is None else resolved


def prune_checkpoints(model_dir: str, keep_latest: int = 1) -> int:
    """Delete every checkpoint but the best-vloss one and the
    ``keep_latest`` newest epochs, and every leftover of a crashed save
    (``.tmp``, and Orbax's ``.orbax-checkpoint-tmp``) -> the number
    removed."""
    if not os.path.isdir(model_dir):
        return 0
    removed = 0
    for name in os.listdir(model_dir):
        if name.endswith((".tmp", ".orbax-checkpoint-tmp")):
            shutil.rmtree(os.path.join(model_dir, name))
            removed += 1
    entries = _entries(model_dir)
    if len(entries) <= keep_latest + 1:
        return removed
    keep = {min(entries, key=lambda e: (e[1], -e[0]))[2]}
    entries.sort(reverse=True)
    keep.update(name for _, _, name in entries[:keep_latest])
    for _, _, name in entries:
        if name not in keep:
            shutil.rmtree(os.path.join(model_dir, name))
            removed += 1
    return removed


# the static-int8 tower's activation scales (models/resnet.py)
QUANT_BUFFERS = ("q_stem", "q1", "q_out")


def _load(path: str, device) -> tuple:
    """A checkpoint (``state.pt``, or a JAX Orbax directory), or a model
    directory's best-vloss one -> (payload, its path). The payload: the
    model's state dict, the optimizer's (a ``state.pt``) or optax's
    ``opt_state`` tree (an Orbax checkpoint), the step and the norm
    statistics."""
    path = resolve_checkpoint(path)
    if orbax_io.is_orbax_checkpoint(path):
        tree = orbax_io.read_checkpoint(path)
        model = {k: v.to(device) for k, v in convert.from_flax_variables(tree).items()}
        return {"model": model, "opt_state": tree.get("opt_state"),
                "step": int(np.asarray(tree.get("step", 0))),
                "norm_stats": {k: torch.as_tensor(np.asarray(v))
                               for k, v in (tree.get("norm_stats") or {}).items()}}, path
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint at {path!r} (expected an "
                                "epoch_* dir or a model dir containing one)")
    return torch.load(file, map_location=device, weights_only=True), path


def restore_checkpoint(path: str, state, with_opt: bool = True, mesh=None):
    """Restore model (parameters and buffers), optimizer state and step into
    ``state`` in place. ``path``: a checkpoint (the port's or the JAX
    package's), or a model directory (its best-vloss checkpoint) ->
    (state, norm_stats (numpy) or None, epoch).
    A model with sharded weights keeps its columns of each (``mesh``: the
    ranks first wait for each other, so that rank 0's write is done)."""
    _barrier(mesh)
    payload, path = _load(path, state.device)
    load_full_state_dict(state.model, payload["model"])
    if with_opt:
        opt_sd = payload.get("optimizer")
        if opt_sd is None:  # an Orbax checkpoint: optax's Adam state
            opt_sd = convert.adam_from_optax(
                payload["opt_state"], _param_groups(state, payload["model"]),
                payload["model"], state.optimizer.state_dict())
        load_full_optimizer_state(state.optimizer, opt_sd)
    state.step = int(payload["step"])
    norm_stats = {k: v.cpu().numpy() for k, v in payload["norm_stats"].items()} or None
    m = _CKPT_RE.match(os.path.basename(os.path.normpath(path)))
    return state, norm_stats, int(m.group(1)) if m else 0


def restore_model(path: str, model):
    """Restore only the weights of a checkpoint (parameters and buffers, no
    optimizer) into ``model`` in place -> (norm_stats (numpy) or None,
    epoch). The int8 tower's activation scales may be absent from the
    checkpoint (a float checkpoint into a ``tower_int8`` model: a
    calibration sets them), as JAX's ``with_opt=False`` restore leaves the
    ``quant`` collection alone; any other missing or unexpected entry
    raises."""
    payload, path = _load(path, next(model.parameters()).device)
    missing, unexpected = model.load_state_dict(payload["model"], strict=False)
    missing = [k for k in missing if k.rsplit(".", 1)[-1] not in QUANT_BUFFERS]
    if missing or unexpected:
        raise KeyError(f"{path}: the checkpoint does not fit the model: missing "
                       f"{missing[:5]}, unexpected {unexpected[:5]}")
    norm_stats = {k: v.cpu().numpy() for k, v in payload["norm_stats"].items()} or None
    m = _CKPT_RE.match(os.path.basename(os.path.normpath(path)))
    return norm_stats, int(m.group(1)) if m else 0


def load_pretrained_trunk(path: str, model) -> None:
    """Graft the ResNet trunk (``tower.features.*``: parameters and BatchNorm
    statistics) of a ``VideoVAD`` checkpoint into ``model`` in place, the
    reference's transfer step (train_AV_net.py:176-187). The int8 tower's
    activation scales (``q_stem``, ``q1``, ``q_out``) are no part of the
    graft on either side, as JAX leaves its ``quant`` collection alone: a
    float trunk grafts into a ``tower_int8=True`` model, whose scales a
    calibration sets. ``path``: a checkpoint or a model directory (its
    best-vloss checkpoint)."""
    payload, path = _load(path, next(model.parameters()).device)

    def grafted(key: str) -> bool:
        return key.startswith(TRUNK_PREFIX) and key.rsplit(".", 1)[-1] not in QUANT_BUFFERS

    trunk = {k: v for k, v in payload["model"].items() if grafted(k)}
    want = {k for k in model.state_dict() if grafted(k)}
    if not want or set(trunk) != want:
        raise ValueError(f"{path}: the trunk's parameters and BatchNorm statistics do "
                         f"not match the model's ({len(trunk)} against {len(want)})")
    model.load_state_dict(trunk, strict=False)
