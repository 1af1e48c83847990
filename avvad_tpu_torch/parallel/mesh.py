"""Device meshes, placements and the tensor-parallel weights (port of
avvad_tpu/parallel/mesh.py).

A ``Mesh`` is a (data, model) array of ``torch.device``. Devices may
repeat: ``["cpu"] * 8`` is the port's counterpart of JAX's eight virtual
CPU devices, and ``["cuda:0"] * 2`` puts two mesh positions on one card.
Two kinds of program use a mesh:

- **One process** (the multi-stream servers): the process holds every
  position, streams shard over the ``data`` axis, nothing is collective.
- **One rank a position** (training, ``evaluate_split``): a
  ``torch.distributed`` process group of exactly ``mesh.size`` ranks, rank
  r at position (r // n_model, r % n_model). A rank holds the rows of its
  data coordinate (``shard_batch``: ranks along ``model`` see the same
  rows), its gradients are added over the ``data`` group, and the wide LSTM
  weights (``param_sharding_rules``) keep only the rank's column shard,
  gathered whole over the ``model`` group before the LSTM runs
  (``shard_params``). The JAX mesh step is one logical program over the
  global batch; this one equals it because every reduction over the batch
  spans the data group (``parallel.sync``, ``train.steps``).

``Placement`` stands for JAX's ``NamedSharding``: a mesh and one axis name
(or None) per tensor dimension, () for replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from .._device import resolve_device

AXES = ("data", "model")
_TP_MIN_COLS = 2048  # only shard matrices at least this wide
_MOMENTS = ("exp_avg", "exp_avg_sq")  # Adam's, placed like their parameter


def world() -> tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A (data, model) array of devices; see the module docstring."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-d (data, model), got shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXES
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}
        self.size = devices.size
        self._groups: Optional[dict] = None
        self._device_mesh = None

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']})"

    def check_world(self) -> None:
        """Raise unless the process group has one rank a mesh position (no
        group counts as one rank)."""
        size = world()[0]
        if size != self.size:
            raise ValueError(
                f"mesh data {self.shape['data']} x model {self.shape['model']} has "
                f"{self.size} positions but the process group has {size} rank(s): "
                "a collective program runs one rank a position "
                "(parallel.initialize_multihost with world_size="
                f"{self.size})")

    @property
    def rank(self) -> int:
        return world()[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def local_device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.data_index, self.model_index]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """This rank's process group along ``axis`` (the ranks that differ
        only in that coordinate), or None without a process group. The
        first call creates every group of both axes, and is collective:
        every rank makes it, in the same order."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} (have {AXES})")
        self.check_world()
        if not dist.is_initialized():
            return None
        if self._groups is None:
            check_backend(dist.get_backend(), self.local_device)
            n_data, n_model = self.shape["data"], self.shape["model"]
            ranks = np.arange(self.size).reshape(n_data, n_model)
            groups = {"data": {}, "model": {}}
            for m in range(n_model):
                groups["data"][m] = dist.new_group([int(r) for r in ranks[:, m]])
            for d in range(n_data):
                groups["model"][d] = dist.new_group([int(r) for r in ranks[d]])
            self._groups = groups
        key = self.model_index if axis == "data" else self.data_index
        return self._groups[axis][key]

    def device_mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` over the process group
        (built at first call, collectively), with dimension names
        ("data", "model")."""
        self.check_world()
        if not dist.is_initialized():
            raise ValueError("a DeviceMesh needs a process group "
                             "(parallel.initialize_multihost)")
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            self._device_mesh = DeviceMesh(
                self.local_device.type,
                torch.arange(self.size).view(self.shape["data"], self.shape["model"]),
                mesh_dim_names=AXES)
        return self._device_mesh


def check_backend(backend: str, device: torch.device) -> None:
    """Raise unless ``backend`` carries the port's collectives (all_reduce,
    all_gather, broadcast) on tensors of ``device``: gloo on the CPU and on
    cards, NCCL on cards only."""
    if backend == "gloo" or (backend == "nccl" and device.type == "cuda"):
        return
    raise ValueError(f"backend {backend!r} cannot carry the collectives of a mesh "
                     f"on {device}: use gloo on the CPU (or for ranks sharing a "
                     "card) and nccl for one rank a card")


def make_mesh(n_data: int = -1, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (entries may repeat; default:
    every visible card, raising when there is none: a mesh on the CPU is
    asked for by name, e.g. ``["cpu"] * 8``)."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if n_data == -1:
        n_data = n // n_model
    if n_data * n_model != n or n_data < 1:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n_data, n_model))


@dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh: one axis name (or None) per
    dimension, () for replicated (JAX's ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple = ()


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def batch_sharding(mesh: Mesh) -> Placement:
    """Axis 0 (batch) over ``data``."""
    return Placement(mesh, ("data",))


def data_rows(batch_size: int, n_data: int, data_index: int) -> slice:
    """The rows of data coordinate ``data_index`` in a global batch split
    ``n_data`` ways; raises where it does not split evenly."""
    if batch_size % n_data:
        raise ValueError(f"batch size {batch_size} not divisible by the mesh data "
                         f"axis ({n_data})")
    per = batch_size // n_data
    return slice(data_index * per, (data_index + 1) * per)


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a global batch: its data coordinate's share."""
    return data_rows(batch_size, mesh.shape["data"], mesh.data_index)


def shard_batch(mesh: Mesh, batch):
    """A batch (a ``Batch``, an array or tensor, or a tuple / list / dict of
    them; None leaves pass) -> this rank's rows of each leaf."""
    def rows_of(a):
        return a[batch_rows(mesh, a.shape[0])]

    return _map_leaves(rows_of, batch)


def _map_leaves(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map_leaves(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


# --- parameter sharding -----------------------------------------------------


def param_sharding_rules(path, value) -> tuple:
    """The placement spec of one parameter: an LSTM's ``w_ih`` / ``w_hh``
    (2-d) at least ``_TP_MIN_COLS`` columns wide is sharded over its column
    (output) dimension on ``model``; everything else is replicated.
    ``path``: a dotted name or a tuple of names."""
    names = path.split(".") if isinstance(path, str) else [str(p) for p in path]
    leaf = names[-1] if names else ""
    if value.ndim == 2 and leaf in ("w_ih", "w_hh") and value.shape[-1] >= _TP_MIN_COLS:
        return (None, "model")
    return ()


def unsharded_name(name: str) -> str:
    """A parametrised parameter's name -> the unsharded model's name."""
    return name.replace(".parametrizations.", ".").removesuffix(".original")


def sharding_tree(mesh: Mesh, model: nn.Module) -> dict:
    """{parameter name: Placement} of ``shard_params``, by the unsharded
    model's names."""
    return {unsharded_name(n): Placement(mesh, param_sharding_rules(unsharded_name(n), _full(p)))
            for n, p in model.named_parameters()}


def opt_sharding_tree(mesh: Mesh, model: nn.Module) -> dict:
    """{parameter name: {moment: Placement}} of ``shard_opt_state``: Adam's
    moments are placed like their parameter, its step count replicated."""
    return {n: {**{m: pl for m in _MOMENTS}, "step": replicated(mesh)}
            for n, pl in sharding_tree(mesh, model).items()}


class _GatherColumns(torch.autograd.Function):
    """The column shards of the model group -> the whole weight; the
    gradient goes back to this rank's columns. Ranks along ``model`` run
    the same rows through the same weights, so each already holds the full
    gradient: no reduction."""

    @staticmethod
    def forward(ctx, shard, group, n, index):
        ctx.index, ctx.cols = index, shard.shape[1]
        parts = [torch.empty_like(shard) for _ in range(n)]
        dist.all_gather(parts, shard.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.cols
        return grad[:, lo:lo + ctx.cols].contiguous(), None, None, None


class ColumnShard(nn.Module):
    """The parametrisation of a column-sharded weight: it stores the rank's
    columns and reads as the whole weight."""

    def __init__(self, group: dist.ProcessGroup, n: int, index: int):
        super().__init__()
        self.group, self.n, self.index = group, n, index

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return _GatherColumns.apply(shard, self.group, self.n, self.index)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return column_slice(full, self.n, self.index)


def column_slice(full: torch.Tensor, n: int, index: int) -> torch.Tensor:
    cols = full.shape[-1] // n
    return full[..., index * cols:(index + 1) * cols].clone()


def _full(p: torch.Tensor) -> torch.Tensor:
    """A parameter's unsharded shape, as a meta tensor (for the rules)."""
    n = getattr(p, "tp_shards", 1)
    return torch.empty((*p.shape[:-1], p.shape[-1] * n), device="meta")


def shard_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Place ``model``'s parameters by ``param_sharding_rules``, in place:
    with a ``model`` axis of n > 1 each sharded weight keeps only this
    rank's 1/n of its columns (a ``ColumnShard`` parametrisation; the
    attribute still reads as the whole weight). Replicated parameters stay
    as they are (each rank holds a copy). Collective where something
    shards; a second call changes nothing. -> ``model``."""
    n = mesh.shape["model"]
    if n == 1:
        return model
    group = mesh.group("model")
    if group is None:
        raise ValueError("sharding weights over a model axis needs a process group "
                         "of one rank a mesh position")
    for name, p in list(model.named_parameters()):
        if not param_sharding_rules(name, p):
            continue
        if p.shape[-1] % n:
            raise ValueError(f"{name}: {p.shape[-1]} columns not divisible by the "
                             f"model axis ({n})")
        module_name, leaf = name.rsplit(".", 1)
        module = model.get_submodule(module_name)
        parametrize.register_parametrization(
            module, leaf, ColumnShard(group, n, mesh.model_index), unsafe=True)
        shard = module.parametrizations[leaf].original
        shard.requires_grad_(p.requires_grad)
        shard.tp_shards, shard.tp_index = n, mesh.model_index
        p.tp_shard = shard  # for shard_opt_state
    return model


def shard_opt_state(mesh: Mesh, optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Point ``optimizer`` at the shards ``shard_params`` made, in place, and
    place each parameter's Adam moments like it: this rank's columns of a
    sharded weight's moments, the rest as they are. -> ``optimizer``."""
    for group in optimizer.param_groups:
        for i, p in enumerate(group["params"]):
            shard = getattr(p, "tp_shard", None)
            if shard is None:
                continue
            group["params"][i] = shard
            st = optimizer.state.pop(p, None)
            if st:
                for k in _MOMENTS:
                    st[k] = column_slice(st[k], shard.tp_shards, shard.tp_index)
                optimizer.state[shard] = st
    return optimizer


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp_shards", 1) > 1


def gather_columns(shard: torch.Tensor, group: dist.ProcessGroup, n: int) -> torch.Tensor:
    """The whole tensor from the column shards of ``group`` (no autograd)."""
    with torch.no_grad():
        return _GatherColumns.apply(shard, group, n, 0)


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` under the unsharded model's names, each
    sharded weight gathered whole (collective over the model group)."""
    out = {}
    for k, v in model.state_dict().items():
        if ".parametrizations." not in k:
            out[k] = v
        elif k.endswith(".original"):
            module_name, leaf = unsharded_name(k).rsplit(".", 1)
            module = model.get_submodule(module_name)
            with torch.no_grad():
                out[unsharded_name(k)] = getattr(module, leaf).detach().clone()
    return out


def load_full_state_dict(model: nn.Module, state: dict) -> None:
    """Load an unsharded state dict into a (possibly) sharded model: each
    sharded weight takes this rank's columns. Strict on names."""
    local = {}
    for k in model.state_dict():
        full = unsharded_name(k)
        if full not in state:
            raise KeyError(f"missing key {full!r} in the state dict")
        local[k] = state[full]
        if k.endswith(".original"):
            module_name, leaf = full.rsplit(".", 1)
            shard = getattr(model.get_submodule(module_name).parametrizations, leaf).original
            local[k] = column_slice(state[full], shard.tp_shards, shard.tp_index)
    extra = set(state) - {unsharded_name(k) for k in local}
    if extra:
        raise KeyError(f"unexpected keys in the state dict: {sorted(extra)[:5]}")
    model.load_state_dict(local, strict=True)


def _sharded_params(optimizer) -> dict:
    """{index in the optimizer's state dict: parameter} of the shards."""
    idx, out = 0, {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if is_sharded(p):
                out[idx] = p
            idx += 1
    return out


def full_optimizer_state(optimizer, group: Optional[dist.ProcessGroup]) -> dict:
    """``optimizer.state_dict()`` with the moments of sharded weights
    gathered whole over the model ``group`` (collective)."""
    sd = optimizer.state_dict()
    for i, p in _sharded_params(optimizer).items():
        st = sd["state"].get(i)
        if st:
            sd["state"][i] = {**st, **{k: gather_columns(st[k], group, p.tp_shards)
                                       for k in _MOMENTS}}
    return sd


def load_full_optimizer_state(optimizer, sd: dict) -> None:
    """Load an unsharded optimizer state dict: the moments of sharded
    weights cut to this rank's columns."""
    sd = {"state": dict(sd["state"]), "param_groups": sd["param_groups"]}
    for i, p in _sharded_params(optimizer).items():
        st = sd["state"].get(i)
        if st:
            sd["state"][i] = {**st, **{k: column_slice(st[k], p.tp_shards, p.tp_index)
                                       for k in _MOMENTS}}
    optimizer.load_state_dict(sd)


def all_reduce_grads(params, group: Optional[dist.ProcessGroup]) -> None:
    """Add the gradients of ``params`` over ``group`` (SUM: the loss is a
    sum over sequences, so the global gradient is the sum of the ranks'),
    flattened into one collective a dtype and device."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets: dict = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    for bucket in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
