"""The data group of a data-parallel step, for the layers that reduce over
the batch.

The JAX mesh step is one logical program over the global batch: its
train-mode BatchNorms take their statistics, and the post-MCB L2 norm its
sum of squares, over every row of every device. A rank-local step of the
port equals it only if those reductions span the ranks of the ``data``
axis. ``data_parallel(group)`` sets that group for the duration of a step;
``resnet.batch_norm`` and ``mcb.global_l2_normalize`` read it through
``data_group()`` and add their partial sums with ``all_reduce_sum``. With
no group set (or a group of one rank) they compute as on one device.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None


@contextlib.contextmanager
def data_parallel(group: Optional[dist.ProcessGroup]):
    """Within: batch reductions span ``group`` (None: this process only)."""
    global _GROUP
    saved, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = saved


def data_group() -> Optional[dist.ProcessGroup]:
    """The group set by ``data_parallel``, or None where it has one rank."""
    if _GROUP is None or dist.get_world_size(_GROUP) == 1:
        return None
    return _GROUP


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks; differentiable (the
    gradient of each rank's input is the sum of every rank's output
    gradient)."""
    if torch.is_grad_enabled() and x.requires_grad:
        from torch.distributed.nn.functional import all_reduce
        return all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
