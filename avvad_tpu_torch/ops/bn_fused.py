"""Train-mode BatchNorm of the float ResNet trunk: the batch statistics, then
the normalisation with the block's shortcut and ReLU (at the stem also the
3x3/2 max pool) in one pass.

No TPU kernel stands behind these: the JAX package leaves BatchNorm to XLA,
which fuses it. On a CUDA tensor ``bn_stats`` and ``bn_apply`` launch the
kernels of ``csrc/batch_norm.cu`` or raise; on a CPU tensor they run
``bn_stats_plain`` and ``bn_apply_plain``. Those are made of the plain
BatchNorm's pieces, which ``models.resnet.batch_norm`` and the trunk's plain
route use too: ``moments``, ``multiplier`` (with the running-statistics
update), ``normalise`` and ``epilogue`` (the residual add, ReLU and max
pool). Each op is a custom op, ``avvad_tpu_torch::bn_stats`` (which updates the
running statistics in place) and ``avvad_tpu_torch::bn_apply``, with a fake
implementation for ``torch.export``. Neither has a backward: the trunk takes
them only where no gradient flows through the BatchNorm
(``models.resnet._takes_fused_bn``).

The statistics kernel sums in another order than PyTorch's reductions (fp32
within 16-byte groups and warps, double across them) and rounds the double
mean and E[x^2] - E[x]^2 to fp32 once; given the same statistics the
normalisation is bit for bit the plain version's separate fp32 operations.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils import profiling

STATS_KERNEL, APPLY_KERNEL = "bn_stats", "bn_apply"
# device types whose tensors the trunk hands to these ops
KERNEL_DEVICE_TYPES = ("cuda",)
MAX_C = 2048                # the kernels' per-channel vectors in shared memory


def _channel_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over channel axis 1 of x."""
    return v.view([1, -1] + [1] * (x.ndim - 2))


def moments(x: torch.Tensor, axes: list) -> tuple:
    """(batch mean, biased variance) over ``axes``, the variance flax's
    E[x^2] - E[x]^2 clamped at 0."""
    mean = x.mean(axes)
    return mean, torch.clamp(torch.mean(x * x, axes) - mean * mean, min=0.0)


def multiplier(mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
               momentum: float, update: bool) -> torch.Tensor:
    """mul = rsqrt(var + eps) * weight; first, if ``update``, the running
    statistics updated in place, ra = (1 - m) ra + m batch (outside
    autograd)."""
    if update:
        with torch.no_grad():
            running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
            running_var.copy_((1 - momentum) * running_var + momentum * var)
    return torch.rsqrt(var + eps) * weight


def normalise(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """(x - mean) * mul + bias per channel (axis 1) of x, flax's order."""
    return ((x - _channel_view(mean, x)) * _channel_view(mul, x)
            + _channel_view(bias, x))


def epilogue(y: torch.Tensor, shortcut: Optional[torch.Tensor], relu: bool,
             pool: bool) -> torch.Tensor:
    """y + ``shortcut``, then ReLU if ``relu``, then the trunk's 3x3/2 max
    pool (padding 1) if ``pool``."""
    if shortcut is not None:
        y = y + shortcut
    if relu:
        y = F.relu(y)
    return F.max_pool2d(y, 3, stride=2, padding=1) if pool else y


def bn_stats_plain(x: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
                   running_var: torch.Tensor, eps: float, momentum: float,
                   update: bool) -> torch.Tensor:
    """x (N, C, H, W) -> (3, C): the batch mean, the biased variance and
    mul (``moments``, ``multiplier``), the running statistics updated in
    place if ``update``."""
    mean, var = moments(x, [0, 2, 3])
    mul = multiplier(mean, var, weight, running_mean, running_var, eps, momentum, update)
    return torch.stack([mean, var, mul])


def bn_apply_plain(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                   shortcut: Optional[torch.Tensor] = None,
                   sc_mean: Optional[torch.Tensor] = None, sc_mul: Optional[torch.Tensor] = None,
                   sc_bias: Optional[torch.Tensor] = None, relu: bool = True,
                   pool: bool = False) -> torch.Tensor:
    """``normalise`` x (N, C, H, W), + ``shortcut`` (normalised first by its
    own ``sc_*`` vectors where they are given), then ReLU if ``relu``, then
    the 3x3/2 max pool if ``pool`` (``epilogue``)."""
    if shortcut is not None and sc_mean is not None:
        shortcut = normalise(shortcut, sc_mean, sc_mul, sc_bias)
    return epilogue(normalise(x, mean, mul, bias), shortcut, relu, pool)


def _check_x(x: torch.Tensor, name: str = "x") -> None:
    """x is what the kernels take: contiguous fp32 (N, C, H, W), not empty,
    C a multiple of 32 (the statistics kernel's eight warps take whole
    channels in 16-byte loads) up to MAX_C, on a 16-byte boundary."""
    if x.ndim != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 (N, C, H, W), got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    c = x.shape[1]
    if x.numel() == 0 or c % 32 or c > MAX_C:
        raise ValueError(f"{name}: the kernels take a non-empty tensor with C a multiple of "
                         f"32 up to {MAX_C}, got {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _check_vectors(x: torch.Tensor, **vectors: torch.Tensor) -> None:
    for name, v in vectors.items():
        if (v.device != x.device or v.dtype != torch.float32 or not v.is_contiguous()
                or tuple(v.shape) != (x.shape[1],)):
            raise ValueError(f"{name} must be contiguous float32 ({x.shape[1]},) on x's device")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _stats_launch(x, weight, running_mean, running_var, eps, momentum, update) -> torch.Tensor:
    from ._build import kernel_lib

    _check_x(x)
    _check_vectors(x, weight=weight, running_mean=running_mean, running_var=running_var)
    n, c, h, w = x.shape
    dev = x.device
    lib, ctas = kernel_lib(), ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.bn_stats_ctas(n, c, ctypes.byref(ctas))  # the C side sizes the grid
        if rc == 0:
            partials = torch.empty(2 * c * ctas.value, device=dev, dtype=torch.float64)
            stats = torch.empty(3, c, device=dev, dtype=torch.float32)
            rc = lib.bn_stats(x.data_ptr(), weight.data_ptr(), running_mean.data_ptr(),
                              running_var.data_ptr(), partials.data_ptr(), ctas.value,
                              stats.data_ptr(), n, c, h * w, eps, 1 - momentum, momentum,
                              int(update), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{STATS_KERNEL} launch failed: cudaError {rc}")
    profiling.count("launch." + STATS_KERNEL)  # by the CUDA wrapper only
    return stats


def _pooled_shape(x: torch.Tensor) -> tuple:
    n, c, h, w = x.shape
    return n, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1


def _apply_launch(x, mean, mul, bias, shortcut, sc_mean, sc_mul, sc_bias, relu,
                  pool) -> torch.Tensor:
    from ._build import kernel_lib

    _check_x(x)
    _check_vectors(x, mean=mean, mul=mul, bias=bias)
    given = sum(v is not None for v in (sc_mean, sc_mul, sc_bias))
    if (pool and shortcut is not None) or given not in (0, 3) or (given and shortcut is None):
        raise ValueError("the pool takes no shortcut; the shortcut's vectors come all three, "
                         "with a shortcut")
    res = 0
    if shortcut is not None:
        _check_x(shortcut, "shortcut")
        if shortcut.shape != x.shape or shortcut.device != x.device:
            raise ValueError(f"shortcut must match x, got {tuple(shortcut.shape)} on "
                             f"{shortcut.device}")
        res = 1
        if given:
            _check_vectors(x, sc_mean=sc_mean, sc_mul=sc_mul, sc_bias=sc_bias)
            res = 2
    out = x.new_empty(_pooled_shape(x)) if pool else torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    n, c, h, w = x.shape
    dev = x.device
    with torch.cuda.device(dev):
        rc = kernel_lib().bn_apply(x.data_ptr(), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
                                   ptr(shortcut), ptr(sc_mean), ptr(sc_mul), ptr(sc_bias),
                                   out.data_ptr(), n, c, h, w, res, int(relu), int(pool),
                                   _stream(dev))
    if rc != 0:
        raise RuntimeError(f"{APPLY_KERNEL} launch failed: cudaError {rc}")
    profiling.count("launch." + APPLY_KERNEL)  # by the CUDA wrapper only
    return out


@torch.library.custom_op("avvad_tpu_torch::bn_stats",
                         mutates_args=("running_mean", "running_var"), device_types="cpu")
def bn_stats(x: torch.Tensor, weight: torch.Tensor, running_mean: torch.Tensor,
             running_var: torch.Tensor, eps: float, momentum: float,
             update: bool) -> torch.Tensor:
    """x (N, C, H, W) fp32 -> (3, C) fp32: batch mean, biased variance, and
    mul = rsqrt(var + eps) * weight; ``update``: the running statistics
    updated in place. A CUDA ``x`` launches ``bn_stats`` (or raises); a CPU
    one runs ``bn_stats_plain``."""
    return bn_stats_plain(x, weight, running_mean, running_var, eps, momentum, update)


@bn_stats.register_kernel("cuda")
def _bn_stats_cuda(x, weight, running_mean, running_var, eps, momentum, update):
    return _stats_launch(x, weight, running_mean, running_var, eps, momentum, update)


@bn_stats.register_fake
def _bn_stats_fake(x, weight, running_mean, running_var, eps, momentum, update):
    return x.new_empty(3, x.shape[1])


@torch.library.custom_op("avvad_tpu_torch::bn_apply", mutates_args=(), device_types="cpu")
def bn_apply(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
             shortcut: Optional[torch.Tensor], sc_mean: Optional[torch.Tensor],
             sc_mul: Optional[torch.Tensor], sc_bias: Optional[torch.Tensor],
             relu: bool, pool: bool) -> torch.Tensor:
    """``bn_apply_plain`` as an op: a CUDA ``x`` launches ``bn_apply`` (or
    raises); a CPU one runs the plain version."""
    return bn_apply_plain(x, mean, mul, bias, shortcut, sc_mean, sc_mul, sc_bias, relu, pool)


@bn_apply.register_kernel("cuda")
def _bn_apply_cuda(x, mean, mul, bias, shortcut, sc_mean, sc_mul, sc_bias, relu, pool):
    return _apply_launch(x, mean, mul, bias, shortcut, sc_mean, sc_mul, sc_bias, relu, pool)


@bn_apply.register_fake
def _bn_apply_fake(x, mean, mul, bias, shortcut, sc_mean, sc_mul, sc_bias, relu, pool):
    return x.new_empty(_pooled_shape(x)) if pool else torch.empty_like(x)


def bn_relu(bn, x: torch.Tensor, shortcut: Optional[torch.Tensor] = None, shortcut_bn=None,
            update: bool = True, pool: bool = False) -> torch.Tensor:
    """relu(BN(x) + s) with batch statistics, max-pooled 3x3/2 if ``pool``:
    s nothing, ``shortcut``, or ``shortcut_bn``'s normalisation of
    ``shortcut``; one ``bn_stats`` a BatchNorm (updating its running
    statistics if ``update``), then one ``bn_apply``. No gradient."""
    st = bn_stats(x, bn.weight, bn.running_mean, bn.running_var, bn.eps, bn.momentum, update)
    sc = (None, None, None)
    if shortcut_bn is not None:
        sd = bn_stats(shortcut, shortcut_bn.weight, shortcut_bn.running_mean,
                      shortcut_bn.running_var, shortcut_bn.eps, shortcut_bn.momentum, update)
        sc = (sd[0], sd[2], shortcut_bn.bias)
    return bn_apply(x, st[0], st[2], bn.bias, shortcut, *sc, True, pool)
