"""The int8 stem epilogue: folded BatchNorm, ReLU, requant and 3x3/2 max pool.

Counterpart of avvad_tpu/ops/stem_pallas.py. On a CUDA tensor
``stem_epilogue_pool_quant`` launches the hand-written kernel of
``csrc/stem_epilogue_pool.cu`` (``stem_epilogue_pool``, replacing
``_stem_epilogue_kernel`` via ``stem_epilogue_pool_quant``, stem_pallas.py:72)
or raises; on a CPU tensor it runs ``stem_epilogue_plain``, the same float32
operations in plain PyTorch. The JAX package leaves its kernel unwired; the
port runs it as the stem conv's epilogue on the static-int8 tower.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_NAME = "stem_epilogue_pool"
HW_IN, HW_OUT = 34, 17

# Kernel launches, counted by the CUDA wrapper only.
launches = {KERNEL_NAME: 0}


def reset_launches() -> None:
    launches[KERNEL_NAME] = 0


def fold_stem(bn, q_stem: torch.Tensor, eps: float | None = None):
    """BatchNorm module ``bn`` (weight, bias, running stats) and the
    calibrated stem amax -> (a, b) float32 (C,) with
    q = round(relu(a * x + b)) = round(relu(BN(x)) / s),
    s = max(q_stem, 1e-8) / 127 (the fusion math of stem_pallas.py:18-27)."""
    eps = bn.eps if eps is None else eps
    inv = torch.rsqrt(bn.running_var.float() + eps)
    scale = bn.weight.float() * inv
    s = torch.clamp(q_stem.float(), min=1e-8) / 127.0
    return scale / s, (bn.bias.float() - bn.running_mean.float() * scale) / s


def _check(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    if x.ndim != 4 or tuple(x.shape[2:]) != (HW_IN, HW_IN):
        raise ValueError(f"x must be (N, C, {HW_IN}, {HW_IN}), got {tuple(x.shape)}")
    c = x.shape[1]
    if tuple(a.shape) != (c,) or tuple(b.shape) != (c,):
        raise ValueError(f"a and b must be ({c},), got {tuple(a.shape)}, {tuple(b.shape)}")


def stem_epilogue_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (N, C, 34, 34) in any layout and float dtype
    -> (N, 17, 17, C) int8, with the kernel's float32 operations."""
    _check(x, a, b)
    c = x.shape[1]
    y = x.float() * a.float().view(1, c, 1, 1) + b.float().view(1, c, 1, 1)
    q = torch.clamp(torch.round(torch.relu(y)), max=127.0)
    # padding never wins the max: q >= 0 > -128
    q = F.max_pool2d(F.pad(q, (1, 1, 1, 1), value=-128.0), 3, stride=2)
    return q.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _launch(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from ._build import kernel_lib

    n, c = x.shape[:2]
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("x must be contiguous NCHW or channels-last")
    if c % 16:
        raise ValueError(f"C must be a multiple of 16, got {c}")
    for name, v in (("a", a), ("b", b)):
        if v.device != dev or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on x's device")
    out = torch.empty(n, HW_OUT, HW_OUT, c, device=dev, dtype=torch.int8)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        rc = kernel_lib().stem_epilogue_pool(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(), n, c,
            *x.stride(), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {rc}")
    launches[KERNEL_NAME] += 1
    return out


def stem_epilogue_pool_quant(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Stem conv output x (N, C, 34, 34), NCHW or channels-last, float32 or
    bfloat16, and the folded (C,) vectors -> (N, 17, 17, C) int8 NHWC:
    q = clip(round(relu(a * x + b)), 0, 127), then the 3x3/2 max pool with
    its padding excluded. A CUDA ``x`` launches the kernel (or raises); a
    CPU ``x`` runs the plain version."""
    _check(x, a, b)
    if x.is_cuda:
        return _launch(x, a, b)
    return stem_epilogue_plain(x, a, b)
