"""The int8 stem epilogue: folded BatchNorm, ReLU, requant and 3x3/2 max pool.

Counterpart of avvad_tpu/ops/stem_pallas.py. On a CUDA tensor
``stem_epilogue_pool_quant`` launches a hand-written kernel of
``csrc/stem_epilogue_pool.cu`` (replacing ``_stem_epilogue_kernel`` via
``stem_epilogue_pool_quant``, stem_pallas.py:72) or raises, by the input's
layout: ``stem_epilogue_pool_nhwc`` (a persistent grid streaming row pairs
through a ring of bulk copies) for channels-last input, which the static-int8
tower's stem conv writes, and ``stem_epilogue_pool`` for NCHW input. On a
CPU tensor it runs ``stem_epilogue_plain``, the same float32 operations in
plain PyTorch. The JAX package leaves its kernel unwired; the port runs it
as the stem conv's epilogue on the static-int8 tower.

Both routes are one custom op, ``avvad_tpu_torch::stem_epilogue_pool_quant``
(``torch.library``), whose CUDA implementation picks the kernel by the
layout of the tensor it is given when it runs, and whose fake
implementation gives the output's shape for ``torch.export``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KERNEL_NAME = "stem_epilogue_pool"            # NCHW input
NHWC_KERNEL_NAME = "stem_epilogue_pool_nhwc"  # channels-last input
HW_IN, HW_OUT = 34, 17

# Kernel launches per kernel, counted by the CUDA wrapper only.
launches = {KERNEL_NAME: 0, NHWC_KERNEL_NAME: 0}

# Geometry of stem_epilogue_pool_nhwc (csrc/stem_epilogue_pool.cu)
NHWC_THREADS = 256       # threads of a CTA
NHWC_MAX_SLOTS = 8       # chunks in the ring at most (the kernel's mbarriers)
NHWC_RING_BYTES = 65536  # a CTA's ring of chunks at most
NHWC_SLICE_BYTES = 256   # bytes of a pixel's channels in one unit at most


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nhwc_plan(c: int, elem_bytes: int) -> dict:
    """The channels-last kernel's geometry for C channels of ``elem_bytes``
    (2: bf16, 4: float32), which the wrapper hands its C entry: a unit is a frame's
    ``slice`` channels (all C where a pixel's channels fit
    ``NHWC_SLICE_BYTES``, else the largest multiple of 16 that divides C and
    fits); a chunk is input rows 2p and 2p + 1 of a unit (one output row);
    the ring holds ``slots`` chunks; a round of the CTA's threads covers
    ``items`` = 17 output columns x slice / 8 channel octets; and
    ``smem_bytes`` is a CTA's shared memory. -> {"slice", "chunk_bytes",
    "slots", "items", "smem_bytes"}."""
    if c <= 0 or c % 16:
        raise ValueError(f"C must be a positive multiple of 16, got {c}")
    cs = c
    if c * elem_bytes > NHWC_SLICE_BYTES:
        cs = next((k for k in range(NHWC_SLICE_BYTES // elem_bytes // 16 * 16, 16, -16)
                   if c % k == 0), 16)
    chunk = 2 * HW_IN * cs * elem_bytes
    slots = min(NHWC_MAX_SLOTS, NHWC_RING_BYTES // chunk)
    items = HW_OUT * cs // 8
    ring_at = -(-(NHWC_MAX_SLOTS * 8 + 8 * c + items * 8 * elem_bytes) // 128) * 128
    return {"slice": cs, "chunk_bytes": chunk, "slots": slots, "items": items,
            "smem_bytes": ring_at + slots * chunk}


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
    if x.is_contiguous():
        name = KERNEL_NAME
    elif x.is_contiguous(memory_format=torch.channels_last):
        name = NHWC_KERNEL_NAME
        if x.data_ptr() % 16:  # the bulk copies move 16-byte-aligned runs
            raise ValueError("channels-last x must start on a 16-byte boundary")
    else:
        raise ValueError("x must be contiguous NCHW or channels-last")
    if c % 16:
        raise ValueError(f"C must be a multiple of 16, got {c}")
    for v_name, v in (("a", a), ("b", b)):
        if v.device != dev or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"{v_name} must be contiguous float32 on x's device")
    out = torch.empty(n, HW_OUT, HW_OUT, c, device=dev, dtype=torch.int8)
    if n == 0:
        return out
    lib, bf16 = kernel_lib(), int(x.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == KERNEL_NAME:
            rc = lib.stem_epilogue_pool(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), n, c, *x.stride(), bf16, stream)
        else:
            plan = nhwc_plan(c, x.element_size())
            rc = lib.stem_epilogue_pool_nhwc(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                             out.data_ptr(), n, c, plan["slice"],
                                             plan["slots"], bf16, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1
    return out


@torch.library.custom_op("avvad_tpu_torch::stem_epilogue_pool_quant", mutates_args=(),
                         device_types="cpu")
def stem_epilogue_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stem epilogue as an op: on the CPU the plain version (the CUDA
    implementation is registered below)."""
    return stem_epilogue_plain(x, a, b)


@stem_epilogue_op.register_kernel("cuda")
def _stem_epilogue_cuda(x, a, b):
    return _launch(x, a, b)


@stem_epilogue_op.register_fake
def _stem_epilogue_fake(x, a, b):
    return x.new_empty(x.shape[0], HW_OUT, HW_OUT, x.shape[1], dtype=torch.int8)


def stem_epilogue_pool_quant(x: torch.Tensor, a: torch.Tensor,
                             b: torch.Tensor) -> torch.Tensor:
    """Stem conv output x (N, C, 34, 34), NCHW or channels-last, float32 or
    bfloat16, and the folded (C,) vectors -> (N, 17, 17, C) int8 NHWC:
    q = clip(round(relu(a * x + b)), 0, 127), then the 3x3/2 max pool with
    its padding excluded. A CUDA ``x`` launches the kernel of its layout,
    ``stem_epilogue_pool_nhwc`` for channels-last and ``stem_epilogue_pool``
    for NCHW (or raises); a CPU ``x`` runs the plain version (both through
    ``stem_epilogue_op``)."""
    _check(x, a, b)
    return stem_epilogue_op(x, a, b)
