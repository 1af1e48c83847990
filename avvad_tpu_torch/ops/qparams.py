"""Weight quantization parameters (copy of avvad_tpu/ops/qparams.py).

Symmetric per-output-channel int8: the output channel is the LAST axis
(HWIO / (H, 4H) layouts alike). ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 weights are bit-identical to the JAX
package's for the same float checkpoint.
"""

from __future__ import annotations

import torch


def weight_qparams(kernel: torch.Tensor):
    """-> (w_q int8, w_scale float32 over the last axis)."""
    kernel = kernel.float()
    reduce_dims = tuple(range(kernel.ndim - 1))
    amax = kernel.abs().amax(dim=reduce_dims) if reduce_dims else kernel.abs()
    w_scale = torch.clamp(amax, min=1e-8) / 127.0
    w_q = torch.round(kernel / w_scale).to(torch.int8)
    return w_q, w_scale
