"""Multimodal Compact Bilinear pooling (port of avvad_tpu/models/mcb.py).

The count sketch is a dense one-nonzero-per-row sign matrix M, and the
rfft / irfft of the sketch convolution are real cos/sin bases, so MCB is a
handful of fp32 matmuls plus elementwise products. Sketches come from the
same ``np.random.default_rng(seed)`` draw as the JAX module (mcb.py:176).

Two storage forms, as in the JAX module:
- plain (``folded_vars=False``): buffers ``sketch1`` / ``sketch2`` hold M
  (d_in, out). With ``fold_sketch`` (default) M is folded into the rfft
  bases ONCE, in fp32, whenever the sketches are set or loaded -- the same
  contraction (M @ C, M @ S) the JAX module does on every call
  (mcb.py:216-220);
- folded (``folded_vars=True``): the buffers hold the (2, d_in, f) stacks
  themselves (``fold_count_sketch``), as the JAX serving form stores them;
  ``fold_sketch_state_dict`` turns a plain state dict into this form
  (``fold_sketch_collection``, mcb.py:114).
``precision``: "highest" runs every matmul in full fp32 (the JAX package's
Precision.HIGHEST, the default); "default" rounds both operands of each MCB
matmul to bf16 and sums in fp32, which is what the TPU's Precision.DEFAULT
computes. The fold of the sketch into the bases stays full precision
(mcb.py:212-218).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..parallel.sync import all_reduce_sum, data_group


def count_sketch_matrix(rng: np.random.Generator, in_dim: int, out_dim: int) -> np.ndarray:
    """Dense (in_dim, out_dim) count-sketch matrix: row i has s_i at column h_i."""
    h = rng.integers(0, out_dim, size=in_dim)
    s = rng.integers(0, 2, size=in_dim) * 2 - 1
    m = np.zeros((in_dim, out_dim), dtype=np.float32)
    m[np.arange(in_dim), h] = s
    return m


@functools.lru_cache(maxsize=4)
def _rdft_bases(d: int):
    """Forward rfft bases: re = p @ C, im = p @ S. Each (d, f), f = d//2+1."""
    n = np.arange(d, dtype=np.float64)[:, None]
    k = np.arange(d // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / d
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _irdft_bases(d: int):
    """Inverse bases: out = re @ Mr + im @ Mi, Mr/Mi (f, d), numpy irfft
    semantics (interior bins weighted 2, imaginary DC/Nyquist ignored)."""
    f = d // 2 + 1
    k = np.arange(f, dtype=np.float64)[:, None]
    n = np.arange(d, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / d
    w = np.full((f, 1), 2.0)
    w[0] = 1.0
    if d % 2 == 0:
        w[-1] = 1.0
    mr = (w * np.cos(ang) / d).astype(np.float32)
    mi = (-(w * np.sin(ang)) / d).astype(np.float32)
    mi[0] = 0.0
    if d % 2 == 0:
        mi[-1] = 0.0
    return mr, mi


def fold_count_sketch(m: np.ndarray, out_dim: int) -> np.ndarray:
    """(in_dim, out_dim) sketch -> (2, in_dim, f) stack [M @ C; M @ S],
    folded in float64 on the host and rounded once to float32."""
    cos_b, sin_b = _rdft_bases(out_dim)
    m64 = np.asarray(m, dtype=np.float64)
    return np.stack([
        (m64 @ cos_b.astype(np.float64)).astype(np.float32),
        (m64 @ sin_b.astype(np.float64)).astype(np.float32),
    ])


PRECISIONS = ("highest", "default")


def dot(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """a @ b in fp32, or with ``precision="default"`` on bf16-rounded
    operands: the products of two bf16 values are exact in fp32, so this is
    the TPU's DEFAULT product (bf16 in, fp32 sums)."""
    if precision == "default":
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return a @ b


def _product_to_signal(re_x, im_x, re_y, im_y, mr, mi, precision="highest"):
    re_p = re_x * re_y - im_x * im_y
    im_p = re_x * im_y + im_x * re_y
    return dot(re_p, mr, precision) + dot(im_p, mi, precision)


def circular_conv_real(px: torch.Tensor, py: torch.Tensor,
                       precision: str = "highest") -> torch.Tensor:
    """Circular convolution of (..., d) signals via the real DFT bases."""
    d = px.shape[-1]
    cos_b, sin_b = (torch.from_numpy(b).to(px.device) for b in _rdft_bases(d))
    mr, mi = (torch.from_numpy(b).to(px.device) for b in _irdft_bases(d))
    return _product_to_signal(dot(px, cos_b, precision), dot(px, sin_b, precision),
                              dot(py, cos_b, precision), dot(py, sin_b, precision),
                              mr, mi, precision)


def fold_sketch_state_dict(state: dict) -> dict:
    """A state dict with plain (d_in, out) ``sketch1`` / ``sketch2`` buffers
    -> the same dict (other entries shared) with each replaced by its
    (2, d_in, f) ``fold_count_sketch`` stack, for a model built with
    ``mcb_folded_vars=True`` (the state-dict twin of the JAX package's
    ``fold_sketch_collection``). Already folded stacks pass through."""
    out = dict(state)
    for key, v in state.items():
        if key.rsplit(".", 1)[-1] in ("sketch1", "sketch2") and v.ndim == 2:
            out[key] = torch.from_numpy(fold_count_sketch(
                v.detach().cpu().numpy(), v.shape[1])).to(v.device)
    return out


class CompactBilinearPooling(nn.Module):
    """MCB of two streams: (..., d1), (..., d2) -> (..., output_size)."""

    def __init__(self, input1_size: int, input2_size: int,
                 output_size: int = 1024, seed: int = 0,
                 fold_sketch: bool = True, folded_vars: bool = False,
                 precision: str = "highest"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"mcb precision {precision!r}: one of {PRECISIONS}")
        self.precision = precision
        self.output_size = output_size
        self.fold_sketch = fold_sketch
        self.folded_vars = folded_vars
        rng = np.random.default_rng(seed)
        m1 = count_sketch_matrix(rng, input1_size, output_size)
        m2 = count_sketch_matrix(rng, input2_size, output_size)
        if folded_vars:
            m1, m2 = (fold_count_sketch(m, output_size) for m in (m1, m2))
        self.register_buffer("sketch1", torch.from_numpy(m1))
        self.register_buffer("sketch2", torch.from_numpy(m2))
        mr, mi = _irdft_bases(output_size)
        self.register_buffer("irdft_re", torch.from_numpy(mr), persistent=False)
        self.register_buffer("irdft_im", torch.from_numpy(mi), persistent=False)
        self.register_buffer("fold1", torch.empty(0), persistent=False)
        self.register_buffer("fold2", torch.empty(0), persistent=False)
        self.refold()
        self.register_load_state_dict_post_hook(
            lambda module, _incompatible: module.refold())

    @torch.no_grad()
    def refold(self) -> None:
        """Recompute the folded (2, d_in, f) bases from the sketch buffers."""
        if self.folded_vars:
            self.fold1, self.fold2 = self.sketch1, self.sketch2
            return
        if not self.fold_sketch:
            return
        cos_b, sin_b = (torch.from_numpy(b).to(self.sketch1.device)
                        for b in _rdft_bases(self.output_size))
        self.fold1, self.fold2 = (torch.stack([m @ cos_b, m @ sin_b])
                                  for m in (self.sketch1, self.sketch2))

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
        y = x if y is None else y
        x, y = x.float(), y.float()
        p = self.precision
        if self.folded_vars or self.fold_sketch:
            return _product_to_signal(dot(x, self.fold1[0], p), dot(x, self.fold1[1], p),
                                      dot(y, self.fold2[0], p), dot(y, self.fold2[1], p),
                                      self.irdft_re, self.irdft_im, p)
        return circular_conv_real(dot(x, self.sketch1, p), dot(y, self.sketch2, p), p)


def signed_sqrt(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """sign(x) * sqrt(|x| + eps)."""
    return torch.sign(x) * torch.sqrt(x.abs() + eps)


def global_l2_normalize(x: torch.Tensor, eps: float = 1e-12,
                        axes=None) -> torch.Tensor:
    """x / max(||x||_2, eps) with the norm detached. ``axes=None`` is the
    whole-tensor norm (every batch row couples through it; under
    ``parallel.sync.data_parallel`` every rank's rows: the sum of squares is
    added over the data group); a tuple of axes reduces over those only
    (keepdim)."""
    if axes is None:
        group = data_group()
        sq = torch.sum(x * x).detach()
        norm = torch.sqrt(sq if group is None else all_reduce_sum(sq, group))
    else:
        norm = torch.sqrt(torch.sum(x * x, dim=tuple(axes), keepdim=True))
    return x / torch.clamp(norm.detach(), min=eps)
