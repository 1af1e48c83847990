"""Fused static-int8 ResNet BasicBlocks and the int8 trunk.

Counterpart of avvad_tpu/ops/conv_pallas.py. On a CUDA tensor
``basic_block_int8`` launches the hand-written kernel of
``csrc/int8_basic_block.cu`` (``int8_basic_block``, replacing
``_block_kernel`` via ``basic_block_int8``, conv_pallas.py:155) or raises;
on a CPU tensor it runs ``basic_block_int8_plain``, the same arithmetic in
plain PyTorch. Activations are NHWC int8 with channels innermost: the TPU
kernel's padded (pixel, C, N) planes (conv_pallas.py:17-30) and its frame
padding to 128 (:287-289) are Mosaic tiling rules the port does not keep.

Weights are packed as (Cout, taps * Cin) int8 with k = (dy * 3 + dx) * Cin
+ c, the K order of the kernel's implicit GEMM. The plain version computes
each int8 convolution exactly, as a float64 convolution over the integer
values (|acc| <= 127^2 * 4608 < 2^53), and then the kernel's float32
epilogue as separate operations, so the two agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .qparams import weight_qparams

KERNEL_NAME = "int8_basic_block"
BN_EPS = 1e-5

# (H_in, stride) per block of the ResNet-18 trunk at 67x67 (conv_pallas.py:261)
TRUNK_GEOM = ((17, 1), (17, 1), (17, 2), (9, 1), (9, 2), (5, 1), (5, 2), (3, 1))
TRUNK_WIDTHS = (64, 64, 128, 128, 256, 256, 512, 512)

# Frames per CTA at the trunk's geometries: about 128-600 output pixels each
# (see the source note), at most 93 KB of shared memory.
_FRAMES_PER_CTA = {(17, 1): 2, (17, 2): 2, (9, 1): 4, (9, 2): 4, (5, 1): 5,
                   (5, 2): 7, (3, 1): 7}
_SMEM_PAD, _SMEM_MAX = 16, 227 * 1024

# Kernel launches, counted by the CUDA wrapper only.
launches = {KERNEL_NAME: 0}


def reset_launches() -> None:
    launches[KERNEL_NAME] = 0


def conv_out(size: int, stride: int) -> int:
    return (size - 1) // stride + 1


def pack_conv3(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, Cout) -> (Cout, 9 * Cin), k = (dy * 3 + dx) * Cin + c."""
    _, _, cin, cout = w_hwio.shape
    return w_hwio.permute(3, 0, 1, 2).reshape(cout, 9 * cin).contiguous()


def pack_conv1(w_hwio: torch.Tensor) -> torch.Tensor:
    """(1, 1, Cin, Cout) -> (Cout, Cin) (downsample shortcuts)."""
    return w_hwio[0, 0].t().contiguous()


def bn_affine(bn: tuple, eps: float = BN_EPS):
    """(scale, bias, mean, var) -> inference BatchNorm as a * x + b."""
    scale, bias, mean, var = (t.float() for t in bn)
    a = scale * torch.rsqrt(var + eps)
    return a, bias - mean * a


def quant_hwio(w_oihw: torch.Tensor):
    """OIHW float weight -> (HWIO int8, per-Cout scale). weight_qparams
    quantises per LAST axis, so it gets the HWIO view: on OIHW it would
    give per-W-column scales."""
    return weight_qparams(w_oihw.permute(2, 3, 1, 0))


def fold_block(x_scale, params: dict, q1_scale, qout_scale,
               eps: float = BN_EPS) -> dict:
    """Fold one BasicBlock into the kernel's arguments (conv_pallas.py:225).

    params: ``conv1`` / ``conv2`` [/ ``downsample_conv``] OIHW float
    weights, ``bn1`` / ``bn2`` [/ ``downsample_bn``] (scale, bias, mean,
    var). x_scale, q1_scale, qout_scale: the static activation scales
    (amax / 127). -> w1, a1, b1, w2, a2, b2 and wd, ad, bd (downsample) or
    res_scale (identity), plus out_scale."""
    w1_q, w1_s = quant_hwio(params["conv1"])
    w2_q, w2_s = quant_hwio(params["conv2"])
    a1, b1 = bn_affine(params["bn1"], eps)
    a2, b2 = bn_affine(params["bn2"], eps)
    spec = {"w1": pack_conv3(w1_q), "a1": a1 * (x_scale * w1_s) / q1_scale,
            "b1": b1 / q1_scale, "w2": pack_conv3(w2_q),
            "a2": a2 * (q1_scale * w2_s) / qout_scale, "b2": b2 / qout_scale,
            "out_scale": qout_scale}
    if "downsample_conv" in params:
        wd_q, wd_s = quant_hwio(params["downsample_conv"])
        ad, bd = bn_affine(params["downsample_bn"], eps)
        spec.update(wd=pack_conv1(wd_q), ad=ad * (x_scale * wd_s) / qout_scale,
                    bd=bd / qout_scale)
    else:
        spec["res_scale"] = x_scale / qout_scale
    return spec


def _check(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride):
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC (N, H, W, Cin), got {tuple(x.shape)}")
    cin, cout = x.shape[3], w1.shape[0]
    if tuple(w1.shape) != (cout, 9 * cin) or tuple(w2.shape) != (cout, 9 * cout):
        raise ValueError(f"w1 / w2 must be ({cout}, {9 * cin}) / ({cout}, "
                         f"{9 * cout}), got {tuple(w1.shape)} / {tuple(w2.shape)}")
    for name, v in (("a1", a1), ("b1", b1), ("a2", a2), ("b2", b2)):
        if tuple(v.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got {tuple(v.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if wd is None:
        if res_scale is None or stride != 1 or cin != cout:
            raise ValueError("the identity residual needs res_scale, stride 1 "
                             "and Cin == Cout; otherwise pass wd, ad, bd")
    elif (tuple(wd.shape) != (cout, cin) or ad is None or bd is None
          or tuple(ad.shape) != (cout,) or tuple(bd.shape) != (cout,)):
        raise ValueError(f"wd must be ({cout}, {cin}) with ad, bd ({cout},)")


def _requant(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(torch.relu(v)), max=127.0)


def conv_exact(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """int-valued NCHW x (int8 or float) and int8 OIHW w -> the int32 sums
    as float32 (exact in float64, then rounded as the kernel's
    __int2float_rn rounds the int32)."""
    return F.conv2d(x.double(), w.double(), stride=stride, padding=pad).float()


def basic_block_int8_plain(x, w1, a1, b1, w2, a2, b2, wd=None, ad=None, bd=None,
                           res_scale=None, *, stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arguments, same result."""
    _check(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride)
    cin, cout = x.shape[3], w1.shape[0]
    col = lambda v: v.float().view(1, cout, 1, 1)  # noqa: E731
    xc = x.permute(0, 3, 1, 2)
    w1o = w1.view(cout, 3, 3, cin).permute(0, 3, 1, 2)
    w2o = w2.view(cout, 3, 3, cout).permute(0, 3, 1, 2)
    y1 = _requant(conv_exact(xc, w1o, stride, 1) * col(a1) + col(b1))
    y2 = conv_exact(y1, w2o, 1, 1) * col(a2) + col(b2)
    if wd is None:
        res = xc.float() * torch.as_tensor(res_scale, dtype=torch.float32,
                                           device=x.device)
    else:
        res = conv_exact(xc, wd.view(cout, cin, 1, 1), stride, 0) * col(ad) + col(bd)
    out = _requant(y2 + res).to(torch.int8)
    return out.permute(0, 2, 3, 1).contiguous()


def frames_per_cta(h: int, w: int, stride: int, cin: int, cout: int) -> int:
    """Frames per CTA: the trunk's table, else about 128 output pixels,
    capped by the shared memory the frames' x and y1 take."""
    ho, wo = conv_out(h, stride), conv_out(w, stride)
    per_frame = h * w * (cin + _SMEM_PAD) + ho * wo * (cout + _SMEM_PAD)
    f = _FRAMES_PER_CTA.get((h, stride)) if h == w else None
    if f is None:
        f = max(1, 128 // (ho * wo))
    return max(1, min(f, _SMEM_MAX // per_frame))


def _launch(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride):
    from ._build import kernel_lib

    n, h, w, cin = x.shape
    cout = w1.shape[0]
    dev = x.device
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC int8 on the CUDA device")
    if cin % 32 or cout % 32:
        raise ValueError(f"Cin and Cout must be multiples of 32, got {cin}, {cout}")
    for name, v, dt in (("w1", w1, torch.int8), ("w2", w2, torch.int8),
                        ("wd", wd, torch.int8), ("a1", a1, torch.float32),
                        ("b1", b1, torch.float32), ("a2", a2, torch.float32),
                        ("b2", b2, torch.float32), ("ad", ad, torch.float32),
                        ("bd", bd, torch.float32)):
        if v is not None and (v.device != dev or v.dtype != dt or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt} on x's device")
    # the identity's scale stays on the card: reading it on the host would
    # wait for the queued work
    rs = None if res_scale is None else torch.as_tensor(
        res_scale, dtype=torch.float32, device=dev).reshape(())
    ho, wo = conv_out(h, stride), conv_out(w, stride)
    out = torch.empty(n, ho, wo, cout, device=dev, dtype=torch.int8)
    if n == 0:
        return out
    ptr = lambda v: None if v is None else v.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        rc = kernel_lib().int8_basic_block(
            x.data_ptr(), w1.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), a2.data_ptr(), b2.data_ptr(), ptr(wd), ptr(ad),
            ptr(bd), ptr(rs), out.data_ptr(), n, h, w, cin, cout, stride,
            frames_per_cta(h, w, stride, cin, cout),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {rc}")
    launches[KERNEL_NAME] += 1
    return out


def basic_block_int8(x, w1, a1, b1, w2, a2, b2, wd=None, ad=None, bd=None,
                     res_scale=None, *, stride: int = 1) -> torch.Tensor:
    """One fused int8 BasicBlock: x (N, H, W, Cin) int8 NHWC -> (N, Ho, Wo,
    Cout) int8 NHWC. w1 / w2: ``pack_conv3``; identity residual:
    ``res_scale`` = x_scale / out_scale; downsample: ``wd`` = ``pack_conv1``
    with its folded ``ad``, ``bd``. A CUDA ``x`` launches the kernel (or
    raises); a CPU ``x`` runs the plain version."""
    _check(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride)
    if x.is_cuda:
        return _launch(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride)
    return basic_block_int8_plain(x, w1, a1, b1, w2, a2, b2, wd, ad, bd,
                                  res_scale, stride=stride)


def _block_args(spec: dict) -> tuple:
    return tuple(spec.get(k) for k in ("w1", "a1", "b1", "w2", "a2", "b2", "wd",
                                       "ad", "bd", "res_scale"))


def trunk_features_int8(x_q: torch.Tensor, blocks: list) -> torch.Tensor:
    """The 8 fused BasicBlocks + global average pool (conv_pallas.py:276).

    x_q: (N, 17, 17, 64) int8, the quantised, max-pooled stem output.
    blocks: ``fold_block`` dicts, one per block of the standard trunk;
    the last one's ``out_scale`` dequantises. -> (N, 512) float32."""
    widths = tuple(int(s["w1"].shape[0]) for s in blocks)
    if tuple(x_q.shape[1:]) != (17, 17, 64) or widths != TRUNK_WIDTHS:
        raise ValueError(
            "the int8 trunk kernels are specialised to the standard ResNet-18 "
            "trunk at 67x67 inputs (17x17x64 stem output); got "
            f"{tuple(x_q.shape[1:])} / {widths}")
    x = x_q
    for spec, (_, stride) in zip(blocks, TRUNK_GEOM):
        x = basic_block_int8(x, *_block_args(spec), stride=stride)
    s = x.reshape(x.shape[0], 9, 512).sum(dim=1, dtype=torch.int32)
    return s.float() * (blocks[-1]["out_scale"] / 9.0)
