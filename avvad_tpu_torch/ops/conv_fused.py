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

The kernel reads each weight as tile-major chunks (``pack_tiles``): n tile
x k chunk of 128, every chunk the shared-memory image an int8 ``wgmma``
takes its B operand from, so that one bulk copy stages it. ``block_plan``
picks the frames a CTA takes, the ring depth and the shared memory; the C
entry checks the bytes against its own count.

``basic_block_int8`` calls the custom op ``avvad_tpu_torch::int8_basic_block``
(``torch.library``): the kernel on the card, the plain version on the CPU,
and a fake implementation with the output's shape, so that ``torch.export``
records the op in a serving program. The op reads the card's SMs and the
plan when it runs, and packs the tiles there when it is given none.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .qparams import weight_qparams

KERNEL_NAME = "int8_basic_block"
BN_EPS = 1e-5

# (H_in, stride) per block of the ResNet-18 trunk at 67x67 (conv_pallas.py:261)
TRUNK_GEOM = ((17, 1), (17, 1), (17, 2), (9, 1), (9, 2), (5, 1), (5, 2), (3, 1))
TRUNK_WIDTHS = (64, 64, 128, 128, 256, 256, 512, 512)

# Geometry of the kernel (csrc/int8_basic_block.cu)
M_TILE = 64            # output rows of one wgmma
K_CHUNK = 128          # k per weight chunk: one 128-byte swizzled row
CONSUMER_GROUPS = 2    # warpgroups that share every weight chunk
MAX_STAGES, MIN_STAGES = 4, 2   # chunks in the weight ring
SMEM_PAD = 16          # bytes of padding per pixel row of the x and y1 tiles
SMEM_ALIGN = 1024      # the ring starts on the swizzle pattern's period
# dynamic shared memory a block may opt in to on sm_90, the only target
SMEM_LIMIT_SM90 = 232448
SM_COUNT_H100 = 132

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
    res_scale (identity), plus out_scale and ``tiles``, the weights as the
    kernel reads them (``pack_block_tiles``)."""
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
    spec["tiles"] = pack_block_tiles(spec["w1"], spec["w2"], spec.get("wd"))
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
                           res_scale=None, *, stride: int = 1,
                           tiles: tuple | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same arguments (``tiles`` is
    not read), same result."""
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


def n_tile(cout: int) -> int:
    """Output channels per wgmma and weight chunk: the largest of 128, 64
    and 32 that divides Cout."""
    return 128 if cout % 128 == 0 else 64 if cout % 64 == 0 else 32


def block_smem_bytes(frames: int, stages: int, h: int, w: int, stride: int,
                     cin: int, cout: int) -> int:
    """Shared memory of a CTA: alignment slack, the weight ring, the x and
    y1 tiles of its frames, the ring's barriers (smem_bytes in the source)."""
    ho, wo = conv_out(h, stride), conv_out(w, stride)
    return (SMEM_ALIGN + stages * n_tile(cout) * K_CHUNK
            + frames * (h * w * (cin + SMEM_PAD) + ho * wo * (cout + SMEM_PAD))
            + 2 * MAX_STAGES * 8)


def block_plan(h: int, w: int, stride: int, cin: int, cout: int,
               smem_limit: int = SMEM_LIMIT_SM90, n_frames: int | None = None,
               sm_count: int = SM_COUNT_H100, down: bool | None = None) -> dict:
    """How the kernel cuts one BasicBlock of (H, W, Cin) -> (Ho, Wo, Cout)
    frames, or ValueError with the reason where it cannot take the shape.

    A CTA takes ``frames`` whole frames: rows = frames * Ho * Wo output
    pixels in ``m_tiles`` tiles of 64 rows, dealt to the two consumer
    warpgroups, ``tiles_per_group`` (2; 1 in a downsample block, which holds
    two accumulator sets) at a time: a pass, against every weight chunk of a
    conv. The weights' bytes a CTA pulls through L2 are ``passes`` x the
    block's weights, the tensor-core time goes with ceil(m_tiles / 2) x 64
    rows, and every CTA pays a fixed start and end, so ``frames`` minimises
        (128 ceil(m_tiles / 2) + 0.5 * 256 passes + 48) / rows
    over the frame counts whose shared memory fits ``smem_limit`` with a
    ring of 2 slots; the ring then takes as many slots, up to 4, as fit
    beside them (on the card the depth beyond 2 moved no block's time, the
    rows a pass did). With ``n_frames``
    given, ``frames`` is capped so that a small batch still spreads over
    ``sm_count`` SMs. ``down``: whether the shortcut is a 1x1 conv (by
    default where the shape changes).
    -> {"frames", "rows", "m_tiles", "tiles_per_group", "passes", "n_tile",
    "n_tiles", "k_chunks": (conv1, conv2, downsample or 0), "stages",
    "chunk_bytes", "smem_bytes"}."""
    if min(h, w, cin, cout) < 1 or stride not in (1, 2):
        raise ValueError(f"bad block geometry {(h, w, stride, cin, cout)}")
    if cin % 32 or cout % 32:
        raise ValueError("the fused int8 block kernel needs Cin % 32 == 0 (k steps "
                         f"of 32) and Cout % 32 == 0 (n tiles), got {cin}, {cout}")
    if down is None:
        down = stride != 1 or cin != cout
    elif not down and (stride != 1 or cin != cout):
        raise ValueError("the identity shortcut needs stride 1 and Cin == Cout")
    per_group = 1 if down else 2
    pixels = conv_out(h, stride) * conv_out(w, stride)
    cap = None if n_frames is None else max(1, -(-n_frames // sm_count))
    best, frames = None, 0
    while cap is None or frames < cap:
        frames += 1
        stages = next((s for s in range(MAX_STAGES, MIN_STAGES - 1, -1)
                       if block_smem_bytes(frames, s, h, w, stride, cin, cout)
                       <= smem_limit), None)
        if stages is None:
            break
        rows = frames * pixels
        m_tiles = -(-rows // M_TILE)
        passes = -(-m_tiles // (CONSUMER_GROUPS * per_group))
        cost = (2 * M_TILE * -(-m_tiles // CONSUMER_GROUPS) + 0.5 * 256 * passes + 48) / rows
        if best is None or cost < best[0] - 1e-9:
            best = (cost, frames, stages, rows, m_tiles, passes)
    if best is None:
        raise ValueError(
            f"one {h}x{w}x{cin} frame with its {cout}-channel y1 and a 2-slot weight "
            f"ring takes {block_smem_bytes(1, MIN_STAGES, h, w, stride, cin, cout)} "
            f"bytes of shared memory, over the limit of {smem_limit}")
    _, frames, stages, rows, m_tiles, passes = best
    nt = n_tile(cout)
    return {"frames": frames, "rows": rows, "m_tiles": m_tiles,
            "tiles_per_group": per_group, "passes": passes, "n_tile": nt,
            "n_tiles": cout // nt,
            "k_chunks": (-(-9 * cin // K_CHUNK), -(-9 * cout // K_CHUNK),
                         -(-cin // K_CHUNK) if down else 0),
            "stages": stages, "chunk_bytes": nt * K_CHUNK,
            "smem_bytes": block_smem_bytes(frames, stages, h, w, stride, cin, cout)}


def _swizzle_index(nt: int, device) -> torch.Tensor:
    """(nt, 8): where the 16-byte group c of row n lies in its 128-byte row
    under the 128-byte swizzle, c ^ (n % 8) (its own inverse)."""
    n = torch.arange(nt, device=device)[:, None]
    return torch.arange(8, device=device)[None, :] ^ (n % 8)


def pack_tiles(w: torch.Tensor) -> torch.Tensor:
    """(Cout, K) int8 (``pack_conv3`` / ``pack_conv1``) -> (n tiles, k
    chunks, n_tile, 128) int8, each [i, j] the shared-memory image of rows
    [i n_tile, (i + 1) n_tile) x k [128 j, 128 j + 128): K-major rows of 128
    bytes whose 16-byte groups are swizzled by the row (c ^ (n % 8)), k
    zero-padded to a multiple of 128."""
    cout, k = w.shape
    nt = n_tile(cout)
    if cout % nt:
        raise ValueError(f"Cout must be a multiple of 32, got {cout}")
    kc = -(-k // K_CHUNK)
    wp = F.pad(w, (0, kc * K_CHUNK - k))
    t = wp.view(cout // nt, nt, kc, 8, 16).permute(0, 2, 1, 3, 4)
    idx = _swizzle_index(nt, w.device)
    t = t[:, :, torch.arange(nt, device=w.device)[:, None], idx]
    return t.reshape(cout // nt, kc, nt, K_CHUNK).contiguous()


def pack_block_tiles(w1, w2, wd=None) -> tuple:
    """The three weights of a block as the kernel reads them."""
    return (pack_tiles(w1), pack_tiles(w2), None if wd is None else pack_tiles(wd))


def _launch(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride, tiles):
    from ._build import kernel_lib

    n, h, w, cin = x.shape
    cout = w1.shape[0]
    dev = x.device
    if x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC int8 on the CUDA device")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = block_plan(h, w, stride, cin, cout, n_frames=n, sm_count=sms,
                      down=wd is not None)
    if tiles is None:
        tiles = pack_block_tiles(w1, w2, wd)
    t1, t2, td = tiles
    shape = lambda kc: (plan["n_tiles"], kc, plan["n_tile"], K_CHUNK)  # noqa: E731
    for name, v, kc in (("w1", t1, plan["k_chunks"][0]), ("w2", t2, plan["k_chunks"][1]),
                        ("wd", td, plan["k_chunks"][2])):
        if (v is None) != (kc == 0) or (v is not None and tuple(v.shape) != shape(kc)):
            raise ValueError(f"tiles of {name} must be pack_tiles of it, "
                             f"{shape(kc) if kc else None}")
    for name, v, dt in (("w1 tiles", t1, torch.int8), ("w2 tiles", t2, torch.int8),
                        ("wd tiles", td, torch.int8), ("a1", a1, torch.float32),
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
            x.data_ptr(), t1.data_ptr(), a1.data_ptr(), b1.data_ptr(),
            t2.data_ptr(), a2.data_ptr(), b2.data_ptr(), ptr(td), ptr(ad),
            ptr(bd), ptr(rs), out.data_ptr(), n, h, w, cin, cout, stride,
            plan["frames"], plan["stages"], plan["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {rc} "
                           f"(x {tuple(x.shape)} -> {cout} channels, stride "
                           f"{stride}, plan {plan})")
    launches[KERNEL_NAME] += 1
    return out


@torch.library.custom_op("avvad_tpu_torch::int8_basic_block", mutates_args=(),
                         device_types="cpu")
def int8_basic_block_op(x: torch.Tensor, w1: torch.Tensor, a1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, a2: torch.Tensor,
                        b2: torch.Tensor, wd: Optional[torch.Tensor],
                        ad: Optional[torch.Tensor], bd: Optional[torch.Tensor],
                        res_scale: Optional[torch.Tensor], stride: int,
                        t1: Optional[torch.Tensor], t2: Optional[torch.Tensor],
                        td: Optional[torch.Tensor]) -> torch.Tensor:
    """One fused int8 BasicBlock as an op: on the CPU the plain version (the
    CUDA implementation is registered below); t1, t2, td: the tiles."""
    return basic_block_int8_plain(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale,
                                  stride=stride)


@int8_basic_block_op.register_kernel("cuda")
def _int8_basic_block_cuda(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride,
                           t1, t2, td):
    tiles = None if t1 is None else (t1, t2, td)
    return _launch(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride, tiles)


@int8_basic_block_op.register_fake
def _int8_basic_block_fake(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride,
                           t1, t2, td):
    n, h, w, _ = x.shape
    return x.new_empty(n, conv_out(h, stride), conv_out(w, stride), w1.shape[0],
                       dtype=torch.int8)


def basic_block_int8(x, w1, a1, b1, w2, a2, b2, wd=None, ad=None, bd=None,
                     res_scale=None, *, stride: int = 1,
                     tiles: tuple | None = None) -> torch.Tensor:
    """One fused int8 BasicBlock: x (N, H, W, Cin) int8 NHWC -> (N, Ho, Wo,
    Cout) int8 NHWC. w1 / w2: ``pack_conv3``; identity residual:
    ``res_scale`` = x_scale / out_scale; downsample: ``wd`` = ``pack_conv1``
    with its folded ``ad``, ``bd``. ``tiles``: ``pack_block_tiles(w1, w2,
    wd)`` where the caller keeps it (``fold_block`` does), else packed
    by the op at every call. A CUDA ``x`` launches the kernel, or raises
    where ``block_plan`` refuses the shape or the launch fails; a CPU ``x``
    runs the plain version (both through ``int8_basic_block_op``)."""
    _check(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, stride)
    if res_scale is not None:
        res_scale = torch.as_tensor(res_scale, dtype=torch.float32, device=x.device)
    t1, t2, td = (None, None, None) if tiles is None else tiles
    return int8_basic_block_op(x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale,
                               stride, t1, t2, td)


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
        x = basic_block_int8(x, *_block_args(spec), stride=stride,
                             tiles=spec.get("tiles"))
    s = x.reshape(x.shape[0], 9, 512).sum(dim=1, dtype=torch.int32)
    return s.float() * (blocks[-1]["out_scale"] / 9.0)
