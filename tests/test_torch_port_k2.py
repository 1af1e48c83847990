"""The fused int8 BasicBlock kernel's plan, weight packing, tiling and fold
cache, on the CPU.

``csrc/int8_basic_block.cu`` runs only on a card. What the CPU can hold:
``block_plan`` (frames per CTA, tiles, ring, shared memory) over the trunk's
geometries and a grid of odd shapes and limits, and the source's constants
against it; the tile-major weight packing against ``pack_conv3`` /
``pack_conv1``; a plain emulation of the kernel's tiling (CTAs of whole
frames, m64 tiles dealt to two warpgroups, n tiles, k chunks eaten in the
producer's ring order, a ragged last CTA) against ``basic_block_int8_plain``
bit for bit and against the JAX package's Pallas kernel in interpret mode;
and the trunk's fold cache.
"""

import copy
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.ops import conv_pallas as jcp
from avvad_tpu_torch.models.resnet import ResNet18
from avvad_tpu_torch.ops import _build, conv_fused as cf

TRUNK = list(zip(cf.TRUNK_GEOM, (64,) + cf.TRUNK_WIDTHS[:-1], cf.TRUNK_WIDTHS))


# --- the plan ---


def _check_plan(plan, h, w, stride, cin, cout, limit):
    pixels = cf.conv_out(h, stride) * cf.conv_out(w, stride)
    down = stride != 1 or cin != cout
    assert plan["frames"] >= 1 and plan["rows"] == plan["frames"] * pixels
    assert plan["m_tiles"] == -(-plan["rows"] // cf.M_TILE)
    assert plan["tiles_per_group"] == (1 if down else 2)
    assert plan["passes"] == -(-plan["m_tiles"] // (2 * plan["tiles_per_group"]))
    assert plan["n_tile"] in (32, 64, 128) and plan["n_tile"] * plan["n_tiles"] == cout
    assert cout % (2 * plan["n_tile"]) or plan["n_tile"] == 128  # the largest that divides
    assert plan["k_chunks"] == (-(-9 * cin // 128), -(-9 * cout // 128),
                                -(-cin // 128) if down else 0)
    assert cf.MIN_STAGES <= plan["stages"] <= cf.MAX_STAGES
    assert plan["chunk_bytes"] == plan["n_tile"] * cf.K_CHUNK
    # the bytes the C entry checks: slack, ring, x and y1 tiles, barriers
    tiles = plan["frames"] * (h * w * (cin + 16) + pixels * (cout + 16))
    assert plan["smem_bytes"] == 1024 + plan["stages"] * plan["chunk_bytes"] + tiles + 64
    assert plan["smem_bytes"] <= limit


@pytest.mark.parametrize("geom", range(8))
def test_plan_for_the_trunk_fills_m64_tiles(geom):
    (h, stride), cin, cout = TRUNK[geom]
    plan = cf.block_plan(h, h, stride, cin, cout)
    _check_plan(plan, h, h, stride, cin, cout, cf.SMEM_LIMIT_SM90)
    # whole m64 tiles with both warpgroups busy (at most 6 % of the rows
    # empty), or as many frames as the shared memory holds beside a 2-slot ring
    slots = 2 * cf.M_TILE * -(-plan["m_tiles"] // 2)
    full = cf.block_smem_bytes(plan["frames"] + 1, cf.MIN_STAGES, h, h, stride, cin,
                               cout) > cf.SMEM_LIMIT_SM90
    assert plan["rows"] / slots >= 0.94 or full, (plan["rows"], slots)
    # the ring takes the slots that fit beside the frames
    deeper = cf.block_smem_bytes(plan["frames"], plan["stages"] + 1, h, h, stride, cin, cout)
    assert plan["stages"] == cf.MAX_STAGES or deeper > cf.SMEM_LIMIT_SM90
    # layer3 / layer4: the weight is large, so a pass takes every row of the CTA
    if cin >= 256 and stride == 1:
        assert plan["passes"] == 1


def test_plan_for_the_trunk_on_an_h100():
    got = [(cf.block_plan(h, h, s, cin, cout)["frames"],
            cf.block_plan(h, h, s, cin, cout)["rows"]) for (h, s), cin, cout in TRUNK]
    assert got == [(3, 867), (3, 867), (3, 243), (6, 486), (10, 250), (10, 250), (14, 126),
                   (20, 180)]


@pytest.mark.parametrize("limit", [cf.SMEM_LIMIT_SM90, 101376, 49152])
@pytest.mark.parametrize("cin, cout", [(32, 32), (64, 96), (96, 64), (256, 512)])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h, w", [(3, 3), (5, 7), (9, 9), (17, 17), (12, 20)])
def test_plan_over_odd_shapes_and_limits(h, w, stride, cin, cout, limit):
    down = stride != 1 or cin != cout
    try:
        plan = cf.block_plan(h, w, stride, cin, cout, smem_limit=limit)
    except ValueError as e:
        # refused only because not even one frame fits with the smallest ring
        assert "shared memory" in str(e)
        assert cf.block_smem_bytes(1, cf.MIN_STAGES, h, w, stride, cin, cout) > limit
        return
    _check_plan(plan, h, w, stride, cin, cout, limit)
    assert (plan["k_chunks"][2] > 0) == down


def test_plan_spreads_a_small_batch_over_the_card():
    """A streaming tick has 288 frames: 20 frames a CTA would leave 15 CTAs
    on 132 SMs."""
    assert cf.block_plan(3, 3, 1, 512, 512)["frames"] == 20
    small = cf.block_plan(3, 3, 1, 512, 512, n_frames=288, sm_count=132)
    assert small["frames"] == 3 and small["m_tiles"] == 1
    assert cf.block_plan(17, 17, 1, 64, 64, n_frames=37, sm_count=132)["frames"] == 1


@pytest.mark.parametrize("args, why", [
    ((5, 5, 1, 48, 64), "Cin % 32"), ((5, 5, 1, 64, 80), "Cout % 32"),
    ((5, 5, 3, 64, 64), "stride"), ((0, 5, 1, 64, 64), "geometry"),
    ((64, 64, 1, 64, 64), "shared memory")])
def test_plan_refuses_with_a_reason(args, why):
    with pytest.raises(ValueError):
        cf.block_plan(*args)
    with pytest.raises(ValueError, match="identity"):
        cf.block_plan(5, 5, 2, 64, 64, down=False)


def test_source_constants_match_the_plan():
    """The geometry the plan assumes is the geometry the source compiles."""
    src = (_build.CSRC / "int8_basic_block.cu").read_text()
    const = {k: v for k, v in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    assert int(const["NCONS"]) == 128 * cf.CONSUMER_GROUPS
    assert int(const["PAD"]) == cf.SMEM_PAD and int(const["KCHUNK"]) == cf.K_CHUNK
    assert int(const["MAX_STAGES"]) == cf.MAX_STAGES and int(const["ALIGN"]) == cf.SMEM_ALIGN
    assert "stages < 2" in src and cf.MIN_STAGES == 2
    # one instantiation per n tile and shortcut, MT as the plan's tiles_per_group
    for nt in (128, 64, 32):
        assert f"launch<{nt}, 1, true>" in src and f"launch<{nt}, 2, false>" in src
        assert f"m64n{nt}k32.s32.s8.s8" in src
    # the products are wgmma on weights staged by asynchronous bulk copies
    assert "wgmma.mma_async" in src and "mma.sync" not in src
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    assert "__ldg(wp" not in src  # no weight fragment from global memory


# --- the packing ---


def unpack_tiles(tiles, k):
    """The inverse of ``pack_tiles``: (n tiles, k chunks, n_tile, 128) int8
    -> (Cout, k) int8 (the swizzle c ^ (n % 8) is its own inverse)."""
    n_tiles, kc, nt, _ = tiles.shape
    idx = cf._swizzle_index(nt, tiles.device)
    t = tiles.view(n_tiles, kc, nt, 8, 16)[:, :, torch.arange(nt)[:, None], idx]
    return t.permute(0, 2, 1, 3, 4).reshape(n_tiles * nt, kc * 128)[:, :k].contiguous()


@pytest.mark.parametrize("cin, cout", [(32, 32), (64, 64), (64, 128), (96, 192), (128, 256)])
def test_pack_tiles_round_trips(cin, cout):
    rng = np.random.default_rng(cin + cout)
    hwio3 = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8))
    hwio1 = torch.from_numpy(rng.integers(-127, 128, (1, 1, cin, cout)).astype(np.int8))
    for w in (cf.pack_conv3(hwio3), cf.pack_conv1(hwio1)):
        k = w.shape[1]
        tiles = cf.pack_tiles(w)
        nt = cf.n_tile(cout)
        assert tiles.shape == (cout // nt, -(-k // 128), nt, 128) and tiles.dtype == torch.int8
        assert tiles.is_contiguous()
        assert torch.equal(unpack_tiles(tiles, k), w)
        # the image: 16-byte group c of row n lies at group c ^ (n % 8); k padded with zeros
        for n, kk in ((0, 0), (5, 17), (cout - 1, k - 1), (nt // 2 + 3, k // 2)):
            i, r, j, kb = n // nt, n % nt, kk // 128, kk % 128
            assert tiles[i, j, r, ((kb // 16) ^ (r % 8)) * 16 + kb % 16] == w[n, kk]
        if k % 128:
            last = unpack_tiles(tiles, tiles.shape[1] * 128)[:, k:]
            assert not last.any()


def test_pack_tiles_refuses_other_widths():
    with pytest.raises(ValueError):
        cf.pack_tiles(torch.zeros(48, 288, dtype=torch.int8))


# --- the tiling, emulated ---


def _im2col(src, rows, pixels, wo_n, stride, pad, taps):
    """Rows of the implicit GEMM: src (F, Hs, Ws, C) int8, output pixel r of
    the CTA -> (len(rows), taps * C) int64, zeros for padding."""
    _, hs, ws, c = src.shape
    kw = 3 if taps == 9 else 1
    out = torch.zeros(len(rows), taps * c, dtype=torch.int64)
    for n, r in enumerate(rows):
        f, p = divmod(r, pixels)
        ho, wo = divmod(p, wo_n)
        for tap in range(taps):
            dy, dx = divmod(tap, kw)
            hi, wi = ho * stride - pad + dy, wo * stride - pad + dx
            if 0 <= hi < hs and 0 <= wi < ws:
                out[n, tap * c:(tap + 1) * c] = src[f, hi, wi].long()
    return out


def block_tiled(x, spec, stride, plan):
    """``int8_basic_block``'s tiling in plain PyTorch: what each CTA, pass,
    warpgroup tile, n tile and k chunk computes, the chunks taken from the
    packed weights in the producer's order."""
    n, h, w, cin = x.shape
    cout = spec["w1"].shape[0]
    t1, t2, td = cf.pack_block_tiles(spec["w1"], spec["w2"], spec.get("wd"))
    frames, nt, n_tiles, per_group = (plan[k] for k in ("frames", "n_tile", "n_tiles",
                                                        "tiles_per_group"))
    kc1, kc2, kcd = plan["k_chunks"]
    ho_n, wo_n = cf.conv_out(h, stride), cf.conv_out(w, stride)
    pixels = ho_n * wo_n
    col = lambda v, i: v.float()[i * nt:(i + 1) * nt]  # noqa: E731
    out = torch.empty(n, pixels, cout, dtype=torch.int8)
    for f0 in range(0, n, frames):
        xt = x[f0:f0 + frames]
        m = xt.shape[0] * pixels  # the last CTA may be ragged
        tiles = -(-m // 64)
        passes = [[t for t in range(p * 2 * per_group, (p + 1) * 2 * per_group) if t < tiles]
                  for p in range(-(-tiles // (2 * per_group)))]

        def producer():
            for _ in passes:
                for i in range(n_tiles):
                    yield from t1[i]
            for _ in passes:
                for i in range(n_tiles):
                    if td is not None:
                        yield from td[i]
                    yield from t2[i]

        ring = producer()

        def gemm(src, s, pad, taps, tile_ids, n_chunks, pix, wn):
            chunks = [unpack_tiles(next(ring)[None, None], 128).long()
                      for _ in range(n_chunks)]
            accs = {}
            for t in tile_ids:  # two warpgroups, ``per_group`` tiles each
                a = _im2col(src, range(t * 64, min(t * 64 + 64, m)), pix, wn, s, pad, taps)
                a = torch.nn.functional.pad(a, (0, n_chunks * 128 - a.shape[1]))
                accs[t] = sum(a[:, j * 128:(j + 1) * 128] @ ch.t()
                              for j, ch in enumerate(chunks))
            return accs

        y1 = torch.zeros(m, cout, dtype=torch.int8)
        for tile_ids in passes:
            for i in range(n_tiles):
                for t, acc in gemm(xt, stride, 1, 9, tile_ids, kc1, pixels, wo_n).items():
                    v = acc.float() * col(spec["a1"], i) + col(spec["b1"], i)
                    y1[t * 64:t * 64 + 64, i * nt:(i + 1) * nt] = cf._requant(v).to(torch.int8)
        y1t = y1.view(xt.shape[0], ho_n, wo_n, cout)
        for tile_ids in passes:
            for i in range(n_tiles):
                if td is not None:
                    accd = gemm(xt, stride, 0, 1, tile_ids, kcd, pixels, wo_n)
                for t, acc in gemm(y1t, 1, 1, 9, tile_ids, kc2, pixels, wo_n).items():
                    rows = slice(t * 64, min(t * 64 + 64, m))
                    y2 = acc.float() * col(spec["a2"], i) + col(spec["b2"], i)
                    if td is not None:
                        res = accd[t].float() * col(spec["ad"], i) + col(spec["bd"], i)
                    else:  # identity: row r is pixel r of the x tile
                        res = (xt.reshape(-1, cin)[rows, i * nt:(i + 1) * nt].float()
                               * torch.as_tensor(spec["res_scale"], dtype=torch.float32))
                    out[f0:f0 + frames].view(-1, cout)[rows, i * nt:(i + 1) * nt] = \
                        cf._requant(y2 + res).to(torch.int8)
        assert next(ring, None) is None  # the consumers ate what the producer sent
    return out.view(n, ho_n, wo_n, cout)


def _random_spec(cin, cout, stride, seed, down=None):
    """Seeded int8 weights and folded vectors, scaled so that the requantised
    values spread over [0, 127]."""
    g = torch.Generator().manual_seed(seed)
    w = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    vec = lambda lo, hi: torch.rand(cout, generator=g) * (hi - lo) + lo  # noqa: E731
    spec = {"w1": w(cout, 9 * cin), "w2": w(cout, 9 * cout),
            "a1": vec(0.5, 1.5) * 64 / (73 * 73 * (9 * cin) ** 0.5), "b1": vec(-20, 20),
            "a2": vec(0.5, 1.5) * 64 / (73 * 40 * (9 * cout) ** 0.5), "b2": vec(-20, 20)}
    if down if down is not None else (stride != 1 or cin != cout):
        spec.update(wd=w(cout, cin), ad=vec(0.5, 1.5) * 64 / (73 * 73 * cin ** 0.5),
                    bd=vec(-20, 20))
    else:
        spec["res_scale"] = torch.tensor(0.37)
    return spec


# (n, h, w, stride, cin, cout, frames a CTA or None for the plan's): identity
# and downsample shortcuts, every n tile width, several n tiles and passes, a
# ragged last CTA (37 = 5 x 7 + 2), one warpgroup without a tile (9 rows)
TILED = [(37, 3, 3, 1, 64, 64, 7), (16, 5, 5, 1, 32, 32, None), (16, 5, 5, 2, 32, 64, None),
         (16, 5, 5, 1, 32, 64, None), (9, 5, 4, 1, 32, 256, 7), (5, 9, 9, 2, 32, 96, None),
         (3, 3, 3, 1, 32, 32, 1), (30, 5, 5, 1, 32, 32, 12)]


@pytest.mark.parametrize("n, h, w, stride, cin, cout, frames", TILED)
def test_tiled_block_matches_plain_bit_for_bit(n, h, w, stride, cin, cout, frames):
    spec = _random_spec(cin, cout, stride, seed=n + cout)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (n, h, w, cin), generator=g, dtype=torch.int8)
    plan = cf.block_plan(h, w, stride, cin, cout)
    if frames is not None:
        plan = {**plan, "frames": frames}
    got = block_tiled(x, spec, stride, plan)
    ref = cf.basic_block_int8_plain(x, *cf._block_args(spec), stride=stride)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert torch.equal(got, ref)
    assert 0 < (ref > 0).float().mean() < 1 and ref.max() == 127  # a spread-out output


def _rand_bn(rng, c):
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": (rng.normal(size=c) * 0.1).astype(np.float32)}
    stats = {"mean": (rng.normal(size=c) * 0.5).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return params, stats


@pytest.mark.parametrize("stride, cin, cout, seed", [(1, 32, 32, 0), (2, 32, 64, 1),
                                                     (1, 32, 64, 2)])
def test_tiled_block_matches_pallas(stride, cin, cout, seed):
    """The emulated kernel against the JAX Pallas kernel in interpret mode on
    the same folded block, h = 5, n = 16 (the sizes of
    test_basic_block_plain_matches_pallas, and its bar: <= 1 LSB on under 1 %
    of the outputs, since XLA's rsqrt and torch's may differ by an ulp in
    the folded vectors)."""
    h, n = 5, 16
    rng = np.random.default_rng(seed)
    conv = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    params = {"conv1": {"kernel": conv(3, 3, cin, cout)},
              "conv2": {"kernel": conv(3, 3, cout, cout)}}
    stats = {}
    params["bn1"], stats["bn1"] = _rand_bn(rng, cout)
    params["bn2"], stats["bn2"] = _rand_bn(rng, cout)
    if stride != 1 or cin != cout:
        params["downsample_conv"] = {"kernel": conv(1, 1, cin, cout)}
        params["downsample_bn"], stats["downsample_bn"] = _rand_bn(rng, cout)
    x_q = rng.integers(-127, 128, size=(n, h, h, cin)).astype(np.int8)
    x_scale, q1_s = np.float32(0.05), np.float32(0.04)
    qo_s = np.float32(2.5 * q1_s)
    spec_j = jcp.fold_block(x_scale, params, stats, q1_s, qo_s)
    planes = np.asarray(jcp.basic_block_int8(
        jcp.nhwc_to_planes(jnp.asarray(x_q)), spec_j["w1"], spec_j["a1"], spec_j["b1"],
        spec_j["w2"], spec_j["a2"], spec_j["b2"], wd=spec_j.get("wd"), ad=spec_j.get("ad"),
        bd=spec_j.get("bd"), res_scale=spec_j.get("res_scale"), H=h, W=h, stride=stride, tn=8))
    ho = (h - 1) // stride + 1
    ref = planes.reshape(ho + 2, ho + 2, cout, n)[1:-1, 1:-1].transpose(3, 0, 1, 2)

    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tparams = {k: t(v["kernel"].transpose(3, 2, 0, 1)) for k, v in params.items()
               if "conv" in k}
    for bn in ("bn1", "bn2", "downsample_bn"):
        if bn in params:
            tparams[bn] = tuple(t(a) for a in (params[bn]["scale"], params[bn]["bias"],
                                               stats[bn]["mean"], stats[bn]["var"]))
    spec = cf.fold_block(torch.tensor(x_scale), tparams, torch.tensor(q1_s),
                         torch.tensor(qo_s))
    assert [None if a is None else tuple(a.shape) for a in spec["tiles"]] == [
        (cout // cf.n_tile(cout), -(-9 * cin // 128), cf.n_tile(cout), 128),
        (cout // cf.n_tile(cout), -(-9 * cout // 128), cf.n_tile(cout), 128),
        (cout // cf.n_tile(cout), 1, cf.n_tile(cout), 128) if "wd" in spec else None]
    got = block_tiled(t(x_q), spec, stride, cf.block_plan(h, h, stride, cin, cout)).numpy()
    assert got.shape == ref.shape == (n, ho, ho, cout)
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff == 1).mean() < 0.01


def test_cpu_block_takes_the_plain_version_and_ignores_tiles():
    spec = _random_spec(32, 32, 1, seed=3)
    x = torch.randint(0, 128, (3, 5, 5, 32), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(2))
    before = dict(cf.launches)
    ref = cf.basic_block_int8_plain(x, *cf._block_args(spec), stride=1)
    tiles = cf.pack_block_tiles(spec["w1"], spec["w2"])
    assert torch.equal(cf.basic_block_int8(x, *cf._block_args(spec), stride=1, tiles=tiles), ref)
    assert torch.equal(cf.basic_block_int8(x, *cf._block_args(spec), stride=1), ref)
    assert cf.launches == before  # CPU tensors launch nothing


# --- the fold cache ---


@pytest.fixture(scope="module")
def int8_trunk():
    """A ResNet-18 with static scales recorded from one calibration batch,
    on the fused path (plain K2 / K3 on the CPU), and two frames."""
    trunk = ResNet18(quant_int8=True, quant_mode="calibrate",
                     generator=torch.Generator().manual_seed(3)).eval()
    frames = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 1, 67, 67)).astype(np.float32))
    with torch.no_grad():
        trunk(frames)
    trunk.quant_mode, trunk.stages_pallas = "static", True
    return trunk, frames


def _change(trunk, kind):
    with torch.no_grad():
        if kind == "weight":
            trunk.layer2_0.conv1.weight.mul_(1.5)
        elif kind == "bn_statistic":
            trunk.layer1_1.bn2.running_var.add_(0.7)
        elif kind == "scale":
            trunk.layer3_0.q1.mul_(2.0)
        elif kind == "stem":
            trunk.bn1.bias.add_(0.2)
        elif kind == "load_state_dict":
            state = {k: v.clone() for k, v in trunk.state_dict().items()}
            state["layer4_1.conv2.weight"] *= 0.5
            trunk.load_state_dict(state)
        else:
            trunk.layer2_1.bn1.weight = torch.nn.Parameter(trunk.layer2_1.bn1.weight * 1.3)


@pytest.mark.parametrize("kind", ["weight", "bn_statistic", "scale", "stem",
                                  "load_state_dict", "assignment"])
def test_fold_is_kept_until_a_tensor_changes(int8_trunk, kind):
    trunk, frames = copy.deepcopy(int8_trunk[0]), int8_trunk[1]
    with torch.no_grad():
        first = trunk(frames)
        fold = trunk.folded()
        assert trunk.folded() is fold  # kept from forward to forward
        assert len(fold[2]) == 8 and all("tiles" in spec for spec in fold[2])
        again = trunk(frames)
        assert trunk.folded() is fold and torch.equal(again, first)
        _change(trunk, kind)
        changed = trunk(frames)
        assert trunk.folded() is not fold
        # a copy has never folded: its first forward folds the changed tensors
        fresh = copy.deepcopy(trunk)
        fresh._fold = None
        assert torch.equal(changed, fresh(frames))
    assert not torch.equal(changed, first)
