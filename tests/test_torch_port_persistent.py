"""The persistent LSTM kernels' plan, bindings and tiling, on the CPU.

``csrc/lstm_persistent.cu`` runs only on a card. What the CPU can hold:
the pure-Python plan that routes a shape to the persistent or the
per-step kernels (the probe's too); the ctypes signatures against the C
declarations; and the kernels' tiling (hidden units and batch tiles over
CTAs, k over k-groups, partials summed in the kernels' order, and the
probe's cuts of the inference kernel) as a plain emulation against the
plain versions and against the JAX package's Pallas kernels in interpret
mode.
"""

import functools
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.ops.lstm_pallas import _bwd_call, _fwd_infer_call, _fwd_train_call
from avvad_tpu_torch.ops import _build, lstm_fused

# fp32 recurrences in another summation order: a few ulp of unit-scale values
ATOL_F32 = 1e-5
H100_SMS = 132
FWD, BWD = "fwd_train_persist", "bwd_persist"


# --- the plan ---


def _plan_parts(b, h):
    units, rows = lstm_fused.PERSIST_UNITS, lstm_fused.PERSIST_ROWS
    ring = lstm_fused.PERSIST_STAGES * rows * (lstm_fused.PERSIST_CHUNK + 8) * 4
    return units, rows, -(-h // units), -(-b // rows), ring


@pytest.mark.parametrize("smem_limit", [lstm_fused.SMEM_LIMIT_SM90, 101376])
@pytest.mark.parametrize("sm_count", [132, 46])
@pytest.mark.parametrize("h", [4, 96, 100, 256, 1024, 1056, 1100, 1280, 4096])
@pytest.mark.parametrize("b", [1, 16, 19, 64])
def test_plan_owns_every_cell_once_and_fits(b, h, sm_count, smem_limit):
    plan = lstm_fused.persistent_plan(b, h, sm_count, smem_limit)
    units, rows, unit_slices, tiles, ring = _plan_parts(b, h)
    if plan is None:
        # refused only for a reason the rule names: not one row slice fits
        # the card, or the forward's shared memory (the larger) is over the limit
        least = 128 * h + ring + 40960 + -(-tiles // max(1, sm_count // unit_slices)) * 512
        assert unit_slices > sm_count or least > smem_limit
        return
    gx, gy = plan["grid"]
    assert (plan["units"], plan["rows"]) == (units, rows)
    owners = np.zeros((b, h), int)
    for x in range(gx):
        for r in range(gy):
            for tile in range(r, tiles, gy):  # dealt round-robin
                owners[tile * rows:(tile + 1) * rows, x * units:(x + 1) * units] += 1
    assert (owners == 1).all()
    assert (gx - 1) * units < h and 1 <= gy <= tiles  # no CTA without a cell
    assert gx * gy <= sm_count  # co-resident with one CTA an SM
    assert gy == tiles or gx * (gy + 1) > sm_count  # as many row slices as fit
    for variant, nbytes in plan["smem_bytes"].items():
        # the weight slice, the ring, the partials and the state of its tiles
        assert nbytes >= 128 * h + ring + 32768 + -(-tiles // gy) * rows * units * 4
        assert nbytes <= smem_limit, variant


def test_plan_for_the_training_shape_on_an_h100():
    plan = lstm_fused.persistent_plan(16, 1024, H100_SMS)
    assert plan["grid"] == (64, 2) and plan["units"] == 16 and plan["rows"] == 8
    assert plan["smem_bytes"] == {FWD: 222464, BWD: 214272}


@pytest.mark.parametrize("b, h, why", [
    (16, 1120, "a 140 KB weight slice"), (16, 1280, "a 160 KB weight slice"),
    (16, 2048, "a 256 KB weight slice"), (3, 2128, "133 unit slices on 132 SMs"),
    (3, 1030, "rows not 16-byte"), (16, 1022, "rows not 16-byte"), (4, 2, "H < 4"),
    (0, 1024, "no rows"), (400, 1024, "the state of 25 tiles a CTA")])
def test_plan_routes_unfit_shapes_to_the_per_step_kernels(b, h, why):
    assert lstm_fused.persistent_plan(b, h, H100_SMS) is None, why


@pytest.mark.parametrize("b, t, h", [(3, 7, 1024), (5, 4, 96), (16, 64, 1024), (4, 33, 256),
                                     (2, 5, 64), (16, 512, 1024), (3, 6, 100), (64, 16, 1056),
                                     (40, 9, 1024)])
def test_plan_takes_the_card_tests_shapes(b, t, h):
    assert lstm_fused.persistent_plan(b, h, H100_SMS) is not None


def test_plan_shrinks_with_the_shared_memory_and_the_card():
    assert lstm_fused.persistent_plan(16, 1024, 108)["grid"] == (64, 1)  # an A100's SM count
    assert lstm_fused.persistent_plan(16, 1024, 46) is None
    assert lstm_fused.persistent_plan(16, 512, 132)["grid"] == (32, 2)
    assert lstm_fused.persistent_plan(64, 256, 132)["grid"] == (16, 8)
    assert lstm_fused.persistent_plan(16, 1024, 132, smem_limit=166912) is None
    assert lstm_fused.persistent_plan(16, 512, 132, smem_limit=166912) is not None


# --- the inference route ---


@pytest.mark.parametrize("sm_count", [132, 108, 46, 12])
@pytest.mark.parametrize("h", [32, 100, 128, 1024, 1030, 1096, 1100, 1280])
@pytest.mark.parametrize("b", [1, 3, 16, 19, 64, 400])
def test_inference_route_follows_the_plan(b, h, sm_count):
    """``lstm_layer_fused`` launches ``lstm_f32h_persist`` for "none" exactly
    where the plan takes the shape and the inference kernel's shared memory
    fits too; "bf16" and "int8" go to ``lstm_bf16h_persist`` /
    ``lstm_int8_persist`` where the plan takes the shape and their shared
    memory fits, else stay per step."""
    plan = lstm_fused.persistent_plan(b, h, sm_count)
    got = lstm_fused.infer_variant("none", b, h, sm_count)
    assert got == ("none_persist" if plan is not None and plan["infer"] else "none")
    for sq in ("bf16", "int8"):
        fits = plan is not None and plan["infer_" + sq]
        assert lstm_fused.infer_variant(sq, b, h, sm_count) == (sq + "_persist" if fits else sq)
    if plan is None:
        return
    gx, gy = plan["grid"]
    tiles = -(-b // plan["rows"])
    # pairs of batch tiles exactly where a CTA walks two or more
    assert plan["infer_pairs"] == (tiles > gy)
    state = -(-tiles // gy) * plan["rows"] * plan["units"] * 4
    want = plan["smem_bytes"][FWD] if not plan["infer_pairs"] else (
        128 * h + 3 * 16 * (256 + 8) * 4 + 8 * 16 * 80 * 4 + state)
    assert plan["infer_smem_bytes"] == want
    assert plan["infer"] == (want <= lstm_fused.SMEM_LIMIT_SM90)


def test_inference_plan_for_the_serving_shape_on_an_h100():
    plan = lstm_fused.persistent_plan(64, 1024, H100_SMS)
    assert plan["grid"] == (64, 2) and plan["infer"] and plan["infer_pairs"]
    assert plan["infer_smem_bytes"] == 224768  # 4 batch tiles a CTA, in two pairs
    assert lstm_fused.infer_variant("none", 64, 1024, H100_SMS) == "none_persist"
    # outside the plan: the per-step kernel
    assert lstm_fused.infer_variant("none", 3, 1030, H100_SMS) == "none"
    assert lstm_fused.infer_variant("none", 64, 2048, H100_SMS) == "none"
    # the pairs' ring is 768 bytes larger than the training forward's: at the
    # edge of the shared memory the plan takes a shape for training alone
    edge = lstm_fused.persistent_plan(16, 1096, H100_SMS)
    assert edge is not None and edge["infer_pairs"] and not edge["infer"]
    assert lstm_fused.infer_variant("none", 16, 1096, H100_SMS) == "none"
    assert lstm_fused.infer_variant("none", 16, 1092, H100_SMS) == "none_persist"


# --- the bindings ---


def _c_entries():
    """{name: [is_pointer per parameter]} of every extern "C" function."""
    entries = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            entries[name] = ["*" in p for p in params.split(",")]
    return entries


def test_signatures_name_every_c_entry():
    entries = _c_entries()
    assert {"lstm_fwd_train_persist", "lstm_bwd_persist", "lstm_fwd_train_f32h",
            "lstm_bwd_f32h", "lstm_f32h_persist", "int8_basic_block"} <= set(entries)
    assert set(_build.SIGNATURES) == set(entries)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    import ctypes

    want = [ctypes.c_void_p if ptr else ctypes.c_int for ptr in _c_entries()[name]]
    assert _build.SIGNATURES[name] == want


def test_kernel_names_are_bound_entries():
    assert set(lstm_fused.KERNEL_NAMES.values()) <= set(_build.SIGNATURES)
    assert set(lstm_fused.TRAIN_KERNELS) <= set(lstm_fused.launch_counts())
    assert set(lstm_fused.PERSIST_K_GROUPS) == {FWD, BWD}


def test_source_constants_match_the_plan():
    """The geometry the plan assumes is the geometry the source compiles."""
    src = (_build.CSRC / "lstm_persistent.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["U"] == lstm_fused.PERSIST_UNITS and const["BT"] == lstm_fused.PERSIST_ROWS
    assert const["KC"] == lstm_fused.PERSIST_CHUNK
    assert const["NSTAGE"] == lstm_fused.PERSIST_STAGES
    warps = const["NT"] // 32
    # Tile<8> (forward, 64 columns) and Tile<2> (backward, 16 columns): a
    # k-group is 2 x NCG threads
    assert "typedef Tile<8> TL;" in src and "typedef Tile<2> TL;" in src
    assert lstm_fused.PERSIST_K_GROUPS == {FWD: warps * 16 // 8, BWD: warps * 16 // 2}
    # a chunk holds a whole number of rounds of the k-groups
    assert all(const["KC"] // 4 % kg == 0 for kg in lstm_fused.PERSIST_K_GROUPS.values())
    # the inference kernel: pairs of tiles, shorter chunks, a partial a warp
    assert const["KCI"] == lstm_fused.PERSIST_INFER_CHUNK
    assert "constexpr int PAIR = 2 * BT;" in src and "constexpr int KG_I = NWARP;" in src
    assert warps == lstm_fused.PERSIST_INFER_K_GROUPS
    assert const["KCI"] // 4 % (2 * warps) == 0
    # one launch: the weight slice is loaded before the time loop, once
    infer = src[src.index("lstm_infer_persist_kernel("):src.index("// Backward: CTA")]
    assert infer.index("wsm + (size_t)slot") < infer.index("for (int t = 0; t < T; ++t)")


# --- the tiling, emulated ---


def _contract(a, w, k_groups, chains):
    """a (rows, K) . w (K, cols) as the kernels sum it: k-group q takes the
    groups of four k with index q mod k_groups; the partials are summed in
    order, in ``chains`` interleaved chains that are joined pairwise."""
    group = (torch.arange(a.shape[1]) // 4) % k_groups
    partial = [a[:, group == q] @ w[group == q] for q in range(k_groups)]
    sums = [sum(partial[e::chains][1:], partial[e]) for e in range(chains)]
    while len(sums) > 1:
        sums = [x + y for x, y in zip(sums[::2], sums[1::2])]
    return sums[0]


def _ctas(plan, b, h):
    """(units j, [row slices of its tiles]) of every CTA of the plan's grid."""
    (gx, gy), units, rows = plan["grid"], plan["units"], plan["rows"]
    tiles = [slice(b0, min(b0 + rows, b)) for b0 in range(0, b, rows)]
    return [(torch.arange(x * units, min((x + 1) * units, h)), tiles[r::gy])
            for x in range(gx) for r in range(gy)]


def fwd_train_tiled(xp, w, h0, c0, sm_count=H100_SMS):
    """``lstm_fwd_train_persist``'s tiling in plain PyTorch."""
    b, t, h4 = xp.shape
    h = h4 // 4
    plan = lstm_fused.persistent_plan(b, h, sm_count)
    wd = lstm_fused._bf16_rounded(w)
    y, c_seq, gates = torch.empty(b, t, h), torch.empty(b, t, h), torch.empty(b, t, h4)
    c = c0.clone()  # each CTA keeps its own columns
    for step in range(t):
        h_in = h0 if step == 0 else y[:, step - 1]  # the exchange
        for j, tiles in _ctas(plan, b, h):
            cols = torch.cat([g * h + j for g in range(4)])
            for rows in tiles:
                pre = xp[rows, step][:, cols] + _contract(
                    h_in[rows], wd[:, cols], lstm_fused.PERSIST_K_GROUPS[FWD], chains=1)
                i, f, g, o = pre.split(len(j), dim=-1)
                i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                cn = f * c[rows][:, j] + i * g
                c[rows.start:rows.stop, j] = cn
                c_seq[rows, step, j] = cn
                gates[rows, step, cols] = torch.cat([i, f, g, o], dim=-1)
        # y[:, step] once every CTA has done its step
        y[:, step] = gates[:, step, 3 * h:] * torch.tanh(c_seq[:, step])
    return y, c_seq, gates


def _contract_pairs(a, w):
    """a (16 rows, K) . w (K, cols) as the inference kernel sums it: 16
    k-groups by the group of four k, the two of a warp added (a shuffle),
    the 8 warps' partials summed in order by the cell's owner."""
    group = (torch.arange(a.shape[1]) // 4) % 16
    partial = [a[:, group == q] @ w[group == q] for q in range(16)]
    warps = [partial[2 * v] + partial[2 * v + 1] for v in range(8)]
    return sum(warps[1:], warps[0])


def infer_tiled(xp, w, h0, c0, sm_count=H100_SMS, cut="full"):
    """``lstm_f32h_persist``'s tiling in plain PyTorch: a CTA walks its batch
    tiles in pairs where it has two or more (a last one alone), else it is
    the training forward without its residuals; a barrier a step. ``cut``:
    the probe's variant of it (``lstm_probe_persist``): "gates_only" without
    the exchange's loads and the product, "matmul_only" without the gate
    math (h = the i columns' sums, c unchanged)."""
    b, t, h4 = xp.shape
    h = h4 // 4
    plan = lstm_fused.persistent_plan(b, h, sm_count)
    assert plan["infer"]
    wd = lstm_fused._bf16_rounded(w)
    y, c = torch.empty(b, t, h), c0.clone()
    for step in range(t):
        h_in = h0 if step == 0 else y[:, step - 1]  # the exchange
        h_out = torch.empty(b, h)
        for j, tiles in _ctas(plan, b, h):
            cols = torch.cat([g * h + j for g in range(4)])
            groups = ([tiles[i:i + 2] for i in range(0, len(tiles), 2)]
                      if plan["infer_pairs"] else [[tile] for tile in tiles])
            for group in groups:
                rows = torch.cat([torch.arange(r.start, r.stop) for r in group])
                if cut == "gates_only":
                    rec = 0.0
                elif plan["infer_pairs"]:
                    rec = _contract_pairs(h_in[rows], wd[:, cols])
                else:
                    rec = _contract(h_in[rows], wd[:, cols], lstm_fused.PERSIST_K_GROUPS[FWD],
                                    chains=1)
                pre = xp[rows, step][:, cols] + rec
                if cut == "matmul_only":
                    h_out[rows[:, None], j[None]] = pre[:, :len(j)]
                    continue
                i, f, g, o = pre.split(len(j), dim=-1)
                i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                cn = f * c[rows][:, j] + i * g
                c[rows[:, None], j[None]] = cn
                h_out[rows[:, None], j[None]] = o * torch.tanh(cn)
        y[:, step] = h_out  # read only after every CTA has done its step
    return y


def bwd_tiled(dy, gates, c_seq, c_prev, w):
    """``lstm_bwd_persist``'s tiling in plain PyTorch."""
    b, t, h4 = gates.shape
    h = h4 // 4
    plan = lstm_fused.persistent_plan(b, h, H100_SMS)
    wt = lstm_fused._bf16_rounded(w).t().contiguous()
    kg = lstm_fused.PERSIST_K_GROUPS[BWD]
    d_gates, dh0, dc = torch.empty(b, t, h4), torch.empty(b, h), torch.zeros(b, h)
    for step in reversed(range(t)):
        for j, tiles in _ctas(plan, b, h):
            for rows in tiles:
                dh = dy[rows, step][:, j]
                if step < t - 1:
                    dh = dh + _contract(d_gates[rows, step + 1], wt[:, j], kg, chains=4)
                i, f, g, o = (gates[rows, step][:, gi * h + j] for gi in range(4))
                tanh_c = torch.tanh(c_seq[rows, step][:, j])
                dcv = dh * o * (1.0 - tanh_c * tanh_c) + dc[rows][:, j]
                d_pre = [dcv * g * i * (1.0 - i), dcv * c_prev[rows, step][:, j] * f * (1.0 - f),
                         dcv * i * (1.0 - g * g), dh * tanh_c * o * (1.0 - o)]
                for gi in range(4):
                    d_gates[rows, step, gi * h + j] = d_pre[gi]
                dc[rows.start:rows.stop, j] = dcv * f
    for j, tiles in _ctas(plan, b, h):  # the last step of the same launch
        for rows in tiles:
            dh0[rows.start:rows.stop, j] = _contract(d_gates[rows, 0], wt[:, j], kg, chains=4)
    return d_gates, dh0, dc


def _inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, t, 4 * h)), rng.normal(size=(h, 4 * h)) * 0.3,
              np.tanh(rng.normal(size=(b, h))), rng.normal(size=(b, h)),
              rng.normal(size=(b, t, h)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _tm(a):
    """batch-major (B, T, ...) <-> time-major (T, B, ...)"""
    return np.swapaxes(np.asarray(a), 0, 1)


# H = 100 and 36 are no multiple of the 16 units a CTA owns; B = 19 is three
# batch tiles, the last ragged, each with a row slice of its own, and B = 50
# at H = 128 seven tiles on the 16 row slices that fit; H = 128 has two rounds
# of the 16 k-groups
SHAPES = [(3, 7, 32), (5, 4, 96), (2, 5, 64), (3, 6, 100), (19, 3, 36), (4, 5, 128),
          (50, 2, 128)]


def test_tiled_emulation_walks_tiles_round_robin():
    """With fewer row slices than tiles a CTA walks several tiles, each with
    its own state: the same result on a card that holds 12 CTAs."""
    xp, w, h0, c0, dy = _inputs(50, 3, 64, seed=4)
    ref = fwd_train_tiled(xp, w, h0, c0)
    plan = lstm_fused.persistent_plan(50, 64, 12)
    assert plan["grid"] == (4, 3)
    assert [len(tiles) for _, tiles in _ctas(plan, 50, 64)] == [3, 2, 2] * 4
    got = fwd_train_tiled(xp, w, h0, c0, sm_count=12)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.parametrize("b, t, h", SHAPES)
def test_tiled_forward_matches_plain(b, t, h):
    xp, w, h0, c0, _ = _inputs(b, t, h, seed=0)
    got = fwd_train_tiled(xp, w, h0, c0)
    ref = lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=ATOL_F32)


@pytest.mark.parametrize("b, t, h", SHAPES)
def test_tiled_backward_matches_plain(b, t, h):
    xp, w, h0, c0, dy = _inputs(b, t, h, seed=1)
    _, c_seq, gates = lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0)
    c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
    got = bwd_tiled(dy, gates, c_seq, c_prev, w)
    ref = lstm_fused.lstm_bwd_plain(dy, gates, c_seq, c_prev, w)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=ATOL_F32)


@pytest.mark.parametrize("b, t, h", [(3, 7, 32), (3, 6, 100), (19, 3, 36)])
def test_tiled_kernels_match_pallas(b, t, h):
    """The emulated persistent kernels against the Pallas K1d and K1e in
    interpret mode (time-major, bf16 weight), from a nonzero state."""
    xp, w, h0, c0, dy = _inputs(b, t, h, seed=2)
    y_j, c_j, g_j = _fwd_train_call(jnp.asarray(_tm(xp)), jnp.asarray(w.numpy()),
                                    jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()),
                                    interpret=True, w_dtype=jnp.bfloat16)
    y, c_seq, gates = fwd_train_tiled(xp, w, h0, c0)
    for got, ref in ((y, y_j), (c_seq, c_j), (gates, g_j)):
        np.testing.assert_allclose(got.numpy(), _tm(ref), atol=ATOL_F32)
    c_prev = np.concatenate([c0.numpy()[:, None], _tm(c_j)[:, :-1]], axis=1)
    dg_j, dh0_j, dc0_j = _bwd_call(jnp.asarray(_tm(dy)), g_j, c_j, jnp.asarray(_tm(c_prev)),
                                   jnp.asarray(w.numpy()), interpret=True,
                                   w_dtype=jnp.bfloat16)
    dg, dh0, dc0 = bwd_tiled(dy, torch.from_numpy(_tm(g_j).copy()),
                             torch.from_numpy(_tm(c_j).copy()), torch.from_numpy(c_prev), w)
    np.testing.assert_allclose(dg.numpy(), _tm(dg_j), atol=ATOL_F32)
    np.testing.assert_allclose(dh0.numpy(), np.asarray(dh0_j), atol=ATOL_F32)
    np.testing.assert_allclose(dc0.numpy(), np.asarray(dc0_j), atol=ATOL_F32)


# (b, t, h, SMs): one tile a CTA; 7 tiles on 3 row slices (pairs and a tile
# alone); 8 tiles on 2 row slices (4 tiles a CTA, two pairs); a ragged last
# tile in a pair; H no multiple of the 16 units or of the 256-column chunk
INFER_SHAPES = [(3, 7, 32, 132), (50, 3, 64, 12), (64, 3, 128, 16), (19, 4, 36, 3),
                (13, 5, 100, 7), (40, 2, 96, 12)]


@pytest.mark.parametrize("b, t, h, sm_count", INFER_SHAPES)
def test_tiled_inference_matches_plain(b, t, h, sm_count):
    xp, w, h0, c0, _ = _inputs(b, t, h, seed=5)
    plan = lstm_fused.persistent_plan(b, h, sm_count)
    assert plan["infer_pairs"] == (b > 8 * plan["grid"][1])
    got = infer_tiled(xp, w, h0, c0, sm_count)
    ref = lstm_fused.lstm_layer_plain(xp, w, h0, c0)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL_F32)


def test_tiled_inference_has_four_tiles_a_cta_at_the_serving_batch():
    plan = lstm_fused.persistent_plan(64, 128, 16)
    assert plan["grid"] == (8, 2) and plan["infer_pairs"]
    assert [len(tiles) for _, tiles in _ctas(plan, 64, 128)] == [4] * 16


@pytest.mark.parametrize("b, t, h, sm_count", [(3, 7, 32, 132), (50, 3, 64, 12),
                                               (64, 3, 128, 16), (19, 4, 36, 3)])
def test_tiled_inference_matches_pallas(b, t, h, sm_count):
    """The emulated inference kernel against the Pallas ``_fwd_infer_call``
    in interpret mode (time-major, bf16 weight), from a nonzero state."""
    xp, w, h0, c0, _ = _inputs(b, t, h, seed=6)
    y_j = _fwd_infer_call(jnp.asarray(_tm(xp)), jnp.asarray(w.numpy()),
                          jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()),
                          interpret=True, w_dtype=jnp.bfloat16)
    got = infer_tiled(xp, w, h0, c0, sm_count)
    np.testing.assert_allclose(got.numpy(), _tm(y_j), atol=ATOL_F32)


def test_contract_covers_every_k_once():
    """The k-groups partition k: with unit weights every group of four k
    lands in exactly one partial."""
    for kg, k in ((16, 100), (64, 400), (16, 1024), (64, 4096)):
        a = torch.arange(k, dtype=torch.float32)[None]
        got = _contract(a, torch.ones(k, 1), kg, chains=4 if kg == 64 else 1)
        assert got.item() == k * (k - 1) / 2
        assert _contract_pairs(a, torch.ones(k, 1)).item() == k * (k - 1) / 2


def test_cpu_tensors_take_the_plain_versions():
    xp, w, h0, c0, dy = _inputs(2, 3, 32, seed=3)
    before = lstm_fused.launch_counts()
    got = lstm_fused.lstm_fwd_train(xp, w, h0, c0)
    ref = lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    c_prev = torch.cat([c0[:, None], got[1][:, :-1]], dim=1)
    got = lstm_fused.lstm_bwd(dy, got[2], got[1], c_prev, w)
    ref = lstm_fused.lstm_bwd_plain(dy, ref[2], ref[1], c_prev, w)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert torch.equal(lstm_fused.lstm_layer_fused(xp, w, h0, c0),
                       lstm_fused.lstm_layer_plain(xp, w, h0, c0))
    assert lstm_fused.launch_counts() == before  # CPU tensors launch nothing


# --- the probe on the persistent frame ---


@pytest.mark.parametrize("sm_count", [132, 46, 12])
@pytest.mark.parametrize("h", [32, 100, 1024, 1030, 1096, 1100])
@pytest.mark.parametrize("b", [1, 3, 19, 64, 400])
def test_probe_route_follows_the_plan(b, h, sm_count):
    """``lstm_probe`` takes ``lstm_probe_persist`` exactly where the inference
    kernel whose arithmetic the mode takes apart is persistent: K1c's plan
    for "h_bf16", K1a's for the other three."""
    for mode in lstm_fused.PROBE_MODES:
        sq = "bf16" if mode == "h_bf16" else "none"
        persist = lstm_fused.infer_variant(sq, b, h, sm_count) == sq + "_persist"
        assert lstm_fused.probe_variant(mode, b, h, sm_count) == (
            "probe_persist" if persist else "probe")
    assert lstm_fused.probe_variant("full", 64, 1024, H100_SMS) == "probe_persist"
    assert lstm_fused.probe_variant("gates_only", 3, 1030, H100_SMS) == "probe"


def test_probe_entries_are_named_and_counted():
    assert lstm_fused.KERNEL_NAMES["probe_persist"] == "lstm_probe_persist"
    assert {"probe", "probe_persist"} <= set(lstm_fused.launch_counts())
    src = (_build.CSRC / "lstm_persistent.cu").read_text()
    # the probe's cuts are template arguments of the kernels serving runs
    assert "f32h_persist<kFull>(xp, w, h0, c, y, nullptr, bar" in src
    assert "lstm_infer_persist_kernel<CUT>" in src and "lstm_fwd_persist_kernel<false, CUT>" in src
    entry = src[src.index('extern "C" int lstm_probe_persist('):]
    for cut in ("kFull", "kGatesOnly", "kMatmulOnly"):
        assert f"f32h_persist<{cut}>" in entry
    assert "lstm_bf16h_persist(xp, w, h0, c, y, hx, bar" in entry


@pytest.mark.parametrize("mode", ["gates_only", "matmul_only"])
@pytest.mark.parametrize("b, t, h, sm_count", INFER_SHAPES)
def test_tiled_probe_cuts_match_plain(b, t, h, sm_count, mode):
    """The probe's draws (x_proj x 0.1, W x 0.02: "matmul_only" is a linear
    recurrence that a wider W lets diverge) from a nonzero state."""
    xp, w, h0, c0, _ = _inputs(b, t, h, seed=7)
    xp, w = xp * 0.1, w * (0.02 / 0.3)
    got = infer_tiled(xp, w, h0, c0, sm_count, cut=mode)
    ref = lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL_F32)


@pytest.fixture(scope="module")
def probe_script():
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "bench_lstm_probe", root / "scripts" / "bench_lstm_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["full", "gates_only", "matmul_only"])
@pytest.mark.parametrize("b, t, h, sm_count", [(3, 7, 32, 132), (50, 3, 64, 12)])
def test_tiled_probe_matches_the_tpu_probe(probe_script, monkeypatch, b, t, h, sm_count,
                                           mode):
    """The emulated persistent probe against the probe kernel of
    scripts/bench_lstm_probe.py in Pallas interpret mode (time-major)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    xp, w, h0, c0, _ = _inputs(b, t, h, seed=8)
    xp, w = xp * 0.1, w * (0.02 / 0.3)
    want = probe_script._variant_kernel(mode)(jnp.asarray(_tm(xp)), jnp.asarray(w.numpy()),
                                              jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()))
    got = infer_tiled(xp, w, h0, c0, sm_count, cut=mode)
    np.testing.assert_allclose(got.numpy(), _tm(want), atol=ATOL_F32)
