"""The quantised-state persistent LSTM kernels' plan and tiling, on the CPU.

``lstm_bf16h_persist`` (K1c) and ``lstm_int8_persist`` (K1b) in
``csrc/lstm_persistent.cu`` run only on a card. What the CPU can hold: the
pure-Python plan that routes "bf16" and "int8" layers to them or to the
per-step kernels, the source's constants against the plan's, and the
kernels' tiling as a plain emulation: unit slices (16 units a CTA for bf16,
32 for int8) x row slices of 8-row batch tiles, walked in groups of 32 or
16 rows, the exchange of the rounded h through two buffers by step parity,
rows padded with zeros to the 32-byte k step, the product split over 4 or
2 k-groups (k step q of every 4 or 2) whose partials are summed in order.
The int8 emulation must equal the plain version bit for bit (exact int32
sums); the bf16 one sums fp32 partials in another order. Both are held to
the Pallas K1b / K1c in interpret mode.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.ops.lstm_pallas import _fwd_quant_call
from avvad_tpu_torch.ops import _build, lstm_fused
from avvad_tpu_torch.tools import lstm_step_split

# fp32 recurrences in another summation order: a few ulp of unit-scale
# values (the bf16 state rounds the same h the same way at these sizes)
ATOL_F32 = 1e-5
H100_SMS = 132
QUANTS = ("bf16", "int8")


def _variant(state_quant):
    return state_quant + "_persist"


# --- the plan ---


@pytest.mark.parametrize("smem_limit", [lstm_fused.SMEM_LIMIT_SM90, 101376])
@pytest.mark.parametrize("sm_count", [132, 46])
@pytest.mark.parametrize("h", [4, 36, 100, 1000, 1024, 1100])
@pytest.mark.parametrize("b", [1, 16, 19, 64, 200])
def test_quant_plan_owns_every_cell_once_and_fits(b, h, sm_count, smem_limit):
    """Each quantised kernel's grid: every cell has one owner, no CTA is
    without a cell, as many row slices as the card holds beside each other;
    the kernel is taken exactly where its shared memory (the padded weight
    slice, the ring, the state of the CTA's tiles) fits."""
    plan = lstm_fused.persistent_plan(b, h, sm_count, smem_limit)
    if plan is None:
        return
    rows = plan["rows"]
    tiles = -(-b // rows)
    for sq in QUANTS:
        v = _variant(sq)
        (gx, gy), units = plan["quant_grid"][v], lstm_fused.PERSIST_QUANT_UNITS[v]
        owners = np.zeros((b, h), int)
        for x in range(gx):
            for r in range(gy):
                for tile in range(r, tiles, gy):
                    owners[tile * rows:(tile + 1) * rows, x * units:(x + 1) * units] += 1
        assert (owners == 1).all()
        assert (gx - 1) * units < h and 1 <= gy <= tiles and gx * gy <= sm_count
        assert gy == tiles or gx * (gy + 1) > sm_count
        ring = (lstm_fused.PERSIST_QUANT_STAGES * lstm_fused.quant_group_rows(v)
                * (lstm_fused.PERSIST_QUANT_CHUNK + 16))
        want = (4 * units * (lstm_fused.quant_row_bytes(h, v) + 16) + ring
                + -(-tiles // gy) * rows * units * 4)
        assert plan["quant_smem_bytes"][v] == want
        assert plan["infer_" + sq] == (want <= smem_limit)
    # the int8 slice is half the bf16 one: int8 fits wherever bf16 does
    assert plan["infer_int8"] or not plan["infer_bf16"]


def test_quant_plan_for_the_serving_shape_on_an_h100():
    plan = lstm_fused.persistent_plan(64, 1024, H100_SMS)
    assert plan["infer_bf16"] and plan["infer_int8"]
    # bf16: 16 units a CTA, 4 tiles (one group of 32 rows); int8: 32 units a
    # CTA, 2 tiles (one group of 16 rows); both 128 CTAs
    assert plan["quant_grid"] == {"bf16_persist": (64, 2), "int8_persist": (32, 4)}
    # a 129 KB weight slice either way (64 columns of 2 KB, 128 of 1 KB), a
    # 66 or 33 KB ring, the c of 4 or 2 tiles
    assert plan["quant_smem_bytes"] == {"bf16_persist": 201728, "int8_persist": 168960}
    for sq in QUANTS:
        assert lstm_fused.infer_variant(sq, 64, 1024, H100_SMS) == _variant(sq)
        # outside the plan: the per-step kernels
        assert lstm_fused.infer_variant(sq, 3, 1030, H100_SMS) == sq
        assert lstm_fused.infer_variant(sq, 64, 2048, H100_SMS) == sq
        assert lstm_fused.infer_variant(sq, 16, 1120, H100_SMS) == sq


@pytest.mark.parametrize("h, bf16, int8", [(1000, 2016, 1024), (1024, 2048, 1024), (36, 96, 64),
                                           (100, 224, 128), (4, 32, 32)])
def test_quant_rows_are_padded_to_the_k_step(h, bf16, int8):
    assert lstm_fused.quant_row_bytes(h, "bf16_persist") == bf16
    assert lstm_fused.quant_row_bytes(h, "int8_persist") == int8


@pytest.mark.parametrize("sm_count", [132, 46, 12])
@pytest.mark.parametrize("h", [32, 100, 1024, 1030, 1100, 1280])
@pytest.mark.parametrize("b", [1, 19, 64, 400])
def test_quant_route_follows_the_plan(b, h, sm_count):
    plan = lstm_fused.persistent_plan(b, h, sm_count)
    for sq in QUANTS:
        takes = plan is not None and plan["infer_" + sq]
        assert lstm_fused.infer_variant(sq, b, h, sm_count) == (_variant(sq) if takes else sq)


def test_source_constants_match_the_quant_plan():
    """The geometry the plan assumes is the geometry the source compiles."""
    src = (_build.CSRC / "lstm_persistent.cu").read_text()
    const = {k: v for k, v in re.findall(r"constexpr int (\w+) = ([^;]+);", src)}
    assert int(const["UQ_BF16"]) == lstm_fused.PERSIST_QUANT_UNITS["bf16_persist"]
    assert int(const["UQ_INT8"]) == lstm_fused.PERSIST_QUANT_UNITS["int8_persist"]
    assert int(const["KCB"]) == lstm_fused.PERSIST_QUANT_CHUNK
    assert const["ARS"] == "KCB + 16"
    assert int(const["QSTAGE"]) == lstm_fused.PERSIST_QUANT_STAGES
    # QGeo<UQ>: 2 cells a thread of 256, 32-column groups, a k-group per
    # column group's share of the 8 warps
    assert const["QR"] == "2 * NT / UQ" and int(const["NT"]) == 256
    assert const["CG"] == "NCOL / 32" and const["KG"] == "NWARP / CG"
    assert const["NCOL"] == "4 * UQ" and const["QRS"] == "NCOL + 8"
    assert "lstm_quant_persist_kernel<false, UQ_BF16>" in src
    assert "lstm_quant_persist_kernel<true, UQ_INT8>" in src
    for v, units in lstm_fused.PERSIST_QUANT_UNITS.items():
        kg, rows = lstm_fused.quant_k_groups(v), lstm_fused.quant_group_rows(v)
        assert rows % 16 == 0 and rows % lstm_fused.PERSIST_ROWS == 0
        # the partials live in the ring between a group's last chunk and the next
        assert kg * rows * (4 * units + 8) * 4 <= (
            lstm_fused.PERSIST_QUANT_STAGES * rows * (lstm_fused.PERSIST_QUANT_CHUNK + 16))
        # a chunk is a whole number of 32-byte k steps, dealt round-robin to the k-groups
        assert lstm_fused.PERSIST_QUANT_CHUNK % (32 * kg) == 0
    assert 'static_assert(RED_BYTES <= RING_BYTES, "the partials live in the idle ring");' in src
    # the tensor-core products, one code for both element types
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    # one launch: the weight slice is loaded before the time loop, once
    kern = src[src.index("lstm_quant_persist_kernel("):]
    loop = kern.index("for (int t = 0; t < T; ++t)")
    assert kern.index("wsm + (size_t)(g * UQ + u4) * WS") < loop
    # the padding rule of the exchange and the weight columns
    assert "return ((int8 ? H : 2 * H) + 31) / 32 * 32;" in src


# --- the tiling, emulated ---


def _ctas(plan, variant, b, h):
    """(units j, [row slices of its tiles]) of every CTA of a quantised
    kernel's grid."""
    (gx, gy), rows = plan["quant_grid"][variant], plan["rows"]
    units = lstm_fused.PERSIST_QUANT_UNITS[variant]
    tiles = [slice(b0, min(b0 + rows, b)) for b0 in range(0, b, rows)]
    return [(torch.arange(x * units, min((x + 1) * units, h)), tiles[r::gy])
            for x in range(gx) for r in range(gy)]


def quant_tiled(xp, w, h0, c0, state_quant, sm_count=H100_SMS, buffers=2):
    """``lstm_bf16h_persist`` / ``lstm_int8_persist``'s tiling in plain
    PyTorch. ``buffers=1`` replaces the parity pair by one exchange buffer."""
    b, t, h4 = xp.shape
    h = h4 // 4
    variant = _variant(state_quant)
    plan = lstm_fused.persistent_plan(b, h, sm_count)
    assert plan["infer_" + state_quant]
    int8 = state_quant == "int8"
    es = lstm_fused.QUANT_ELEMENT_BYTES[variant]
    kp = lstm_fused.quant_row_bytes(h, variant) // es  # K padded to the k step
    # float64 holds the int8 products' sums exactly
    dtype = torch.float64 if int8 else torch.float32
    wk = torch.zeros(kp, h4, dtype=dtype)
    if int8:
        wq, ws = lstm_fused._quant_weights(w)
        wk[:h] = wq.to(dtype)
    else:
        wk[:h] = lstm_fused._bf16_rounded(w)

    def quant(v):  # the owner's rounding of h into the exchange
        return torch.round(v * 127.0).to(dtype) if int8 else v.to(torch.bfloat16).float()

    def cell(pre, c_prev):  # the gate math of _scan -> (c, h)
        ig, fg, gg, og = pre.split(pre.shape[-1] // 4, dim=-1)
        cn = torch.sigmoid(fg) * c_prev + torch.sigmoid(ig) * torch.tanh(gg)
        return cn, torch.sigmoid(og) * torch.tanh(cn)

    hx = torch.zeros(buffers, b, kp, dtype=dtype)  # the pad stays zero
    hx[0, :, :h] = quant(h0)
    k_groups = lstm_fused.quant_k_groups(variant)
    per_group = lstm_fused.quant_group_rows(variant) // plan["rows"]  # tiles
    group = (torch.arange(kp) // (32 // es)) % k_groups
    y, c = torch.empty(b, t, h), c0.clone()
    for step in range(t):
        h_in, h_out = hx[step % buffers], hx[(step + 1) % buffers]
        rec = torch.empty(b, h4)
        for j, tiles in _ctas(plan, variant, b, h):
            cols = torch.cat([g * h + j for g in range(4)])
            for i in range(0, len(tiles), per_group):  # groups of tiles
                rows = torch.cat([torch.arange(r.start, r.stop)
                                  for r in tiles[i:i + per_group]])
                a = h_in[rows]
                parts = [a[:, group == q] @ wk[group == q][:, cols] for q in range(k_groups)]
                acc = sum(parts[1:], parts[0])
                rec[rows[:, None], cols[None]] = acc.float() * ws[cols] if int8 else acc
                if buffers == 1:  # the owners' h_t lands where later CTAs read h_{t-1}
                    _, hn = cell(xp[rows, step][:, cols] + rec[rows][:, cols], c[rows][:, j])
                    h_out[rows[:, None], j[None]] = quant(hn)
        # every cell's gate math, elementwise, on the whole step as the plain
        # version lays it out (CPU sigmoid / tanh may round by layout)
        c, hn = cell(xp[:, step] + rec, c)
        y[:, step] = hn
        h_out[:, :h] = quant(hn)  # the exchange
    return y


def _inputs(b, t, h, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(b, t, 4 * h)), rng.normal(size=(h, 4 * h)) * 0.3,
              np.tanh(rng.normal(size=(b, h))), rng.normal(size=(b, h)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays]


def _tm(a):
    """batch-major (B, T, ...) <-> time-major (T, B, ...)"""
    return np.swapaxes(np.asarray(a), 0, 1)


# (b, t, h, SMs): one tile a CTA; H = 36 and 100 no multiple of the units
# or of the k step (bf16 rows padded from 72 to 96 and from 200 to 224
# bytes); a ragged last group (bf16: 3 tiles, a half-empty second m16 tile;
# int8: groups of 2 and 1); several groups (bf16: 4 + 3, int8: 2 + 2 and
# 2 + 1); the serving shape's one full group a CTA at H = 128 on 16 SMs
QUANT_SHAPES = [(3, 7, 32, 132), (19, 4, 36, 3), (50, 3, 64, 4), (13, 5, 100, 7),
                (64, 3, 128, 16), (37, 2, 96, 6)]


def test_emulated_shapes_walk_the_groups_they_name():
    tiles_a_cta = {v: {} for v in lstm_fused.QUANT_ELEMENT_BYTES}
    for v in tiles_a_cta:
        for b, _, h, sms in QUANT_SHAPES:
            plan = lstm_fused.persistent_plan(b, h, sms)
            tiles_a_cta[v][(b, h)] = sorted({len(tiles) for _, tiles in _ctas(plan, v, b, h)})
    assert tiles_a_cta["bf16_persist"] == {(3, 32): [1], (19, 36): [3], (50, 64): [7],
                                           (13, 100): [2], (64, 128): [4], (37, 96): [5]}
    assert tiles_a_cta["int8_persist"] == {(3, 32): [1], (19, 36): [3], (50, 64): [3, 4],
                                           (13, 100): [2], (64, 128): [2], (37, 96): [2, 3]}


@pytest.mark.parametrize("b, t, h, sm_count", QUANT_SHAPES)
@pytest.mark.parametrize("state_quant", QUANTS)
def test_tiled_quant_matches_plain(state_quant, b, t, h, sm_count):
    xp, w, h0, c0 = _inputs(b, t, h, seed=7)
    got = quant_tiled(xp, w, h0, c0, state_quant, sm_count)
    ref = lstm_fused.lstm_layer_plain(xp, w, h0, c0, state_quant=state_quant)
    assert got.shape == ref.shape
    if state_quant == "int8":  # exact int32 sums, the same float32 operations
        assert torch.equal(got, ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL_F32)


@pytest.mark.parametrize("b, t, h, sm_count", [(3, 7, 32, 132), (19, 4, 36, 3), (37, 2, 96, 6)])
@pytest.mark.parametrize("state_quant", QUANTS)
def test_tiled_quant_matches_pallas(state_quant, b, t, h, sm_count):
    """The emulated kernels against the Pallas ``_fwd_quant_call`` in
    interpret mode (time-major), from a nonzero state."""
    xp, w, h0, c0 = _inputs(b, t, h, seed=8)
    y_j = _fwd_quant_call(jnp.asarray(_tm(xp)), jnp.asarray(w.numpy()),
                          jnp.asarray(h0.numpy()), jnp.asarray(c0.numpy()),
                          interpret=True, state_quant=state_quant)
    got = quant_tiled(xp, w, h0, c0, state_quant, sm_count)
    np.testing.assert_allclose(got.numpy(), _tm(y_j), atol=ATOL_F32)


@pytest.mark.parametrize("state_quant", QUANTS)
def test_one_exchange_buffer_would_race(state_quant):
    """With one buffer, a CTA that has written its h_t is read as h_{t-1} by
    a CTA that comes later in the same step: the parity pair is needed."""
    xp, w, h0, c0 = _inputs(3, 4, 64, seed=9)
    ref = lstm_fused.lstm_layer_plain(xp, w, h0, c0, state_quant=state_quant)
    np.testing.assert_allclose(quant_tiled(xp, w, h0, c0, state_quant)[:, 0].numpy(),
                               ref[:, 0].numpy(), atol=ATOL_F32)
    raced = quant_tiled(xp, w, h0, c0, state_quant, buffers=1)
    assert (raced - ref).abs().max().item() > 1e-2


def test_k_groups_cover_every_k_step_once():
    """With unit weights every k of the padded row lands in one partial."""
    for variant in lstm_fused.QUANT_ELEMENT_BYTES:
        es = lstm_fused.QUANT_ELEMENT_BYTES[variant]
        for h in (36, 100, 1000, 1024):
            kp = lstm_fused.quant_row_bytes(h, variant) // es
            k_groups = lstm_fused.quant_k_groups(variant)
            group = (torch.arange(kp) // (32 // es)) % k_groups
            counts = torch.bincount(group, minlength=k_groups)
            assert counts.sum().item() == kp and kp >= h and kp * es % 32 == 0
            # the k-groups' shares differ by at most one k step
            assert counts.max() - counts.min() <= 32 // es


@pytest.mark.parametrize("state_quant", QUANTS)
def test_cpu_tensors_take_the_plain_quant_versions(state_quant):
    xp, w, h0, c0 = _inputs(2, 3, 32, seed=3)
    before = lstm_fused.launch_counts()
    got = lstm_fused.lstm_layer_fused(xp, w, h0, c0, state_quant=state_quant)
    assert torch.equal(got, lstm_fused.lstm_layer_plain(xp, w, h0, c0, state_quant=state_quant))
    assert lstm_fused.launch_counts() == before  # CPU tensors launch nothing


# --- the step-split tool (runs on the card; its cuts are checked here) ---


@pytest.mark.parametrize("copy", sorted(lstm_step_split.PATCHES))
def test_step_split_copies_name_text_of_the_source(copy):
    """Each copy replaces text that occurs once in the source (a cut: in the
    quantised kernel's body; another geometry: a constant), so the tool's
    copies stay what their names say as the source changes."""
    src = (_build.CSRC / "lstm_persistent.cu").read_text()
    kern = src[src.index("lstm_quant_persist_kernel("):src.index("// Backward: CTA")]
    for old, new in lstm_step_split.PATCHES[copy]:
        assert src.count(old) == 1 and old != new
        assert kern.count(old) == 1 or old.startswith("constexpr int ")
    patched = lstm_step_split.patched_source(copy)
    assert (patched == src) == (copy == "full")


def test_step_split_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run")
    with pytest.raises(SystemExit):
        lstm_step_split.run(b=2, t=2, h=32)
