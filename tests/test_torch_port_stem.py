"""The channels-last stem epilogue (K3, ``stem_epilogue_pool_nhwc``) on the CPU.

``csrc/stem_epilogue_pool.cu`` runs only on a card. What the CPU can hold:
the plain version on channels-last input against NCHW input and against the
JAX package's Pallas kernel in interpret mode; the geometry the wrapper
plans against the source's constants; and a plain emulation of the
kernel's schedule (units dealt to a persistent grid, row pairs streamed
through a ring of slots, the horizontal 3/2 max of each row, the vertical
max with the odd row kept from the chunk before, pooling on sign-flipped
values before quantising) against the plain version, bit for bit. And the
fused int8 route hands the epilogue the stem conv's output channels-last.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avvad_tpu_torch.models.resnet as resnet_mod
from avvad_tpu.ops.stem_pallas import stem_epilogue_pool_quant as jstem
from avvad_tpu_torch.ops import _build, stem_fused

HI, HO = stem_fused.HW_IN, stem_fused.HW_OUT


def _inputs(n, c, seed, dtype=torch.float32, edges=True):
    """Seeded (N, C, 34, 34) channels-last x and (C,) a, b: a of both signs
    (a third negative, one -0.0), b spread so that q covers [0, 127] and
    its clip; with ``edges`` the largest and the smallest value of every
    frame and channel sit in input rows 0 and 33 or columns 0 and 33, so that
    the windows at the edges decide them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, HI, HI, c)) * 3
    if edges:
        for f in range(n):
            for ch in range(c):
                r, col = rng.choice([0, HI - 1], 2)
                x[f, r, rng.integers(HI), ch] = 12.0
                x[f, rng.integers(HI), col, ch] = -12.0
    a = rng.uniform(2.0, 12.0, c) * np.where(rng.random(c) < 1 / 3, -1.0, 1.0)
    a[c // 2] = -0.0
    b = rng.normal(size=c) * 20 + 40
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    return xt, torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32))


def nhwc_emulated(x, a, b, grid):
    """``stem_epilogue_pool_nhwc``'s schedule in plain PyTorch: CTA r of
    ``grid`` walks units r, r + grid, ... (a frame's slice of channels) as a
    stream of chunks, one an output row p (input rows 2p and 2p + 1), each
    landing in ring slot s % slots before it is read; a thread of the round
    owns 8 channels of output column q, takes the max over input columns
    2q - 1, 2q, 2q + 1 of each row on the values with the sign of a flipped,
    the max of the two rows and of row 2p - 1's (kept from the chunk
    before), then flips back and quantises."""
    n, c = x.shape[:2]
    es = x.element_size()
    plan = stem_fused.nhwc_plan(c, es)
    cs, slots = plan["slice"], plan["slots"]
    nslice = c // cs
    xh = x.permute(0, 2, 3, 1).float()  # (N, 34, 34, C): the bytes as they lie
    flip = torch.where(torch.signbit(a), -1.0, 1.0)
    out = torch.full((n, HO, HO, c), -1, dtype=torch.int8)
    units = n * nslice
    for cta in range(min(grid, units)):
        my_units = list(range(cta, units, grid))
        nchunks = len(my_units) * HO
        ring = [None] * slots

        def issue(s):
            u = my_units[s // HO]
            f, sl, pr = u // nslice, u % nslice, s % HO
            ring[s % slots] = (s, xh[f, 2 * pr:2 * pr + 2, :, sl * cs:(sl + 1) * cs].clone())

        for s in range(min(slots, nchunks)):
            issue(s)
        carry = None
        for s in range(nchunks):
            tag, rows = ring[s % slots]
            assert tag == s  # the slot holds this chunk, not an earlier one
            u = my_units[s // HO]
            f, sl, pr = u // nslice, u % nslice, s % HO
            ch = slice(sl * cs, (sl + 1) * cs)
            rows = rows * flip[ch]
            hmax = torch.stack([torch.stack([rows[r, max(2 * q - 1, 0):2 * q + 2].amax(0)
                                             for q in range(HO)]) for r in range(2)])
            v = hmax.amax(0)
            if pr > 0:
                v = torch.maximum(v, carry)
            carry = hmax[1]
            y = (v * flip[ch]) * a[ch] + b[ch]
            out[f, pr, :, ch] = torch.round(torch.clamp(y, 0.0, 127.0)).to(torch.int8)
            if s + slots < nchunks:
                issue(s + slots)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n, c", [(1, 16), (1, 64), (37, 16), (37, 64)])
def test_plain_on_channels_last_equals_nchw(n, c, dtype):
    x, a, b = _inputs(n, c, seed=n + c, dtype=dtype)
    got = stem_fused.stem_epilogue_plain(x, a, b)
    ref = stem_fused.stem_epilogue_plain(x.contiguous(), a, b)
    assert got.shape == (n, HO, HO, c) and got.dtype == torch.int8
    assert torch.equal(got, ref)
    assert 0 < (got == 0).float().mean() < 1 and (got == 127).any()


def test_plain_matches_pallas_with_scales_of_both_signs():
    """The plain version on channels-last bf16-valued input against the JAX
    Pallas kernel in interpret mode, bit for bit, with a of both signs."""
    x, a, b = _inputs(37, 64, seed=11, dtype=torch.bfloat16)
    ref = np.asarray(jstem(jnp.asarray(x.float().permute(0, 2, 3, 1).numpy()),
                           jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    got = stem_fused.stem_epilogue_pool_quant(x, a, b).numpy()
    np.testing.assert_array_equal(got, ref)


# (N, C, dtype, grid): one frame; 37 frames on fewer CTAs than units (a CTA
# walks several, its ring wraps many times); more CTAs than units; a pixel's
# channels over the slice limit (fp32 C = 160: slices of 32 channels)
SCHEDULES = [(1, 16, torch.bfloat16, 396), (1, 64, torch.float32, 396),
             (37, 16, torch.float32, 5), (37, 64, torch.bfloat16, 7),
             (37, 64, torch.float32, 64), (3, 160, torch.float32, 4),
             (2, 144, torch.bfloat16, 3)]


@pytest.mark.parametrize("n, c, dtype, grid", SCHEDULES)
def test_emulated_schedule_matches_plain(n, c, dtype, grid):
    x, a, b = _inputs(n, c, seed=3 * n + c, dtype=dtype)
    got = nhwc_emulated(x, a, b, grid)
    ref = stem_fused.stem_epilogue_plain(x, a, b)
    assert torch.equal(got, ref)


def test_pooling_before_quantising_needs_the_sign_flip():
    """Without the flip a channel with a < 0 would take q(max x) where the
    max of q is q(min x): the emulation would disagree. (A mutation check
    of the flip, kept as a test.)"""
    x, a, b = _inputs(2, 16, seed=5)
    ref = stem_fused.stem_epilogue_plain(x, a, b)
    got = nhwc_emulated(x, a.abs(), b, grid=2)
    neg = torch.signbit(a)
    assert torch.equal(got[..., ~neg], ref[..., ~neg])
    assert not torch.equal(got[..., neg], ref[..., neg])


@pytest.mark.parametrize("c, es, want", [
    (64, 2, {"slice": 64, "chunk_bytes": 8704, "slots": 7, "items": 136}),
    (64, 4, {"slice": 64, "chunk_bytes": 17408, "slots": 3, "items": 136}),
    (16, 2, {"slice": 16, "chunk_bytes": 2176, "slots": 8, "items": 34}),
    (160, 4, {"slice": 32, "chunk_bytes": 8704, "slots": 7, "items": 68}),
    (192, 4, {"slice": 64, "chunk_bytes": 17408, "slots": 3, "items": 136}),
    (144, 2, {"slice": 48, "chunk_bytes": 6528, "slots": 8, "items": 102})])
def test_plan(c, es, want):
    plan = stem_fused.nhwc_plan(c, es)
    assert {k: plan[k] for k in want} == want
    assert c % plan["slice"] == 0 and plan["slice"] % 16 == 0
    assert plan["slice"] * es <= stem_fused.NHWC_SLICE_BYTES or plan["slice"] == 16
    # the ring and its neighbours fit a CTA; at C = 64 three CTAs an SM
    assert plan["smem_bytes"] <= 232448
    if c == 64:
        assert 3 * (plan["smem_bytes"] + 1024) <= 233472
    with pytest.raises(ValueError):
        stem_fused.nhwc_plan(40, es)


def test_source_constants_match_the_plan():
    src = (_build.CSRC / "stem_epilogue_pool.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["NT_L"] == stem_fused.NHWC_THREADS
    assert const["MAX_SLOTS"] == stem_fused.NHWC_MAX_SLOTS
    # the shared memory the plan counts is the layout the kernel uses
    assert "(MAX_SLOTS * 8 + 8 * C + items * 8 * es + 127) / 128 * 128" in src
    # a round of the threads is a whole number of warps, octets in pairs
    assert stem_fused.NHWC_THREADS % 32 == 0
    assert "extern \"C\" int stem_epilogue_pool_nhwc(" in src


def test_cpu_tensors_take_the_plain_version():
    x, a, b = _inputs(3, 64, seed=2, dtype=torch.bfloat16)
    before = dict(stem_fused.launches)
    got = stem_fused.stem_epilogue_pool_quant(x, a, b)
    assert torch.equal(got, stem_fused.stem_epilogue_plain(x, a, b))
    assert stem_fused.launches == before
    assert set(stem_fused.launches) == {stem_fused.KERNEL_NAME, stem_fused.NHWC_KERNEL_NAME}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_conv_writes_channels_last_on_the_fused_route(dtype, monkeypatch):
    """``ResNet18`` with the fused int8 route hands the epilogue the stem
    conv's output channels-last, with the values of the NCHW convolution."""
    trunk = resnet_mod.ResNet18(dtype=dtype, quant_int8=True, quant_mode="static",
                                stages_pallas=True).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 1, 67, 67))
                         .astype(np.float32))
    seen = []

    def record(stem, a, b):
        seen.append(stem)
        return stem_fused.stem_epilogue_plain(stem, a, b)

    monkeypatch.setattr(resnet_mod, "stem_epilogue_pool_quant", record)
    with torch.no_grad():
        feats = trunk(x)
        ref = trunk.conv1(x)
    assert feats.shape == (3, 512) and len(seen) == 1
    stem = seen[0]
    assert stem.shape == (3, 64, HI, HI) and stem.dtype == dtype
    assert stem.is_contiguous(memory_format=torch.channels_last) and not stem.is_contiguous()
    assert torch.equal(stem, ref)
