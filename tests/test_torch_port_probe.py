"""CPU parity of the port's probe path with the JAX package: the probe
kernel's plain version against the TPU probe kernel (interpret mode), the
hop-block and split-radix frontends, and the probe tool on the CPU.

Inputs are seeded numpy draws handed to both sides. The TPU probe kernel
lives in ``scripts/bench_lstm_probe.py``; it is loaded by path and run in
Pallas interpret mode by patching ``pallas_call`` for the test only.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avvad_tpu.ops.stft import log_power_frontend as jlog_power
from avvad_tpu.ops.stft import stft_frames as jstft_frames
from avvad_tpu_torch.ops import lstm_fused
from avvad_tpu_torch.ops.stft import log_power_frontend, stft_frames

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the plain version against the Pallas kernel in interpret mode: fp32 on
# both sides, the same bf16-rounded W; measured <= 1.5e-7
PROBE_ATOL = 1e-5
# re / im of the other DFT routes, as a share of the largest value: against
# JAX's same route 1e-5; against the direct route the bars of
# tests/test_ops_stft.py:108 (hop_dft, 1e-5) and :138 (split_radix, 1e-4)
ROUTE_VS_JAX = 1e-5
ROUTE_VS_DIRECT = {"hop_dft": 1e-5, "split_radix": 1e-4}


@pytest.fixture(scope="module")
def probe_script():
    spec = importlib.util.spec_from_file_location(
        "bench_lstm_probe", ROOT / "scripts" / "bench_lstm_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The script's ``call`` looks ``pl.pallas_call`` up when it runs."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _probe_draws(t, b, h, seed=0, zero_state=False):
    rng = np.random.default_rng(seed)
    xp = rng.normal(size=(t, b, 4 * h)).astype(np.float32) * 0.1
    w = rng.normal(size=(h, 4 * h)).astype(np.float32) * 0.02
    if zero_state:
        return xp, w, np.zeros((b, h), np.float32), np.zeros((b, h), np.float32)
    return (xp, w, np.tanh(rng.normal(size=(b, h))).astype(np.float32),
            rng.normal(size=(b, h)).astype(np.float32))


@pytest.mark.parametrize("shape", [(5, 3, 32), (4, 8, 128)])
@pytest.mark.parametrize("mode", lstm_fused.PROBE_MODES)
def test_probe_plain_matches_tpu_kernel(probe_script, interpret_pallas, mode, shape):
    t, b, h = shape
    xp, w, h0, c0 = _probe_draws(t, b, h, seed=3)
    want = np.asarray(probe_script._variant_kernel(mode)(
        jnp.asarray(xp), jnp.asarray(w), jnp.asarray(h0), jnp.asarray(c0)))
    got = lstm_fused.lstm_probe(torch.from_numpy(xp).transpose(0, 1).contiguous(),
                                torch.from_numpy(w), torch.from_numpy(h0),
                                torch.from_numpy(c0), mode)
    assert got.shape == (b, t, h)
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), want, atol=PROBE_ATOL)


def test_probe_modes_are_what_they_say():
    """full is the serving op's arithmetic; gates_only does not read W;
    matmul_only is the linear recurrence over the i columns and leaves c
    alone (so c0 does not matter)."""
    xp, w, h0, c0 = (torch.from_numpy(a) for a in _probe_draws(6, 3, 32, seed=4))
    xp = xp.transpose(0, 1).contiguous()
    probe = lstm_fused.lstm_probe
    assert torch.equal(probe(xp, w, h0, c0, "full"),
                       lstm_fused.lstm_layer_fused(xp, w, h0, c0, "none"))
    assert torch.equal(probe(xp, w, h0, c0, "h_bf16"),
                       lstm_fused.lstm_layer_fused(xp, w, h0, c0, "bf16"))
    assert torch.equal(probe(xp, w, h0, c0, "gates_only"),
                       probe(xp, torch.full_like(w, float("nan")), h0, c0, "gates_only"))
    assert torch.equal(probe(xp, w, h0, c0, "matmul_only"),
                       probe(xp, w, h0, c0 + 5.0, "matmul_only"))
    wd = w.to(torch.bfloat16).float()
    hh = h0
    for step in range(xp.shape[1]):
        hh = xp[:, step, :32] + hh @ wd[:, :32]
    torch.testing.assert_close(probe(xp, w, h0, c0, "matmul_only")[:, -1], hh,
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="probe mode"):
        probe(xp, w, h0, c0, "fast")
    before = lstm_fused.launch_counts()
    probe(xp, w, mode="full")
    assert lstm_fused.launch_counts() == before  # CPU tensors launch nothing


def _noise(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.3


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("n", [9000, 256 * 11 + 1024])
@pytest.mark.parametrize("route", ["hop_dft", "split_radix"])
def test_dft_routes_match_jax_and_direct(route, n):
    """(2, n) seeded noise; n = 9000 takes the end pad, the other exactly
    12 frames."""
    x = _noise((2, n), seed=5)
    got = stft_frames(torch.from_numpy(x), **{route: True})
    want = jstft_frames(jnp.asarray(x), **{route: True})
    direct = stft_frames(torch.from_numpy(x))
    for g, w, d in zip(got, want, direct):
        assert g.shape == tuple(w.shape) == d.shape
        assert _rel(g.numpy(), w) < ROUTE_VS_JAX
        assert _rel(g.numpy(), d.numpy()) < ROUTE_VS_DIRECT[route]


@pytest.mark.parametrize("route", ["hop_dft", "split_radix"])
def test_log_power_frontend_routes_match_jax(route):
    """The log of small powers magnifies an fp32 rounding of re / im, so
    log-power is held where the power is not tiny: 1e-3 absolute on bins
    above 1e-3 of the largest power (readings 1.7e-5 for hop_dft, 2.7e-6 for
    split_radix; 5.9e-4 over all bins)."""
    x = _noise((3, 7000), seed=6)
    got = log_power_frontend(torch.from_numpy(x), **{route: True}).numpy()
    want = np.asarray(jlog_power(jnp.asarray(x), **{route: True}))
    assert got.shape == want.shape
    loud = want > want.max() + np.log(1e-3)
    assert loud.mean() > 0.5
    np.testing.assert_allclose(got[loud], want[loud], atol=1e-3)


def test_route_guards_fall_back_as_jax():
    """hop_dft needs hop | nfft, split_radix 8 | nfft; otherwise the direct
    route runs (avvad_tpu/ops/stft.py:251, :255). A 30 fps-aligned hop of
    533 samples does not divide 1024."""
    x = _noise((1, 6000), seed=7)
    kw = dict(hop_percent=533 / 1024)
    direct = stft_frames(torch.from_numpy(x), **kw)
    got = stft_frames(torch.from_numpy(x), hop_dft=True, **kw)
    want = jstft_frames(jnp.asarray(x), hop_dft=True, **kw)
    for g, d, w in zip(got, direct, want):
        assert torch.equal(g, d)
        assert _rel(g.numpy(), w) < ROUTE_VS_JAX


def test_probe_tool_runs_on_the_cpu():
    from avvad_tpu_torch.tools import lstm_probe as tool

    lines = []
    res = tool.run(b=2, t=4, h=32, iters=1, device="cpu", out=lines.append)
    assert set(res["probe"]) == set(lstm_fused.PROBE_MODES)
    assert set(res["lstm_layer_fused"]) == set(lstm_fused.STATE_QUANTS)
    assert set(res["frontend"]) == {"direct", "hop_dft"}
    assert res["h_bf16_vs_full"] is not None and res["h_bf16_vs_full"] < 1e-2
    assert len(lines) == 1 + 4 + 1 + 3 + 2 and "cpu" in lines[0]
    # the tool's draws are the TPU probe's: same seed, same order, same scales
    xp, w, h0, c0 = tool.probe_inputs(2, 4, 32, torch.device("cpu"))
    want_xp, want_w, _, _ = _probe_draws(4, 2, 32, seed=0, zero_state=True)
    np.testing.assert_array_equal(xp.transpose(0, 1).numpy(), want_xp)
    np.testing.assert_array_equal(w.numpy(), want_w)
    assert not h0.any() and not c0.any()
    res = tool.main(["--b", "2", "--t", "3", "--h", "32", "--iters", "1",
                     "--modes", "gates_only", "--device", "cpu"])
    assert list(res["probe"]) == ["gates_only"]
