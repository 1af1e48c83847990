"""The roofline counts reproduce the bounds the port's kernel table carries
(K1a 4.103 ms, K1d / K1e 1.026 ms, K2 6.707 TOP and 2.741 GB, K3 2.621 GB),
and the step models' parts are what the configurations state."""

import pytest

from benchmark.harness.spec import Cell
from benchmark.roofline import k1a, k1d, k1e, k2, k3, model_audiovad_ref, model_avvad_ref, peaks

N_FRAMES = 64 * 246  # the serving batch's unique camera-rate frames


@pytest.mark.parametrize("mod, shape, ms", [(k1a, (64, 512, 1024), 4.103),
                                            (k1d, (16, 512, 1024), 1.026),
                                            (k1e, (16, 512, 1024), 1.026)])
def test_lstm_bounds(mod, shape, ms):
    assert 1e3 * peaks.bound_s(*mod.cost(*shape), mod.PRECISION) == pytest.approx(ms, abs=5e-4)


def test_k2_counts():
    cost = k2.cost(N_FRAMES)
    assert len(cost) == 8
    assert sum(o for o, _ in cost) / 1e12 == pytest.approx(6.707, abs=5e-4)
    assert sum(b for _, b in cost) / 1e9 == pytest.approx(2.741, abs=5e-4)
    assert 1e3 * sum(peaks.bound_s(o, b, k2.PRECISION) for o, b in cost) == pytest.approx(3.389, abs=5e-4)


def test_k3_counts():
    ops, nbytes = k3.cost(N_FRAMES)
    assert nbytes / 1e9 == pytest.approx(2.621, abs=5e-4)
    assert 1e3 * peaks.bound_s(ops, nbytes, k3.PRECISION) == pytest.approx(0.782, abs=5e-4)


@pytest.mark.parametrize("cell, model, ideal_ms", [
    ("avvad.serve_b64", model_avvad_ref, 15.351), ("avvad.train_b16", model_avvad_ref, 65.798),
    ("audiovad.serve_b64", model_audiovad_ref, 9.651),
    ("audiovad.train_b16", model_audiovad_ref, 10.259)])
def test_step_models(cell, model, ideal_ms):
    c = Cell(cell)
    parts = model.parts(c.config, c.mix)
    assert all(p in peaks.PEAK and ops > 0 for _, ops, p in parts)
    assert 1e3 * sum(ops / peaks.PEAK[p] for _, ops, p in parts) == pytest.approx(ideal_ms, abs=1e-3)
