"""The readers of the program's own spans and counters
(``avvad_tpu_torch.utils.profiling.snapshot()``): each gives a number from a
stub snapshot, and None from an empty one or from a program without the
recorder."""

import pytest

from avvad_tpu_torch.utils import profiling
from benchmark.harness.spec import BENCH_DIR, load_module


def _span(count, host_ms, device_ms, counts=None):
    return {"count": count, "host_ms": host_ms, "device_ms": device_ms,
            "self_ms": host_ms / 2, "counts": counts or {}}


STEPS = 24
STUB = {
    "spans": {
        "serve.step": _span(STEPS, 7.5, 56.0, {"launch.lstm_f32h_persist": 2.0,
                                               "launch.int8_basic_block": 8.0,
                                               "launch.stem_epilogue_pool_nhwc": 1.0,
                                               "build.nvcc": 0.5}),
        "train.step": _span(STEPS, 25.0, 185.0, {"launch.lstm_fwd_train_persist": 2.0,
                                                 "launch.lstm_bwd_persist": 2.0}),
        "serve.frontend": _span(STEPS, 0.5, 2.7),
        "tower": _span(STEPS, 2.0, 26.6),
        "tower.stem": _span(STEPS, 0.1, 11.3),
        "bn": _span(20 * STEPS, 0.05, 1.75),
        "fusion": _span(STEPS, 0.4, 4.6),
        "lstm": _span(STEPS, 0.2, 21.5),
        "train.backward": _span(STEPS, 3.0, 17.0),
        "train.optimizer": _span(STEPS, 1.0, 0.45),
    },
    "counters": {"launch.lstm_f32h_persist": 50},
    "setup": {"setup.kernels": {"calls": 1, "s": 0.25, "self_s": 0.25},
              "setup.serving_fn": {"calls": 1, "s": 0.5, "self_s": 0.5},
              "setup.calibrate": {"calls": 1, "s": 1.5, "self_s": 1.25},
              "setup.train_state": {"calls": 1, "s": 8.0, "self_s": 8.0}},
    "dropped": 0,
}
EMPTY = {"spans": {}, "counters": {}, "setup": {}, "dropped": 0}
WANT = {
    "step_host_ms.serve": 7.5, "frontend_span_ms.serve": 2.7, "tower_span_ms.serve": 26.6,
    "fusion_span_ms.serve": 4.6, "lstm_span_ms.serve": 21.5, "tower_span_ms.train": 26.6,
    "lstm_fwd_span_ms.train": 21.5, "backward_span_ms.train": 17.0,
    "optimizer_span_ms.train": 0.45, "stem_ms.serve": 11.3, "stem_ms.train": 11.3,
    "tower_bn_ms.train": 35.0, "kernel_launches.serve": 11.0, "kernel_launches.train": 4.0,
    "setup_kernels_s": 0.25, "setup_entry_s.serve": 1.75, "setup_entry_s.train": 8.0,
}


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"bench_metric_{name.replace('.', '_')}").read


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_snapshot(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(profiling, "snapshot", lambda: STUB)
    assert read({}) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiling, "snapshot", lambda: EMPTY)
    assert read({}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_the_recorder_reads_nothing(name, monkeypatch):
    """The parent commit's program has a profiling module and no snapshot."""
    monkeypatch.delattr(profiling, "snapshot")
    assert _reader(name)({}) is None


def test_device_ms_off_the_card_reads_nothing(monkeypatch):
    cpu = {**STUB, "spans": {k: {**v, "device_ms": None} for k, v in STUB["spans"].items()}}
    monkeypatch.setattr(profiling, "snapshot", lambda: cpu)
    assert _reader("tower_span_ms.train")({}) is None
    assert _reader("step_host_ms.serve")({}) == pytest.approx(7.5)
