"""The port's recorder (``avvad_tpu_torch/utils/profiling.py``): spans off
and on, their parents, steps and self times, the fixed buffer, the
profiler's own switch, the spans of a serving step and a train step, the
exported serving program with the recorder on, the counter registry and the
set-up spans. CPU only: device times are None here."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from avvad_tpu_torch.utils import profiling

H, MCB_OUT, T = 16, 32, 8


@pytest.fixture
def recorder():
    """The process's recorder, cleared and off before and after."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _tree(recs: list) -> set:
    names = {r["id"]: r["name"] for r in recs}
    return {(r["name"], names.get(r["parent"])) for r in recs}


def test_a_span_that_is_off_is_the_shared_null_object(recorder):
    a, b = profiling.span("tower"), profiling.span("lstm")
    assert a is b is profiling._NULL
    with a:
        with b:
            torch.ones(3).sum()
    assert profiling.records() == [] and profiling.snapshot()["spans"] == {}


def test_a_span_that_is_on_records_parent_step_and_host_times(recorder):
    profiling.enable()
    t0 = time.perf_counter_ns()
    for _ in range(2):
        with profiling.span("serve.step"):
            with profiling.span("tower"):
                with profiling.span("tower.stem"):
                    pass
            with profiling.span("lstm"):
                pass
    t1 = time.perf_counter_ns()
    recs = profiling.records()
    assert [r["name"] for r in recs] == ["tower.stem", "tower", "lstm", "serve.step"] * 2
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        assert t0 <= r["host_start_ns"] <= r["host_end_ns"] <= t1
        assert r["device_start_ms"] is None and r["device_end_ms"] is None
        if r["name"] == "serve.step":
            assert r["parent"] is None and r["step"] == r["id"]
        else:
            parent = by_id[r["parent"]]
            assert r["step"] == parent["step"]
            assert parent["host_start_ns"] <= r["host_start_ns"] <= r["host_end_ns"] \
                <= parent["host_end_ns"]
    assert _tree(recs) == {("serve.step", None), ("tower", "serve.step"),
                           ("tower.stem", "tower"), ("lstm", "serve.step")}
    assert len({r["step"] for r in recs}) == 2
    snap = profiling.snapshot()["spans"]
    assert {k: v["count"] for k, v in snap.items()} == {
        "serve.step": 2, "tower": 2, "tower.stem": 2, "lstm": 2}
    profiling.disable()
    with profiling.span("serve.step"):
        pass
    assert len(profiling.records()) == 8


def test_self_time_is_the_duration_less_the_children(recorder, monkeypatch):
    ticks = iter(range(0, 10 ** 9, 10 ** 6))   # 1 ms a reading of the clock
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))
    profiling.enable()
    with profiling.span("train.step"):          # 0 .. 7 ms
        with profiling.span("train.forward"):   # 1 .. 4 ms
            with profiling.span("lstm"):        # 2 .. 3 ms
                pass
        with profiling.span("train.backward"):  # 5 .. 6 ms
            pass
    spans = profiling.snapshot()["spans"]
    assert spans["train.step"]["host_ms"] == 7.0
    assert spans["train.step"]["self_ms"] == 7.0 - 3.0 - 1.0
    assert spans["train.forward"]["host_ms"] == 3.0
    assert spans["train.forward"]["self_ms"] == 2.0
    assert spans["lstm"]["self_ms"] == spans["lstm"]["host_ms"] == 1.0
    assert spans["train.step"]["device_ms"] is None


def test_a_full_buffer_drops_the_oldest_and_counts_them():
    rec = profiling.Recorder(capacity=3)
    for i in range(5):
        with rec.open(f"s{i}"):
            pass
    assert [r["name"] for r in rec.records()] == ["s2", "s3", "s4"]
    assert rec.snapshot()["dropped"] == 2
    rec.reset()
    assert rec.records() == [] and rec.snapshot()["dropped"] == 0


def test_spans_follow_the_torch_profiler(recorder):
    assert profiling.span("tower") is profiling._NULL
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.span("serve.step") is not profiling._NULL
        with profiling.span("serve.step"):
            with profiling.span("tower"):
                torch.ones(8, 8).sum()
    assert profiling.span("tower") is profiling._NULL
    names = [e.name for e in prof.events()]
    assert names.count("serve.step") == 1 and names.count("tower") == 1
    assert {r["name"] for r in profiling.records()} == {"serve.step", "tower"}


def test_spans_are_off_while_compiling(recorder, monkeypatch):
    profiling.enable()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert profiling.span("tower") is profiling._NULL


def test_counters_and_launches(recorder):
    profiling.count("launch.lstm_f32h_persist", 2)
    profiling.count("launch.int8_basic_block", 8)
    profiling.count("launch.int8_basic_block")
    profiling.count("build.nvcc")
    assert profiling.launches() == {"lstm_f32h_persist": 2, "int8_basic_block": 9}
    assert profiling.counters("build.") == {"build.nvcc": 1}
    from avvad_tpu_torch.ops import lstm_fused

    counts = lstm_fused.launch_counts()
    assert set(counts) == set(lstm_fused.KERNEL_NAMES)
    assert counts["none_persist"] == 2 and sum(counts.values()) == 2
    profiling.enable()
    with profiling.span("serve.step"):
        profiling.count("launch.int8_basic_block", 8)
        with profiling.span("tower"):
            profiling.count("launch.stem_epilogue_pool_nhwc")
    spans = profiling.snapshot()["spans"]
    assert spans["serve.step"]["counts"] == {"launch.int8_basic_block": 8,
                                             "launch.stem_epilogue_pool_nhwc": 1}
    assert spans["tower"]["counts"] == {"launch.stem_epilogue_pool_nhwc": 1}
    profiling.reset()
    assert profiling.launches() == {} and profiling.counters() == {}


def test_setup_spans_are_timed_off_and_nest(recorder, monkeypatch):
    rec = profiling.Recorder()
    ticks = iter([0.0, 1.0, 3.0, 6.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    with rec.setup_span("setup.calibrate"):        # 0 .. 6 s
        with rec.setup_span("setup.kernels"):      # 1 .. 3 s
            pass
    setup = rec.snapshot()["setup"]
    assert setup["setup.calibrate"] == {"calls": 1, "s": 6.0, "self_s": 4.0}
    assert setup["setup.kernels"] == {"calls": 1, "s": 2.0, "self_s": 2.0}
    assert rec.records() == []


def test_phase_timer_phases_are_spans(recorder):
    timer = profiling.PhaseTimer()
    profiling.enable()
    with timer.phase("load"):
        pass
    assert [r["name"] for r in profiling.records()] == ["load"]
    assert timer.counts["load"] == 1


def _av_model(**kw):
    from avvad_tpu_torch.models import AVVAD

    return AVVAD(lstm_hidden_size=H, lstm_layers=2, mcb_output_size=MCB_OUT,
                 use_kernel_lstm=True, seed=3, **kw)


def _serving(int8: bool):
    """A tiny AVVAD serving step on the CPU (-> fn, wave, video), the
    static-int8 fused tower calibrated first where ``int8``."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import calibrate

    g = torch.Generator().manual_seed(0)
    idx = np.minimum(np.arange(T) * 30 // 62, 3)
    video = torch.randn(2, 4, 67, 67, generator=g)
    wave = torch.randn(2, 256 * (T - 1) + 1024, generator=g)
    model = _av_model(tower_int8=int8, tower_quant_mode="static", tower_pallas=int8)
    if int8:
        calibrate(model, [(torch.zeros(2, T, 513), video)],
                  video_frame_indices=torch.as_tensor(idx))
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx, device="cpu")
    return fn, wave, video


@pytest.mark.parametrize("int8", [True, False])
def test_serving_step_span_tree(recorder, int8):
    fn, wave, video = _serving(int8)
    fn(wave, video)
    assert profiling.records() == []   # off
    profiling.enable()
    probs = fn(wave, video)
    recs = profiling.records()
    assert probs.shape == (2, T, 1)
    want = {("serve.step", None), ("serve.frontend", "serve.step"), ("tower", "serve.step"),
            ("tower.stem", "tower"), ("fusion", "serve.step"), ("lstm", "serve.step"),
            ("head", "serve.step")}
    if not int8:
        want.add(("bn", "tower"))
    assert _tree(recs) == want
    assert len({r["step"] for r in recs}) == 1
    assert sum(r["name"] == "bn" for r in recs) == (0 if int8 else 20)
    setup = profiling.snapshot()["setup"]
    assert setup["setup.serving_fn"]["calls"] >= 1
    if int8:
        assert setup["setup.calibrate"]["calls"] >= 1


def test_train_step_span_tree(recorder):
    from avvad_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(0)
    batch = SimpleNamespace(audio=rng.standard_normal((2, T, 513), np.float32),
                            video=rng.standard_normal((2, T, 67, 67), np.float32),
                            label=np.ones((2, T, 1), np.float32),
                            mask=np.ones((2, T), np.float32), lengths=np.array([T, T]))
    state = create_train_state(_av_model(), device="cpu", freeze_video_trunk=True)
    step = make_train_step("av")
    profiling.enable()
    state, metrics = step(state, batch)
    recs = profiling.records()
    assert np.isfinite(float(metrics["loss"]))
    assert _tree(recs) == {
        ("train.step", None), ("train.forward", "train.step"), ("train.loss", "train.step"),
        ("train.backward", "train.step"), ("train.optimizer", "train.step"),
        ("train.metrics", "train.step"), ("tower", "train.forward"),
        ("tower.stem", "tower"), ("bn", "tower"), ("fusion", "train.forward"),
        ("lstm", "train.forward"), ("head", "train.forward")}
    assert sum(r["name"] == "bn" for r in recs) == 20
    assert len({r["step"] for r in recs}) == 1
    assert profiling.snapshot()["setup"]["setup.train_state"]["calls"] >= 1


def test_exported_serving_program_is_the_same_with_the_recorder_on(recorder):
    from avvad_tpu_torch.export import ServingArtifact

    fn, wave, video = _serving(int8=True)
    codes = []
    for on in (False, True):
        if on:
            profiling.enable()
        art = ServingArtifact.build({"b2": (fn, (wave, video))})
        codes.append(art.entries["b2"].graph_module.code)
        assert "record_function" not in codes[-1]
    assert codes[0] == codes[1]
