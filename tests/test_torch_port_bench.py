"""The port's timers (``avvad_tpu_torch/scripts/bench*.py``) on the CPU:
the history gate against bench.py's on the same histories, the records'
keys against the JAX timers' lines, the knobs and their named errors, the
liveness probe, each twin's ``main`` at smoke size with ``--device cpu``,
and the rules of the port (no JAX, no silent CPU). The programs the twins
time are held to JAX in ``tests/test_torch_port_bench_parity.py``.
"""

import ast
import importlib
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import bench as jbench
from avvad_tpu_torch.scripts import bench, bench_modalities, bench_round3

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = ("bench", "bench_modalities", "bench_streaming", "bench_wire_ab",
         "bench_artifact_overhead", "bench_round3")
# record keys, copied from the JAX timers' lines
SERVING_KEYS = {"metric", "value", "unit", "vs_baseline", "config"}  # bench.py:625-634
TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "config"}  # bench.py:217-226
MODALITY_KEYS = {"metric", "value", "unit", "ms_per_step", "vs_baseline"}  # :145-150
TRIPWIRE_KEYS = {"metric", "results", "tripwire_fired"}  # bench.py:337-338
# bench.py:314-318's row keys -> the port's: the fused kernels against the
# unfused route ("pallas" and "xla" would mislabel the port)
TRIPWIRE_ROW = {"kernel": "kernel", "pallas_ms": "kernel_ms", "xla_ms": "unfused_ms",
                "ratio_pallas_over_xla": "ratio_kernel_over_unfused",
                "pallas_faster": "kernel_faster"}
# tests/test_bench_gate.py's four cases: (mode, key, winner, s, reps,
# candidates, write-back)
GATE_CASES = {
    "regression": [("inference", "b4_t8_int80", "shipped", 0.050, [0.050, 0.051], None)],
    "within_tolerance": [("inference", "b4_t8_int80", "shipped", 0.041, [0.041], None)],
    "unknown_key": [("inference", "b99_t99_int80", "shipped", 0.050, [0.050], None),
                    ("train", "b16_t512_frozen1", "av", 0.050, [0.050], None)],
    "write_back": [("inference", "b4_t8_int80", "cand_a", 0.048, [0.048, 0.049],
                    {"cand_a": [0.048, 0.049]}),
                   ("inference", "b4_t8_int80", "cand_b", 0.039, [0.039], None),
                   ("train", "b16_t512_frozen1", "av_train_step", 0.100,
                    [0.100, 0.102, 0.101], None)],
}
SEED_HISTORY = {"inference": {"b4_t8_int80": {"best_ms_per_step": 40.0,
                                              "best_config": "seed"}}}
CARD = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these programs are many small operations, which
    a pool of threads slows down badly when the suite's workers share the
    cores (tests/test_torch_port_ranks.py does the same)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _drop_card(tree):
    if isinstance(tree, dict):
        return {k: _drop_card(v) for k, v in tree.items() if k not in ("card", "best_card")}
    return tree


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_and_record_matches_jax(tmp_path, monkeypatch, case):
    """``gate_and_record`` against bench.py's ``_gate_and_record``, each on
    its copy of the same seeded history: the same returned fields and the
    same file written, apart from the port's card fields."""
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    for p in (jpath, tpath):
        p.write_text(json.dumps(SEED_HISTORY))
    monkeypatch.setattr(jbench, "_HISTORY_PATH", str(jpath))
    if case == "write_back":
        monkeypatch.setenv("AVVAD_BENCH_WRITE_HISTORY", "1")
    else:
        monkeypatch.delenv("AVVAD_BENCH_WRITE_HISTORY", raising=False)
    for mode, key, winner, s, reps, cands in GATE_CASES[case]:
        want = jbench._gate_and_record(mode, key, winner, s, reps, candidates=cands)
        got = bench.gate_and_record(mode, key, winner, s, reps, candidates=cands,
                                    path=tpath, card=CARD)
        assert got == want
    written = json.loads(tpath.read_text())
    assert _drop_card(written) == json.loads(jpath.read_text())
    if case == "write_back":
        assert written["inference"]["b4_t8_int80"]["last"]["card"] == CARD
        assert written["inference"]["b4_t8_int80"]["best_card"] == CARD
        assert written["inference"]["b4_t8_int80"]["best_ms_per_step"] == 39.0
    if case == "regression":
        assert got == {"regression_vs_best": 1.25, "best_known_ms": 40.0}


def test_serving_knobs_default_to_bench_py():
    """bench.py's defaults (bench.py:353-534) and the ladder's order
    (:552-557); the fused int8 trunk unless AVVAD_BENCH_PALLAS_TOWER=0."""
    cfg = bench.serving_config({})
    assert (cfg["b"], cfg["t"], cfg["int8_mode"], cfg["lstm_h"], cfg["iters"],
            cfg["reps"]) == (64, 512, 2, 1024, 20, 3)
    assert cfg["auto"] and cfg["budget_s"] == 1800.0 and cfg["mcb_precision"] == "default"
    assert cfg["fused"] and cfg["route"] == "int8_fused" and not cfg["hop_dft"]
    assert bench.ladder(cfg) == [("shipped", False, "none"), ("lstm_bf16", False, "bf16"),
                                 ("lstm_int8", False, "int8"), ("hop_dft", True, "none")]
    assert bench.shape_key(cfg) == "b64_t512_int82_fused"
    unfused = bench.serving_config({"AVVAD_BENCH_PALLAS_TOWER": "0"})
    assert not unfused["fused"] and unfused["route"] == "int8_unfused"
    for env in ({"AVVAD_BENCH_HOP_DFT": "1"}, {"AVVAD_BENCH_LSTM_QUANT": "int8"},
                {"AVVAD_BENCH_MCB_HOIST": "0"}):
        assert not bench.serving_config(env)["auto"]  # an explicit candidate flag
    assert bench.ladder(bench.serving_config({"AVVAD_BENCH_LSTM_QUANT": "int8",
                                              "AVVAD_BENCH_HOP_DFT": "1"})) == [
        ("shipped", True, "int8")]
    assert bench.serving_config({"AVVAD_BENCH_MCB_PREC": "highest"})["mcb_precision"] \
        == "highest"
    assert bench.serving_config({"AVVAD_BENCH_INT8": "0"})["route"] == "float"


@pytest.mark.parametrize("env, match", [
    ({"AVVAD_BENCH_CHUNK_UNROLL": "1"}, "AVVAD_BENCH_CHUNK_UNROLL"),
    ({"AVVAD_BENCH_FE_PREC": "high"}, "AVVAD_BENCH_FE_PREC"),
    ({"AVVAD_BENCH_PALLAS_TOWER": "1", "AVVAD_BENCH_INT8": "0"},
     "AVVAD_BENCH_PALLAS_TOWER=1 requires AVVAD_BENCH_INT8=2"),
    ({"AVVAD_BENCH_PALLAS_TOWER": "1", "AVVAD_BENCH_INT8": "1"},
     "AVVAD_BENCH_PALLAS_TOWER=1 requires AVVAD_BENCH_INT8=2"),
    ({"AVVAD_BENCH_STEM_INT8": "1", "AVVAD_BENCH_INT8": "0"},
     "AVVAD_BENCH_STEM_INT8=1 requires AVVAD_BENCH_INT8=2"),
])
def test_serving_knobs_named_errors(env, match):
    """The XLA-only flags and bench.py's consistency errors (bench.py:398-403)."""
    with pytest.raises(SystemExit, match=match):
        bench.serving_config(env)


def test_record_keys_match_the_jax_timers():
    """Each record's keys, ``metric`` and ``unit`` against the JAX lines."""
    cfg = bench.serving_config({})
    rec = bench.serving_record(cfg, "lstm_int8", 0.04, {})
    assert set(rec) == SERVING_KEYS and rec["metric"] == "av_vad_inference_rt_factor"
    assert rec["unit"] == "x_realtime_per_chip"
    assert rec["value"] == round(64 * 512 / 62.5 / 0.04, 2)
    assert rec["vs_baseline"] == round(rec["value"] / 50.0, 3)
    assert rec["config"] == "lstm_int8; tower: int8 static, fused kernels"
    extra = {"regression_vs_best": 1.25, "best_known_ms": 40.0}
    assert set(bench.serving_record(cfg, "x", 0.05, extra)) == SERVING_KEYS | set(extra)
    mrec = bench_modalities.record("video", 1000.0, 0.05)
    assert set(mrec) == MODALITY_KEYS and mrec["metric"] == "video_vad_inference_rt_factor"
    assert mrec["ms_per_step"] == 50.0 and mrec["unit"] == "x_realtime_per_chip"
    row = bench._tripwire_row("k", 0.001, 0.004)
    assert set(row) == set(TRIPWIRE_ROW.values())
    assert row == {"kernel": "k", "kernel_ms": 1.0, "unfused_ms": 4.0,
                   "ratio_kernel_over_unfused": 0.25, "kernel_faster": True}


def test_liveness_probe_exits_1_with_the_error_record():
    """A probe that never answers within 0.1 s: the error record on stdout,
    exit code 1 (bench.py exits 0 there)."""
    code = ("import threading\n"
            "from avvad_tpu_torch.scripts.bench import require_live_backend\n"
            "require_live_backend('cpu', 0.1, probe=threading.Event().wait)\n"
            "print('not reached')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert rec["value"] == 0.0 and "unresponsive after 0.1 s" in rec["error"]
    assert "not reached" not in out.stdout


def _records(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


SMOKE_ENV = {"AVVAD_BENCH_B": "1", "AVVAD_BENCH_T": "4", "AVVAD_BENCH_LSTM_H": "32",
             "AVVAD_BENCH_ITERS": "1", "AVVAD_BENCH_REPS": "1", "AVVAD_BENCH_TRAIN_B": "1",
             "AVVAD_BENCH_TRAIN_T": "4", "AVVAD_BENCH_TRAIN_H": "32", "AVVAD_TRIPWIRE_N": "2",
             "AVVAD_BENCH_AUTO": "0", "AVVAD_BENCH_MCB_HOIST": "1",
             "AVVAD_BENCH_LSTM_QUANT": "int8"}
SMOKE = {
    "bench": [],
    "bench --train-matrix": ["--train-matrix"],
    "bench --kernel-tripwire": ["--kernel-tripwire"],
    "bench_modalities": ["--configs", "audio", "video", "--batch", "1", "--frames", "4",
                         "--iters", "1", "--rounds", "1"],
    "bench_streaming": ["--streams", "2", "--ticks", "1"],
    "bench_wire_ab": ["--streams", "2", "--ticks", "1", "--rounds", "1"],
    "bench_artifact_overhead": ["--b", "1", "--t", "4", "--iters", "1"],
}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_twin_main_prints_parseable_records(monkeypatch, capsys, name, tmp_path):
    """Each twin's main with --device cpu at smoke size: json records with
    finite, positive values (the plain versions; the numbers measure
    nothing). History is neither read from nor written to the repository."""
    for k, v in SMOKE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("AVVAD_BENCH_WRITE_HISTORY", raising=False)
    monkeypatch.setattr(bench, "HISTORY_PATH", tmp_path / "none.json")
    mod = importlib.import_module(f"avvad_tpu_torch.scripts.{name.split()[0]}")
    out = mod.main([*SMOKE[name], "--device", "cpu"])
    recs = _records(capsys.readouterr().out)
    assert recs
    flat = recs[0]["configs"] if name == "bench --train-matrix" else recs
    if name == "bench --kernel-tripwire":
        assert set(recs[0]) == TRIPWIRE_KEYS
        flat = [{"value": r["kernel_ms"]} for r in recs[0]["results"]]
    for rec in flat:
        assert rec["value"] > 0 and rec["value"] != float("inf")
    if name == "bench":
        assert set(out) == SERVING_KEYS
        assert out["config"] == ("explicit:hop_dft=0,lstm=int8+mcb_hoist(env); "
                                 "tower: int8 static, fused kernels")
    if name == "bench --train-matrix":
        assert [r["metric"] for r in out["configs"]] == [
            "av_vad_train_rt_factor", "av_vad_train_rt_factor",
            "audio_vad_train_rt_factor", "video_vad_train_rt_factor"]
        assert all(set(r) == TRAIN_KEYS for r in out["configs"])
    if name == "bench_modalities":
        assert [set(r) for r in out] == [MODALITY_KEYS] * 2
    assert not (ROOT / "BENCH_HISTORY_torch.json").exists() or name == "bench_round3"


ROUND3 = {  # scripts/bench_round3.sh:16-26 and scripts/bench_round3b.sh:21-47
    "3": ["python -m avvad_tpu_torch.scripts.bench",
          "AVVAD_BENCH_B=96 python -m avvad_tpu_torch.scripts.bench",
          "AVVAD_BENCH_B=128 python -m avvad_tpu_torch.scripts.bench",
          "python -m avvad_tpu_torch.scripts.bench_streaming --av --ticks 40",
          "python -m avvad_tpu_torch.scripts.bench_streaming --av --av-u8 --ticks 40",
          "python -m avvad_tpu_torch.scripts.bench_streaming --av --av-int8 --ticks 40",
          "python -m avvad_tpu_torch.scripts.bench_streaming --av --av-int8 --av-u8 --ticks 40",
          "python -m avvad_tpu_torch.scripts.bench_modalities --configs audio wavenet video"],
    "3b": ["python -m avvad_tpu_torch.tools.lstm_probe --iters 30",
           "AVVAD_BENCH_AUTO_BUDGET_S=3000 python -m avvad_tpu_torch.scripts.bench",
           "AVVAD_BENCH_LSTM_QUANT=bf16 python -m avvad_tpu_torch.scripts.bench",
           "python -m avvad_tpu_torch.scripts.bench_streaming --av-int8 --av-u8",
           "python -m avvad_tpu_torch.scripts.bench_streaming --av-int8 --av-u8 --audio-span",
           "python -m avvad_tpu_torch.scripts.bench_streaming --av-int8 --av-u8 --hop-dft",
           "python -m avvad_tpu_torch.scripts.bench_artifact_overhead --iters 20"],
}


@pytest.mark.parametrize("which", sorted(ROUND3))
def test_round3_plan_matches_the_shell_passes(capsys, which):
    """--print-only: the items of bench_round3.sh / bench_round3b.sh through
    the port's twins, in order, with --device passed through."""
    recs = bench_round3.main(["--pass", which, "--print-only", "--device", "cpu"])
    assert [r["command"] for r in recs] == [f"{c} --device cpu" for c in ROUND3[which]]
    assert recs == _records(capsys.readouterr().out)
    assert {r["timeout_s"] for r in recs} == ({None} if which == "3" else {1800, 3600, 4800})


def test_round3_runs_items_in_series_into_the_log(tmp_path):
    """run_item: the shell scripts' framing in the log, the item's output,
    its exit code, a timeout as 124."""
    log_path = tmp_path / "r.log"
    with open(log_path, "w") as log:
        ok = bench_round3.run_item({"X": "1"}, [sys.executable, "-c",
                                                "import os; print('x=' + os.environ['X'])"],
                                   60, log)
        bad = bench_round3.run_item({}, [sys.executable, "-c", "raise SystemExit(3)"], 60,
                                    log)
        slow = bench_round3.run_item({}, [sys.executable, "-c", "import time; "
                                          "time.sleep(30)"], 0.5, log)
    text = log_path.read_text()
    assert (ok["rc"], bad["rc"], slow["rc"]) == (0, 3, 124)
    assert ok["command"].startswith("X=1 python -c")
    assert "x=1\n--- rc=0 ---" in text and "--- rc=3 ---" in text
    assert text.count("=== ") == 3 and ok["value"] > 0


def _module_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_no_jax_and_no_optional_package(name):
    """No jax, flax, avvad_tpu or h5py anywhere in a twin; no matplotlib,
    yaml or cv2 at module level."""
    path = ROOT / "avvad_tpu_torch" / "scripts" / f"{name}.py"
    tree = ast.parse(path.read_text())
    every = {(a.name if isinstance(n, ast.Import) else n.module or "").split(".")[0]
             for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
             and not getattr(n, "level", 0) for a in getattr(n, "names", [None])}
    assert not every & {"jax", "flax", "avvad_tpu", "h5py"}
    assert not {m.split(".")[0] for m in _module_level_imports(path)} & {
        "matplotlib", "yaml", "cv2"}


RAISE = {"bench": [], "bench --train": ["--train"], "bench_modalities": [],
         "bench_streaming": [], "bench_wire_ab": [], "bench_artifact_overhead": [],
         "bench_round3": ["--log", "r.log"]}


@pytest.mark.parametrize("name", sorted(RAISE))
def test_twin_raises_without_a_card(monkeypatch, tmp_path, name):
    """Each twin runs on the card unless given --device cpu: with no card it
    raises before it runs or writes anything."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"avvad_tpu_torch.scripts.{name.split()[0]}")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(RAISE[name])
    assert list(tmp_path.iterdir()) == []
