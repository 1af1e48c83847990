"""Headline timers of the port: AV-VAD serving and training throughput on
one card (counterpart of the repository's bench.py, all four modes).

    python -m avvad_tpu_torch.scripts.bench                      # serving
    python -m avvad_tpu_torch.scripts.bench --train              # one train step
    python -m avvad_tpu_torch.scripts.bench --train-matrix       # four train steps
    python -m avvad_tpu_torch.scripts.bench --kernel-tripwire    # fused vs unfused

Serving (``main``) times the full serving step that ``export.
make_waveform_serving_fn`` builds for ``AVVAD``: raw waveform -> log-power
frontend -> ResNet-18 tower on the unique 30 fps frames -> MCB -> 2 x LSTM
1024 -> probabilities, bf16 model, B=64 x T=512 frames, and prints ONE json
line with bench.py's keys (``metric``, ``value``, ``unit``, ``vs_baseline``,
``config``). The environment variables are bench.py's, with its defaults:

  AVVAD_BENCH_INT8        0 float tower, 1 dynamic W8A8, 2 calibrated static
                          W8A8 (the default; scales from 2 utterances)
  AVVAD_BENCH_PALLAS_TOWER  unset: with INT8=2 the fused kernels (the stem
                          epilogue kernel once, the int8 BasicBlock kernel 8
                          times a pass: eager torch has no CUDA int8
                          convolution, so they are the int8 trunk on the card);
                          0: the unfused route (each int8 conv a float64
                          convolution); 1: the fused kernels, INT8=2 required
  AVVAD_BENCH_STEM_INT8   1: the W8A8 stem conv (INT8=2 required)
  AVVAD_BENCH_CHUNK       frames per tower pass (0: one pass)
  AVVAD_BENCH_MCB_PREC    "highest": fp32 MCB matmuls (default: bf16 operands)
  AVVAD_BENCH_MCB_HOIST   1: the MCB sketches stored pre-folded
  AVVAD_BENCH_HOP_DFT     1: the hop-block DFT frontend
  AVVAD_BENCH_LSTM_QUANT  none / bf16 / int8 recurrence state
  AVVAD_BENCH_LSTM_H, _B, _T, _ITERS (20), _REPS (3)
  AVVAD_BENCH_AUTO        the ladder (default on unless HOP_DFT, LSTM_QUANT or
                          MCB_HOIST is set): shipped, lstm_bf16, lstm_int8,
                          hop_dft, then +mcb_hoist on the winner; the winner
                          gets the full ITERS x REPS measurement
  AVVAD_BENCH_AUTO_BUDGET_S  seconds after which the ladder stops (1800)

AVVAD_BENCH_CHUNK_UNROLL=1 (an XLA scan choice) and AVVAD_BENCH_FE_PREC=high
(XLA's bf16x3 matmuls) have no counterpart here and raise a SystemExit that
names them.

Every timed step depends on the one before it (the input is wave + carry x
0, the carry the previous step's first probability), and a value fetch of
the last carry is the barrier; the minimum over the reps is the result.
The training modes chain each step on the state the last one updated and
fetch the loss at the end.

History gate: the best-known ms/step a (mode, shape key) lives in the port's
own ``BENCH_HISTORY_torch.json`` at the repository root (the JAX package's
BENCH_HISTORY.json holds a TPU's numbers and is neither read nor written).
A result more than 5 % slower than the best adds ``regression_vs_best``
and ``best_known_ms`` to the record; AVVAD_BENCH_WRITE_HISTORY=1 merges the
numbers back, the best kept monotone, each entry naming the card. The file
is not committed.

Runs on the CUDA card unless ``--device cpu``, where the plain versions of
the kernels run and the numbers measure nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ._common import add_device_flag, device_of

FS, HOP = 16000, 256
FRAME_RATE = FS / HOP  # 62.5
NFFT = 1024
VIDEO_FPS = 30.0
HISTORY_PATH = Path(__file__).resolve().parents[2] / "BENCH_HISTORY_torch.json"
METRIC = "av_vad_inference_rt_factor"
UNIT = "x_realtime_per_chip"
BASELINE_RT = 50.0  # BASELINE.md: >= 50x real time a chip
REGRESSION = 1.05
# the record's `config` names the tower's route
ROUTES = {"float": "float tower", "int8_dynamic": "int8 dynamic, unfused",
          "int8_unfused": "int8 static, unfused",
          "int8_fused": "int8 static, fused kernels"}
# environment variables with no counterpart in the port
XLA_ONLY = {"AVVAD_BENCH_CHUNK_UNROLL": "1", "AVVAD_BENCH_FE_PREC": "high"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def n_samples(t: int) -> int:
    """Exactly ``t`` STFT frames, no end pad."""
    return HOP * (t - 1) + NFFT


# --- liveness and the history gate ---------------------------------------------


def _tiny_matmul(device: torch.device) -> None:
    x = torch.ones(8, 128, device=device)
    float((x @ x.T).sum())


def require_live_backend(device: torch.device, timeout_s: Optional[float] = None,
                         probe: Optional[Callable[[], None]] = None) -> None:
    """Fail fast, with a parseable record, if the card never answers a tiny
    matmul within AVVAD_BENCH_LIVENESS_S (600 s). The probe runs in a daemon
    thread; on timeout the error record is printed and the process exits 1
    at once (``os._exit``: a wedged CUDA context can hang the interpreter's
    own exit). bench.py exits 0 there; a card that never answers is a
    failure here, not a result."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("AVVAD_BENCH_LIVENESS_S", "600"))
    probe = probe or (lambda: _tiny_matmul(device))
    done = threading.Event()

    def run():
        probe()
        done.set()

    threading.Thread(target=run, daemon=True).start()
    if not done.wait(timeout_s):
        print(f"bench: {device} unresponsive after {timeout_s:g} s liveness probe",
              file=sys.stderr)
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT,
                          "vs_baseline": 0.0,
                          "error": f"{device} unresponsive after {timeout_s:g} s "
                                   "liveness probe"}), flush=True)
        sys.stderr.flush()
        os._exit(1)


def card_identity(device: torch.device) -> dict:
    """The card's name, and its power limit where nvidia-smi answers."""
    if device.type != "cuda":
        return {"name": "cpu"}
    out = {"name": torch.cuda.get_device_name(device)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            out["power_limit"] = res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def load_history(path=None) -> dict:
    try:
        with open(HISTORY_PATH if path is None else path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def gate_and_record(mode: str, shape_key: str, winner: str, step_time: float,
                    rep_times: list, candidates: Optional[dict] = None,
                    path=None, card: Optional[dict] = None) -> dict:
    """bench.py's ``_gate_and_record`` on the port's history file: the
    winner against the recorded best (5 % tolerance) -> the record's extra
    fields; with AVVAD_BENCH_WRITE_HISTORY=1 the numbers merged back (best
    monotone), ``card`` written beside the last run and beside a new best.
    ``path``: the history file (``HISTORY_PATH`` by default)."""
    path = HISTORY_PATH if path is None else path
    ms = step_time * 1e3
    history = load_history(path)
    entry = history.get(mode, {}).get(shape_key)
    extra: dict = {}
    if entry and "best_ms_per_step" in entry:
        best = float(entry["best_ms_per_step"])
        if ms > best * REGRESSION:
            extra["regression_vs_best"] = round(ms / best, 3)
            extra["best_known_ms"] = round(best, 2)
            print(f"bench REGRESSION: {mode}/{shape_key} winner {winner} measured "
                  f"{ms:.2f} ms/step vs best-known {best:.2f} ({ms / best:.2f}x)",
                  file=sys.stderr)
    if os.environ.get("AVVAD_BENCH_WRITE_HISTORY") == "1":
        cur = history.setdefault(mode, {}).setdefault(shape_key, {})
        if "best_ms_per_step" not in cur or ms < cur["best_ms_per_step"]:
            cur["best_ms_per_step"] = round(ms, 3)
            cur["best_config"] = winner
            cur["best_card"] = card
        cur["last"] = {
            "winner": winner, "ms_per_step": round(ms, 3),
            "rep_ms": [round(r * 1e3, 3) for r in rep_times],
            "mean_ms": round(float(np.mean(rep_times)) * 1e3, 3),
            "spread_ms": round((max(rep_times) - min(rep_times)) * 1e3, 3),
            "card": card,
        }
        if candidates:
            cur["candidates_ms"] = {
                k: {"rep_ms": [round(r * 1e3, 3) for r in v],
                    "min_ms": round(min(v) * 1e3, 3),
                    "mean_ms": round(float(np.mean(v)) * 1e3, 3)}
                for k, v in candidates.items()}
        with open(path, "w") as f:
            json.dump(history, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"bench history updated: {mode}/{shape_key}", file=sys.stderr)
    return extra


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


# --- training ------------------------------------------------------------------


class TrainBench(NamedTuple):
    state: object
    batch: object
    step: Callable


def train_inputs(b: int, t: int) -> tuple:
    """bench.py's draws (``np.random.default_rng(0)``): audio (B, T, 513),
    video (B, T, 67, 67) normal, labels in {0, 1}."""
    rng = np.random.default_rng(0)
    audio = rng.normal(size=(b, t, 513)).astype(np.float32)
    video = rng.normal(size=(b, t, 67, 67)).astype(np.float32)
    label = rng.integers(0, 2, size=(b, t, 1)).astype(np.float32)
    return audio, video, label


def build_train_bench(modality: str, freeze: bool, b: int, t: int, lstm_h: int,
                      device: torch.device, state_dict: Optional[dict] = None,
                      mcb_output_size: int = 1024) -> TrainBench:
    """One config of the train matrix (bench.py:150-200): the fp32 model
    (LSTM on the training kernels), Adam 1e-4 (the trunk frozen with
    ``freeze``), TF32 off, the batch of ``train_inputs`` on ``device`` and
    the train step.
    ``state_dict``: weights to start from (``convert.from_flax_variables``)."""
    from ..data import Batch
    from ..models import AVVAD, AudioVAD, VideoVAD
    from ..train import create_train_state, make_train_step

    kw = dict(y_dim=1, lstm_hidden_size=lstm_h, lstm_layers=2, use_kernel_lstm=True)
    if modality == "audio":
        model = AudioVAD(**kw)
    elif modality == "video":
        model = VideoVAD(**kw)
    elif modality == "av":
        model = AVVAD(**kw, use_mcb=True, mcb_output_size=mcb_output_size)
    else:
        raise ValueError(f"train bench modality {modality!r}: audio, video or av")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    state = create_train_state(model, 1e-4, freeze_video_trunk=freeze, device=device)
    audio, video, label = train_inputs(b, t)

    def on_device(a):  # the batch stays on the card, as bench.py's jnp arrays do
        return None if a is None else torch.from_numpy(a).to(state.device)

    batch = Batch(audio=on_device(audio if modality != "video" else None),
                  video=on_device(video if modality != "audio" else None),
                  label=on_device(label), lengths=np.full((b,), t, np.int32),
                  mask=on_device(np.ones((b, t), np.float32)))
    return TrainBench(state, batch, make_train_step(modality))


def train_bench_one(modality: str, freeze: bool, b: int, t: int, iters: int, reps: int,
                    lstm_h: int, device: torch.device, card: Optional[dict] = None) -> dict:
    """Time one train-step config -> bench.py's record."""
    tb = build_train_bench(modality, freeze, b, t, lstm_h, device)
    state, metrics = tb.step(tb.state, tb.batch)  # warm-up
    float(metrics["loss"])
    rep_times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = tb.step(state, tb.batch)
        float(metrics["loss"])  # barrier: the chain's last value
        rep_times.append((time.perf_counter() - t0) / iters)
    step_time = min(rep_times)
    rt_factor = (b * t / FRAME_RATE) / step_time
    shape_key = f"{modality}_b{b}_t{t}_frozen{int(freeze)}"
    extra = gate_and_record("train", shape_key, f"{modality}_train_step", step_time,
                            rep_times, card=card)
    return {
        "metric": f"{modality}_vad_train_rt_factor",
        "value": round(rt_factor, 2),
        "unit": UNIT,
        "vs_baseline": round(rt_factor / BASELINE_RT, 3),
        "config": f"{modality}_train b={b} t={t} frozen_trunk={int(freeze)} "
                  f"ms_per_step={step_time * 1e3:.1f}",
        **extra,
    }


def train_env() -> tuple:
    return (_env_int("AVVAD_BENCH_TRAIN_B", 16), _env_int("AVVAD_BENCH_TRAIN_T", 512),
            _env_int("AVVAD_BENCH_ITERS", 10), _env_int("AVVAD_BENCH_REPS", 3),
            _env_int("AVVAD_BENCH_TRAIN_H", 1024))


TRAIN_MATRIX = (("av", True), ("av", False), ("audio", False), ("video", False))


def train_main(device: torch.device) -> dict:
    """AVVAD_BENCH_TRAIN_MODALITY (av / audio / video), AVVAD_BENCH_TRAIN_FREEZE
    (av only; 1 by default) -> ONE json line."""
    b, t, iters, reps, lstm_h = train_env()
    modality = os.environ.get("AVVAD_BENCH_TRAIN_MODALITY", "av")
    freeze = os.environ.get("AVVAD_BENCH_TRAIN_FREEZE", "1") == "1" and modality == "av"
    rec = train_bench_one(modality, freeze, b, t, iters, reps, lstm_h, device,
                          card_identity(device))
    print(json.dumps(rec), flush=True)
    return rec


def train_matrix_main(device: torch.device) -> dict:
    """Frozen AV, unfrozen AV, audio, video -> ONE json line of four records."""
    b, t, iters, reps, lstm_h = train_env()
    card, records = card_identity(device), []
    for modality, freeze in TRAIN_MATRIX:
        rec = train_bench_one(modality, freeze, b, t, iters, reps, lstm_h, device, card)
        print(f"train matrix: {rec['config']} -> {rec['value']}x rt", file=sys.stderr)
        records.append(rec)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {"metric": "train_matrix", "configs": records}
    print(json.dumps(out), flush=True)
    return out


# --- the kernel tripwire -------------------------------------------------------


def tripwire_trunk(n: int, device: torch.device):
    """The calibrated static-int8 ResNet-18 trunk of the tripwire
    (bench.py:302-311): fp32, gray input, scales recorded on the first 8 of
    ``n`` normal frames -> (trunk, frames (n, 1, 67, 67) on ``device``)."""
    from ..models import ResNet18, calibrate

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, 1, 67, 67)).astype(np.float32)).to(device)
    trunk = ResNet18(gray_input=True, quant_int8=True, quant_mode="static").to(device)
    calibrate(trunk, [x[:8]])
    return trunk.eval(), x


def stem_tripwire_inputs(n: int, device: torch.device) -> tuple:
    """The stem epilogue's inputs (bench.py:321-323): (n, 64, 34, 34)
    normal values as the model feeds them, channels-last bf16, and the (64,)
    affine a ~ U(0.5, 1.5), b ~ N(0, 1)."""
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.normal(size=(n, 34, 34, 64)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    xs = xs.to(device, torch.bfloat16).permute(0, 3, 1, 2)
    return xs, a.to(device), b.to(device)


def _best_ms(fn, reps: int, iters: int, device: torch.device) -> float:
    fn()
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _tripwire_row(name: str, t_kernel: float, t_unfused: float) -> dict:
    return {"kernel": name, "kernel_ms": round(t_kernel * 1e3, 2),
            "unfused_ms": round(t_unfused * 1e3, 2),
            "ratio_kernel_over_unfused": round(t_kernel / t_unfused, 3),
            "kernel_faster": bool(t_kernel < t_unfused)}


def kernel_tripwire_main(device: torch.device, on_trunk: Optional[Callable] = None) -> dict:
    """The fused kernels against the unfused route on the same inputs
    (bench.py:267-338): (1) the calibrated static-int8 trunk at N=512
    frames (AVVAD_TRIPWIRE_N), the stem epilogue kernel once and the int8
    BasicBlock kernel 8 times against the unfused int8 route; (2) the stem
    epilogue kernel against its plain version. Keys: bench.py's
    ``pallas_ms`` / ``xla_ms`` / ``ratio_pallas_over_xla`` /
    ``pallas_faster`` become ``kernel_ms`` / ``unfused_ms`` /
    ``ratio_kernel_over_unfused`` / ``kernel_faster``. ONE json line.
    ``on_trunk(trunk, frames)``, if given, is called once the timing is done."""
    from ..ops.stem_fused import stem_epilogue_plain, stem_epilogue_pool_quant

    n = _env_int("AVVAD_TRIPWIRE_N", 512)
    reps, iters = _env_int("AVVAD_BENCH_REPS", 3), _env_int("AVVAD_BENCH_ITERS", 10)
    trunk, x = tripwire_trunk(n, device)

    def run(fused: bool):
        trunk.stages_pallas = fused
        with torch.inference_mode():
            return trunk(x)

    t_unfused = _best_ms(lambda: run(False), reps, iters, device)
    t_kernel = _best_ms(lambda: run(True), reps, iters, device)
    results = [_tripwire_row(f"int8 trunk: stem epilogue + 8 int8 BasicBlocks (N={n})",
                             t_kernel, t_unfused)]
    xs, a, b = stem_tripwire_inputs(n, device)
    with torch.inference_mode():
        t_unfused = _best_ms(lambda: stem_epilogue_plain(xs, a, b), reps, iters, device)
        t_kernel = _best_ms(lambda: stem_epilogue_pool_quant(xs, a, b), reps, iters, device)
    results.append(_tripwire_row(f"stem epilogue (N={n})", t_kernel, t_unfused))
    fired = [r["kernel"] for r in results if r["kernel_faster"]]
    if fired:
        print("TRIPWIRE: the fused kernel is faster for " + ", ".join(fired),
              file=sys.stderr)
    out = {"metric": "kernel_tripwire", "results": results, "tripwire_fired": bool(fired)}
    print(json.dumps(out), flush=True)
    if on_trunk is not None:
        on_trunk(trunk, x)
    return out


# --- serving -------------------------------------------------------------------


def serving_config(env=None) -> dict:
    """bench.py's knobs (bench.py:353-424, 460-534) from ``env`` (the
    process environment by default), with its consistency errors."""
    env = os.environ if env is None else env
    for name, value in XLA_ONLY.items():
        if env.get(name) == value:
            raise SystemExit(f"{name}={value} has no counterpart in the port (an XLA "
                             "choice); unset it")
    int8_mode = int(env.get("AVVAD_BENCH_INT8", "2"))
    if int8_mode not in (0, 1, 2):
        raise SystemExit(f"AVVAD_BENCH_INT8={int8_mode}: 0, 1 or 2")
    pallas_env = env.get("AVVAD_BENCH_PALLAS_TOWER")
    stem_int8 = env.get("AVVAD_BENCH_STEM_INT8", "0") == "1"
    if pallas_env == "1" and int8_mode != 2:
        raise SystemExit("AVVAD_BENCH_PALLAS_TOWER=1 requires "
                         "AVVAD_BENCH_INT8=2 (calibrated static scales)")
    if stem_int8 and int8_mode != 2:
        raise SystemExit("AVVAD_BENCH_STEM_INT8=1 requires "
                         "AVVAD_BENCH_INT8=2 (calibrated static scales)")
    # with static scales the fused kernels run unless asked for the unfused route
    fused = int8_mode == 2 and pallas_env != "0"
    explicit = any(k in env for k in ("AVVAD_BENCH_HOP_DFT", "AVVAD_BENCH_LSTM_QUANT",
                                      "AVVAD_BENCH_MCB_HOIST"))
    lstm_quant = env.get("AVVAD_BENCH_LSTM_QUANT", "none")
    if lstm_quant not in ("none", "bf16", "int8"):
        raise SystemExit(f"AVVAD_BENCH_LSTM_QUANT={lstm_quant}: none, bf16 or int8")
    route = ("float" if int8_mode == 0 else "int8_dynamic" if int8_mode == 1
             else "int8_fused" if fused else "int8_unfused")
    return {
        "b": int(env.get("AVVAD_BENCH_B", "64")), "t": int(env.get("AVVAD_BENCH_T", "512")),
        "int8_mode": int8_mode, "tower_chunk": int(env.get("AVVAD_BENCH_CHUNK", "0")),
        "stem_int8": stem_int8, "fused": fused, "route": route,
        "mcb_precision": ("highest" if env.get("AVVAD_BENCH_MCB_PREC") == "highest"
                          else "default"),
        "lstm_quant": lstm_quant, "lstm_h": int(env.get("AVVAD_BENCH_LSTM_H", "1024")),
        "hop_dft": env.get("AVVAD_BENCH_HOP_DFT") == "1",
        "mcb_hoist": env.get("AVVAD_BENCH_MCB_HOIST") == "1",
        "auto": env.get("AVVAD_BENCH_AUTO", "0" if explicit else "1") == "1",
        "budget_s": float(env.get("AVVAD_BENCH_AUTO_BUDGET_S", "1800")),
        "iters": int(env.get("AVVAD_BENCH_ITERS", "20")),
        "reps": int(env.get("AVVAD_BENCH_REPS", "3")),
    }


def shape_key(cfg: dict) -> str:
    return (f"b{cfg['b']}_t{cfg['t']}_int8{cfg['int8_mode']}"
            + ("_stem" if cfg["stem_int8"] else "") + ("_fused" if cfg["fused"] else "")
            + (f"_chunk{cfg['tower_chunk']}" if cfg["tower_chunk"] else ""))


def serving_inputs(b: int, t: int, seed: int = 0) -> tuple:
    """(wave (B, n), video (B, t_src, 67, 67), frame indices (t,)): normal
    draws from ``seed`` and the 30 fps unique-frame schedule
    (bench.py:431-443)."""
    from ..processing import unique_frame_schedule

    t_src, idx = unique_frame_schedule(t, VIDEO_FPS, FRAME_RATE)
    rng = np.random.default_rng(seed)
    wave = rng.standard_normal((b, n_samples(t)), np.float32)
    video = rng.standard_normal((b, t_src, 67, 67), np.float32)
    return wave, video, idx


class Serving(NamedTuple):
    """A built serving bench: the model, the inputs on the device and the
    ``make(hop_dft, lstm_quant, mcb_hoist)`` of a candidate's step."""
    model: torch.nn.Module
    wave: torch.Tensor
    video: torch.Tensor
    frame_idx: np.ndarray
    make: Callable


def serving_model(cfg: dict, mcb_output_size: int = 1024, **overrides):
    """bench.py's AVVAD (bench.py:416-424) for ``cfg``, on the CPU."""
    from ..models import AVVAD

    kw = dict(y_dim=1, lstm_hidden_size=cfg["lstm_h"], lstm_layers=2, use_mcb=True,
              mcb_output_size=mcb_output_size, use_kernel_lstm=True,
              lstm_state_quant=cfg["lstm_quant"], dtype=torch.bfloat16,
              tower_int8=cfg["int8_mode"] > 0,
              tower_quant_mode="static" if cfg["int8_mode"] == 2 else "dynamic",
              tower_pallas=cfg["fused"], tower_stem_int8=cfg["stem_int8"],
              tower_chunk=cfg["tower_chunk"], mcb_precision=cfg["mcb_precision"])
    kw.update(overrides)
    return AVVAD(**kw)


def build_serving(cfg: dict, device: torch.device, state_dict: Optional[dict] = None,
                  inputs: Optional[tuple] = None, mcb_output_size: int = 1024) -> Serving:
    """The serving bench of ``cfg``: the model (``state_dict`` loaded where
    given), with INT8=2 its scales calibrated on the first 2 utterances of
    zero audio features and the video (bench.py:447-458), and the inputs
    (``serving_inputs`` unless given) on ``device``."""
    from ..export import make_waveform_serving_fn
    from ..models import calibrate
    from ._common import hoist_mcb

    wave, video, idx = inputs if inputs is not None else serving_inputs(cfg["b"], cfg["t"])
    model = serving_model(cfg, mcb_output_size)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model = model.to(device).eval()
    wave = torch.as_tensor(np.asarray(wave, np.float32), device=device)
    video = torch.as_tensor(np.asarray(video, np.float32), device=device)
    if cfg["int8_mode"] == 2:
        calibrate(model, [(torch.zeros(2, cfg["t"], 513, device=device), video[:2])],
                  video_frame_indices=torch.as_tensor(idx, device=device))
    hoisted = {}

    def make(hop_dft: bool, lstm_quant: str, mcb_hoist: bool):
        """-> the serving step of a candidate: bench.py's make_serve (the
        composition deployment exports), its recurrence state set at each
        call; the hoisted model is made once."""
        mdl = model
        if mcb_hoist:
            if "m" not in hoisted:
                hoisted["m"] = hoist_mcb(model, lambda **kw: serving_model(
                    cfg, mcb_output_size, **kw)).eval()
            mdl = hoisted["m"]
        fn = make_waveform_serving_fn(mdl, t_frames=cfg["t"], hop_dft=hop_dft,
                                      video_frame_indices=idx, device=device)

        def serve(w, v):
            mdl.set_lstm_state_quant(lstm_quant)
            return fn(w, v)

        return serve

    return Serving(model, wave, video, idx, make)


def time_serve(serve, inputs: tuple, n_iters: int, reps: int) -> list:
    """bench.py's chained timing (bench.py:483-506; the other timers' is the
    same) -> per-rep seconds a step of ``serve(*inputs)``: two warm-ups in
    the chained form, then each rep's steps chained through the first
    output value (the first input + carry x 0), a value fetch of the last
    carry ending the rep."""
    first, rest = inputs[0], inputs[1:]
    out = serve(*inputs)
    carry = torch.zeros((), device=first.device)
    out = serve(first + carry * 0.0, *rest)
    carry = out.reshape(-1)[0].float()
    out = serve(first + carry * 0.0, *rest)
    float(out.reshape(-1)[0])
    times = []
    for _ in range(reps):
        carry = torch.zeros((), device=first.device)
        t0 = time.perf_counter()
        for _ in range(n_iters):
            out = serve(first + carry * 0.0, *rest)
            carry = out.reshape(-1)[0].float()
        float(carry)  # value fetch: the barrier
        times.append((time.perf_counter() - t0) / n_iters)
    return times


def ladder(cfg: dict) -> list:
    """The AUTO candidates (bench.py:552-557): (name, hop_dft, lstm_quant)."""
    cands = [("shipped", cfg["hop_dft"], cfg["lstm_quant"])]
    if cfg["lstm_quant"] == "none":
        cands += [("lstm_bf16", cfg["hop_dft"], "bf16"), ("lstm_int8", cfg["hop_dft"], "int8")]
    if not cfg["hop_dft"]:
        cands.append(("hop_dft", True, cfg["lstm_quant"]))
    return cands


def serving_record(cfg: dict, winner: str, step_time: float, extra: dict) -> dict:
    rt_factor = cfg["b"] * cfg["t"] / FRAME_RATE / step_time
    return {"metric": METRIC, "value": round(rt_factor, 2), "unit": UNIT,
            "vs_baseline": round(rt_factor / BASELINE_RT, 3),
            "config": f"{winner}; tower: {ROUTES[cfg['route']]}", **extra}


def serving_main(device: torch.device, cfg: Optional[dict] = None,
                 on_serving: Optional[Callable] = None) -> dict:
    """Time the serving step (bench.py:341-634) -> the record, printed as
    ONE json line. ``on_serving(bench, candidates)``, if given, is called
    once the timing is done with the built bench and {name: serve}."""
    cfg = serving_config() if cfg is None else cfg
    bench = build_serving(cfg, device)
    hoist_env = cfg["mcb_hoist"]
    candidate_reps: dict = {}
    serves: dict = {}
    full_iters, full_reps = cfg["iters"], cfg["reps"]
    if not cfg["auto"]:
        serves["explicit"] = bench.make(cfg["hop_dft"], cfg["lstm_quant"], hoist_env)
        rep_times = time_serve(serves["explicit"], (bench.wave, bench.video), full_iters,
                               full_reps)
        winner = f"explicit:hop_dft={int(cfg['hop_dft'])},lstm={cfg['lstm_quant']}"
    else:
        t_start = time.perf_counter()
        cands = ladder(cfg)
        timings: dict = {}
        first_error = None
        for name, use_hop, quant in cands:
            if name != "shipped" and time.perf_counter() - t_start > cfg["budget_s"]:
                print(f"bench auto: budget exhausted, skipping {name}", file=sys.stderr)
                continue
            try:
                serves[name] = bench.make(use_hop, quant, hoist_env)
                candidate_reps[name] = time_serve(serves[name], (bench.wave, bench.video),
                                                  max(2, full_iters // 2), 3)
                timings[name] = min(candidate_reps[name])
                print(f"bench auto: {name}: {timings[name] * 1e3:.2f} ms/step (reps "
                      f"{[f'{r * 1e3:.1f}' for r in candidate_reps[name]]})",
                      file=sys.stderr)
            except Exception as e:  # never lose the headline to a candidate
                first_error = first_error or e
                print(f"bench auto: {name} failed: {e!r}", file=sys.stderr)
        if not timings:
            raise first_error
        winner = min(timings, key=timings.get)
        if not hoist_env and time.perf_counter() - t_start <= cfg["budget_s"]:
            try:
                _, use_hop, quant = next(c for c in cands if c[0] == winner)
                name = winner + "+mcb_hoist"
                serves[name] = bench.make(use_hop, quant, True)
                candidate_reps[name] = time_serve(serves[name], (bench.wave, bench.video),
                                                  max(2, full_iters // 2), 3)
                timings[name] = min(candidate_reps[name])
                print(f"bench auto: {name}: {timings[name] * 1e3:.2f} ms/step",
                      file=sys.stderr)
                winner = min(timings, key=timings.get)
            except Exception as e:
                print(f"bench auto: mcb_hoist failed: {e!r}", file=sys.stderr)
        print(f"bench auto: winner = {winner}", file=sys.stderr)
        rep_times = time_serve(serves[winner], (bench.wave, bench.video), full_iters,
                               full_reps)
    step_time = min(rep_times)
    winner = winner + ("+mcb_hoist(env)" if hoist_env else "")
    extra = gate_and_record("inference", shape_key(cfg), winner, step_time, rep_times,
                            candidate_reps or None, card=card_identity(device))
    rec = serving_record(cfg, winner, step_time, extra)
    print(json.dumps(rec), flush=True)
    if on_serving is not None:
        on_serving(bench, serves)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="one train step config (AVVAD_BENCH_TRAIN_MODALITY, _FREEZE)")
    mode.add_argument("--train-matrix", action="store_true",
                      help="frozen AV, unfrozen AV, audio and video train steps")
    mode.add_argument("--kernel-tripwire", action="store_true",
                      help="the fused int8 kernels against the unfused route")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require_live_backend(device)
    env_mode = os.environ.get("AVVAD_BENCH_MODE")
    if args.train_matrix or env_mode == "train_matrix":
        return train_matrix_main(device)
    if args.train or env_mode == "train":
        return train_main(device)
    if args.kernel_tripwire:
        return kernel_tripwire_main(device)
    return serving_main(device)


if __name__ == "__main__":
    main()
