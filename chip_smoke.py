"""Smoke run of the PyTorch/CUDA port (avvad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
1. card check (no CUDA device -> exit 1) and the card's name and power limit;
2. build the LSTM kernels from avvad_tpu_torch/csrc with nvcc (sm_90a);
3. each kernel against its plain PyTorch version on the card, at the main
   path's shape (B=64, T=512, H=1024) and a ragged one (B=3, T=7), with
   CUDA-event times of the kernel, the plain version and one cuDNN
   torch.nn.LSTM layer, and the bound from the shapes;
4. the full-width AV serving step (ResNet-18 tower, MCB 1024, 2 x LSTM 1024,
   bf16 model, B=64, T=512, 30 fps unique frames) for each LSTM
   state_quant, with launch counters read around the step, outputs checked,
   the step compared with the plain recurrence and timed, its stages timed
   by CUDA events recorded at the tower's and the LSTM stack's edges, and
   one more step under torch.profiler for the device's idle share and top
   kernels (one {"profile": ...} line per state_quant);
5. one {"kernels": [...]} line, then the ok line with the device.
Weights are random, from the port's own seeded init; nothing of JAX runs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B, T, H = 64, 512, 1024
RAGGED = (3, 7, 1024)
HOP, FRAME_RATE = 256, 62.5
N_SAMPLES = HOP * (T - 1) + 1024  # exactly T frames, no end pad
# H100 SXM published peaks (dense) and memory rate
PEAK = {"none": 67e12, "bf16": 989e12, "int8": 1979e12}
PEAK_NAME = {"none": "fp32 CUDA-core", "bf16": "bf16 tensor-core",
             "int8": "int8 tensor-core"}
MEM_BW = 3.35e12
REPLACES = {"none": "avvad_tpu/ops/lstm_pallas.py:54",
            "bf16": "avvad_tpu/ops/lstm_pallas.py:71",
            "int8": "avvad_tpu/ops/lstm_pallas.py:92"}
# kernel vs plain over T steps (same card, same inputs). none: fp32 in
# another summation order and expf/tanhf vs PyTorch's. bf16 / int8: the
# same, plus the rare h whose fp32 noise crosses a bf16 / int8 rounding
# boundary, which moves one gate term by one LSB of the quantised h.
KERNEL_TOL = {"none": 1e-4, "bf16": 2e-3, "int8": 2e-3}
# serving probabilities at the main path's shape, kernel vs plain
# recurrence on the same card: H100 80GB HBM3 (700 W) readings were
# 3.8e-6 (none), 1.2e-5 (bf16) and 0 (int8); held at 1e-4
PROB_TOL = 1e-4
# spans of the serving step between the CUDA events that stage_hooks and
# timed_step record
STAGES = ("frontend", "tower", "fusion", "lstm", "head")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(b: int, t: int, h: int, sq: str) -> tuple[float, str]:
    """Least time for one layer's recurrence: max(FLOPs / peak of the
    operand type, bytes / memory rate), each input read once (x_proj, the
    stored W_hh, h0, c0) and each output written once (y, c)."""
    flops = 2.0 * b * t * h * 4 * h
    w_bytes = h * 4 * h * (1 if sq == "int8" else 2) + (4 * h * 4 if sq == "int8" else 0)
    nbytes = b * t * 4 * h * 4 + w_bytes + 3 * b * h * 4 + b * t * h * 4
    t_ops, t_bytes = flops / PEAK[sq], nbytes / MEM_BW
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(lstm_fused):
    rows = {}
    for sq in lstm_fused.STATE_QUANTS:
        errs = []
        for b, t, h in ((B, T, H), RAGGED):
            g = torch.Generator().manual_seed(1)
            xp = torch.randn(b, t, 4 * h, generator=g).cuda()
            w = (torch.randn(h, 4 * h, generator=g) / h ** 0.5).cuda()
            y = lstm_fused.lstm_layer_fused(xp, w, state_quant=sq)
            torch.cuda.synchronize()
            ref = lstm_fused.lstm_layer_plain(xp, w, state_quant=sq)
            err = (y - ref).abs().max().item()
            print(f"{lstm_fused.KERNEL_NAMES[sq]} B={b} T={t} H={h}: max|kernel-plain| "
                  f"= {err:.3e} (tol {KERNEL_TOL[sq]:g})")
            if not (torch.isfinite(y).all() and err <= KERNEL_TOL[sq]):
                raise RuntimeError(f"{sq}: kernel disagrees with plain ({err})")
            errs.append(err)
        g = torch.Generator().manual_seed(2)
        xp = torch.randn(B, T, 4 * H, generator=g).cuda()
        w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).cuda()
        ms = cuda_ms(lambda: lstm_fused.lstm_layer_fused(xp, w, state_quant=sq), 5)
        plain_ms = cuda_ms(lambda: lstm_fused.lstm_layer_plain(xp, w, state_quant=sq), 2)
        lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
        x_in = torch.randn(B, T, H, generator=g).cuda()
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: lstm(x_in), 5)
        bound_ms, bound_by = bound(B, T, H, sq)
        print(f"{lstm_fused.KERNEL_NAMES[sq]}: kernel {ms:.3f} ms/layer, plain "
              f"{plain_ms:.3f}, cuDNN LSTM layer {library_ms:.3f}, bound "
              f"{bound_ms:.4f} ms ({bound_by}; {PEAK_NAME[sq]} peak, "
              f"{MEM_BW / 1e12} TB/s)")
        rows[sq] = {"name": lstm_fused.KERNEL_NAMES[sq], "route": "cuda",
                    "source": "avvad_tpu_torch/csrc/lstm_recurrence.cu",
                    "replaces": REPLACES[sq], "launches": None,
                    "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms}
    return rows


def _mark(marks: list) -> None:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append(ev)


def stage_hooks(model, marks: list) -> list:
    """Forward hooks that record a CUDA event at each edge of the video
    tower and of the LSTM stack inside the served step -> hook handles.
    With timed_step's events before and after the step these bound the
    STAGES: frontend (and input normalisation), tower, fusion (gather, MCB,
    signed sqrt, L2, BatchNorm), LSTM, head (Dense, sigmoid)."""
    return [register(lambda *_: _mark(marks))
            for mod in (model.tower, model.lstm_merged)
            for register in (mod.register_forward_pre_hook,
                             mod.register_forward_hook)]


def timed_step(fn, wave, video, marks: list) -> tuple[float, dict]:
    """One serving step -> (host seconds to the end of its device work,
    {stage: device ms})."""
    marks.clear()
    t0 = time.perf_counter()
    _mark(marks)
    fn(wave, video)
    _mark(marks)
    torch.cuda.synchronize()
    step = time.perf_counter() - t0
    return step, {s: marks[i].elapsed_time(marks[i + 1])
                  for i, s in enumerate(STAGES)}


def profile_step(fn, wave, video) -> dict:
    """One serving step under torch.profiler -> device busy time, idle
    share and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(wave, video)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side entries only: a CPU op's self device time repeats its kernels'
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")
                     and e.self_device_time_total > 0),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in events[:10]]}


def main_path(lstm_fused, rows):
    import avvad_tpu_torch.models.lstm as lstm_mod
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.processing import unique_frame_schedule

    t_src, idx = unique_frame_schedule(T)
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal((B, N_SAMPLES), np.float32)).cuda()
    video = torch.from_numpy(rng.standard_normal((B, t_src, 67, 67), np.float32)).cuda()
    model = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=1024, dtype=torch.bfloat16,
                  use_kernel_lstm=True, seed=0)
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx)
    audio_s = B * T / FRAME_RATE
    print(f"main path: AVVAD bf16, LSTM 2x{H}, MCB 1024, ResNet-18, "
          f"B={B} T={T} n={N_SAMPLES} t_src={t_src} (30 fps unique frames)")
    for sq in lstm_fused.STATE_QUANTS:
        model.set_lstm_state_quant(sq)
        lstm_fused.reset_launches()
        probs = fn(wave, video)
        torch.cuda.synchronize()
        counts = dict(lstm_fused.launches)
        expect = {k: (2 * T if k == sq else 0) for k in counts}
        if counts != expect:
            raise RuntimeError(f"{sq}: launch counts {counts}, expected {expect}")
        rows[sq]["launches"] = counts[sq]
        if probs.shape != (B, T, 1) or not torch.isfinite(probs).all() \
                or probs.min() < 0 or probs.max() > 1:
            raise RuntimeError(f"{sq}: bad probabilities {probs.shape}")
        lstm_mod.lstm_layer_fused = lstm_fused.lstm_layer_plain
        try:
            ref = fn(wave, video)
        finally:
            lstm_mod.lstm_layer_fused = lstm_fused.lstm_layer_fused
        err = (probs - ref).abs().max().item()
        if err > PROB_TOL:
            raise RuntimeError(f"{sq}: serving step vs plain LSTM {err}")
        torch.cuda.reset_peak_memory_stats()
        marks = []
        hooks = stage_hooks(model, marks)
        try:
            reps = [timed_step(fn, wave, video, marks) for _ in range(3)]
        finally:
            for hk in hooks:
                hk.remove()
        step, stage_ms = min(reps, key=lambda r: r[0])
        print(f"serving state_quant={sq}: {1e3 * step:.2f} ms/step (reps "
              f"{[round(1e3 * s, 2) for s, _ in reps]}), {audio_s / step:.1f}x real "
              f"time, launches {counts[sq]}, max|probs-plain| {err:.2e} "
              f"(tol {PROB_TOL:g}), peak mem "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(json.dumps({"profile": sq, "stage_ms": stage_ms,
                          **profile_step(fn, wave, video)}))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"card: {card}")
    from avvad_tpu_torch.ops import _build, lstm_fused

    info = _build.build(force=True)
    print(f"built {info['path']} in {info['seconds']:.1f} s")
    for line in info["ptxas"]:
        print(f"  {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = kernel_phase(lstm_fused)
    main_path(lstm_fused, rows)
    print(json.dumps({"kernels": [rows[sq] for sq in lstm_fused.STATE_QUANTS]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
