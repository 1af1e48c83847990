"""Smoke run of the PyTorch/CUDA port (avvad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
1. card check (no CUDA device -> exit 1) and the card's name and power limit;
2. build every kernel of avvad_tpu_torch/csrc with nvcc (sm_90a), one
   process per source;
3. each LSTM kernel against its plain PyTorch version on the card, at the
   main path's shape (B=64, T=512, H=1024) and a ragged one (B=3, T=7), with
   CUDA-event times of the kernel, the plain version and one cuDNN
   torch.nn.LSTM layer, and the bound from the shapes;
4. the int8 tower's kernels against their plain versions: the stem
   epilogue (K3) on bf16 NCHW stem output and the fused BasicBlock (K2) at
   each of the 8 trunk geometries with seeded int8 inputs and random folded
   parameters, at the main path's frame count (64 x 246 = 15,744) and a
   ragged one (37); CUDA-event times of kernel and plain version, bounds;
5. the full-width AV serving step with the float ResNet-18 tower (MCB 1024,
   2 x LSTM 1024, bf16 model, B=64, T=512, 30 fps unique frames) for each
   LSTM state_quant, with launch counters read around the step, outputs
   checked, the step compared with the plain recurrence and timed, its
   stages timed by CUDA events recorded at the tower's and the LSTM stack's
   edges, and one more step under torch.profiler for the device's idle
   share and top kernels (one {"profile": ...} line per state_quant);
6. the same step with the calibrated static-int8 tower on the fused
   kernels (K3 once and K2 eight times per tower pass), calibrated with the
   port's ``calibrate`` on 2 utterances, for state_quant none and int8:
   launch counts, outputs, the step against the same step with the plain
   K2/K3 versions, times, stages and a profile line; and the int8 tower's
   features against the fp32 float tower's on the same frames;
7. the training kernels against their plain versions: K1d (forward with
   residuals), K1e (reverse-time backward), and the four gradients of the
   autograd Function that joins them. At the training shape (B=16, T=512,
   H=1024) and the ragged one the wrappers take the persistent kernels
   (one cooperative launch a layer); at a small shape outside their plan
   (B=3, T=7, H=1030: H % 4 != 0) they take the per-step kernels; the
   launch counters show each route. CUDA-event times at the training shape
   of each persistent kernel, of the per-step kernel it replaces there
   (the route forced for the timing), of the plain version and of one
   cuDNN torch.nn.LSTM layer's forward with grad (K1d) and backward (K1e),
   and the bounds;
8. the full-width AV train step (fp32, frozen ResNet-18 trunk in train
   mode, MCB 1024, 2 x LSTM 1024, Adam 1e-4, B=16, T=512, seeded batch on
   the card): launch counters, loss and metrics, the step's gradients
   against the same step with the plain recurrence, ms/step (best of 3
   after a warm-up), x real time, peak memory, stage times by CUDA events
   (inputs, tower, fusion, LSTM forward, head and loss, backward,
   optimizer, metrics) and one {"profile": ...} line; then the audio
   (AudioVAD) train step at the same B, T and H: 2 persistent K1d and 2
   persistent K1e launches a step, no per-step launch; then an AudioVAD
   train step outside the plan (2 x LSTM 1030, B=4, T=64), which goes
   through the per-step K1d and K1e (2 T and 2 (T + 1) launches);
9. a short Trainer.fit (one epoch of 2 batches and an eval pass, K1a) of
   the AV model with a checkpoint round trip into a temporary directory
   under build/: the restored state equals the saved one, and one more
   step from each agrees;
10. the probe kernel (P1) in its four modes against its plain version at
    the probe's shape (B=64, T=512, H=1024) and the ragged one, on the
    probe's own draws (x_proj x 0.1, W_hh x 0.02); CUDA-event times of the
    kernel, the plain version and, for "full" and "h_bf16", one cuDNN
    torch.nn.LSTM layer; bounds from the shapes;
11. the probe tool's main() in-process at its default shape, with launch
    counters read around it: its lines, and one {"probe_tool": ...} line;
12. the hop-block and split-radix DFT routes against the direct one at the
    serving shape (B=64, T=512), and the three frontends' times;
13. streaming at full width, 32 streams x 16 frames a tick, 40 ticks:
    MultiStreamVAD (AudioVAD, 2 x LSTM 1024) on the frames wire and on the
    int16 span wire with the hop-block DFT; MultiStreamAVVAD (30 fps uint8
    camera frames, int16 span wire) with the bf16 float tower and with the
    calibrated static-int8 tower (K3 once and K2 eight times a tick, launch
    counters read around a tick). Probabilities checked; streams 0 and 1
    against a solo StreamingVAD / StreamingAVVAD fed the same data; the
    int8-tower ticks against the same ticks with the plain K2/K3;
    tick_pipelined one tick late against the synchronous run; a stream
    reset with a tick pending delivers nothing of the old stream; ms/tick,
    x real time, peak memory, the LSTM loop's share, the device's idle
    share of one step under torch.profiler, one {"streaming": ...} line
    each;
14. one {"kernels": [...]} line (13 rows), then the ok line with the device.
Weights are random, from the port's own seeded init; nothing of JAX runs.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
MEM_BW_NAME = "3.35 TB/s HBM3"
REPLACES = {"none": "avvad_tpu/ops/lstm_pallas.py:54",
            "bf16": "avvad_tpu/ops/lstm_pallas.py:71",
            "int8": "avvad_tpu/ops/lstm_pallas.py:92"}
# kernel vs plain over T steps (same card, same inputs). none: fp32 in
# another summation order and expf/tanhf vs PyTorch's. bf16 / int8: the
# same, plus the rare h whose fp32 noise crosses a bf16 / int8 rounding
# boundary, which moves one gate term by one LSB of the quantised h.
KERNEL_TOL = {"none": 1e-4, "bf16": 2e-3, "int8": 2e-3}
# a ragged frame count for the int8 tower's kernels
N_RAGGED = 37
# K2 / K3 against their plain versions: both compute exact int32 sums and
# the same separate float32 operations, so they agree bit for bit; held at
# one LSB on under 0.1 % of the outputs
LSB_TOL, FLIP_TOL = 1, 1e-3
# the int8 step with the K2/K3 kernels vs the same step with their plain
# versions (bit-identical tower, the same LSTM kernel)
INT8_PROB_TOL = 1e-4
# int8 tower features vs the fp32 float tower (tests/test_models.py:419-422)
FEAT_REL, FEAT_CORR = 0.05, 0.995
INT8_STATE_QUANTS = ("none", "int8")
# serving probabilities at the main path's shape, kernel vs plain
# recurrence on the same card: H100 80GB HBM3 (700 W) readings were
# 3.8e-6 (none), 1.2e-5 (bf16) and 0 (int8); held at 1e-4
PROB_TOL = 1e-4
# spans of the serving step between the CUDA events that stage_hooks and
# timed_step record
STAGES = ("frontend", "tower", "fusion", "lstm", "head")
# the training slice: the reference recipe that bench.py --train sizes
TRAIN_B = 16
TRAIN_REPLACES = {"fwd_train_persist": "avvad_tpu/ops/lstm_pallas.py:279",
                  "bwd_persist": "avvad_tpu/ops/lstm_pallas.py:314",
                  "fwd_train": "avvad_tpu/ops/lstm_pallas.py:279",
                  "bwd": "avvad_tpu/ops/lstm_pallas.py:314"}
TRAIN_SOURCES = {"fwd_train_persist": "avvad_tpu_torch/csrc/lstm_persistent.cu",
                 "bwd_persist": "avvad_tpu_torch/csrc/lstm_persistent.cu",
                 "fwd_train": "avvad_tpu_torch/csrc/lstm_recurrence.cu",
                 "bwd": "avvad_tpu_torch/csrc/lstm_train.cu"}
# outside the persistent kernels' plan on any card (H % 4 != 0): the
# per-step K1d / K1e
OUT_OF_PLAN = (3, 7, 1030)
OUT_OF_PLAN_STEP = {"h": 1030, "b": 4, "t": 64}
# K1d against its plain version: K1a's arithmetic (KERNEL_TOL["none"]).
# K1e, the Function's gradients and a train step's gradients against the
# plain recurrence on the same card: fp32 sums in another order over T
# reverse steps, as the largest error over the largest |plain| value.
# H100 80GB HBM3 (700 W) readings, per-step kernels: K1d 3.6e-7; K1e
# 5.8e-7, the Function's gradients 6.2e-7; train steps 7.2e-7 (AV) and
# 7.8e-7 (audio), loss equal; the persistent kernels read the same orders
TRAIN_REL_TOL = 1e-4
STEP_GRAD_REL_TOL = 1e-3
# the step's loss, kernel recurrence against plain
STEP_LOSS_REL_TOL = 1e-5
# spans of a train step between the CUDA events of train_marks and
# timed_train_step, by the marks that bound them
TRAIN_STAGES = {("start", "tower_start"): "inputs", ("tower_start", "tower_end"): "tower",
                ("tower_end", "lstm_start"): "fusion",
                ("start", "lstm_start"): "inputs",
                ("lstm_start", "lstm_end"): "lstm_forward",
                ("lstm_end", "backward_start"): "head_loss",
                ("backward_start", "optimizer_start"): "backward",
                ("optimizer_start", "optimizer_end"): "optimizer",
                ("optimizer_end", "end"): "metrics"}
# the probe kernel against its plain version (KERNEL_TOL's reasons: "full",
# "matmul_only" and "gates_only" are fp32 in another summation order or with
# expf/tanhf; "h_bf16" adds the rare h that crosses a bf16 rounding boundary)
PROBE_TOL = {"full": 1e-4, "gates_only": 1e-4, "matmul_only": 1e-4, "h_bf16": 2e-3}
PROBE_SQ = {"full": "none", "matmul_only": "none", "h_bf16": "bf16"}
# re / im of the other DFT routes against the direct one, as a share of the
# largest value (tests/test_ops_stft.py:108 and :138)
ROUTE_TOL = {"hop_dft": 1e-5, "split_radix": 1e-4}
# streaming: the shape of scripts/bench_streaming.py
STREAMS, BLOCK, TICKS = 32, 16, 40
SOLO_TICKS = 8
# rows of the batched tick against a solo streamer on the same card. fp32
# AudioVAD: cuBLAS may pick another kernel for 32 rows than for one, and the
# solo streamer runs the direct DFT where the span wire runs the hop-block
# one. bf16 AVVAD: cuDNN may pick its bf16 kernels by batch (288 unique
# frames against 16 duplicated ones), which would move tower features by
# bf16 roundings. H100 80GB HBM3 (700 W) readings: 1.8e-7 (audio), 5.5e-6
# (float tower) and 2.9e-6 (int8 tower)
SOLO_TOL = {"audio": 1e-5, "av": 5e-4}
# the pipelined run against the synchronous one: the same operations at the
# same shapes on the same card
PIPE_TOL = 1e-6
BUILD = Path(__file__).resolve().parent / "build"


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


def random_block(cin: int, cout: int, stride: int, seed: int) -> dict:
    """Seeded int8 weights and folded epilogue vectors of one fused block on
    the card, scaled so that the requantised values spread over [0, 127]."""
    g = torch.Generator().manual_seed(seed)
    w = lambda *s: torch.randint(-127, 128, s, generator=g, dtype=torch.int8)  # noqa: E731
    vec = lambda lo, hi: torch.rand(cout, generator=g) * (hi - lo) + lo  # noqa: E731
    args = {"w1": w(cout, 9 * cin), "w2": w(cout, 9 * cout),
            "a1": vec(0.5, 1.5) * 64 / (73 * 73 * (9 * cin) ** 0.5),
            "b1": vec(-20, 20),
            "a2": vec(0.5, 1.5) * 64 / (73 * 40 * (9 * cout) ** 0.5),
            "b2": vec(-20, 20)}
    if stride != 1 or cin != cout:
        args.update(wd=w(cout, cin), ad=vec(0.5, 1.5) * 64 / (73 * 73 * cin ** 0.5),
                    bd=vec(-20, 20))
    else:
        args["res_scale"] = torch.tensor(0.37)
    return {k: v.cuda() for k, v in args.items()}


def lsb_diff(y: torch.Tensor, ref: torch.Tensor) -> tuple[int, float]:
    d = (y.int() - ref.int()).abs()
    return int(d.max().item()), float((d > 0).float().mean().item())


def k2_bound(n: int, h: int, stride: int, cin: int, cout: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one fused block launch: 2 per MAC of the
    two 3x3 convs and the 1x1 downsample; x, the weights and the folded
    vectors read once, the int8 output written once."""
    ho = (h - 1) // stride + 1
    down = stride != 1 or cin != cout
    macs = n * ho * ho * cout * (9 * cin + 9 * cout + (cin if down else 0))
    w_bytes = 9 * cin * cout + 9 * cout * cout + (cin * cout if down else 0)
    v_bytes = 4 * cout * (6 if down else 4)
    return 2.0 * macs, n * h * h * cin + w_bytes + v_bytes + n * ho * ho * cout


def int8_kernel_phase(n_frames: int) -> dict:
    """K3 and K2 against their plain versions at the main path's frame count
    and a ragged one, with CUDA-event times and bounds -> kernel rows."""
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    # K3 on the bf16 model's stem output: (N, 64, 34, 34) bf16, cuDNN's NCHW
    errs, g = [], torch.Generator().manual_seed(5)
    a = (torch.rand(64, generator=g) * 20 + 5).cuda()
    b = (torch.randn(64, generator=g) * 10).cuda()
    for n in (n_frames, N_RAGGED):
        x = (torch.randn(n, 64, 34, 34, generator=g) * 3).to("cuda", torch.bfloat16)
        y = stem_fused.stem_epilogue_pool_quant(x, a, b)
        torch.cuda.synchronize()
        errs.append(lsb_diff(y, stem_fused.stem_epilogue_plain(x, a, b)))
        print(f"stem_epilogue_pool N={n}: max {errs[-1][0]} LSB, "
              f"{errs[-1][1]:.2e} of outputs differ")
        if errs[-1][0] > LSB_TOL or errs[-1][1] >= FLIP_TOL:
            raise RuntimeError(f"stem_epilogue_pool disagrees with plain: {errs[-1]}")
    x = (torch.randn(n_frames, 64, 34, 34, generator=g) * 3).to("cuda", torch.bfloat16)
    ms = cuda_ms(lambda: stem_fused.stem_epilogue_pool_quant(x, a, b), 10)
    plain_ms = cuda_ms(lambda: stem_fused.stem_epilogue_plain(x, a, b), 2)
    # each input read once (bf16) and each int8 output written once; fp32
    # operations: multiply, add, max, round, min per input, 8 maxima per output
    nbytes = x.numel() * 2 + 2 * 64 * 4 + n_frames * 17 * 17 * 64
    ops = 5.0 * x.numel() + 8.0 * n_frames * 17 * 17 * 64
    bound_ms = 1e3 * max(nbytes / MEM_BW, ops / PEAK["none"])
    bound_by = "bytes" if nbytes / MEM_BW >= ops / PEAK["none"] else "operations"
    print(f"stem_epilogue_pool N={n_frames}: kernel {ms:.3f} ms, plain {plain_ms:.3f}, "
          f"bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e9:.3f} GB at {MEM_BW_NAME})")
    rows = {"k3": {"name": stem_fused.KERNEL_NAME, "route": "cuda",
                   "source": "avvad_tpu_torch/csrc/stem_epilogue_pool.cu",
                   "replaces": "avvad_tpu/ops/stem_pallas.py:72", "launches": None,
                   "max_abs_err": max(e[0] for e in errs), "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}}
    del x

    # K2 at the 8 trunk geometries
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0}
    worst, cin = 0, 64
    for i, ((h, stride), cout) in enumerate(zip(conv_fused.TRUNK_GEOM,
                                                conv_fused.TRUNK_WIDTHS)):
        spec = random_block(cin, cout, stride, 30 + i)
        args = conv_fused._block_args(spec)
        for n in (N_RAGGED, n_frames):
            x = torch.randint(0, 128, (n, h, h, cin), generator=g, dtype=torch.int8).cuda()
            y = conv_fused.basic_block_int8(x, *args, stride=stride)
            torch.cuda.synchronize()
            ref = conv_fused.basic_block_int8_plain(x, *args, stride=stride)
            lsb, share = lsb_diff(y, ref)
            del ref
            worst = max(worst, lsb)
            if lsb > LSB_TOL or share >= FLIP_TOL:
                raise RuntimeError(f"int8_basic_block {h}/{stride}: {lsb} LSB, {share}")
        ms = cuda_ms(lambda: conv_fused.basic_block_int8(x, *args, stride=stride), 5)
        plain_ms = cuda_ms(lambda: conv_fused.basic_block_int8_plain(x, *args,
                                                                     stride=stride), 1)
        ops, nbytes = k2_bound(n_frames, h, stride, cin, cout)
        t_ops, t_bytes = ops / PEAK["int8"], nbytes / MEM_BW
        print(f"int8_basic_block {h}x{h}/{stride} {cin}->{cout} N={n_frames}: "
              f"max {lsb} LSB, {share:.2e} differ (also N={N_RAGGED}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f}, bound {1e3 * max(t_ops, t_bytes):.4f} "
              f"ms ({'operations' if t_ops >= t_bytes else 'bytes'}), "
              f"{ops / ms / 1e9:.1f} TOP/s")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += 1e3 * max(t_ops, t_bytes)
        tot["ops"] += ops
        tot["bytes"] += nbytes
        cin = cout
    bound_by = ("operations" if tot["ops"] / PEAK["int8"] >= tot["bytes"] / MEM_BW
                else "bytes")
    print(f"int8_basic_block, 8 blocks at N={n_frames}: kernel {tot['ms']:.3f} ms, "
          f"plain {tot['plain_ms']:.3f}, bound {tot['bound_ms']:.4f} ms ({bound_by}; "
          f"{tot['ops'] / 1e12:.3f} TOP at {PEAK_NAME['int8']} peak, "
          f"{tot['bytes'] / 1e9:.3f} GB, {tot['ops'] / 2 / n_frames / 1e6:.1f} M MAC/frame)")
    rows["k2"] = {"name": conv_fused.KERNEL_NAME, "route": "cuda",
                  "source": "avvad_tpu_torch/csrc/int8_basic_block.cu",
                  "replaces": "avvad_tpu/ops/conv_pallas.py:155", "launches": None,
                  "max_abs_err": worst, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                  "bound_ms": tot["bound_ms"], "bound_by": bound_by,
                  "library_ms": None}
    return rows


def _mark(marks: list, name: str = "") -> None:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append((name, ev))


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
    return step, {s: marks[i][1].elapsed_time(marks[i + 1][1])
                  for i, s in enumerate(STAGES)}


def profile_step(fn, *args) -> dict:
    """One step fn(*args) under torch.profiler -> device busy time, idle
    share and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
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


def serving_inputs():
    """-> (wave (B, n), video (B, t_src, 67, 67), frame indices), seeded,
    on the card."""
    from avvad_tpu_torch.processing import unique_frame_schedule

    t_src, idx = unique_frame_schedule(T)
    rng = np.random.default_rng(0)
    wave = torch.from_numpy(rng.standard_normal((B, N_SAMPLES), np.float32)).cuda()
    video = torch.from_numpy(rng.standard_normal((B, t_src, 67, 67), np.float32)).cuda()
    return wave, video, idx


def check_probs(probs: torch.Tensor, label: str) -> None:
    if probs.shape != (B, T, 1) or not torch.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise RuntimeError(f"{label}: bad probabilities {tuple(probs.shape)}")


def time_step(fn, model, wave, video, label: str, tail: str) -> None:
    """Best of 3 timed steps with the stage split, then one profiled step:
    one line of times and one {"profile": ...} line."""
    torch.cuda.reset_peak_memory_stats()
    marks = []
    hooks = stage_hooks(model, marks)
    try:
        reps = [timed_step(fn, wave, video, marks) for _ in range(3)]
    finally:
        for hk in hooks:
            hk.remove()
    step, stage_ms = min(reps, key=lambda r: r[0])
    print(f"serving {label}: {1e3 * step:.2f} ms/step (reps "
          f"{[round(1e3 * s, 2) for s, _ in reps]}), {B * T / FRAME_RATE / step:.1f}x "
          f"real time, {tail}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"profile": label, "stage_ms": stage_ms,
                      **profile_step(fn, wave, video)}))


def main_path(lstm_fused, rows):
    import avvad_tpu_torch.models.lstm as lstm_mod
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    wave, video, idx = serving_inputs()
    model = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=1024, dtype=torch.bfloat16,
                  use_kernel_lstm=True, seed=0)
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx)
    print(f"main path: AVVAD bf16, LSTM 2x{H}, MCB 1024, ResNet-18 float, "
          f"B={B} T={T} n={N_SAMPLES} t_src={video.shape[1]} (30 fps unique frames)")
    for sq in lstm_fused.STATE_QUANTS:
        model.set_lstm_state_quant(sq)
        for mod in (lstm_fused, conv_fused, stem_fused):
            mod.reset_launches()
        probs = fn(wave, video)
        torch.cuda.synchronize()
        counts = {**lstm_fused.launches, **conv_fused.launches, **stem_fused.launches}
        expect = {k: (2 * T if k == sq else 0) for k in counts}
        if counts != expect:
            raise RuntimeError(f"{sq}: launch counts {counts}, expected {expect}")
        rows[sq]["launches"] = counts[sq]
        check_probs(probs, sq)
        lstm_mod.lstm_layer_fused = lstm_fused.lstm_layer_plain
        try:
            ref = fn(wave, video)
        finally:
            lstm_mod.lstm_layer_fused = lstm_fused.lstm_layer_fused
        err = (probs - ref).abs().max().item()
        if err > PROB_TOL:
            raise RuntimeError(f"{sq}: serving step vs plain LSTM {err}")
        time_step(fn, model, wave, video, sq, f"launches {counts[sq]}, "
                  f"max|probs-plain| {err:.2e} (tol {PROB_TOL:g})")
    return model


def int8_path(rows):
    """The static-int8 tower on the fused kernels: K3 -> 8 x K2 -> LSTM."""
    import avvad_tpu_torch.models.resnet as resnet_mod
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD, ResNet18, calibrate
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused

    wave, video, idx = serving_inputs()
    model = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=1024, dtype=torch.bfloat16, use_kernel_lstm=True,
                  tower_int8=True, tower_quant_mode="static", tower_pallas=True,
                  seed=0).cuda()
    # the scales from 2 utterances on the unfused path, as bench.py:447-458
    t0 = time.perf_counter()
    calibrate(model, [(torch.zeros(2, T, 513, device="cuda"), video[:2])],
              video_frame_indices=torch.as_tensor(idx, device="cuda"))
    torch.cuda.synchronize()
    trunk = model.tower.features
    print(f"int8 path: calibrated on 2 utterances ({2 * video.shape[1]} frames) in "
          f"{time.perf_counter() - t0:.1f} s; q_stem {trunk.q_stem.item():.4f}, "
          f"layer4_1.q_out {trunk.layer4_1.q_out.item():.4f}")
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx)
    for sq in INT8_STATE_QUANTS:
        model.set_lstm_state_quant(sq)
        for mod in (lstm_fused, conv_fused, stem_fused):
            mod.reset_launches()
        probs = fn(wave, video)
        torch.cuda.synchronize()
        counts = {**lstm_fused.launches, **conv_fused.launches, **stem_fused.launches}
        expect = {k: (2 * T if k == sq else 0) for k in lstm_fused.launches}
        expect.update({conv_fused.KERNEL_NAME: 8, stem_fused.KERNEL_NAME: 1})
        if counts != expect:
            raise RuntimeError(f"int8 tower {sq}: launch counts {counts}, "
                               f"expected {expect}")
        rows["k2"]["launches"] = counts[conv_fused.KERNEL_NAME]
        rows["k3"]["launches"] = counts[stem_fused.KERNEL_NAME]
        check_probs(probs, f"int8 tower {sq}")
        block_kernel = conv_fused.basic_block_int8
        resnet_mod.stem_epilogue_pool_quant = stem_fused.stem_epilogue_plain
        conv_fused.basic_block_int8 = conv_fused.basic_block_int8_plain
        try:
            ref = fn(wave, video)
        finally:
            resnet_mod.stem_epilogue_pool_quant = stem_fused.stem_epilogue_pool_quant
            conv_fused.basic_block_int8 = block_kernel
        err = (probs - ref).abs().max().item()
        if err > INT8_PROB_TOL:
            raise RuntimeError(f"int8 tower {sq}: step vs plain K2/K3 {err}")
        time_step(fn, model, wave, video, f"int8_tower/{sq}",
                  f"launches {counts}, max|probs-plain K2/K3| {err:.2e} "
                  f"(tol {INT8_PROB_TOL:g})")
    # int8 tower features against the fp32 float tower, same weights and frames
    float_trunk = ResNet18().cuda().eval()
    float_trunk.load_state_dict({k: v for k, v in trunk.state_dict().items()
                                 if k.split(".")[-1] not in ("q_stem", "q1", "q_out")})
    with torch.inference_mode():
        frames = video[0][:, None]
        got, ref = trunk(frames).double(), float_trunk(frames).double()
    rel = ((got - ref).norm() / ref.norm()).item()
    corr = torch.corrcoef(torch.stack([got.flatten(), ref.flatten()]))[0, 1].item()
    print(f"int8 tower (bf16 stem) vs fp32 float tower on {frames.shape[0]} frames: "
          f"rel {rel:.5f} (bar {FEAT_REL}), corr {corr:.6f} (bar {FEAT_CORR})")
    if not (rel < FEAT_REL and corr > FEAT_CORR):
        raise RuntimeError(f"int8 tower features: rel {rel}, corr {corr}")
    return model


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| over the largest |ref|."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


@contextlib.contextmanager
def plain_recurrence(lstm_fused):
    """LSTMRecurrence with the plain K1d / K1e versions on the card."""
    saved = lstm_fused.lstm_fwd_train, lstm_fused.lstm_bwd
    lstm_fused.lstm_fwd_train = lstm_fused.lstm_fwd_train_plain
    lstm_fused.lstm_bwd = lstm_fused.lstm_bwd_plain
    try:
        yield
    finally:
        lstm_fused.lstm_fwd_train, lstm_fused.lstm_bwd = saved


@contextlib.contextmanager
def per_step_route(lstm_fused):
    """The wrappers with the persistent plan refused: the per-step K1d /
    K1e at a shape the plan would take, to time both on the same inputs."""
    saved = lstm_fused._persistent
    lstm_fused._persistent = lambda *_: False
    try:
        yield
    finally:
        lstm_fused._persistent = saved


def train_inputs(b: int, t: int, h: int, seed: int) -> tuple:
    """x_proj, W_hh, h0, c0 and a cotangent dy, seeded, on the card."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, 4 * h, generator=g).cuda(),
            (torch.randn(h, 4 * h, generator=g) / h ** 0.5).cuda(),
            torch.tanh(torch.randn(b, h, generator=g)).cuda(),
            torch.randn(b, h, generator=g).cuda(),
            torch.randn(b, t, h, generator=g).cuda())


def function_grads(lstm_fused, xp, w, h0, c0, dy) -> list:
    args = [a.clone().requires_grad_() for a in (xp, w, h0, c0)]
    lstm_fused.LSTMRecurrence.apply(*args).backward(dy)
    return [a.grad for a in args]


def train_bound(b: int, t: int, h: int, kind: str) -> tuple[float, str]:
    """Least time of one layer's K1d or K1e: 2*B*T*H*4H operations at the
    fp32 CUDA-core peak (an fp32 x bf16 product has no tensor-core form)
    against the bytes, each input read once and each output written once:
    K1d x_proj, W_hh (bf16), h0, c0 in, y, c_seq, gates out; K1e dy,
    c_seq, c_prev, gates, W^T (bf16) in, d_gates, dh0, dc0 out."""
    flops = 2.0 * b * t * h * 4 * h
    if kind == "fwd_train":
        nbytes = 4 * (2 * b * t * 4 * h + 2 * b * t * h + 2 * b * h) + 2 * h * 4 * h
    else:
        nbytes = 4 * (2 * b * t * 4 * h + 3 * b * t * h + 2 * b * h) + 2 * h * 4 * h
    t_ops, t_bytes = flops / PEAK["none"], nbytes / MEM_BW
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def train_kernel_phase(lstm_fused) -> dict:
    """K1d, K1e and the Function's gradients against their plain versions:
    the persistent kernels at the training shape and the ragged one, the
    per-step kernels at a shape outside the plan, each route shown by the
    launch counters; times, library times and bounds at the training
    shape -> kernel rows."""
    errs = {k: [] for k in (*lstm_fused.TRAIN_KERNELS, "grads_persist", "grads")}
    for (b, t, h), sfx in (((TRAIN_B, T, H), "_persist"), (RAGGED, "_persist"),
                           (OUT_OF_PLAN, "")):
        fwd, bwd = "fwd_train" + sfx, "bwd" + sfx
        xp, w, h0, c0, dy = train_inputs(b, t, h, seed=6)
        lstm_fused.reset_launches()
        y, c_seq, gates = lstm_fused.lstm_fwd_train(xp, w, h0, c0)
        torch.cuda.synchronize()
        ref = lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0)
        errs[fwd].append(max((a - r).abs().max().item()
                             for a, r in zip((y, c_seq, gates), ref)))
        c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
        got = lstm_fused.lstm_bwd(dy, gates, c_seq, c_prev, w)
        torch.cuda.synchronize()
        ref = lstm_fused.lstm_bwd_plain(dy, gates, c_seq, c_prev, w)
        errs[bwd].append(max(rel_err(a, r) for a, r in zip(got, ref)))
        got = function_grads(lstm_fused, xp, w, h0, c0, dy)
        counts = {k: v for k, v in lstm_fused.launches.items() if v}
        # the wrapper's call and the Function's: one launch each where the
        # kernel is persistent, T and T + 1 where it is per step
        expect = {fwd: 2 if sfx else 2 * t, bwd: 2 if sfx else 2 * (t + 1)}
        if counts != expect:
            raise RuntimeError(f"training kernels B={b} T={t} H={h}: launch counts "
                               f"{counts}, expected {expect}")
        with plain_recurrence(lstm_fused):
            ref = function_grads(lstm_fused, xp, w, h0, c0, dy)
        errs["grads" + sfx].append(max(rel_err(a, r) for a, r in zip(got, ref)))
        print(f"training kernels B={b} T={t} H={h}, launches {counts}: K1d "
              f"{lstm_fused.KERNEL_NAMES[fwd]} max|kernel-plain| {errs[fwd][-1]:.3e} (tol "
              f"{KERNEL_TOL['none']:g}); K1e {lstm_fused.KERNEL_NAMES[bwd]} rel "
              f"{errs[bwd][-1]:.3e}, Function grads (dx_proj, dW_hh, dh0, dc0) rel "
              f"{errs['grads' + sfx][-1]:.3e} (tol {TRAIN_REL_TOL:g})")
        if not (errs[fwd][-1] <= KERNEL_TOL["none"] and errs[bwd][-1] <= TRAIN_REL_TOL
                and errs["grads" + sfx][-1] <= TRAIN_REL_TOL):
            raise RuntimeError(f"training kernels disagree with plain: {errs}")
    xp, w, h0, c0, dy = train_inputs(TRAIN_B, T, H, seed=7)
    y, c_seq, gates = lstm_fused.lstm_fwd_train(xp, w, h0, c0)
    c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], dim=1)
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x_in = torch.randn(TRAIN_B, T, H, device="cuda", requires_grad=True)
    out = lstm(x_in)[0]
    calls = {
        "fwd_train": (lambda: lstm_fused.lstm_fwd_train(xp, w, h0, c0),
                      lambda: lstm_fused.lstm_fwd_train_plain(xp, w, h0, c0),
                      lambda: lstm(x_in)),
        "bwd": (lambda: lstm_fused.lstm_bwd(dy, gates, c_seq, c_prev, w),
                lambda: lstm_fused.lstm_bwd_plain(dy, gates, c_seq, c_prev, w),
                lambda: torch.autograd.grad(out, [x_in, *lstm.parameters()], dy,
                                            retain_graph=True))}
    rows = {}
    for kind, (kernel, plain, library) in calls.items():
        # per step, persistent, persistent, per step: in turns on one card
        lstm_fused.reset_launches()
        with per_step_route(lstm_fused):
            step_ms = [cuda_ms(kernel, 5)]
        persist_ms = [cuda_ms(kernel, 5), cuda_ms(kernel, 5)]
        with per_step_route(lstm_fused):
            step_ms.append(cuda_ms(kernel, 5))
        if lstm_fused.launches[kind + "_persist"] != 12 or not lstm_fused.launches[kind]:
            raise RuntimeError(f"{kind}: timed the wrong route: {lstm_fused.launches}")
        plain_ms, library_ms = cuda_ms(plain, 2), cuda_ms(library, 5)
        bound_ms, bound_by = train_bound(TRAIN_B, T, H, kind)
        for name, reps in ((kind + "_persist", persist_ms), (kind, step_ms)):
            print(f"{lstm_fused.KERNEL_NAMES[name]} B={TRAIN_B} T={T} H={H}: kernel "
                  f"{min(reps):.3f} ms/layer ({1e3 * min(reps) / T:.2f} us/step; reps "
                  f"{[round(r, 3) for r in reps]}), plain {plain_ms:.3f}, cuDNN LSTM layer "
                  f"{'forward with grad' if kind == 'fwd_train' else 'backward'} "
                  f"{library_ms:.3f}, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{PEAK_NAME['none']} peak, {MEM_BW / 1e12} TB/s)")
            rows[name] = {"name": lstm_fused.KERNEL_NAMES[name], "route": "cuda",
                          "source": TRAIN_SOURCES[name], "replaces": TRAIN_REPLACES[name],
                          "launches": None,
                          "max_abs_err": max(errs[name]) if kind == "fwd_train"
                          else max(errs[name] + errs["grads" + name[len(kind):]]),
                          "ms": min(reps), "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": library_ms}
    return rows


def train_batch(t: int, b: int, av: bool, seed: int):
    """A seeded batch on the card (as a prefetcher leaves it): ragged
    lengths in [t/2, t] (the first full), random labels on valid frames."""
    from avvad_tpu_torch.data import Batch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(t // 2, t + 1, size=b)
    lengths[0] = t
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    label = (rng.random((b, t, 1)) > 0.5).astype(np.float32) * mask[..., None]
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return Batch(audio=cuda(rng.standard_normal((b, t, 513), np.float32)),
                 video=cuda(rng.standard_normal((b, t, 67, 67), np.float32)) if av else None,
                 label=cuda(label), lengths=lengths, mask=cuda(mask))


def train_marks(model, optimizer, marks: list) -> list:
    """Hooks that record CUDA events inside a train step at the tower's and
    the LSTM stack's edges, when the logits' gradient is formed (the start
    of the backward pass) and around the optimizer step -> handles."""
    def mark(name):
        return lambda *_: _mark(marks, name)

    handles = []
    if hasattr(model, "tower"):
        handles += [model.tower.register_forward_pre_hook(mark("tower_start")),
                    model.tower.register_forward_hook(mark("tower_end"))]
    lstm = model.lstm_merged if hasattr(model, "lstm_merged") else model.lstm_audio
    def on_logits(_module, _inputs, logits):
        logits.register_hook(mark("backward_start"))

    handles += [lstm.register_forward_pre_hook(mark("lstm_start")),
                lstm.register_forward_hook(mark("lstm_end")),
                model.register_forward_hook(on_logits),
                optimizer.register_step_pre_hook(mark("optimizer_start")),
                optimizer.register_step_post_hook(mark("optimizer_end"))]
    return handles


def timed_train_step(step, state, batch, marks: list) -> tuple[float, dict]:
    """One train step -> (host seconds to the end of its device work,
    {stage: device ms})."""
    marks.clear()
    t0 = time.perf_counter()
    _mark(marks, "start")
    step(state, batch)
    _mark(marks, "end")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return dt, {TRAIN_STAGES[(a, b)]: ea.elapsed_time(eb)
                for (a, ea), (b, eb) in zip(marks, marks[1:])}


def train_path(rows: dict, modality: str, h: int = H, b: int = TRAIN_B, t: int = T):
    """One train step (at full width by default) with launch counters and
    the plain recurrence's step as reference, then 3 timed steps and a
    profiled one -> the train state. At H=1024 the recurrence goes through
    the persistent K1d / K1e, one launch a layer; at an ``h`` outside
    their plan through the per-step ones."""
    from avvad_tpu_torch.models import AVVAD, AudioVAD
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused
    from avvad_tpu_torch.train import create_train_state, make_train_step

    av = modality == "av"
    model = (AVVAD(lstm_hidden_size=h, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                   use_kernel_lstm=True, seed=0) if av
             else AudioVAD(lstm_hidden_size=h, lstm_layers=2, use_kernel_lstm=True, seed=0))
    reference = copy.deepcopy(model)
    state = create_train_state(model, learning_rate=1e-4, freeze_video_trunk=av)
    step = make_train_step(modality)
    batch = train_batch(t, b, av, seed=8)
    persist = lstm_fused.persistent_plan(
        b, h, torch.cuda.get_device_properties(0).multi_processor_count) is not None
    fwd, bwd = ("fwd_train_persist", "bwd_persist") if persist else ("fwd_train", "bwd")
    print(f"train path {modality}: {type(model).__name__} fp32, LSTM 2x{h}"
          f"{', MCB 1024, ResNet-18 frozen (train-mode BatchNorm)' if av else ''}, "
          f"Adam 1e-4, B={b} T={t}, lengths {batch.lengths.tolist()}; the plan "
          f"{'takes' if persist else 'refuses'} H={h}")
    for mod in (lstm_fused, conv_fused, stem_fused):
        mod.reset_launches()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    counts = {**lstm_fused.launches, **conv_fused.launches, **stem_fused.launches}
    expect = {k: 0 for k in counts}
    expect.update({fwd: 2, bwd: 2} if persist else {fwd: 2 * t, bwd: 2 * (t + 1)})
    if counts != expect:
        raise RuntimeError(f"train {modality}: launch counts {counts}, expected {expect}")
    if av or not persist:
        rows[fwd]["launches"] = counts[fwd]
        rows[bwd]["launches"] = counts[bwd]
    m = {k: v.item() for k, v in metrics.items()}
    if not (np.isfinite(m["loss"]) and all(0 <= m[k] <= 1 for k in m if k != "loss")):
        raise RuntimeError(f"train {modality}: bad metrics {m}")
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    ref_state = create_train_state(reference, learning_rate=1e-4, freeze_video_trunk=av)
    with plain_recurrence(lstm_fused):
        _, ref_metrics = step(ref_state, batch)
    ref_grads = {n: p.grad for n, p in ref_state.model.named_parameters()
                 if p.grad is not None}
    if grads.keys() != ref_grads.keys():
        raise RuntimeError(f"train {modality}: gradients of {sorted(grads)} "
                           f"against {sorted(ref_grads)}")
    grad_err = max(rel_err(grads[n], ref_grads[n]) for n in grads)
    loss_err = abs(m["loss"] - ref_metrics["loss"].item()) / abs(ref_metrics["loss"].item())
    del ref_state, reference, ref_grads
    torch.cuda.empty_cache()
    print(f"train {modality}: launches {counts[fwd]} K1d ({lstm_fused.KERNEL_NAMES[fwd]}), "
          f"{counts[bwd]} K1e ({lstm_fused.KERNEL_NAMES[bwd]}), {counts['none']} K1a; "
          f"metrics {json.dumps({k: round(v, 6) for k, v in m.items()})}; "
          f"against the plain recurrence: grads rel {grad_err:.3e} (tol "
          f"{STEP_GRAD_REL_TOL:g}) over {len(grads)} tensors, loss rel {loss_err:.3e} "
          f"(tol {STEP_LOSS_REL_TOL:g})")
    if grad_err > STEP_GRAD_REL_TOL or loss_err > STEP_LOSS_REL_TOL:
        raise RuntimeError(f"train {modality}: step vs plain recurrence {grad_err}, {loss_err}")
    torch.cuda.reset_peak_memory_stats()
    marks = []
    hooks = train_marks(state.model, state.optimizer, marks)
    try:
        reps = [timed_train_step(step, state, batch, marks) for _ in range(3)]
    finally:
        for hk in hooks:
            hk.remove()
    dt, stage_ms = min(reps, key=lambda r: r[0])
    print(f"train {modality}: {1e3 * dt:.2f} ms/step (reps "
          f"{[round(1e3 * r[0], 2) for r in reps]}), {b * t / FRAME_RATE / dt:.1f}x "
          f"real time, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"profile": f"train/{modality}" + ("" if persist else "/out_of_plan"),
                      "stage_ms": stage_ms,
                      **profile_step(step, state, batch)}))
    return state


def trainer_phase(state) -> None:
    """Trainer.fit for one epoch (2 train batches and 1 eval batch of B=4,
    T=128) on the AV state, a checkpoint round trip, and one more step
    from the saved and from the restored state."""
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.ops import lstm_fused
    from avvad_tpu_torch.train import (Trainer, create_train_state, latest_checkpoint,
                                       make_train_step, restore_checkpoint)

    t = 128
    train = [train_batch(t, 4, True, seed=s) for s in (10, 11)]
    valid = [train_batch(t, 4, True, seed=12)]
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as model_dir:
        lstm_fused.reset_launches()
        t0 = time.perf_counter()
        last = Trainer(state, "av", model_dir).fit(train, valid, end_epoch=2)
        torch.cuda.synchronize()
        counts = dict(lstm_fused.launches)
        expect = {k: 0 for k in counts}
        # 2 train batches x 2 layers, one persistent launch each way; the
        # eval pass runs K1a
        expect.update(fwd_train_persist=2 * 2, bwd_persist=2 * 2, none=2 * t)
        if counts != expect:
            raise RuntimeError(f"Trainer.fit: launch counts {counts}, expected {expect}")
        logs = {name: (Path(model_dir) / name).read_text().splitlines()
                for name in ("output_batch.log", "output_epoch.log")}
        path = latest_checkpoint(model_dir)
        if len(logs["output_batch.log"]) != 2 or len(logs["output_epoch.log"]) != 4 \
                or path is None:
            raise RuntimeError(f"Trainer.fit: logs {logs}, checkpoint {path}")
        fresh = create_train_state(
            AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                  use_kernel_lstm=True, seed=1), freeze_video_trunk=True)
        fresh, _, epoch = restore_checkpoint(model_dir, fresh)
        print(f"Trainer.fit: 1 epoch in {time.perf_counter() - t0:.1f} s, launches "
              f"{counts}; valid {json.dumps({k: round(v, 4) for k, v in last['valid'].items()})}; "
              f"restored {Path(path).name} (epoch {epoch}, step {fresh.step})")
    want, got = state.model.state_dict(), fresh.model.state_dict()
    if want.keys() != got.keys() or any(not torch.equal(want[k], got[k]) for k in want) \
            or fresh.step != state.step:
        raise RuntimeError("restored state differs from the saved one")
    step = make_train_step("av")
    for s in (state, fresh):
        step(s, train[0])
    err = max((a - b).abs().max().item() for a, b in
              zip(state.model.parameters(), fresh.model.parameters()))
    print(f"one more step from the saved and the restored state: max |param diff| "
          f"{err:.3e} (tol 1e-6)")
    if err > 1e-6:
        raise RuntimeError(f"resumed step differs: {err}")


def probe_bound(b: int, t: int, h: int, mode: str) -> tuple[float, str]:
    """Least time of one probe layer. "full", "matmul_only" and "h_bf16" do
    K1a's / K1c's work (bound()); "gates_only" reads x_proj and c0 and
    writes y and c once, and does some 30 fp32 operations a cell."""
    if mode != "gates_only":
        return bound(b, t, h, PROBE_SQ[mode])
    nbytes = 4 * (b * t * 4 * h + b * t * h + 2 * b * h)
    t_ops, t_bytes = 30.0 * b * t * h / PEAK["none"], nbytes / MEM_BW
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def probe_kernel_phase(lstm_fused, tool) -> dict:
    """P1's four modes against the plain version at the probe's shape and
    the ragged one, with times and bounds -> kernel rows "probe/<mode>"."""
    dev = torch.device("cuda")
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x_in = torch.randn(B, T, H, generator=torch.Generator().manual_seed(9)).cuda()
    with torch.inference_mode():
        cudnn_ms = cuda_ms(lambda: lstm(x_in), 5)
    rows = {}
    for mode in lstm_fused.PROBE_MODES:
        errs = []
        for b, t, h in ((B, T, H), RAGGED):
            xp, w, _, _ = tool.probe_inputs(b, t, h, dev, seed=3)
            g = torch.Generator().manual_seed(4)
            h0 = torch.tanh(torch.randn(b, h, generator=g)).cuda()
            c0 = torch.randn(b, h, generator=g).cuda()
            y = lstm_fused.lstm_probe(xp, w, h0, c0, mode)
            torch.cuda.synchronize()
            ref = lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode)
            err = (y - ref).abs().max().item()
            print(f"lstm_probe[{mode}] B={b} T={t} H={h}: max|kernel-plain| = {err:.3e} "
                  f"(tol {PROBE_TOL[mode]:g}; max|plain| {ref.abs().max().item():.3f})")
            if not (torch.isfinite(y).all() and err <= PROBE_TOL[mode]):
                raise RuntimeError(f"probe {mode}: kernel disagrees with plain ({err})")
            errs.append(err)
        xp, w, h0, c0 = tool.probe_inputs(B, T, H, dev)
        ms = cuda_ms(lambda: lstm_fused.lstm_probe(xp, w, h0, c0, mode), 5)
        plain_ms = cuda_ms(lambda: lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode), 2)
        library_ms = cudnn_ms if mode in ("full", "h_bf16") else None
        bound_ms, bound_by = probe_bound(B, T, H, mode)
        print(f"lstm_probe[{mode}]: kernel {ms:.3f} ms/layer ({1e3 * ms / T:.2f} us/step), "
              f"plain {plain_ms:.3f}, cuDNN LSTM layer "
              f"{'none' if library_ms is None else f'{library_ms:.3f}'}, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        rows[f"probe/{mode}"] = {
            "name": f"lstm_probe[{mode}]", "route": "cuda",
            "source": "avvad_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "scripts/bench_lstm_probe.py:71", "launches": None,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    full, mm, go = (rows[f"probe/{m}"]["ms"] for m in ("full", "matmul_only", "gates_only"))
    print(f"lstm_probe split of a full step ({1e3 * full / T:.2f} us): matmul_only "
          f"{mm / full:.3f} of full, gates_only {go / full:.3f} of full")
    # a quarter of the product would be dead-code elimination of three gates
    if mm < 0.5 * full:
        raise RuntimeError(f"matmul_only {mm:.3f} ms is under half of full {full:.3f} ms: "
                           "the contraction was cut")
    return rows


def probe_tool_phase(lstm_fused, tool, rows: dict) -> None:
    """The probe entry point, as a user runs it, with launch counters."""
    iters = 30
    lstm_fused.reset_launches()
    res = tool.main([])
    torch.cuda.synchronize()
    counts = dict(lstm_fused.launches)
    # each timing is a warm-up and `iters` calls; "full" and "h_bf16" are
    # run once more each for their difference
    expect = {k: 0 for k in counts}
    expect.update(probe=T * (4 * (iters + 1) + 2),
                  **{sq: T * (iters + 1) for sq in lstm_fused.STATE_QUANTS})
    if counts != expect:
        raise RuntimeError(f"probe tool: launch counts {counts}, expected {expect}")
    for mode, n in res["probe_launches"].items():
        if n < T:
            raise RuntimeError(f"probe tool: mode {mode} launched {n} times")
        rows[f"probe/{mode}"]["launches"] = n
    times = [*res["probe"].values(), *res["lstm_layer_fused"].values(),
             *res["frontend"].values()]
    if not all(np.isfinite(v) and v > 0 for v in times) or \
            not 0 <= res["h_bf16_vs_full"] < 1e-2:
        raise RuntimeError(f"probe tool: bad result {res}")
    print(json.dumps({"probe_tool": res, "launches": counts}))


def frontend_phase() -> None:
    """hop_dft and split_radix against the direct DFT at the serving shape,
    then the three log-power frontends' times."""
    from avvad_tpu_torch.ops.stft import log_power_frontend, stft_frames

    rng = np.random.default_rng(1)
    wave = torch.from_numpy(rng.standard_normal((B, N_SAMPLES), np.float32) * 0.3).cuda()
    direct = stft_frames(wave)
    errs = {}
    for route, tol in ROUTE_TOL.items():
        got = stft_frames(wave, **{route: True})
        errs[route] = max(rel_err(g, d) for g, d in zip(got, direct))
        if got[0].shape != (B, T, 513) or not errs[route] < tol:
            raise RuntimeError(f"frontend {route}: {tuple(got[0].shape)}, rel {errs[route]}")
    ms = {route: cuda_ms(lambda: log_power_frontend(wave, **kw), 10)
          for route, kw in (("direct", {}), ("hop_dft", {"hop_dft": True}),
                            ("split_radix", {"split_radix": True}))}
    print(f"frontend B={B} T={T}: re/im against direct, share of the largest value: "
          + ", ".join(f"{r} {e:.2e} (tol {ROUTE_TOL[r]:g})" for r, e in errs.items())
          + "; log-power ms: " + ", ".join(f"{r} {v:.3f}" for r, v in ms.items()))


def stream_data(seed: int = 0):
    """Seeded traffic of STREAMS real-time streams over TICKS ticks: int16
    PCM (a block of frames a tick) and 30 fps uint8 lip frames, cut so
    that every tick completes exactly one block of both modalities ->
    (pcm chunks per tick (STREAMS, n), video chunks per tick
    (STREAMS, k, 67, 67), the same video at 62.5 fps (STREAMS, T, 67, 67))."""
    from avvad_tpu_torch.processing import fps_block_schedule, fps_resample_indices

    rng = np.random.default_rng(seed)
    n0 = 1024 - HOP
    pcm = (rng.standard_normal((STREAMS, n0 + TICKS * BLOCK * HOP)) * 6000).astype(np.int16)
    cuts = [0] + [n0 + (k + 1) * BLOCK * HOP for k in range(TICKS)]
    need = [0]
    for k in range(TICKS):
        lo, rel = fps_block_schedule(k * BLOCK, BLOCK, 30.0, FRAME_RATE)
        need.append(lo + int(rel[-1]) + 1)
    src = rng.integers(0, 256, (STREAMS, need[-1], 67, 67), dtype=np.uint8)
    up = src[:, fps_resample_indices(need[-1], 30.0, FRAME_RATE)[:TICKS * BLOCK]]
    return ([pcm[:, a:b] for a, b in zip(cuts, cuts[1:])],
            [src[:, a:b] for a, b in zip(need, need[1:])], up)


def feed_tick(ms, pcm, video, float_wire: bool) -> None:
    for i in range(STREAMS):
        chunk = pcm[i].astype(np.float32) / 32768.0 if float_wire else pcm[i]
        if video is None:
            ms.feed(i, chunk)
        else:
            ms.feed(i, pcm=chunk, video_frames=video[i])


def check_tick(out: dict, label: str) -> None:
    if sorted(out) != list(range(STREAMS)):
        raise RuntimeError(f"{label}: streams {sorted(out)} produced output")
    probs = np.stack([out[i] for i in range(STREAMS)])
    if probs.shape != (STREAMS, BLOCK) or not np.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise RuntimeError(f"{label}: bad probabilities {probs.shape}")


def run_streamer(ms, lstm, pcm, video, float_wire: bool, label: str):
    """warmup(), then TICKS ticks of feed + tick() -> (per-tick outputs,
    a summary). CUDA events at the LSTM stack's edges give the carried-state
    loop's device time inside each tick."""
    ms.warmup()
    marks, outs, ticks = [], [], []
    hooks = [lstm.register_forward_pre_hook(lambda *_: _mark(marks)),
             lstm.register_forward_hook(lambda *_: _mark(marks))]
    torch.cuda.reset_peak_memory_stats()
    try:
        for k in range(TICKS):
            marks.clear()
            t0 = time.perf_counter()
            feed_tick(ms, pcm[k], None if video is None else video[k], float_wire)
            t1 = time.perf_counter()
            out = ms.tick()  # fetches: ends with the device's work done
            t2 = time.perf_counter()
            check_tick(out, f"{label} tick {k}")
            outs.append(out)
            ticks.append((t2 - t0, t1 - t0, marks[0][1].elapsed_time(marks[1][1])))
    finally:
        for hk in hooks:
            hk.remove()
    best = min(ticks, key=lambda r: r[0])
    med = float(np.median([r[0] for r in ticks]))
    audio_s = STREAMS * BLOCK / FRAME_RATE
    summary = {"streaming": label, "streams": STREAMS, "block_frames": BLOCK,
               "ticks": TICKS, "ms_per_tick_best": 1e3 * best[0],
               "ms_per_tick_median": 1e3 * med, "feed_ms_of_best": 1e3 * best[1],
               "x_real_time_best": audio_s / best[0], "x_real_time_median": audio_s / med,
               "lstm_loop_ms_of_best": best[2], "lstm_loop_share_of_best": best[2] / (1e3 * best[0]),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    # the device step alone (warmup() runs it on zeros and synchronises)
    # under the profiler: how much of it the device is busy
    prof = profile_step(ms.warmup)
    summary.update(step_wall_ms=prof["profiled_step_wall_ms"],
                   step_device_busy_ms=prof["device_busy_ms"],
                   step_device_idle_share=prof["device_idle_share"],
                   step_top_kernels=prof["top_kernels"][:4])
    print(f"streaming {label}: {summary['ms_per_tick_best']:.2f} ms/tick best, "
          f"{summary['ms_per_tick_median']:.2f} median (feed {summary['feed_ms_of_best']:.2f}), "
          f"{summary['x_real_time_best']:.0f}x real time, LSTM loop "
          f"{best[2]:.2f} ms = {summary['lstm_loop_share_of_best']:.2f} of the tick, peak mem "
          f"{summary['peak_mem_gib']:.2f} GiB; the step alone under the profiler: "
          f"{prof['profiled_step_wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms "
          f"(idle share {prof['device_idle_share']:.2f})")
    return outs, summary


def solo_check(solo, outs, pcm, up, kind: str, label: str) -> float:
    """Streams 0 and 1 of the batched run against a solo streamer fed the
    same samples (and the same frames at 62.5 fps) -> largest difference."""
    worst = 0.0
    for i in (0, 1):
        solo.reset()
        for k in range(SOLO_TICKS):
            chunk = pcm[k][i].astype(np.float32)  # int-domain values and peak
            got = (solo.feed(chunk) if up is None
                   else solo.feed(chunk, up[i, k * BLOCK:(k + 1) * BLOCK]))
            if got.shape != (BLOCK,):
                raise RuntimeError(f"{label}: solo stream {i} tick {k} gave {got.shape}")
            worst = max(worst, float(np.abs(got - outs[k][i]).max()))
    print(f"streaming {label}: streams 0 and 1 against solo over {SOLO_TICKS} ticks: "
          f"max |diff| {worst:.2e} (tol {SOLO_TOL[kind]:g})")
    if worst > SOLO_TOL[kind]:
        raise RuntimeError(f"{label}: multi-stream against solo {worst}")
    return worst


def pipeline_check(make, outs, pcm, video, label: str) -> float:
    """tick_pipelined hands out tick n-1's result at tick n and equals the
    synchronous run; a slot recycled with a tick pending delivers nothing."""
    ms = make()
    worst, n = 0.0, 6
    for k in range(n):
        feed_tick(ms, pcm[k], None if video is None else video[k], False)
        got = ms.tick_pipelined()
        if k == 0:
            if got != {}:
                raise RuntimeError(f"{label}: first pipelined tick returned {sorted(got)}")
            continue
        check_tick(got, f"{label} pipelined tick {k}")
        worst = max(worst, max(float(np.abs(got[i] - outs[k - 1][i]).max())
                               for i in range(STREAMS)))
    if ms.pending_streams() != set(range(STREAMS)):
        raise RuntimeError(f"{label}: pending {sorted(ms.pending_streams())}")
    ms.reset_stream(3)
    tail = ms.flush_pipelined()
    if sorted(tail) != [i for i in range(STREAMS) if i != 3]:
        raise RuntimeError(f"{label}: a recycled slot delivered: {sorted(tail)}")
    worst = max(worst, max(float(np.abs(tail[i] - outs[n - 1][i]).max()) for i in tail))
    print(f"streaming {label}: tick_pipelined one tick late against the synchronous run "
          f"over {n} ticks: max |diff| {worst:.2e} (tol {PIPE_TOL:g}); reset_stream(3) "
          f"with a tick pending delivered {len(tail)} streams, none of slot 3")
    if worst > PIPE_TOL:
        raise RuntimeError(f"{label}: pipelined against synchronous {worst}")
    return worst


def streaming_phase(float_model, int8_model) -> None:
    import avvad_tpu_torch.models.resnet as resnet_mod
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused

    pcm, video, up = stream_data()
    span = dict(span_wire=True, hop_dft=True, audio_int16=True)
    print(f"streaming: {STREAMS} streams x {BLOCK} frames a tick "
          f"({STREAMS * BLOCK / FRAME_RATE:.3f} s of audio), {TICKS} ticks; "
          f"{sum(v.shape[1] for v in video)} camera frames a stream")

    audio = AudioVAD(lstm_hidden_size=H, lstm_layers=2, seed=0)
    for label, kw, float_wire in (("audio/frames", {}, True), ("audio/span_int16_hop_dft", span, False)):
        ms = serve.MultiStreamVAD(audio, STREAMS, block_frames=BLOCK, **kw)
        outs, summary = run_streamer(ms, ms.model.lstm_audio, pcm, None, float_wire, label)
        if not float_wire:
            summary["solo_max_abs_diff"] = solo_check(
                serve.StreamingVAD(audio, block_frames=BLOCK), outs, pcm, None, "audio", label)
            summary["pipelined_max_abs_diff"] = pipeline_check(
                lambda: serve.MultiStreamVAD(audio, STREAMS, block_frames=BLOCK, **span),
                outs, pcm, None, label)
        print(json.dumps(summary))
    del audio, ms
    torch.cuda.empty_cache()

    def av_server(model):
        return serve.MultiStreamAVVAD(model, STREAMS, block_frames=BLOCK, video_fps=30.0,
                                      video_uint8=True, **span)

    for label, model in (("av/float_tower", float_model), ("av/int8_tower", int8_model)):
        ms = av_server(model)
        outs, summary = run_streamer(ms, ms.model.lstm_merged, pcm, video, False, label)
        summary["solo_max_abs_diff"] = solo_check(
            serve.StreamingAVVAD(model, block_frames=BLOCK, video_uint8=True),
            outs, pcm, up, "av", label)
        summary["pipelined_max_abs_diff"] = pipeline_check(
            lambda: av_server(model), outs, pcm, video, label)
        if label == "av/int8_tower":
            # one tick with the counters at 0 before and read after, then the
            # same ticks with the plain K2 / K3
            ms = av_server(model)
            worst, block_kernel = 0.0, conv_fused.basic_block_int8
            for k in range(3):
                feed_tick(ms, pcm[k], video[k], False)
                for mod in (lstm_fused, conv_fused, stem_fused):
                    mod.reset_launches()
                got = ms.tick()
                counts = {**lstm_fused.launches, **conv_fused.launches, **stem_fused.launches}
                expect = {k_: 0 for k_ in counts}
                expect.update({conv_fused.KERNEL_NAME: 8, stem_fused.KERNEL_NAME: 1})
                if counts != expect:
                    raise RuntimeError(f"{label}: tick launch counts {counts}, expected {expect}")
                worst = max(worst, max(float(np.abs(got[i] - outs[k][i]).max())
                                       for i in range(STREAMS)))
            if worst > PIPE_TOL:
                raise RuntimeError(f"{label}: a second run differs by {worst}")
            ref = av_server(model)
            resnet_mod.stem_epilogue_pool_quant = stem_fused.stem_epilogue_plain
            conv_fused.basic_block_int8 = conv_fused.basic_block_int8_plain
            try:
                worst = 0.0
                for k in range(3):
                    feed_tick(ref, pcm[k], video[k], False)
                    got = ref.tick()
                    worst = max(worst, max(float(np.abs(got[i] - outs[k][i]).max())
                                           for i in range(STREAMS)))
            finally:
                resnet_mod.stem_epilogue_pool_quant = stem_fused.stem_epilogue_pool_quant
                conv_fused.basic_block_int8 = block_kernel
            print(f"streaming {label}: launches a tick {conv_fused.KERNEL_NAME} 8, "
                  f"{stem_fused.KERNEL_NAME} 1; 3 ticks against the plain K2/K3: max |diff| "
                  f"{worst:.2e} (tol {INT8_PROB_TOL:g})")
            if worst > INT8_PROB_TOL:
                raise RuntimeError(f"{label}: ticks against plain K2/K3 {worst}")
            summary.update(k2_launches_per_tick=8, k3_launches_per_tick=1,
                           plain_k2_k3_max_abs_diff=worst)
        print(json.dumps(summary))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"card: {card}")
    from avvad_tpu_torch.ops import _build, lstm_fused
    from avvad_tpu_torch.processing import unique_frame_schedule
    from avvad_tpu_torch.tools import lstm_probe as probe_tool

    info = _build.build(force=True)
    print(f"built {info['path']} in {info['seconds']:.1f} s")
    for line in info["ptxas"]:
        print(f"  {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = kernel_phase(lstm_fused)
    rows.update(int8_kernel_phase(B * unique_frame_schedule(T)[0]))
    float_model = main_path(lstm_fused, rows)
    torch.cuda.empty_cache()
    int8_model = int8_path(rows)
    torch.cuda.empty_cache()
    rows.update(train_kernel_phase(lstm_fused))
    state = train_path(rows, "av")
    torch.cuda.empty_cache()
    train_path(rows, "audio")
    torch.cuda.empty_cache()
    train_path(rows, "audio", **OUT_OF_PLAN_STEP)
    torch.cuda.empty_cache()
    trainer_phase(state)
    del state
    torch.cuda.empty_cache()
    rows.update(probe_kernel_phase(lstm_fused, probe_tool))
    probe_tool_phase(lstm_fused, probe_tool, rows)
    frontend_phase()
    streaming_phase(float_model, int8_model)
    print(json.dumps({"kernels": [rows[k] for k in (
        *lstm_fused.STATE_QUANTS, *lstm_fused.TRAIN_KERNELS, "k2", "k3",
        *(f"probe/{m}" for m in lstm_fused.PROBE_MODES))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
