"""Smoke run of the PyTorch/CUDA port (avvad_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
1. card check (no CUDA device -> exit 1) and the card's name and power limit;
2. build every kernel of avvad_tpu_torch/csrc with nvcc (sm_90a), one
   process per source, and the host library (csrc/avvad_io.cpp, the C++
   stream hub) with g++;
3. each LSTM inference kernel against its plain PyTorch version on the
   card, with CUDA-event times of the kernel, the plain version and one
   cuDNN torch.nn.LSTM layer, and the bound from the shapes. For each
   state_quant the persistent kernel (one cooperative launch a layer:
   lstm_f32h_persist, K1c lstm_bf16h_persist and K1b lstm_int8_persist on
   the tensor cores) at the main path's shape (B=64, T=512, H=1024), a
   ragged one (B=3, T=7) and one with a single batch tile a CTA (B=13, T=7,
   H=1000), two launches agreeing bit for bit (K1b also bit for bit with
   its plain version and with the per-step lstm_int8 at each shape), and
   the per-step kernel (lstm_f32h, lstm_bf16h, lstm_int8) outside the plan
   (B=3, T=7, H=1030); the launch counters show each route, and both
   routes are timed in turns at the main path's shape (the per-step route
   forced);
4. the int8 tower's kernels against their plain versions: the stem
   epilogue (K3) on both routes, stem_epilogue_pool_nhwc on channels-last
   stem output (bf16, as serving gives it, and fp32) and stem_epilogue_pool
   on NCHW (bf16), a of both signs, and the fused BasicBlock (K2) at each of
   the 8 trunk geometries with seeded int8 inputs and random folded
   parameters, bit for bit at the main path's frame count (64 x 246 =
   15,744) and a ragged one (37); CUDA-event times of kernel (K3's two
   routes in turns) and plain version, bounds, and one line per block with
   its plan, TOP/s and share of the int8 peak; then K4, the float trunk's
   train-mode BatchNorm pair (bn_stats, bn_apply) at the 20 BatchNorms of
   the AV training step (8,192 frames; the stem's max pool in its pass):
   launches (20 + 17), each site against its plain version, and CUDA-event
   times of the kernels, the plain version and F.batch_norm(training=True)
   (cuDNN; a yardstick, the port never calls it) summed over the step,
   beside the byte bound;
5. the full-width AV serving step with the float ResNet-18 tower (MCB 1024,
   2 x LSTM 1024, bf16 model, B=64, T=512, 30 fps unique frames) for each
   LSTM state_quant (2 launches of the persistent K1a, K1c or K1b), with
   launch counters read around the step, outputs
   checked, the step compared with the plain recurrence and timed, its
   stages timed by CUDA events recorded at the tower's and the LSTM stack's
   edges, and one more step under torch.profiler for the device's idle
   share and top kernels (one {"profile": ...} line per state_quant);
6. the same step with the calibrated static-int8 tower on the fused
   kernels (the stem conv writing channels-last, then the channels-last K3
   once and K2 eight times per tower pass), calibrated with the port's
   ``calibrate`` on 2 utterances, for state_quant none and int8: launch
   counts, outputs, the step against the same step with the plain K2/K3
   versions, times, stages and a profile line with the stem's split (conv,
   layout transforms, K3); the stem's two routes alone on the step's
   frames (conv and K3 of each, timed in turns; the conv kernels of each
   under torch.profiler); and the int8 tower's features against the fp32
   float tower's on the same frames;
6a. the serving artifacts and the serving options: the int8-tower
   step (none, int8) exported with torch.export (the kernels as
   torch.library custom ops), saved, loaded and replayed: export s, .pt2
   MB, load s, the replay's launches (K1 2, K3 1, K2 8, nothing else), the
   replay bit for bit against the live step, both timed in turns; the AV
   server (int8 tower, span int16 hop_dft, 30 fps uint8) exported and
   rebuilt by load_multistream_server, TICKS ticks of the streaming data,
   K3 1 and K2 8 a tick of the rebuilt server, every stream within 1e-6 of
   the live server, tick ms of both; the int8 stem (tower_stem_int8) at
   the serving shape: its card route (fp32 conv, rounded) bit for bit
   against the float64 route on every frame, then K3 and the 8 K2 on its
   output bit for bit against their plain versions, the stem alone against
   the bf16 float stem, and its serving step with the stage split; MCB at
   "default" against "highest" on the step for none (probabilities within
   1e-4, the JAX bench's configuration) and int8 (printed), each timed
   with its stage split;
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
   the card): launch counters (K4's 20 + 17 among them, the K4 row's
   launches), loss and metrics, the step's gradients
   against the same step with the plain recurrence, ms/step (best of 3
   after a warm-up), x real time, peak memory, stage times by CUDA events
   (inputs, tower, fusion, LSTM forward, head and loss, backward,
   optimizer, metrics) and one {"profile": ...} line; then the audio
   (AudioVAD) train step at the same B, T and H: 2 persistent K1d and 2
   persistent K1e launches a step, no per-step launch; then an AudioVAD
   train step outside the plan (2 x LSTM 1030, B=4, T=64), which goes
   through the per-step K1d and K1e (2 T and 2 (T + 1) launches), and
   inference passes of that model for each state_quant, which go through
   the per-step K1a, K1c and K1b (2 T launches each);
9. a short Trainer.fit (one epoch of 2 batches and an eval pass, the
   persistent K1a) of
   the AV model with a checkpoint round trip into a temporary directory
   under build/: the restored state equals the saved one, and one more
   step from each agrees;
10. the probe kernel (P1) in its four modes against its plain version, on
    the probe's own draws (x_proj x 0.1, W_hh x 0.02): on the persistent
    frame (lstm_probe_persist, one launch a layer) at the probe's shape
    (B=64, T=512, H=1024) and the ragged one, "full" and "h_bf16" bit for
    bit against lstm_f32h_persist and lstm_bf16h_persist; per step
    (lstm_probe) outside the plan (B=3, T=7, H=1030) and, the route forced,
    at the probe's shape; CUDA-event times of both routes in turns, the
    plain version and, for "full" and "h_bf16", one cuDNN torch.nn.LSTM
    layer; bounds from the shapes; the split of a step of each route;
11. the probe tool's main() in-process at its default shape (the persistent
    P1) and at a shape outside the plan (the per-step P1), with launch
    counters read around each: its lines, and one {"probe_tool": ...} and
    one {"probe_tool_outside_plan": ...} line;
12. the hop-block and split-radix DFT routes against the direct one at the
    serving shape (B=64, T=512), and the three frontends' times;
13. streaming at full width, 32 streams x 16 frames a tick, 40 ticks:
    MultiStreamVAD (AudioVAD, 2 x LSTM 1024) on the frames wire and on the
    int16 span wire with the hop-block DFT; MultiStreamAVVAD (30 fps uint8
    camera frames, int16 span wire) with the bf16 float tower and with the
    calibrated static-int8 tower (the channels-last K3 once and K2 eight
    times a tick, launch
    counters read around a tick). Probabilities checked; streams 0 and 1
    against a solo StreamingVAD / StreamingAVVAD fed the same data; the
    int8-tower ticks against the same ticks with the plain K2/K3;
    tick_pipelined one tick late against the synchronous run; a stream
    reset with a tick pending delivers nothing of the old stream; ms/tick,
    x real time, peak memory, the LSTM loop's share, the device's idle
    share of one step under torch.profiler, one {"streaming": ...} line
    each. Before them the same feeds through the C++ stream hub and its
    numpy route in turns (feed + assemble ms a tick of each, the blocks,
    peaks and masks bit-equal; one {"hub": ...} line); after them the TCP
    server (VADServer) over sockets: 32 localhost client threads each send
    a whole stream (40 blocks: int16 P and uint8 U messages to the AV
    server with the static-int8 tower, int16 raw PCM to the AudioVAD fp32
    server) while poll() runs in the main thread: wall seconds, ms of a
    poll that ticked, x real time, the hub's ms inside the polls, K3 once
    and K2 eight times a tick (nothing else), every stream against a solo
    streamer (5e-4 AV, 1e-5 audio), one {"server": ...} line each;
14. the video-only family and the trunk's backward: the full-width video
    train step (VideoVAD, its ResNet-18 trained from scratch, 2 x LSTM 1024,
    fp32, Adam 1e-4, B=16, T=512: 8,192 frames through the trunk) with the
    checks and records of phase 8, its two compared steps on cuDNN's
    deterministic algorithms; the same step with remat=True against the
    step without (gradients, running statistics updated once; ms/step and
    peak memory of both, one {"remat": ...} line); the AV train step with
    the trunk unfrozen, as the video step; Trainer.fit on the video state,
    as phase 9; MultiStreamVideoVAD (VideoVAD bf16, 30 fps uint8 camera
    frames, 32 streams x 16 frames, 40 ticks) with the bf16 float tower and
    with the calibrated static-int8 tower (the channels-last K3 once and K2
    eight times a tick on its 288 unique frames), with the checks of phase
    13, one {"streaming": ...} line each;
15. the corpus path at full width, on disk: a raw NTCD-TIMIT tree made
    from the seed under build/ (2-8 s utterances, DCT video as HDF5 .mat
    files, white noise at -5 dB; HDF5 read and written by the port's own
    hdf5.py, no h5py), the port's builders through the create_train_files
    twin (its {"cli": ...} line) and AudioVisualSource over the processed
    tree. 32 train, 16 validation and 64 test utterances. Trainer.fit,
    one epoch of the fp32 AVVAD (MCB 1024, 2 x LSTM 1024, ResNet-18
    frozen) on DataLoader(batch_size=16, bucket=128, shuffled), with the
    Prefetcher, without it and with it again, each with its launch counts
    (the persistent K1d / K1e 2 + 2 a train batch, K1a 2 a validation
    batch) and its epoch seconds; the trained weights in the static-int8
    fused tower, calibrate_quant_scales on the train split, evaluate_split
    over the test split (batch 8, bucket ladder, one .npy pair an
    utterance) for state_quant none and int8 with the launch counts (K3 1,
    K2 8, the persistent K1a or K1b 2 a batch), rt_factor and peak memory,
    every soft prediction against the same batches through the predict
    step with the plain K2 / K3 and the plain recurrence; the loader alone
    over the test split (the host feed's time); one more evaluate_split
    under torch.profiler for the device's idle share; the
    predictions scored (score_split); one {"corpus": ...} line;
15a. the command-line twins (avvad_tpu_torch/scripts), each main(argv)
    in process at full width on phase 15's tree, the launch counters read
    around each, one {"cli": ...} line a call: import_checkpoint of a
    seeded reference-layout .pt (AVVAD: ResNet-18, MCB 1024, 2 x LSTM 1024;
    VideoVAD); train --resume, one epoch at B=16 (the persistent K1d / K1e
    2 + 2 a train batch, K1a 2 a validation batch); evaluate with the
    static-int8 tower and int8 state (K3 1, K2 8, K1b 2 a batch, and 2 a
    batch of the calibration), its predictions bit for bit against the
    in-process evaluate_split; run_metrics; reconstruct (VideoVAD, B=1);
    export_serving (the int8-tower step at B=64, T=512, 30 fps), whose
    replay matches the live step bit for bit (K1a 2, K3 1, K2 8); the
    serve_server twin's build_server from a multi-stream artifact of the
    int8 AV server, 32 localhost clients, every stream within 5e-4 of a
    solo streamer, K3 1 and K2 8 a tick; stream_demo on one wav and its lip
    video;
15b. the complete-corpus rehearsal (rehearse_complete's stages at the JAX
    script's defaults): a raw tree of 20 speakers x 10 utterances with the
    6-noise x 3-SNR grid (4,000 files, the .mat files by hdf5.py), the
    build with one pool of workers, one audio and one AV epoch (AVVAD, MCB
    1024, 2 x LSTM 1024, ResNet-18 trained; 2,520 train and 540
    validation items; the persistent K1d / K1e 2 + 2 a train batch, K1a 2
    a validation batch), evaluate + run_metrics for audio and AV over the
    540-item test grid (K1a 2 a batch; all 18 conditions scored), the
    files, seconds, x real time and launches of each step in one
    {"rehearsal": ...} line; the AV evaluate under torch.profiler (idle
    share); the AV test split with the static-int8 tower and int8 state
    (K3 1, K2 8, K1b 2 a batch) against the float predictions through
    compare_predictions, held to the quantization gate (mean |dp| and hard
    flips each under 5 %), and its controls (the calibrated scales x0 or
    x1/8), which must fail it; summarize_training on both model dirs; the device
    STFT against the host one over the test split's clean wavs (5e-3); the
    upsampling QA held to the JAX script's rule on diffs computed from the
    raw files; the figure twins, which raise an ImportError naming
    matplotlib or cv2 where it is missing; one {"rehearsal": "phase", ...}
    line;
16. RawAudioVAD serving (WaveNet encoder on cuDNN convolutions, 2 x LSTM
    1024 as the plain loop, bf16, out_frames 512) through
    make_waveform_serving_fn at scripts/bench_modalities.py's shape (B=64,
    131,840 samples an utterance): no kernel launch, probabilities finite
    in [0, 1], 2 utterances within 2e-2 of the same model on the CPU;
    ms/step (best of 3 after a warm-up), x real time, peak memory, stage ms
    by CUDA events (encoder, LSTM, head), and one more step under
    torch.profiler; one {"profile": "raw_serving", ...} line;
17. RawAudioVAD training (fp32, Adam 1e-4, make_train_step("waveform")):
    at B=2 one card step against the CPU's (loss within 1e-5, every
    gradient within 1e-3 in relative L2); at B=16, T=512 no kernel launch,
    the loss finite, ms/step, x real time, peak memory, the stage split
    (encoder forward, LSTM forward, head and loss, backward, optimizer) and
    one {"profile": "train/waveform", ...} line;
17a. scale-out on the one card (the mesh phase): (a) an NCCL process group
    of world size 1 and a 1 x 1 mesh, Trainer(mesh=) taking phase 8's
    full-width AV train step, bit for bit against the unmeshed step, 2 + 2
    persistent K1d / K1e; (b) two gloo ranks on the one card (NCCL refuses
    two ranks on one device), spawned after the kernels are built: the
    same step at data 2 (B=8 a rank) and at model 2 (the (1024, 4096)
    w_ih / w_hh column-sharded, gathered for the kernels), each against
    the single-process step (loss within 1e-5, every gradient within 1e-3
    in relative L2), each rank's K1d / K1e launches by the route
    persistent_plan picks for its rows, a checkpoint saved by rank 0 and
    restored bit for bit on both; (c) MultiStreamAVVAD with the static-int8
    tower sharded over ["cuda:0"] * 2, TICKS ticks of the streaming data,
    every stream within 1e-6 of the unsharded server, K3 2 and K2 16 a
    tick; (d) evaluate_split(mesh=) of the int8-tower model on two gloo
    ranks over 16 in-script test utterances, every prediction within 1e-4
    of the unmeshed run, K3 1, K2 8 and K1a 2 a batch and a rank. One
    {"mesh": ...} line each, with ms, peak memory and launches; two ranks
    on one card time-slice it, so these times are no scaling figure;
17b. the timers (avvad_tpu_torch/scripts/bench*.py), each twin's main in
    process at full width with short loops (ITERS=2, REPS=2, 8 ticks, one
    A/B round), the launch counters read around each and added to the
    kernels line's rows, one {"timers": ...} line each: bench's serving
    ladder (AVVAD bf16, static-int8 tower on K3 + 8 x K2, B=64, T=512;
    shipped, lstm_bf16, lstm_int8, hop_dft, then +mcb_hoist on the
    winner), the train matrix (AV frozen and trained, audio, video; K1d /
    K1e 2 + 2 a step), the kernel tripwire at N=512 (the fused trunk and K3
    alone against the unfused route and plain K3), bench_modalities (audio,
    wavenet, video int8), bench_streaming (--av --av-int8 --av-u8
    --audio-int16), bench_wire_ab (audio, then AV) and
    bench_artifact_overhead (B=8, T=64). Every record parses with a finite,
    positive value; launches a call as the kernels' table says (whole runs
    where the count is exact, one check call otherwise); each timed
    serving program's first output within 1e-4 of its plain route, the
    tripwire's fused trunk bit for bit; the phase's wall seconds;
17c. the JAX package's Orbax checkpoints, read and written by the port
    (avvad_tpu_torch/orbax_io.py; zstd, XXH64 and CRC-32C from the host
    library, no Orbax, TensorStore or zstd package): (a) the committed
    real-Orbax fixture (tests/fixtures/make_orbax_fixtures.py: an AudioVAD
    train state at H=32 that JAX saved) read, every array's SHA-256 as
    Orbax restored it, restored into the port's model, its waveform serving
    step on the persistent K1a (2 launches) against JAX's recorded
    probabilities (1e-4), and the decoder's MB/s over the fixture's zstd
    chunks on this host; (b) the full-width AVVAD (MCB 1024, 2 x LSTM
    1024, ResNet-18 trained) at B=16, T=512: 2 train steps (K1d 2, K1e 2
    a step), export_jax_checkpoint (write s, MB), restore_checkpoint into
    a fresh state (read s): every model tensor and Adam moment bit-equal,
    one more step from the restored and from the live state bit-equal
    (cuDNN deterministic); restore_model of the same checkpoint into the
    static-int8-tower model, calibrated, its B=64, T=512 serving step with
    int8 state (K3 1, K2 8, K1b 2) within 1e-4 of its plain route; a
    VideoVAD checkpoint written the same way and load_pretrained_trunk
    from it into a frozen-trunk AVVAD, the trunk bit-equal. One
    {"orbax": ...} line each;
18. one {"kernels": [...]} line (22 rows), then the card's name and power
    limit and the ok line with the device.
Weights are random, from the port's own seeded init (the Orbax fixture's
were JAX's, written where the fixture was made); nothing of JAX runs.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from avvad_tpu_torch.utils import profiling

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
REPLACES = {"none_persist": "avvad_tpu/ops/lstm_pallas.py:54",
            "none": "avvad_tpu/ops/lstm_pallas.py:54",
            "bf16_persist": "avvad_tpu/ops/lstm_pallas.py:71",
            "bf16": "avvad_tpu/ops/lstm_pallas.py:71",
            "int8_persist": "avvad_tpu/ops/lstm_pallas.py:92",
            "int8": "avvad_tpu/ops/lstm_pallas.py:92"}
# kernel vs plain over T steps (same card, same inputs). none: fp32 in
# another summation order and expf/tanhf vs PyTorch's. bf16 / int8: the
# same, plus the rare h whose fp32 noise crosses a bf16 / int8 rounding
# boundary, which moves one gate term by one LSB of the quantised h. The
# persistent bf16 kernel sums in the tensor cores' fp32 order, held to the
# same 2e-3; the persistent int8 one to 0 (exact int32 sums, the same
# float32 operations as plain and as the per-step kernel)
KERNEL_TOL = {"none": 1e-4, "bf16": 2e-3, "int8": 2e-3}
# the persistent K1a against plain: fp32 in another summation order, held
# ten times tighter at the shapes it is checked at (readings 3e-7 to 5e-7)
PERSIST_TOL = 1e-5
# inside the persistent plan with one batch tile a CTA, H no multiple of 16
RAGGED_PERSIST = (13, 7, 1000)
LSTM_SOURCES = {"none_persist": "avvad_tpu_torch/csrc/lstm_persistent.cu",
                "none": "avvad_tpu_torch/csrc/lstm_recurrence.cu",
                "bf16_persist": "avvad_tpu_torch/csrc/lstm_persistent.cu",
                "bf16": "avvad_tpu_torch/csrc/lstm_recurrence.cu",
                "int8_persist": "avvad_tpu_torch/csrc/lstm_persistent.cu",
                "int8": "avvad_tpu_torch/csrc/lstm_recurrence.cu"}
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
# stages of the serving step between the edges of the program's spans
# (profiling.span), by the marks that bound them
SERVE_MARKS = {"serve.step": ("start", "end"), "tower": ("tower_start", "tower_end"),
               "lstm": ("lstm_start", "lstm_end")}
STAGES = {("start", "tower_start"): "frontend", ("tower_start", "tower_end"): "tower",
          ("tower_end", "lstm_start"): "fusion", ("lstm_start", "lstm_end"): "lstm",
          ("lstm_end", "end"): "head"}
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
# the remat step against the same step without, on the same card with cuDNN
# deterministic: the same operations, recomputed
REMAT_TOL = 1e-5
# stages of the raw-waveform serving step, as STAGES
RAW_SERVE_MARKS = {"serve.step": ("start", "end"), "encoder": ("encoder_start", "encoder_end"),
                   "lstm": ("lstm_start", "lstm_end")}
RAW_SERVE_STAGES = {("start", "encoder_start"): "input", ("encoder_start", "encoder_end"): "encoder",
                    ("lstm_start", "lstm_end"): "lstm", ("lstm_end", "end"): "head"}
# stages of a train step between the edges of the program's spans, by the
# marks that bound them: the backward pass from the start of train.backward
# (zero_grad, then loss.backward) to the optimizer step
TRAIN_MARKS = {"train.step": ("start", "end"), "tower": ("tower_start", "tower_end"),
               "encoder": ("encoder_start", "encoder_end"), "lstm": ("lstm_start", "lstm_end"),
               "train.backward": ("backward_start", None),
               "train.optimizer": ("optimizer_start", "optimizer_end")}
TRAIN_STAGES = {("start", "tower_start"): "inputs", ("tower_start", "tower_end"): "tower",
                ("start", "encoder_start"): "inputs",
                ("encoder_start", "encoder_end"): "encoder_forward",
                ("encoder_end", "lstm_start"): "encoder_to_lstm",
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
# (float tower) and 2.9e-6 (int8 tower). bf16 VideoVAD: the same bf16 kernel
# choice, and no MCB normalisation damps it on the way to the LSTM: 2.4e-3
# (float tower), 6.0e-8 (int8 tower); the fp32 VideoVAD 2.4e-7
SOLO_TOL = {"audio": 1e-5, "av": 5e-4, "video": 1e-2, "video_fp32": 1e-5}
# the pipelined run against the synchronous one: the same operations at the
# same shapes on the same card
PIPE_TOL = 1e-6
BUILD = Path(__file__).resolve().parent / "build"
HDF5_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
# the serving artifacts this run exports (deleted at the end of their phase)
ARTIFACTS = BUILD / "artifacts"
# MCB at "default" (bf16 operands) against "highest" on the serving step's
# probabilities with state_quant "none": the JAX bench measured 2.3e-6 at
# its serving configuration (bench.py:383-384). With "int8" a relative
# change of about 1e-3 in the fused features flips int8 roundings of h, as
# KERNEL_TOL's int8 entry says: 3.4e-4 on an H100 80GB HBM3 (700 W)
MCB_DEFAULT_TOL = 1e-4
# the server phase: blocks a stream may buffer, since every client sends its
# whole stream (TICKS blocks) as fast as the socket takes it
SERVER_BACKLOG = TICKS + 8
# raw-waveform serving, card against CPU on the same bf16 model: bf16
# convolutions and recurrence summed in other orders over 512 steps
RAW_CPU_TOL = 2e-2
# the corpus phase: NTCD-TIMIT's shapes (16 kHz, 2-8 s utterances: 125-500
# frames at 62.5 fps), utterances a split, the reference recipe's batch for
# training and evaluate.py's for evaluation, bucket 128
CORPUS_FS = 16000
CORPUS_SPLITS = {"train": 32, "validation": 16, "test": 64}
CORPUS_SPLIT_DIR = {"train": "train", "validation": "dev", "test": "test"}
CORPUS_SPLIT_CODE = {"train": 0, "validation": 1, "test": 2}
CORPUS_DUR = (2.0, 8.0)
CORPUS_TRAIN_B, CORPUS_EVAL_B, CORPUS_BUCKET = 16, 8, 128
CORPUS_BUILD_WORKERS = 8


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


def lstm_inputs(b: int, t: int, h: int, seed: int) -> tuple:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, 4 * h, generator=g).cuda(),
            (torch.randn(h, 4 * h, generator=g) / h ** 0.5).cuda())


def check_lstm_kernel(lstm_fused, sq: str, shape: tuple, variant: str, tol: float) -> float:
    """One inference layer against its plain version at ``shape``; the launch
    counters must show ``variant`` alone; a persistent launch must repeat
    bit for bit -> max |kernel - plain|."""
    b, t, h = shape
    xp, w = lstm_inputs(b, t, h, seed=1)
    reset_counts()
    y = lstm_fused.lstm_layer_fused(xp, w, state_quant=sq)
    torch.cuda.synchronize()
    counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
    persist = variant.endswith("_persist")
    if counts != {variant: 1 if persist else t}:
        raise RuntimeError(f"{sq} B={b} T={t} H={h}: launch counts {counts}, expected "
                           f"{variant} alone")
    ref = lstm_fused.lstm_layer_plain(xp, w, state_quant=sq)
    err = (y - ref).abs().max().item()
    print(f"{lstm_fused.KERNEL_NAMES[variant]} B={b} T={t} H={h}: max|kernel-plain| "
          f"= {err:.3e} (tol {tol:g}), launches {counts}")
    if not (torch.isfinite(y).all() and err <= tol):
        raise RuntimeError(f"{variant}: kernel disagrees with plain ({err})")
    if persist and not torch.equal(lstm_fused.lstm_layer_fused(xp, w, state_quant=sq), y):
        raise RuntimeError(f"{variant}: two launches differ")
    if variant == "int8_persist":
        with per_step_route(lstm_fused):
            y_step = lstm_fused.lstm_layer_fused(xp, w, state_quant=sq)
        if not torch.equal(y_step, y):
            raise RuntimeError(f"int8_persist B={b} T={t} H={h}: differs from the per-step "
                               f"lstm_int8 by {(y_step - y).abs().max().item()}")
        print(f"lstm_int8_persist B={b} T={t} H={h}: bit for bit equal to the per-step lstm_int8")
    return err


def kernel_phase(lstm_fused):
    """K1a (persistent and per-step), K1b, K1c against their plain versions,
    with times, the cuDNN layer's time and bounds -> kernel rows."""
    persist_shapes = ((B, T, H), RAGGED, RAGGED_PERSIST)
    checks = {"none_persist": ("none", persist_shapes, PERSIST_TOL),
              "bf16_persist": ("bf16", persist_shapes, KERNEL_TOL["bf16"]),
              "int8_persist": ("int8", persist_shapes, 0.0),
              **{sq: (sq, (OUT_OF_PLAN,), KERNEL_TOL[sq]) for sq in lstm_fused.STATE_QUANTS}}
    errs = {variant: [check_lstm_kernel(lstm_fused, sq, shape, variant, tol)
                      for shape in shapes]
            for variant, (sq, shapes, tol) in checks.items()}
    xp, w = lstm_inputs(B, T, H, seed=2)
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x_in = torch.randn(B, T, H, generator=torch.Generator().manual_seed(2)).cuda()
    rows = {}
    for sq in lstm_fused.STATE_QUANTS:
        kernel = lambda: lstm_fused.lstm_layer_fused(xp, w, state_quant=sq)  # noqa: E731
        # per step, persistent, persistent, per step: in turns on one card
        reset_counts()
        with per_step_route(lstm_fused):
            step_ms = [cuda_ms(kernel, 5)]
        persist_ms = [cuda_ms(kernel, 5), cuda_ms(kernel, 5)]
        with per_step_route(lstm_fused):
            step_ms.append(cuda_ms(kernel, 5))
        counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
        if counts != {sq + "_persist": 12, sq: 12 * T}:
            raise RuntimeError(f"{sq}: timed the wrong route: {counts}")
        with per_step_route(lstm_fused):  # the per-step kernel at the main path's shape too
            y_step = kernel()
        errs[sq].append((y_step - lstm_fused.lstm_layer_plain(xp, w, state_quant=sq))
                        .abs().max().item())
        times = {sq + "_persist": persist_ms, sq: step_ms}
        plain_ms = cuda_ms(lambda: lstm_fused.lstm_layer_plain(xp, w, state_quant=sq), 2)
        with torch.inference_mode():
            library_ms = cuda_ms(lambda: lstm(x_in), 5)
        bound_ms, bound_by = bound(B, T, H, sq)
        for variant, reps in times.items():
            print(f"{lstm_fused.KERNEL_NAMES[variant]} B={B} T={T} H={H}: kernel "
                  f"{min(reps):.3f} ms/layer ({1e3 * min(reps) / T:.2f} us/step; reps "
                  f"{[round(r, 3) for r in reps]}), plain {plain_ms:.3f}, cuDNN LSTM layer "
                  f"{library_ms:.3f}, bound {bound_ms:.4f} ms ({bound_by}; {PEAK_NAME[sq]} "
                  f"peak, {MEM_BW / 1e12} TB/s)")
            rows[variant] = {"name": lstm_fused.KERNEL_NAMES[variant], "route": "cuda",
                             "source": LSTM_SOURCES[variant], "replaces": REPLACES[variant],
                             "launches": None, "max_abs_err": max(errs[variant]),
                             "ms": min(reps), "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "library_ms": library_ms}
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


def stem_input(n: int, g: torch.Generator, layout: str, dtype=torch.bfloat16) -> torch.Tensor:
    """Seeded (N, 64, 34, 34) stem conv output on the card, in ``layout``."""
    x = (torch.randn(n, 34, 34, 64, generator=g) * 3).to("cuda", dtype).permute(0, 3, 1, 2)
    return x.contiguous() if layout == "nchw" else x


def int8_kernel_phase(n_frames: int) -> dict:
    """K3 (both routes) and K2 against their plain versions at the main
    path's frame count and a ragged one, with CUDA-event times and bounds ->
    kernel rows."""
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    # K3 on the stem conv's output, (N, 64, 34, 34): channels-last, as the
    # int8 tower's conv writes it (bf16, and fp32), and NCHW, the other
    # route; a of both signs (the channels-last kernel pools on sign-flipped
    # values before it quantises)
    g = torch.Generator().manual_seed(5)
    a = ((torch.rand(64, generator=g) * 20 + 5) * (torch.rand(64, generator=g) - 0.25).sign()).cuda()
    b = (torch.randn(64, generator=g) * 10 + 20).cuda()
    errs = {stem_fused.NHWC_KERNEL_NAME: [], stem_fused.KERNEL_NAME: []}
    for layout, dtype in (("channels_last", torch.bfloat16), ("channels_last", torch.float32),
                          ("nchw", torch.bfloat16)):
        name = stem_fused.KERNEL_NAME if layout == "nchw" else stem_fused.NHWC_KERNEL_NAME
        for n in (n_frames, N_RAGGED):
            x = stem_input(n, g, layout, dtype)
            reset_counts()
            y = stem_fused.stem_epilogue_pool_quant(x, a, b)
            torch.cuda.synchronize()
            if profiling.launches() != {name: 1}:
                raise RuntimeError(f"K3 {layout}: launches {profiling.launches()}")
            errs[name].append(lsb_diff(y, stem_fused.stem_epilogue_plain(x, a, b)))
            print(f"{name} ({layout} {str(dtype)[6:]}) N={n}: max {errs[name][-1][0]} LSB, "
                  f"{errs[name][-1][1]:.2e} of outputs differ")
            if errs[name][-1] != (0, 0.0):  # the same float32 operations: bit for bit
                raise RuntimeError(f"{name} disagrees with plain: {errs[name][-1]}")
            del x, y
    # the NCHW route's launches: one call of the op on NCHW input, the
    # counters at 0 before (no model path gives it NCHW input now)
    x_nchw = stem_input(n_frames, g, "nchw")
    reset_counts()
    stem_fused.stem_epilogue_pool_quant(x_nchw, a, b)
    torch.cuda.synchronize()
    nchw_launches = profiling.launches().get(stem_fused.KERNEL_NAME, 0)
    x_cl = x_nchw.contiguous(memory_format=torch.channels_last)
    # NCHW, channels-last, channels-last, NCHW: in turns on one card
    k3 = lambda x: stem_fused.stem_epilogue_pool_quant(x, a, b)  # noqa: E731
    times = {"nchw": [cuda_ms(lambda: k3(x_nchw), 10)], "cl": []}
    times["cl"] += [cuda_ms(lambda: k3(x_cl), 10), cuda_ms(lambda: k3(x_cl), 10)]
    times["nchw"].append(cuda_ms(lambda: k3(x_nchw), 10))
    plain_ms = {"nchw": cuda_ms(lambda: stem_fused.stem_epilogue_plain(x_nchw, a, b), 2),
                "cl": cuda_ms(lambda: stem_fused.stem_epilogue_plain(x_cl, a, b), 2)}
    # each input read once (bf16) and each int8 output written once; fp32
    # operations: multiply, add, max, round, min per input, 8 maxima per output
    nbytes = x_cl.numel() * 2 + 2 * 64 * 4 + n_frames * 17 * 17 * 64
    ops = 5.0 * x_cl.numel() + 8.0 * n_frames * 17 * 17 * 64
    bound_ms = 1e3 * max(nbytes / MEM_BW, ops / PEAK["none"])
    bound_by = "bytes" if nbytes / MEM_BW >= ops / PEAK["none"] else "operations"
    plan = stem_fused.nhwc_plan(64, 2)
    rows = {}
    for key, route, name in (("k3", "nchw", stem_fused.KERNEL_NAME),
                             ("k3_nhwc", "cl", stem_fused.NHWC_KERNEL_NAME)):
        ms = min(times[route])
        print(f"{name} N={n_frames} (bf16): kernel {ms:.3f} ms (reps "
              f"{[round(t, 3) for t in times[route]]}; {bound_ms / ms:.3f} of the bound), plain "
              f"{plain_ms[route]:.3f}, bound {bound_ms:.4f} ms ({bound_by}; {nbytes / 1e9:.3f} GB "
              f"at {MEM_BW_NAME})" + (f"; plan: {plan['slots']} x {plan['chunk_bytes']} B ring, "
                                     f"{plan['smem_bytes']} B shared a CTA" if route == "cl" else ""))
        rows[key] = {"name": name, "route": "cuda",
                     "source": "avvad_tpu_torch/csrc/stem_epilogue_pool.cu",
                     "replaces": "avvad_tpu/ops/stem_pallas.py:72",
                     "launches": nchw_launches if route == "nchw" else None,
                     "max_abs_err": max(e[0] for e in errs[name]), "ms": ms,
                     "plain_ms": plain_ms[route], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
    del x_nchw, x_cl

    # K2 at the 8 trunk geometries
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops": 0.0, "bytes": 0.0}
    worst, cin = 0, 64
    for i, ((h, stride), cout) in enumerate(zip(conv_fused.TRUNK_GEOM,
                                                conv_fused.TRUNK_WIDTHS)):
        spec = random_block(cin, cout, stride, 30 + i)
        args = conv_fused._block_args(spec)
        # packed once, as the trunk's fold keeps them
        tiles = conv_fused.pack_block_tiles(spec["w1"], spec["w2"], spec.get("wd"))
        for n in (N_RAGGED, n_frames):
            x = torch.randint(0, 128, (n, h, h, cin), generator=g, dtype=torch.int8).cuda()
            y = conv_fused.basic_block_int8(x, *args, stride=stride, tiles=tiles)
            torch.cuda.synchronize()
            ref = conv_fused.basic_block_int8_plain(x, *args, stride=stride)
            lsb, share = lsb_diff(y, ref)
            del ref
            worst = max(worst, lsb)
            if lsb or share:  # exact int32 sums, the same float32 operations
                raise RuntimeError(f"int8_basic_block {h}/{stride} N={n}: {lsb} LSB, {share}")
        ms = cuda_ms(lambda: conv_fused.basic_block_int8(x, *args, stride=stride,
                                                         tiles=tiles), 5)
        plain_ms = cuda_ms(lambda: conv_fused.basic_block_int8_plain(x, *args,
                                                                     stride=stride), 1)
        ops, nbytes = k2_bound(n_frames, h, stride, cin, cout)
        t_ops, t_bytes = ops / PEAK["int8"], nbytes / MEM_BW
        plan = conv_fused.block_plan(h, h, stride, cin, cout, n_frames=n_frames)
        print(f"int8_basic_block {h}x{h}/{stride} {cin}->{cout} N={n_frames}: "
              f"bit-identical to plain (also N={N_RAGGED}); kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f}, bound {1e3 * max(t_ops, t_bytes):.4f} "
              f"ms ({'operations' if t_ops >= t_bytes else 'bytes'}), "
              f"{ops / ms / 1e9:.1f} TOP/s = {ops / (ms * 1e-3) / PEAK['int8']:.3f} of the "
              f"int8 peak, {ms * 1e6 / (ops / 2 / 1e6):.3f} ns a M MAC; plan: "
              f"{plan['frames']} frames = {plan['rows']} rows a CTA, {plan['m_tiles']} m64 "
              f"tiles in {plan['passes']} passes, {plan['n_tiles']} n{plan['n_tile']} tiles, "
              f"ring {plan['stages']} x {plan['chunk_bytes']} B, {plan['smem_bytes']} B "
              f"shared")
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


# the float trunk's BatchNorm sites at the AV training step, in order: (stage,
# C, side of H x W, forms); a form is a bn_relu call: "pool" one BatchNorm and
# the stem's 3x3/2 max pool, "relu" one BatchNorm, "identity" one plus the
# block's input, "downsample" two (bn2 and the shortcut's) and their sum
BN_SITES = (("stem", 64, 34, ("pool",)),
            ("layer1", 64, 17, ("relu", "identity") * 2),
            *((f"layer{i}", c, h, ("relu", "downsample", "relu", "identity"))
              for i, c, h in ((2, 128, 9), (3, 256, 5), (4, 512, 3))))


def bn_kernel_phase(n_frames: int = TRAIN_B * T) -> dict:
    """K4 (``bn_stats`` + ``bn_apply``) at the AV training step's 20
    train-mode BatchNorms: launches, each site against the plain version
    (``batch_norm`` with its ReLU and add, at the stem its max pool),
    CUDA-event times of the kernels, the plain version and
    ``F.batch_norm(training=True)`` (cuDNN, a yardstick only; the same ReLU,
    add and pool) summed over the step, and the byte bound -> kernel row."""
    import torch.nn.functional as F

    from avvad_tpu_torch.models.resnet import batch_norm
    from avvad_tpu_torch.ops import bn_fused

    g = torch.Generator(device="cuda").manual_seed(21)

    def new_bn(c):
        bn = torch.nn.BatchNorm2d(c).cuda().train().requires_grad_(False)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(generator=g)
        return bn

    def run(kind, form, bn, sc_bn, x, s):
        sc = s if form in ("identity", "downsample") else None
        ds = sc_bn if form == "downsample" else None
        if kind == "kernel":
            return bn_fused.bn_relu(bn, x, sc, ds, pool=form == "pool")
        if kind == "plain":
            norm = batch_norm
        else:
            norm = lambda m, t: F.batch_norm(t, m.running_mean, m.running_var,  # noqa: E731
                                             m.weight, m.bias, True, m.momentum, m.eps)
        y = norm(bn, x)
        if sc is not None:
            y = y + (sc if ds is None else norm(ds, sc))
        y = F.relu(y)
        return F.max_pool2d(y, 3, stride=2, padding=1) if form == "pool" else y

    tot = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
    nbytes, worst, launches = 0, 0.0, {}
    for stage, c, h, forms in BN_SITES:
        x = torch.randn(n_frames, c, h, h, generator=g, device="cuda") * 2 + 0.5
        s = torch.randn(n_frames, c, h, h, generator=g, device="cuda")
        bn, sc_bn = new_bn(c), new_bn(c)
        for form in set(forms):
            y = run("kernel", form, bn, sc_bn, x, s)
            ref = run("plain", form, copy.deepcopy(bn), copy.deepcopy(sc_bn), x, s)
            err = ((y - ref).abs().max() / ref.abs().max()).item()
            worst = max(worst, err)
            if not err < 1e-5:  # the statistics in another summation order
                raise RuntimeError(f"K4 {stage} {form}: {err:.2e} off plain")
            del y, ref
        step = {kind: (lambda kind=kind: [run(kind, f, bn, sc_bn, x, s) for f in forms])
                for kind in tot}
        reset_counts()
        step["kernel"]()
        torch.cuda.synchronize()
        for k, v in profiling.launches().items():
            launches[k] = launches.get(k, 0) + v
        # kernel, plain, library, kernel: in turns on one card
        ms = {"kernel": [cuda_ms(step["kernel"], 5)], "plain": [cuda_ms(step["plain"], 2)],
              "library": [cuda_ms(step["library"], 5)]}
        ms["kernel"].append(cuda_ms(step["kernel"], 5))
        # stats read x (and the shortcut's input), apply reads x and the
        # shortcut and writes the output (pooled: a quarter), each once
        site_bytes = sum({"pool": 2.25, "relu": 3, "identity": 4, "downsample": 5}[f]
                         for f in forms)
        nbytes += int(site_bytes * x.numel() * 4)
        print(f"bn_stats + bn_apply {stage} ({n_frames}, {c}, {h}, {h}) x {len(forms)} sites: "
              f"kernel {min(ms['kernel']):.3f} ms (reps {[round(t, 3) for t in ms['kernel']]}), "
              f"plain {ms['plain'][0]:.3f}, F.batch_norm {ms['library'][0]:.3f}, bound "
              f"{1e3 * site_bytes * x.numel() * 4 / MEM_BW:.4f} ms")
        for kind in tot:
            tot[kind] += min(ms[kind])
        del x, s, step
        torch.cuda.empty_cache()
    if launches != {bn_fused.STATS_KERNEL: 20, bn_fused.APPLY_KERNEL: 17}:
        raise RuntimeError(f"K4: launches a step {launches}")
    bound_ms = 1e3 * nbytes / MEM_BW
    print(f"K4 bn_stats + bn_apply, 20 BatchNorms at N={n_frames}: kernel {tot['kernel']:.3f} "
          f"ms ({bound_ms / tot['kernel']:.3f} of the bound), plain {tot['plain']:.3f}, "
          f"F.batch_norm {tot['library']:.3f}, bound {bound_ms:.4f} ms (bytes; "
          f"{nbytes / 1e9:.3f} GB at {MEM_BW_NAME}); launches {launches}; worst "
          f"{worst:.2e} of the output's max off plain")
    return {"k4": {"name": "bn_stats + bn_apply", "route": "cuda",
                   "source": "avvad_tpu_torch/csrc/batch_norm.cu",
                   "replaces": "none (XLA fuses BatchNorm)", "launches": 0,
                   "max_abs_err": worst, "ms": tot["kernel"], "plain_ms": tot["plain"],
                   "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": tot["library"]}}


def _mark(marks: list, name: str = "") -> None:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append((name, ev))


def spanned_step(fn, *args) -> tuple[float, list]:
    """One call ``fn(*args)`` with the program's recorder on -> (host seconds
    to the end of its device work, the span records of its step)."""
    profiling.enable()
    try:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        profiling.disable()
    recs = profiling.records()
    return dt, [r for r in recs if r["step"] == recs[-1]["step"]]


def span_stages(recs: list, marks: dict, stages: dict) -> dict:
    """{stage: device ms} of one step's span records: the edges that
    ``marks`` names (span -> marks at its start and end), in the order the
    program reached them, paired as ``stages`` names them."""
    edges = []
    for r in recs:
        a, b = marks.get(r["name"], (None, None))
        if a and all(e[1] != a for e in edges):
            edges.append((r["host_start_ns"], a, r["device_start_ms"]))
        if b and all(e[1] != b for e in edges):
            edges.append((r["host_end_ns"], b, r["device_end_ms"]))
    edges.sort()
    return {stages[(a, b)]: tb - ta for (_, a, ta), (_, b, tb) in zip(edges, edges[1:])
            if (a, b) in stages}


def timed_step(fn, *args) -> tuple[float, dict]:
    """One serving step -> (host seconds to the end of its device work,
    {stage: device ms}): the STAGES frontend (and input normalisation),
    tower, fusion (gather, MCB, signed sqrt, L2, BatchNorm), LSTM, head
    (Dense, sigmoid), between the edges of the program's spans."""
    dt, recs = spanned_step(fn, *args)
    return dt, span_stages(recs, SERVE_MARKS, STAGES)


# kernels of the int8 tower's stem by name in a profile (lower case): the
# cuDNN convolution, cuDNN's layout transforms, the epilogue (K3)
STEM_KERNELS = {"conv": ("fprop", "convolve", "implicit", "conv2d"),
                "transposes": ("nchwtonhwc", "nhwctonchw", "transpose", "padding"),
                "k3": ("stem_epilogue_pool",)}


def stem_split(events) -> dict:
    """Device ms of the profiled step's stem kernels, by STEM_KERNELS."""
    split = {k: 0.0 for k in STEM_KERNELS}
    for e in events:
        name = e.key.lower()
        kind = ("k3" if "stem_epilogue_pool" in name else
                next((k for k in ("transposes", "conv") if any(w in name for w in STEM_KERNELS[k])),
                     None))
        if kind and "int8_basic_block" not in name:
            split[kind] += e.self_device_time_total / 1e3
    return split


def device_ops(prof) -> list:
    """The profile's device operations by name (``key_averages``): device
    entries only, since a CPU op's self device time repeats its kernels',
    and without the device mirrors of the program's spans (user
    annotations), which cover kernels counted already."""
    spans = {e.name for e in prof.events() if e.is_user_annotation}
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0 and e.key not in spans]


def profile_step(fn, *args) -> dict:
    """One step fn(*args) under torch.profiler -> device busy time, idle
    share, the kernels with the most device time and the stem's split."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = sorted(device_ops(prof), key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "stem_split_ms": stem_split(events),
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


def time_step(fn, wave, video, label: str, tail: str) -> dict:
    """Best of 3 timed steps with the stage split, then one profiled step:
    one line of times and one {"profile": ...} line -> the profile."""
    torch.cuda.reset_peak_memory_stats()
    reps = [timed_step(fn, wave, video) for _ in range(3)]
    step, stage_ms = min(reps, key=lambda r: r[0])
    print(f"serving {label}: {1e3 * step:.2f} ms/step (reps "
          f"{[round(1e3 * s, 2) for s, _ in reps]}), {B * T / FRAME_RATE / step:.1f}x "
          f"real time, {tail}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    prof = profile_step(fn, wave, video)
    print(json.dumps({"profile": label, "stage_ms": stage_ms, **prof}))
    return prof


def serving_launches(sq: str) -> dict:
    """LSTM launches of one serving step (two layers): the persistent K1a,
    K1c or K1b once a layer."""
    return {sq + "_persist": 2}


def main_path(lstm_fused, rows):
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD

    wave, video, idx = serving_inputs()
    model = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=1024, dtype=torch.bfloat16,
                  use_kernel_lstm=True, seed=0)
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx)
    print(f"main path: AVVAD bf16, LSTM 2x{H}, MCB 1024, ResNet-18 float, "
          f"B={B} T={T} n={N_SAMPLES} t_src={video.shape[1]} (30 fps unique frames)")
    for sq in lstm_fused.STATE_QUANTS:
        model.set_lstm_state_quant(sq)
        reset_counts()
        probs = fn(wave, video)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {**dict.fromkeys(counts, 0), **serving_launches(sq)}
        if counts != expect:
            raise RuntimeError(f"{sq}: launch counts {counts}, expected {expect}")
        variant = next(iter(serving_launches(sq)))
        rows[variant]["launches"] = counts[variant]
        check_probs(probs, sq)
        with plain_inference(lstm_fused):
            ref = fn(wave, video)
        err = (probs - ref).abs().max().item()
        if err > PROB_TOL:
            raise RuntimeError(f"{sq}: serving step vs plain LSTM {err}")
        time_step(fn, wave, video, sq, f"launches {counts[variant]} {variant}, "
                  f"max|probs-plain| {err:.2e} (tol {PROB_TOL:g})")
    return model


def int8_path(rows):
    """The static-int8 tower on the fused kernels: K3 -> 8 x K2 -> LSTM."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD, ResNet18, calibrate
    from avvad_tpu_torch.ops import conv_fused, stem_fused

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
        reset_counts()
        probs = fn(wave, video)
        torch.cuda.synchronize()
        counts = launch_counts()
        # the stem conv writes channels-last: the channels-last K3, once
        expect = {**dict.fromkeys(counts, 0), **serving_launches(sq),
                  conv_fused.KERNEL_NAME: 8, stem_fused.NHWC_KERNEL_NAME: 1}
        if counts != expect:
            raise RuntimeError(f"int8 tower {sq}: launch counts {counts}, "
                               f"expected {expect}")
        rows["k2"]["launches"] = counts[conv_fused.KERNEL_NAME]
        rows["k3_nhwc"]["launches"] = counts[stem_fused.NHWC_KERNEL_NAME]
        check_probs(probs, f"int8 tower {sq}")
        with plain_k2_k3():
            ref = fn(wave, video)
        err = (probs - ref).abs().max().item()
        if err > INT8_PROB_TOL:
            raise RuntimeError(f"int8 tower {sq}: step vs plain K2/K3 {err}")
        prof = time_step(fn, wave, video, f"int8_tower/{sq}",
                         f"launches {counts}, max|probs-plain K2/K3| {err:.2e} "
                         f"(tol {INT8_PROB_TOL:g})")
        split = prof["stem_split_ms"]
        print(f"int8_tower/{sq} stem in the profiled step: conv {split['conv']:.3f} ms, "
              f"transposes {split['transposes']:.3f} ms, K3 {split['k3']:.3f} ms")
    stem_routes(trunk, video)
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


def stem_routes(trunk, video) -> None:
    """The stem of the int8 tower on the serving step's frames (64 x 246),
    each route timed alone by CUDA events, in turns: the conv writing
    channels-last and the channels-last K3 (the served route), against the
    NCHW conv and the NCHW K3; and one profiled pass of each conv for its
    layout transforms."""
    from torch.profiler import ProfilerActivity, profile

    from avvad_tpu_torch.ops import stem_fused

    frames = video.reshape(-1, 1, 67, 67)
    a, b, _ = trunk.folded()
    with torch.inference_mode():
        conv = {"cl": lambda: trunk.conv1(frames, channels_last=True),
                "nchw": lambda: trunk.conv1(frames)}
        stems = {k: f() for k, f in conv.items()}
        if not stems["cl"].is_contiguous(memory_format=torch.channels_last) or \
                not stems["nchw"].is_contiguous():
            raise RuntimeError("stem conv: unexpected output layouts")
        ms = {k: [] for k in ("conv_cl", "k3_cl", "conv_nchw", "k3_nchw")}
        for order in (("cl", "nchw"), ("nchw", "cl")):
            for route in order:
                ms["conv_" + route].append(cuda_ms(conv[route], 3))
                ms["k3_" + route].append(cuda_ms(
                    lambda: stem_fused.stem_epilogue_pool_quant(stems[route], a, b), 5))
        transforms, kernels = {}, {}
        for route, f in conv.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                f()
                torch.cuda.synchronize()
            events = device_ops(prof)
            transforms[route] = stem_split(events)
            kernels[route] = [[e.key[:90], e.self_device_time_total / 1e3] for e in events]
    best = {k: min(v) for k, v in ms.items()}
    print(f"int8 stem on {frames.shape[0]} frames, alone: channels-last route conv "
          f"{best['conv_cl']:.3f} ms + K3 {best['k3_cl']:.3f} ms; NCHW route conv "
          f"{best['conv_nchw']:.3f} ms + K3 {best['k3_nchw']:.3f} ms (reps "
          f"{ {k: [round(t, 3) for t in v] for k, v in ms.items()} })")
    print(json.dumps({"stem_routes_ms": best, "profiled_conv_split_ms": transforms,
                      "profiled_conv_kernels": kernels}))


def host_ms(fn, *args) -> float:
    """Host ms of fn(*args) to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def expect_launches(counts: dict, expect: dict, label: str) -> None:
    """The launch counters equal ``expect``, every other one 0."""
    want = {**dict.fromkeys(counts, 0), **expect}
    if counts != want:
        raise RuntimeError(f"{label}: launch counts {counts}, expected {want}")


def serving_artifact(fn, wave, video, sq: str, rows) -> None:
    """The serving step exported, saved, loaded and replayed: export s,
    .pt2 MB, load s, the replay's launches (K1 2, K3 1, K2 8, nothing
    else), the replay against the live step bit for bit, and both timed in
    turns (live, replay, replay, live; best of each)."""
    from avvad_tpu_torch.export import ServingArtifact
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    label = f"artifact/int8_tower/{sq}"
    live = fn(wave, video)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    art = ServingArtifact.build({"b64": (fn, (wave, video))},
                                meta={"modality": "av", "lstm_state_quant": sq})
    export_s = time.perf_counter() - t0
    path = ARTIFACTS / f"serving_{sq}.avvadx"
    art.save(str(path))
    blob_mb = zipfile.ZipFile(path).getinfo("b64.pt2").file_size / 2**20
    t0 = time.perf_counter()
    loaded = ServingArtifact.load(str(path))
    load_s = time.perf_counter() - t0
    if set(loaded.meta["custom_ops"]["b64"]) != {
            f"avvad_tpu_torch.{op}.default"
            for op in ("lstm_infer", "int8_basic_block", "stem_epilogue_pool_quant")}:
        raise RuntimeError(f"{label}: custom ops {loaded.meta['custom_ops']}")
    loaded.call("b64", wave, video)  # the first call unlifts the program
    reset_counts()
    got = loaded.call("b64", wave, video)
    torch.cuda.synchronize()
    counts = launch_counts()
    variant = next(iter(serving_launches(sq)))
    expect_launches(counts, {**serving_launches(sq), conv_fused.KERNEL_NAME: 8,
                             stem_fused.NHWC_KERNEL_NAME: 1}, label)
    rows[variant]["launches"] = counts[variant]
    rows["k2"]["launches"] = counts[conv_fused.KERNEL_NAME]
    rows["k3_nhwc"]["launches"] = counts[stem_fused.NHWC_KERNEL_NAME]
    check_probs(got, label)
    diff = (got - live).abs().max().item()
    if not torch.equal(got, live):
        raise RuntimeError(f"{label}: the replay differs from the live step by {diff}")
    ms = {"live": [], "replay": []}
    for route in ("live", "replay", "replay", "live"):
        step = fn if route == "live" else (lambda w, v: loaded.call("b64", w, v))
        ms[route] += [host_ms(step, wave, video) for _ in range(2)]
    out = {"artifact": label, "export_s": export_s, "pt2_mb": blob_mb, "load_s": load_s,
           "launches": {k: v for k, v in counts.items() if v},
           "replay_equals_live": True, "live_ms_best": min(ms["live"]),
           "replay_ms_best": min(ms["replay"]), "ms": ms,
           "custom_ops": loaded.meta["custom_ops"]["b64"],
           "torch_version": loaded.meta["torch_version"]}
    print(f"{label}: export {export_s:.1f} s, .pt2 {blob_mb:.1f} MB, load {load_s:.1f} s; "
          f"replay launches {out['launches']}, bit-equal to the live step; live "
          f"{out['live_ms_best']:.2f} ms/step, replay {out['replay_ms_best']:.2f}")
    print(json.dumps(out))


def server_artifact(int8_model) -> None:
    """The AV server on the static-int8 tower (span int16 hop_dft, 30 fps
    uint8) exported and rebuilt by load_multistream_server: TICKS ticks of
    the streaming data fed to both, the rebuilt server's launches each
    tick (K3 1, K2 8, nothing else), every stream against the live
    server's, and the tick ms of both (the order alternating by tick)."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.export import export_multistream_server, load_multistream_server
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    label = "artifact/av_server/int8_tower"
    pcm, video, _ = stream_data()
    live = serve.MultiStreamAVVAD(int8_model, STREAMS, block_frames=BLOCK, video_fps=30.0,
                                  video_uint8=True, span_wire=True, hop_dft=True,
                                  audio_int16=True)
    path = ARTIFACTS / "av_server.avvadx"
    t0 = time.perf_counter()
    export_multistream_server(live, str(path))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_multistream_server(str(path))
    load_s = time.perf_counter() - t0
    loaded.warmup()
    live.warmup()
    ms = {"live": [], "loaded": []}
    worst = 0.0
    for k in range(TICKS):
        for srv in (live, loaded):
            feed_tick(srv, pcm[k], video[k], False)
        out = {}
        for route in (("live", "loaded") if k % 2 else ("loaded", "live")):
            srv = loaded if route == "loaded" else live
            reset_counts()
            t0 = time.perf_counter()
            out[route] = srv.tick()
            ms[route].append(1e3 * (time.perf_counter() - t0))
            if route == "loaded":
                expect_launches(launch_counts(), {conv_fused.KERNEL_NAME: 8,
                                                  stem_fused.NHWC_KERNEL_NAME: 1},
                                f"{label} tick {k}")
        check_tick(out["loaded"], f"{label} tick {k}")
        worst = max(worst, max(float(np.abs(out["loaded"][i] - out["live"][i]).max())
                               for i in range(STREAMS)))
    if worst > PIPE_TOL:
        raise RuntimeError(f"{label}: the rebuilt server differs from the live one by {worst}")
    summary = {"artifact": label, "export_s": export_s, "load_s": load_s,
               "pt2_mb": zipfile.ZipFile(path).getinfo("tick.pt2").file_size / 2**20,
               "ticks": TICKS, "k2_launches_per_tick": 8, "k3_launches_per_tick": 1,
               "max_abs_diff_vs_live": worst,
               **{f"{r}_tick_ms_{f.__name__}": float(f(v)) for r, v in ms.items()
                  for f in (np.min, np.median)}}
    print(f"{label}: rebuilt in {load_s:.1f} s (export {export_s:.1f} s); {TICKS} ticks, "
          f"K3 1 and K2 8 a tick, every stream within {worst:.2e} of the live server "
          f"(tol {PIPE_TOL:g}); tick ms best / median: rebuilt "
          f"{summary['loaded_tick_ms_min']:.2f} / {summary['loaded_tick_ms_median']:.2f}, "
          f"live {summary['live_tick_ms_min']:.2f} / {summary['live_tick_ms_median']:.2f}")
    print(json.dumps(summary))


def int8_stem_phase(int8_model, wave, video, idx) -> None:
    """The int8 stem at the serving shape: a copy of the int8-tower model
    with ``tower_stem_int8`` calibrated as int8_path calibrates; its stem's
    card route (fp32 conv, rounded) bit for bit against the float64 route
    on every frame of the step, then K3 on its output and the 8 K2 after it
    against their plain versions (bit for bit); the stem alone against the
    bf16 float stem in turns; the serving step with its stage split."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD, calibrate
    from avvad_tpu_torch.models.resnet import act_quant
    from avvad_tpu_torch.ops import conv_fused, stem_fused
    from avvad_tpu_torch.ops.conv_fused import conv_exact

    model = AVVAD(y_dim=1, lstm_hidden_size=H, lstm_layers=2, use_mcb=True,
                  mcb_output_size=1024, dtype=torch.bfloat16, use_kernel_lstm=True,
                  lstm_state_quant="int8", tower_int8=True, tower_quant_mode="static",
                  tower_pallas=True, tower_stem_int8=True, seed=0).cuda()
    model.load_state_dict(int8_model.state_dict(), strict=False)  # q_in is new
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.split(".")[-1] in ("q_in", "q_stem", "q1", "q_out"):
                buf.zero_()
    calibrate(model, [(torch.zeros(2, T, 513, device="cuda"), video[:2])],
              video_frame_indices=torch.as_tensor(idx, device="cuda"))
    trunk = model.tower.features
    frames = video.reshape(-1, 1, 67, 67)
    with torch.inference_mode():
        x_q, x_s = act_quant(frames, trunk.q_in, "static")
        stem = trunk.conv1.forward_int8(x_q, x_s, channels_last=True)
        if not stem.is_contiguous(memory_format=torch.channels_last):
            raise RuntimeError("int8 stem: the card route's output is not channels-last")
        k = trunk.conv1.weight.sum(dim=1, keepdim=True)
        w_q, w_s = conv_fused.quant_hwio(k)
        flips = 0
        for i in range(0, frames.shape[0], 2048):
            ref = conv_exact(x_q[i:i + 2048], w_q.permute(3, 2, 0, 1), 2, 3) * \
                (x_s * w_s).view(1, -1, 1, 1)
            flips += int((stem[i:i + 2048] != ref).sum())
        if flips:
            raise RuntimeError(f"int8 stem: {flips} outputs differ from the float64 route")
        a, b, specs = trunk.folded()
        reset_counts()
        pooled = stem_fused.stem_epilogue_pool_quant(stem, a, b)
        feats = conv_fused.trunk_features_int8(pooled, specs)
        torch.cuda.synchronize()
        expect_launches(launch_counts(), {conv_fused.KERNEL_NAME: 8,
                                          stem_fused.NHWC_KERNEL_NAME: 1}, "int8 stem chain")
        with plain_k2_k3():
            pooled_ref = stem_fused.stem_epilogue_plain(stem, a, b)
            feats_ref = conv_fused.trunk_features_int8(pooled_ref, specs)
        if not (torch.equal(pooled, pooled_ref) and torch.equal(feats, feats_ref)):
            raise RuntimeError("int8 stem: K3 / K2 differ from their plain versions")
        float_stem = int8_model.tower.features
        ms = {"int8_stem": [], "bf16_stem": []}
        for order in (("int8_stem", "bf16_stem"), ("bf16_stem", "int8_stem")):
            for route in order:
                t = trunk if route == "int8_stem" else float_stem
                ms[route].append(cuda_ms(lambda: t._stem(frames, channels_last=True), 3))
    print(f"int8 stem on {frames.shape[0]} frames: the card route equals the float64 route "
          f"on all {stem.numel()} outputs; K3 and the 8 K2 on its output equal their plain "
          f"versions; stem conv alone: int8 {min(ms['int8_stem']):.3f} ms (quantise, fp32 "
          f"conv, round, dequantise), bf16 float {min(ms['bf16_stem']):.3f} ms")
    print(json.dumps({"int8_stem_ms": {k: min(v) for k, v in ms.items()}, "reps": ms,
                      "q_in": trunk.q_in.item(), "bit_exact_outputs": stem.numel()}))
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx)
    reset_counts()
    probs = fn(wave, video)
    torch.cuda.synchronize()
    expect_launches(launch_counts(), {**serving_launches("int8"), conv_fused.KERNEL_NAME: 8,
                                      stem_fused.NHWC_KERNEL_NAME: 1}, "int8 stem step")
    check_probs(probs, "int8 stem step")
    prof = time_step(fn, wave, video, "int8_tower_stem_int8/int8",
                     "the int8 stem, K3 + 8 x K2, K1b x 2")
    split = prof["stem_split_ms"]
    print(f"int8_tower_stem_int8/int8 stem in the profiled step: conv {split['conv']:.3f} ms, "
          f"transposes {split['transposes']:.3f} ms, K3 {split['k3']:.3f} ms")
    del model, fn


def mcb_precision_phase(int8_model, wave, video, idx) -> None:
    """MCB at "default" (bf16 operands, fp32 sums) against "highest" on the
    int8-tower serving step: with state_quant "none", the JAX bench's
    configuration (bench.py:412), probabilities within MCB_DEFAULT_TOL;
    with "int8" the difference is printed, not held (the int8 state's
    rounding flips amplify it); both timed with their stage split, in turns."""
    from avvad_tpu_torch.export import make_waveform_serving_fn

    fn = make_waveform_serving_fn(int8_model, t_frames=T, video_frame_indices=idx)
    mcb = int8_model.mcb
    err = {}
    try:
        for sq in INT8_STATE_QUANTS:
            int8_model.set_lstm_state_quant(sq)
            probs = {}
            for prec in ("highest", "default", "default", "highest"):
                mcb.precision = prec
                probs[prec] = fn(wave, video)
                check_probs(probs[prec], f"mcb {prec}")
                time_step(fn, wave, video, f"int8_tower/{sq}/mcb_{prec}",
                          f"MCB precision {prec}")
            err[sq] = (probs["default"] - probs["highest"]).abs().max().item()
    finally:
        mcb.precision = "highest"
    print(f"MCB precision default against highest on the int8-tower step: max |probs diff| "
          f"{err['none']:.2e} with state_quant none (tol {MCB_DEFAULT_TOL:g}), "
          f"{err['int8']:.2e} with int8 (not held)")
    print(json.dumps({"mcb_default_vs_highest_max_abs_diff": err}))
    if err["none"] > MCB_DEFAULT_TOL:
        raise RuntimeError(f"mcb default against highest: {err['none']}")


def artifact_phase(int8_model, rows) -> None:
    """The serving artifacts and the serving options."""
    from avvad_tpu_torch.export import make_waveform_serving_fn

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    wave, video, idx = serving_inputs()
    fn = make_waveform_serving_fn(int8_model, t_frames=T, video_frame_indices=idx)
    for sq in INT8_STATE_QUANTS:
        int8_model.set_lstm_state_quant(sq)
        serving_artifact(fn, wave, video, sq, rows)
    torch.cuda.empty_cache()
    server_artifact(int8_model)
    torch.cuda.empty_cache()
    int8_stem_phase(int8_model, wave, video, idx)
    torch.cuda.empty_cache()
    mcb_precision_phase(int8_model, wave, video, idx)
    for path in ARTIFACTS.glob("*.avvadx"):
        path.unlink()


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| over the largest |ref|."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def launch_counts() -> dict:
    """{LSTM variant or kernel name: launches} since ``reset_counts``, from
    the program's counters."""
    from avvad_tpu_torch.ops import bn_fused, conv_fused, lstm_fused, stem_fused

    done = profiling.launches()
    return {**lstm_fused.launch_counts(),
            **{k: done.get(k, 0) for k in (conv_fused.KERNEL_NAME, stem_fused.KERNEL_NAME,
                                            stem_fused.NHWC_KERNEL_NAME,
                                            bn_fused.STATS_KERNEL, bn_fused.APPLY_KERNEL)}}


def k4_launches(steps: int = 1) -> dict:
    """K4's launches in ``steps`` AV train steps on the frozen fp32 trunk
    outside a data group: 20 statistics (one a BatchNorm) and 17 apply (one
    a normalisation site) a step."""
    from avvad_tpu_torch.ops import bn_fused

    return {bn_fused.STATS_KERNEL: 20 * steps, bn_fused.APPLY_KERNEL: 17 * steps}


def reset_counts() -> None:
    profiling.reset()


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
def plain_inference(lstm_fused):
    """The models' LSTM layers with the plain inference recurrence."""
    import avvad_tpu_torch.models.lstm as lstm_mod

    lstm_mod.lstm_layer_fused = lstm_fused.lstm_layer_plain
    try:
        yield
    finally:
        lstm_mod.lstm_layer_fused = lstm_fused.lstm_layer_fused


@contextlib.contextmanager
def plain_k2_k3():
    """The int8 tower's K2 and K3 replaced by their plain versions."""
    import avvad_tpu_torch.models.resnet as resnet_mod
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    block_kernel = conv_fused.basic_block_int8
    resnet_mod.stem_epilogue_pool_quant = stem_fused.stem_epilogue_plain
    conv_fused.basic_block_int8 = conv_fused.basic_block_int8_plain
    try:
        yield
    finally:
        resnet_mod.stem_epilogue_pool_quant = stem_fused.stem_epilogue_pool_quant
        conv_fused.basic_block_int8 = block_kernel


@contextlib.contextmanager
def per_step_route(lstm_fused):
    """The wrappers with the persistent plan refused: the per-step K1a /
    K1d / K1e at a shape the plan would take, to time both on the same
    inputs."""
    saved = lstm_fused.persistent_plan
    lstm_fused.persistent_plan = lambda *_a, **_k: None
    try:
        yield
    finally:
        lstm_fused.persistent_plan = saved


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
        reset_counts()
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
        counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
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
        reset_counts()
        with per_step_route(lstm_fused):
            step_ms = [cuda_ms(kernel, 5)]
        persist_ms = [cuda_ms(kernel, 5), cuda_ms(kernel, 5)]
        with per_step_route(lstm_fused):
            step_ms.append(cuda_ms(kernel, 5))
        if lstm_fused.launch_counts()[kind + "_persist"] != 12 or not lstm_fused.launch_counts()[kind]:
            raise RuntimeError(f"{kind}: timed the wrong route: {lstm_fused.launch_counts()}")
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


def train_batch(t: int, b: int, modality: str, seed: int):
    """A seeded batch on the card (as a prefetcher leaves it): ragged
    lengths in [t/2, t] (the first full), random labels on valid frames;
    log-power frames unless the modality is "video", lip frames unless it
    is "audio"."""
    from avvad_tpu_torch.data import Batch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(t // 2, t + 1, size=b)
    lengths[0] = t
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    label = (rng.random((b, t, 1)) > 0.5).astype(np.float32) * mask[..., None]
    cuda = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    audio = rng.standard_normal((b, t, 513), np.float32)
    video = rng.standard_normal((b, t, 67, 67), np.float32) if modality != "audio" else None
    return Batch(audio=cuda(audio) if modality != "video" else None,
                 video=cuda(video) if video is not None else None,
                 label=cuda(label), lengths=lengths, mask=cuda(mask))


def timed_train_step(step, state, batch) -> tuple[float, dict]:
    """One train step -> (host seconds to the end of its device work,
    {stage: device ms}) between the edges of the program's spans
    (TRAIN_STAGES)."""
    dt, recs = spanned_step(step, state, batch)
    return dt, span_stages(recs, TRAIN_MARKS, TRAIN_STAGES)


def train_path(rows: dict, modality: str, h: int = H, b: int = TRAIN_B, t: int = T,
               frozen: bool = True):
    """One train step (at full width by default) with launch counters and
    the plain recurrence's step as reference, then 3 timed steps and a
    profiled one -> the train state. At H=1024 the recurrence goes through
    the persistent K1d / K1e, one launch a layer; at an ``h`` outside
    their plan through the per-step ones. "video" trains VideoVAD's
    ResNet-18 from scratch, "av" with ``frozen=False`` AVVAD's; the two
    compared steps then run cuDNN's deterministic algorithms, so that the
    trunk's weight gradients sum in one order in both."""
    from avvad_tpu_torch.models import AVVAD, AudioVAD, VideoVAD
    from avvad_tpu_torch.ops import lstm_fused
    from avvad_tpu_torch.train import (create_train_state, make_predict_step,
                                       make_train_step)

    av = modality == "av"
    if av:
        model = AVVAD(lstm_hidden_size=h, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                      use_kernel_lstm=True, seed=0)
    elif modality == "video":
        model = VideoVAD(lstm_hidden_size=h, lstm_layers=2, use_kernel_lstm=True, seed=0)
    else:
        model = AudioVAD(lstm_hidden_size=h, lstm_layers=2, use_kernel_lstm=True, seed=0)
    freeze = av and frozen
    trunk_trains = modality == "video" or (av and not frozen)
    label = modality + ("/unfrozen" if av and not frozen else "")
    reference = copy.deepcopy(model)
    state = create_train_state(model, learning_rate=1e-4, freeze_video_trunk=freeze)
    step = make_train_step(modality)
    batch = train_batch(t, b, modality, seed=8)
    persist = lstm_fused.persistent_plan(
        b, h, torch.cuda.get_device_properties(0).multi_processor_count) is not None
    fwd, bwd = ("fwd_train_persist", "bwd_persist") if persist else ("fwd_train", "bwd")
    trunk = {"av": ", MCB 1024, ResNet-18 " + ("frozen (train-mode BatchNorm)" if frozen
                                                 else "trained"),
             "video": ", ResNet-18 trained from scratch", "audio": ""}[modality]
    print(f"train path {label}: {type(model).__name__} fp32, LSTM 2x{h}{trunk}, "
          f"Adam 1e-4, B={b} T={t} ({b * t} frames), lengths {batch.lengths.tolist()}; "
          f"the plan {'takes' if persist else 'refuses'} H={h}")
    torch.backends.cudnn.deterministic = trunk_trains
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    first_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts()
    expect = {k: 0 for k in counts}
    expect.update({fwd: 2, bwd: 2} if persist else {fwd: 2 * t, bwd: 2 * (t + 1)})
    if freeze:  # the frozen trunk's BatchNorms on K4; a trained one on autograd
        expect.update(k4_launches())
    if counts != expect:
        raise RuntimeError(f"train {label}: launch counts {counts}, expected {expect}")
    if av or not persist:
        rows[fwd]["launches"] = counts[fwd]
        rows[bwd]["launches"] = counts[bwd]
    if freeze:
        rows["k4"]["launches"] = sum(counts[k] for k in k4_launches())
    m = {k: v.item() for k, v in metrics.items()}
    if not (np.isfinite(m["loss"]) and all(0 <= m[k] <= 1 for k in m if k != "loss")):
        raise RuntimeError(f"train {label}: bad metrics {m}")
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    ref_state = create_train_state(reference, learning_rate=1e-4, freeze_video_trunk=freeze)
    with plain_recurrence(lstm_fused):
        _, ref_metrics = step(ref_state, batch)
    torch.backends.cudnn.deterministic = False
    ref_grads = {n: p.grad for n, p in ref_state.model.named_parameters()
                 if p.grad is not None}
    if grads.keys() != ref_grads.keys():
        raise RuntimeError(f"train {label}: gradients of {sorted(grads)} "
                           f"against {sorted(ref_grads)}")
    n_trunk = sum(n.startswith("tower.features.") for n in grads)
    if n_trunk != (60 if trunk_trains else 0):
        raise RuntimeError(f"train {label}: {n_trunk} trunk gradients")
    grad_err = max(rel_err(grads[n], ref_grads[n]) for n in grads)
    loss_err = abs(m["loss"] - ref_metrics["loss"].item()) / abs(ref_metrics["loss"].item())
    del ref_state, reference, ref_grads
    torch.cuda.empty_cache()
    print(f"train {label}: launches {counts[fwd]} K1d ({lstm_fused.KERNEL_NAMES[fwd]}), "
          f"{counts[bwd]} K1e ({lstm_fused.KERNEL_NAMES[bwd]}), "
          f"{counts['none'] + counts['none_persist']} K1a, "
          f"{' + '.join(str(counts[k]) for k in k4_launches())} K4; "
          f"metrics {json.dumps({k: round(v, 6) for k, v in m.items()})}; "
          f"against the plain recurrence: grads rel {grad_err:.3e} (tol "
          f"{STEP_GRAD_REL_TOL:g}) over {len(grads)} tensors ({n_trunk} of the trunk), "
          f"loss rel {loss_err:.3e} (tol {STEP_LOSS_REL_TOL:g}); first step's peak mem "
          f"{first_peak:.2f} GiB")
    if grad_err > STEP_GRAD_REL_TOL or loss_err > STEP_LOSS_REL_TOL:
        raise RuntimeError(f"train {label}: step vs plain recurrence {grad_err}, {loss_err}")
    torch.cuda.reset_peak_memory_stats()
    reps = [timed_train_step(step, state, batch) for _ in range(3)]
    dt, stage_ms = min(reps, key=lambda r: r[0])
    print(f"train {label}: {1e3 * dt:.2f} ms/step (reps "
          f"{[round(1e3 * r[0], 2) for r in reps]}), {b * t / FRAME_RATE / dt:.1f}x "
          f"real time, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"profile": f"train/{label}" + ("" if persist else "/out_of_plan"),
                      "stage_ms": stage_ms,
                      **profile_step(step, state, batch)}))
    if not persist:
        # the same model in inference: outside the plan K1a, K1c and K1b are
        # the per-step kernels
        predict = make_predict_step(modality)
        for sq in lstm_fused.STATE_QUANTS:
            for cell in state.model.lstm_audio.layers():
                cell.state_quant = sq
            reset_counts()
            probs = predict(state, batch)
            torch.cuda.synchronize()
            counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
            with plain_inference(lstm_fused):
                err = (probs - predict(state, batch)).abs().max().item()
            print(f"inference {modality} {sq} outside the plan: launches {counts}, "
                  f"max|probs-plain| {err:.2e} (tol {PROB_TOL:g})")
            if counts != {sq: 2 * t} or not err <= PROB_TOL:
                raise RuntimeError(f"inference {sq} outside the plan: launches {counts}, "
                                   f"err {err}")
            rows[sq]["launches"] = counts[sq]
        for cell in state.model.lstm_audio.layers():
            cell.state_quant = "none"
    return state


def trainer_phase(state, modality: str) -> None:
    """Trainer.fit for one epoch (2 train batches and 1 eval batch of B=4,
    T=128) on the AV (trunk frozen) or the video state, a checkpoint round
    trip, and one more step from the saved and from the restored state."""
    from avvad_tpu_torch.models import AVVAD, VideoVAD
    from avvad_tpu_torch.ops import lstm_fused
    from avvad_tpu_torch.train import (Trainer, create_train_state, latest_checkpoint,
                                       make_train_step, restore_checkpoint)

    t = 128
    train = [train_batch(t, 4, modality, seed=s) for s in (10, 11)]
    valid = [train_batch(t, 4, modality, seed=12)]
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as model_dir:
        reset_counts()
        t0 = time.perf_counter()
        last = Trainer(state, modality, model_dir).fit(train, valid, end_epoch=2)
        torch.cuda.synchronize()
        counts = dict(lstm_fused.launch_counts())
        expect = {k: 0 for k in counts}
        # 2 train batches x 2 layers, one persistent launch each way; the
        # eval pass runs the persistent K1a, one launch a layer
        expect.update(fwd_train_persist=2 * 2, bwd_persist=2 * 2, none_persist=2)
        if counts != expect:
            raise RuntimeError(f"Trainer.fit {modality}: launch counts {counts}, "
                               f"expected {expect}")
        logs = {name: (Path(model_dir) / name).read_text().splitlines()
                for name in ("output_batch.log", "output_epoch.log")}
        path = latest_checkpoint(model_dir)
        if len(logs["output_batch.log"]) != 2 or len(logs["output_epoch.log"]) != 4 \
                or path is None:
            raise RuntimeError(f"Trainer.fit {modality}: logs {logs}, checkpoint {path}")
        fresh = (AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                       use_kernel_lstm=True, seed=1) if modality == "av"
                 else VideoVAD(lstm_hidden_size=H, lstm_layers=2, use_kernel_lstm=True, seed=1))
        fresh = create_train_state(fresh, freeze_video_trunk=modality == "av")
        fresh, _, epoch = restore_checkpoint(model_dir, fresh)
        print(f"Trainer.fit {modality}: 1 epoch in {time.perf_counter() - t0:.1f} s, launches "
              f"{counts}; valid {json.dumps({k: round(v, 4) for k, v in last['valid'].items()})}; "
              f"restored {Path(path).name} (epoch {epoch}, step {fresh.step})")
    want, got = state.model.state_dict(), fresh.model.state_dict()
    if want.keys() != got.keys() or any(not torch.equal(want[k], got[k]) for k in want) \
            or fresh.step != state.step:
        raise RuntimeError(f"{modality}: restored state differs from the saved one")
    step = make_train_step(modality)
    # a trunk that trains sums its weight gradients in one order in both
    torch.backends.cudnn.deterministic = modality == "video"
    for s in (state, fresh):
        step(s, train[0])
    torch.backends.cudnn.deterministic = False
    err = max((a - b).abs().max().item() for a, b in
              zip(state.model.parameters(), fresh.model.parameters()))
    print(f"{modality}: one more step from the saved and the restored state: max |param "
          f"diff| {err:.3e} (tol 1e-6)")
    if err > 1e-6:
        raise RuntimeError(f"{modality}: resumed step differs: {err}")


def remat_phase() -> None:
    """VideoVAD's full-width train step with ``remat=True`` (the trunk's
    activations recomputed in the backward pass) against the same step
    without, from the same init and batch, cuDNN deterministic: gradients
    and the running statistics after the step (updated once, not again by
    the recompute); then each timed (best of 3 after the compared step)
    with its peak memory."""
    from avvad_tpu_torch.models import VideoVAD
    from avvad_tpu_torch.ops import lstm_fused
    from avvad_tpu_torch.train import create_train_state, make_train_step

    step = make_train_step("video")
    batch = train_batch(T, TRAIN_B, "video", seed=8)
    res = {}
    for remat in (False, True):
        model = VideoVAD(lstm_hidden_size=H, lstm_layers=2, use_kernel_lstm=True, remat=remat,
                         seed=0)
        state = create_train_state(model, learning_rate=1e-4)
        torch.backends.cudnn.deterministic = True
        reset_counts()
        step(state, batch)
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
        if counts != {"fwd_train_persist": 2, "bwd_persist": 2}:
            raise RuntimeError(f"remat={remat}: launch counts {counts}")
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        stats = {n: v.clone() for n, v in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))}
        torch.cuda.reset_peak_memory_stats()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        res[remat] = {"grads": grads, "stats": stats, "ms": 1e3 * min(reps),
                      "reps_ms": [round(1e3 * r, 2) for r in reps],
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del state, model
        torch.cuda.empty_cache()
    off, on = res[False], res[True]
    grad_err = max(rel_err(on["grads"][n], g) for n, g in off["grads"].items())
    stat_err = max((on["stats"][n] - v).abs().max().item() for n, v in off["stats"].items())
    print(f"train video remat: {on['ms']:.2f} ms/step (reps {on['reps_ms']}), peak mem "
          f"{on['peak_gib']:.2f} GiB; without remat {off['ms']:.2f} ms/step (reps "
          f"{off['reps_ms']}), peak mem {off['peak_gib']:.2f} GiB; one step each from the same "
          f"init: grads rel {grad_err:.3e}, running statistics max |diff| {stat_err:.3e} "
          f"over {len(off['stats'])} (tol {REMAT_TOL:g})")
    print(json.dumps({"remat": {k: {"ms_per_step": v["ms"], "peak_mem_gib": v["peak_gib"]}
                                for k, v in (("on", on), ("off", off))},
                      "grads_rel": grad_err, "running_stats_max_abs_diff": stat_err}))
    if not (grad_err <= REMAT_TOL and stat_err <= REMAT_TOL):
        raise RuntimeError(f"remat step against the step without: {grad_err}, {stat_err}")


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
    """P1's four modes against the plain version: on the persistent frame
    (``lstm_probe_persist``) at the probe's shape and the ragged one, "full"
    and "h_bf16" also bit for bit against the serving kernels; per step
    (``lstm_probe``) outside the plan and, the route forced, at the probe's
    shape; both routes timed in turns there, with bounds -> kernel rows
    "probe_persist/<mode>" and "probe/<mode>" (per step)."""
    dev = torch.device("cuda")
    lstm = torch.nn.LSTM(H, H, batch_first=True).cuda()
    x_in = torch.randn(B, T, H, generator=torch.Generator().manual_seed(9)).cuda()
    with torch.inference_mode():
        cudnn_ms = cuda_ms(lambda: lstm(x_in), 5)
    rows = {}

    def check(mode, b, t, h, route):
        xp, w, _, _ = tool.probe_inputs(b, t, h, dev, seed=3)
        g = torch.Generator().manual_seed(4)
        h0 = torch.tanh(torch.randn(b, h, generator=g)).cuda()
        c0 = torch.randn(b, h, generator=g).cuda()
        reset_counts()
        y = lstm_fused.lstm_probe(xp, w, h0, c0, mode)
        torch.cuda.synchronize()
        counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
        if counts != {route: 1 if route == "probe_persist" else t}:
            raise RuntimeError(f"probe {mode} B={b} T={t} H={h}: launches {counts}, "
                               f"expected {route} alone")
        ref = lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode)
        err = (y - ref).abs().max().item()
        print(f"{lstm_fused.KERNEL_NAMES[route]}[{mode}] B={b} T={t} H={h}: max|kernel-plain| = "
              f"{err:.3e} (tol {PROBE_TOL[mode]:g}; max|plain| {ref.abs().max().item():.3f})")
        if not (torch.isfinite(y).all() and err <= PROBE_TOL[mode]):
            raise RuntimeError(f"probe {mode}: kernel disagrees with plain ({err})")
        if route == "probe_persist" and mode in PROBE_SQ and mode != "matmul_only":
            serving = lstm_fused.lstm_layer_fused(xp, w, h0, c0, PROBE_SQ[mode])
            if not torch.equal(y, serving):
                raise RuntimeError(f"probe {mode} B={b} T={t} H={h}: differs from "
                                   f"{PROBE_SQ[mode]}_persist by "
                                   f"{(y - serving).abs().max().item()}")
            print(f"lstm_probe_persist[{mode}] B={b} T={t} H={h}: bit for bit equal to "
                  f"{lstm_fused.KERNEL_NAMES[PROBE_SQ[mode] + '_persist']}")
        return err

    for mode in lstm_fused.PROBE_MODES:
        errs = {"probe_persist": [check(mode, *shape, "probe_persist")
                                  for shape in ((B, T, H), RAGGED)],
                "probe": [check(mode, *OUT_OF_PLAN, "probe")]}
        xp, w, h0, c0 = tool.probe_inputs(B, T, H, dev)
        kernel = lambda: lstm_fused.lstm_probe(xp, w, h0, c0, mode)  # noqa: E731
        with per_step_route(lstm_fused):  # the per-step route at the probe's shape too
            y_step = kernel()
            errs["probe"].append((y_step - lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode))
                                 .abs().max().item())
            if errs["probe"][-1] > PROBE_TOL[mode]:
                raise RuntimeError(f"per-step probe {mode}: {errs['probe'][-1]}")
        # per step, persistent, persistent, per step: in turns on one card
        reset_counts()
        with per_step_route(lstm_fused):
            step_ms = [cuda_ms(kernel, 5)]
        persist_ms = [cuda_ms(kernel, 5), cuda_ms(kernel, 5)]
        with per_step_route(lstm_fused):
            step_ms.append(cuda_ms(kernel, 5))
        counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
        if counts != {"probe_persist": 12, "probe": 12 * T}:
            raise RuntimeError(f"probe {mode}: timed the wrong route: {counts}")
        plain_ms = cuda_ms(lambda: lstm_fused.lstm_probe_plain(xp, w, h0, c0, mode), 2)
        library_ms = cudnn_ms if mode in ("full", "h_bf16") else None
        bound_ms, bound_by = probe_bound(B, T, H, mode)
        for route, reps in (("probe_persist", persist_ms), ("probe", step_ms)):
            ms = min(reps)
            print(f"{lstm_fused.KERNEL_NAMES[route]}[{mode}]: kernel {ms:.3f} ms/layer "
                  f"({1e3 * ms / T:.2f} us/step; reps {[round(r, 3) for r in reps]}), plain "
                  f"{plain_ms:.3f}, cuDNN LSTM layer "
                  f"{'none' if library_ms is None else f'{library_ms:.3f}'}, bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
            rows[f"{route}/{mode}"] = {
                "name": f"{lstm_fused.KERNEL_NAMES[route]}[{mode}]", "route": "cuda",
                "source": ("avvad_tpu_torch/csrc/lstm_persistent.cu" if route == "probe_persist"
                           else "avvad_tpu_torch/csrc/lstm_recurrence.cu"),
                "replaces": "scripts/bench_lstm_probe.py:71", "launches": None,
                "max_abs_err": max(errs[route]), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    for route in ("probe_persist", "probe"):
        full, mm, go, hb = (rows[f"{route}/{m}"]["ms"] for m in
                            ("full", "matmul_only", "gates_only", "h_bf16"))
        us = 1e3 / T
        print(f"{lstm_fused.KERNEL_NAMES[route]} split of a full step ({us * full:.2f} us): "
              f"matmul_only {us * mm:.2f} us ({mm / full:.3f} of full), gates_only "
              f"{us * go:.2f} us ({go / full:.3f}), h_bf16 {us * hb:.2f} us ({hb / full:.3f}); "
              f"gate math (full - matmul_only) {us * (full - mm):.2f} us, exchange loads + "
              f"product + reduction (full - gates_only) {us * (full - go):.2f} us")
        # a quarter of the product would be dead-code elimination of three gates
        if mm < 0.5 * full:
            raise RuntimeError(f"{route} matmul_only {mm:.3f} ms is under half of full "
                               f"{full:.3f} ms: the contraction was cut")
    return rows


def probe_tool_phase(lstm_fused, tool, rows: dict) -> None:
    """The probe entry point, as a user runs it, with launch counters: at
    its default shape (the persistent P1) and at a shape outside the plan
    (the per-step P1), each with the counters at 0 before."""
    iters = 30
    reset_counts()
    res = tool.main([])
    torch.cuda.synchronize()
    counts = dict(lstm_fused.launch_counts())
    # each timing is a warm-up and `iters` calls; "full" and "h_bf16" are
    # run once more each for their difference
    expect = {k: 0 for k in counts}
    expect.update(probe_persist=4 * (iters + 1) + 2, none_persist=iters + 1,
                  bf16_persist=iters + 1, int8_persist=iters + 1)
    if counts != expect:
        raise RuntimeError(f"probe tool: launch counts {counts}, expected {expect}")
    for mode, n in res["probe_launches"].items():
        if n < 1:
            raise RuntimeError(f"probe tool: mode {mode} launched {n} times")
        rows[f"probe_persist/{mode}"]["launches"] = n
    times = [*res["probe"].values(), *res["lstm_layer_fused"].values(),
             *res["frontend"].values()]
    if not all(np.isfinite(v) and v > 0 for v in times) or \
            not 0 <= res["h_bf16_vs_full"] < 1e-2:
        raise RuntimeError(f"probe tool: bad result {res}")
    print(json.dumps({"probe_tool": res, "launches": counts}))
    # outside the plan (H % 4 != 0): the per-step probe, T launches a call
    b, t, h = OUT_OF_PLAN_STEP["b"], OUT_OF_PLAN_STEP["t"], OUT_OF_PLAN_STEP["h"]
    reset_counts()
    res = tool.main(["--b", str(b), "--t", str(t), "--h", str(h), "--iters", "2"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in lstm_fused.launch_counts().items() if v}
    if counts.get("probe") != t * (4 * 3 + 2) or any(k.endswith("_persist") for k in counts):
        raise RuntimeError(f"probe tool outside the plan: launch counts {counts}")
    for mode, n in res["probe_launches"].items():
        rows[f"probe/{mode}"]["launches"] = n
    print(json.dumps({"probe_tool_outside_plan": res, "launches": counts}))


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
    """One tick's chunks of every stream; ``pcm`` None: video only."""
    for i in range(STREAMS):
        if pcm is None:
            ms.feed(i, video_frames=video[i])
            continue
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
            feed_tick(ms, None if pcm is None else pcm[k], None if video is None else video[k],
                      float_wire)
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
    same samples (and the same frames at 62.5 fps; ``pcm`` None: the frames
    alone) -> largest difference."""
    worst = 0.0
    for i in (0, 1):
        solo.reset()
        for k in range(SOLO_TICKS):
            frames = None if up is None else up[i, k * BLOCK:(k + 1) * BLOCK]
            if pcm is None:
                got = solo.feed(frames)
            else:
                chunk = pcm[k][i].astype(np.float32)  # int-domain values and peak
                got = solo.feed(chunk) if frames is None else solo.feed(chunk, frames)
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
        feed_tick(ms, None if pcm is None else pcm[k], None if video is None else video[k],
                  False)
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


def int8_tick_checks(make, outs, pcm, video, label: str) -> dict:
    """The static-int8 tower's ticks: 3 ticks of a fresh server, each with
    the counters at 0 before and read after (the channels-last K3 once, K2
    eight times, nothing else), equal to the run's first ticks; then the
    same ticks with the plain K2 / K3 -> summary entries."""
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    def ticks(ms, count: bool) -> float:
        worst = 0.0
        for k in range(3):
            feed_tick(ms, None if pcm is None else pcm[k], video[k], False)
            reset_counts()
            got = ms.tick()
            counts = launch_counts()
            expect = {k_: 0 for k_ in counts}
            expect.update({conv_fused.KERNEL_NAME: 8, stem_fused.NHWC_KERNEL_NAME: 1})
            if count and counts != expect:
                raise RuntimeError(f"{label}: tick launch counts {counts}, expected {expect}")
            worst = max(worst, max(float(np.abs(got[i] - outs[k][i]).max())
                                   for i in range(STREAMS)))
        return worst

    worst = ticks(make(), True)
    if worst > PIPE_TOL:
        raise RuntimeError(f"{label}: a second run differs by {worst}")
    ref = make()
    with plain_k2_k3():
        worst = ticks(ref, False)
    print(f"streaming {label}: launches a tick {conv_fused.KERNEL_NAME} 8, "
          f"{stem_fused.NHWC_KERNEL_NAME} 1; 3 ticks against the plain K2/K3: max |diff| "
          f"{worst:.2e} (tol {INT8_PROB_TOL:g})")
    if worst > INT8_PROB_TOL:
        raise RuntimeError(f"{label}: ticks against plain K2/K3 {worst}")
    return {"k2_launches_per_tick": 8, "k3_launches_per_tick": 1,
            "plain_k2_k3_max_abs_diff": worst}


def streaming_phase(float_model, int8_model) -> None:
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import AudioVAD

    pcm, video, up = stream_data()
    hub_phase(pcm)
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
            summary.update(int8_tick_checks(lambda: av_server(model), outs, pcm, video, label))
        print(json.dumps(summary))


def video_streaming_phase() -> None:
    """MultiStreamVideoVAD at full width (VideoVAD bf16, 2 x LSTM 1024), 30
    fps uint8 camera frames, 32 streams x 16 frames a tick: the bf16 float
    tower, then the static-int8 tower on its kernels (calibrated with the
    port's ``calibrate`` on 2 streams' camera frames of the first 8 ticks),
    each with the checks of streaming_phase; the int8 ticks with the launch
    counters (the channels-last K3 once and K2 eight times a tick on its 288
    unique frames) and against the plain K2 / K3; then the fp32 model's
    batched ticks against its solo streamer."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import VideoVAD, calibrate

    _, video, up = stream_data()
    kw = dict(lstm_hidden_size=H, lstm_layers=2, dtype=torch.bfloat16, seed=0)
    float_model = VideoVAD(**kw)
    int8_model = VideoVAD(**kw, tower_int8=True, tower_quant_mode="static",
                          tower_pallas=True).cuda()
    frames = torch.from_numpy(np.concatenate(video[:8], axis=1)[:2]).float().cuda()
    calibrate(int8_model, [frames])
    print(f"video streaming: {STREAMS} streams x {BLOCK} frames a tick, {TICKS} ticks, 30 fps "
          f"uint8 camera frames; the int8 tower calibrated on {frames.shape[0]} x "
          f"{frames.shape[1]} frames, q_stem {int8_model.tower.features.q_stem.item():.4f}")

    def server(model):
        return serve.MultiStreamVideoVAD(model, STREAMS, block_frames=BLOCK, video_fps=30.0,
                                         video_uint8=True)

    for label, model in (("video/float_tower", float_model), ("video/int8_tower", int8_model)):
        ms = server(model)
        if ms._vout.shape[:2] != (STREAMS, 9):
            raise RuntimeError(f"{label}: {ms._vout.shape[:2]} unique frames a tick")
        outs, summary = run_streamer(ms, ms.model.lstm_video, None, video, False, label)
        summary["solo_max_abs_diff"] = solo_check(
            serve.StreamingVideoVAD(model, block_frames=BLOCK, video_uint8=True),
            outs, None, up, "video", label)
        summary["pipelined_max_abs_diff"] = pipeline_check(
            lambda: server(model), outs, None, video, label)
        if label == "video/int8_tower":
            summary.update(int8_tick_checks(lambda: server(model), outs, None, video, label))
        print(json.dumps(summary))
        del ms
        torch.cuda.empty_cache()
    # the fp32 model, where no bf16 rounding hides a fault of the batched tick
    fp32 = VideoVAD(lstm_hidden_size=H, lstm_layers=2, seed=0)
    ms, outs = server(fp32), []
    for k in range(SOLO_TICKS):
        feed_tick(ms, None, video[k], False)
        outs.append(ms.tick())
        check_tick(outs[-1], f"video/float_tower_fp32 tick {k}")
    solo_check(serve.StreamingVideoVAD(fp32, block_frames=BLOCK, video_uint8=True), outs,
               None, up, "video_fp32", "video/float_tower_fp32")


# --- the corpus path ---------------------------------------------------------


class SyntheticCorpus:
    """One NTCD-TIMIT split made from the seed, in memory: the mesh phase's
    source for the sharded evaluate_split (its ranks read no disk tree),
    with the utterances ``write_raw_corpus`` writes. It follows the port's
    source protocol (``__len__``, ``__getitem__``, ``probe_length``,
    ``rel_path``, ``label_rel_path``, ``metadata``) and yields the dicts of
    ``data.AudioVisualSource`` at the corpus's shapes: log-power (T, 513)
    of speech-like audio with Babble-like white noise at -5 dB, 30 fps
    camera frames upsampled to 62.5 fps (T, 67, 67) in [0, 255], and the
    energy-VAD labels (T, 1) of the clean speech, 2-8 s an utterance."""

    def __init__(self, split: str, n: int, seed: int = 0, dur: tuple = CORPUS_DUR):
        self.split, self.n, self.seed = split, n, seed
        self.durs = np.random.default_rng((seed, CORPUS_SPLIT_CODE[split])).uniform(
            *dur, size=n)

    def __len__(self) -> int:
        return self.n

    def rel_path(self, i: int) -> str:
        spk, utt = corpus_names(self.split, i)
        return f"ntcd_timit/Noisy/Babble/-5/{CORPUS_SPLIT_DIR[self.split]}/{spk}/{utt}.wav"

    def label_rel_path(self, i: int) -> str:
        spk, utt = corpus_names(self.split, i)
        return (f"ntcd_timit/Clean/{CORPUS_SPLIT_DIR[self.split]}/{spk}/"
                f"{utt}_vad_labels_upsampled.h5")

    def metadata(self, i: int) -> dict:
        from avvad_tpu_torch.data.sources import parse_utt_metadata

        return parse_utt_metadata(self.rel_path(i))

    def probe_length(self, i: int) -> int:
        from avvad_tpu_torch.processing.stft import n_stft_frames

        return n_stft_frames(int(self.durs[i] * CORPUS_FS))

    def __getitem__(self, i: int) -> dict:
        from avvad_tpu_torch.data.records import truncate_common
        from avvad_tpu_torch.processing import (clean_speech_VAD, fps_resample_indices,
                                                log_power_spectrogram, stft)
        from avvad_tpu_torch.processing.audio_io import peak_normalize

        rng = np.random.default_rng((self.seed, CORPUS_SPLIT_CODE[self.split], i))
        clean, noisy = corpus_audio(rng, float(self.durs[i]))
        audio = np.ascontiguousarray(log_power_spectrogram(stft(peak_normalize(noisy))).T)
        label = np.ascontiguousarray(clean_speech_VAD(peak_normalize(clean)).T)
        camera = corpus_camera(rng, int(np.ceil(self.durs[i] * 30)))
        video = camera[fps_resample_indices(len(camera), 30.0, FRAME_RATE)]
        audio, video, label = truncate_common(audio, video, label)
        return {"audio": audio, "video": video, "label": label,
                "length": audio.shape[0], **self.metadata(i)}


def corpus_names(split: str, i: int) -> tuple[str, str]:
    """Speaker and utterance of item i: 2 utterances a speaker."""
    spk = 20 * CORPUS_SPLIT_CODE[split] + i // 2 + 1
    return f"{spk:02d}{'M' if spk % 2 else 'F'}", f"s{i % 2}"


def corpus_audio(rng, dur: float) -> tuple[np.ndarray, np.ndarray]:
    """-> (clean, noisy) float32 16 kHz: 2-5 voiced harmonic bursts between
    near silences (so the energy VAD's labels are not constant), and white
    noise mixed in at -5 dB."""
    from avvad_tpu_torch.data import mix_at_snr

    n = int(dur * CORPUS_FS)
    t = np.arange(n) / CORPUS_FS
    x = rng.normal(size=n) * 1e-4
    k = int(rng.integers(2, 6))
    edges = np.sort(rng.uniform(0.05, 0.95, size=2 * k)) * dur
    for b in range(k):
        i0 = int(edges[2 * b] * CORPUS_FS)
        i1 = min(n, int(max(edges[2 * b + 1], edges[2 * b] + 0.1) * CORPUS_FS))
        f0 = rng.uniform(80, 220)
        burst = sum(np.sin(2 * np.pi * h * f0 * t[i0:i1] + rng.uniform(0, 2 * np.pi)) / h
                    for h in range(1, 12))
        x[i0:i1] += burst * np.hanning(i1 - i0) ** 0.5 * rng.uniform(0.2, 0.5)
    clean = np.clip(x, -1.0, 1.0).astype(np.float32)
    noisy = mix_at_snr(clean, rng.normal(size=n).astype(np.float32), -5.0)
    return clean, noisy / np.abs(noisy).max()


def corpus_camera(rng, n: int) -> np.ndarray:
    """(n, 67, 67) float32 lip-crop stand-ins at 30 fps: smooth fields
    (17 x 17 AR(1) noise held over 4 x 4 pixels), min-max to [0, 255] per
    frame, as the corpus's decoded frames are."""
    base = rng.normal(size=(17, 17))
    frames = np.empty((n, 17, 17))
    for f in range(n):
        base = 0.9 * base + 0.45 * rng.normal(size=(17, 17))
        frames[f] = base
    up = np.repeat(np.repeat(frames, 4, axis=1), 4, axis=2)[:, :67, :67]
    lo = up.min(axis=(1, 2), keepdims=True)
    hi = up.max(axis=(1, 2), keepdims=True)
    return ((up - lo) / (hi - lo) * 255.0).astype(np.float32)


def write_raw_corpus(raw: Path, sizes: dict, seed: int = 0, dur: tuple = CORPUS_DUR) -> None:
    """A raw NTCD-TIMIT tree under ``raw`` in the corpus's layout
    (scripts/synth_complete_corpus.py): for each split of ``sizes`` the
    utterances of ``SyntheticCorpus``, clean and noisy wavs and the video
    as a DCT ``.mat`` (HDF5, written by the port's ``hdf5``) file at 30
    fps, its fields those of the synth_complete_corpus twin."""
    from avvad_tpu_torch import hdf5
    from avvad_tpu_torch.processing import write_wav
    from avvad_tpu_torch.scripts.synth_complete_corpus import synth_dct_video

    noisy_base = raw / "ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT/Babble/-5/volunteers"
    for split, n in sizes.items():
        durs = SyntheticCorpus(split, n, seed, dur).durs
        for i in range(n):
            spk, utt = corpus_names(split, i)
            dirs = (raw / "ntcd_timit/matlab_raw" / CORPUS_SPLIT_DIR[split] / spk,
                    raw / "ntcd_timit/Clean/volunteers" / spk / "straightcam",
                    noisy_base / spk / "straightcam")
            for d in dirs:
                d.mkdir(parents=True, exist_ok=True)
            rng = np.random.default_rng((seed, CORPUS_SPLIT_CODE[split], i))
            clean, noisy = corpus_audio(rng, float(durs[i]))
            write_wav(str(dirs[1] / f"{utt}.wav"), clean, CORPUS_FS)
            write_wav(str(dirs[2] / f"{utt}.wav"), noisy, CORPUS_FS)
            with hdf5.File(dirs[0] / f"{utt}.mat", "w") as f:
                f.create_dataset("data", data=synth_dct_video(rng, int(np.ceil(durs[i] * 30))))


def hdf5_fixture_check() -> dict:
    """The committed HDF5 fixtures (tests/fixtures/make_hdf5_fixtures.py,
    written by h5py: a lip video as the JAX builders write it, LZF, one
    chunk a frame in a two-level chunk B-tree; a MATLAB v7.3-style ``.mat``
    with a 512-byte user block, shuffle and deflate) read through the
    port's ``hdf5``: each array's SHA-256 against h5py's, the ``.mat``
    through ``read_mat_dct`` too, and the C++ LZF decoder against its Python
    twin chunk by chunk -> {file: {dataset: ...}}."""
    import hashlib

    from avvad_tpu_torch import hdf5, native
    from avvad_tpu_torch.processing.video import read_mat_dct

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    meta = json.loads((HDF5_FIXTURES / "hdf5_fixtures.json").read_text())
    out = {}
    for fname, datasets in meta.items():
        path = HDF5_FIXTURES / fname
        out[fname] = {}
        with hdf5.File(path) as f:
            if f.keys() != list(datasets):
                raise RuntimeError(f"hdf5 fixture {fname}: datasets {f.keys()}")
            for name, want in datasets.items():
                t0 = time.perf_counter()
                d = f[name]
                a = d[()]
                read_ms = 1e3 * (time.perf_counter() - t0)
                if (list(a.shape), a.dtype.str, sha(a)) != (want["shape"], want["dtype"],
                                                             want["sha256"]):
                    raise RuntimeError(f"hdf5 fixture {fname}/{name}: {a.shape} {a.dtype} "
                                       f"differs from h5py's reading")
                row = {"shape": list(a.shape), "read_ms": read_ms, "sha256_equal": True}
                if want["lzf_chunks"]:
                    nbytes = int(np.prod(d.chunks)) * d.dtype.itemsize
                    chunks = [f._reader.read(addr, size) for addr, size, mask in
                              f._reader.chunk_index(d._layout[1], d.ndim).values() if mask == 0]
                    same = sum(native.lzf_decompress(c, nbytes) == hdf5.lzf_decompress_py(c, nbytes)
                               for c in chunks)
                    if len(chunks) != want["lzf_chunks"] or same != len(chunks):
                        raise RuntimeError(f"hdf5 fixture {fname}/{name}: {same} of "
                                           f"{len(chunks)} LZF chunks decode alike "
                                           f"({want['lzf_chunks']} expected)")
                    row["lzf_chunks_native_equal_python"] = same
                out[fname][name] = row
        if fname.endswith(".mat"):
            (name, want), = datasets.items()
            if sha(read_mat_dct(str(path))) != want["sha256"]:
                raise RuntimeError(f"hdf5 fixture {fname}: read_mat_dct differs from h5py's")
    print(f"hdf5 fixtures: {json.dumps(out)}")
    return out


def _import_builders(_) -> None:
    import avvad_tpu_torch.builders  # noqa: F401


def corpus_build_stages(raw: Path, n_utts: int = 1) -> dict:
    """Where the build's time goes: the wall of starting a pool of
    CORPUS_BUILD_WORKERS spawned workers that import the builders (what
    the build pays once), and each stage of the first ``n_utts`` train
    utterances' video and audio work, serially, by ``PhaseTimer``."""
    from avvad_tpu_torch import builders
    from avvad_tpu_torch.builders import BuildConfig, make_label
    from avvad_tpu_torch.datasets import ntcd_timit as catalog
    from avvad_tpu_torch.processing import read_wav, stft
    from avvad_tpu_torch.processing.audio_io import peak_normalize
    from avvad_tpu_torch.processing.stft import log_power_spectrogram
    from avvad_tpu_torch.processing.video import (decode_dct_frames, idct2, read_mat_dct,
                                                  upsample_video)
    from avvad_tpu_torch.utils import PhaseTimer

    t0 = time.perf_counter()
    with builders._spawn_pool(CORPUS_BUILD_WORKERS) as pool:
        list(pool.map(_import_builders, range(CORPUS_BUILD_WORKERS)))
    pool_s = time.perf_counter() - t0

    cfg = BuildConfig(raw_dir=str(raw) + "/", processed_dir="")
    mats = catalog.video_list(cfg.raw_dir, "train")[:n_utts]
    clean = catalog.speech_list(cfg.raw_dir, "train")[0][:n_utts]
    noisy = list(catalog.noisy_speech_dict(cfg.raw_dir, "train", "subset"))[:n_utts]
    timer, frames = PhaseTimer(), 0
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as out:
        for i, (mat, wav, nwav) in enumerate(zip(mats, clean, noisy)):
            with timer.phase("read_mat"):
                dct = read_mat_dct(cfg.raw_dir + mat)
            with timer.phase("idct2 (in decode)"):
                idct2(dct.reshape(-1, 67, 67))
            with timer.phase("decode"):
                video = decode_dct_frames(dct)
            with timer.phase("upsample"):
                video = np.ascontiguousarray(np.moveaxis(upsample_video(video), 0, -1))
            with timer.phase("wav_label"):
                x, fs = read_wav(cfg.raw_dir + wav)
                label = make_label(peak_normalize(x), fs, cfg.stft, cfg.label)
            with timer.phase("write_h5"):
                builders._write_h5(f"{out}/{i}_x.h5", "X", video)
                builders._write_h5(f"{out}/{i}_y.h5", "Y", label)
            with timer.phase("noisy_stats"):
                xn, fs = read_wav(cfg.raw_dir + nwav)
                c = cfg.stft
                spec = log_power_spectrogram(
                    stft(peak_normalize(xn), fs=fs, wlen_sec=c.wlen_sec, win=c.win,
                         hop_percent=c.hop_percent, center=c.center, pad_mode=c.pad_mode,
                         pad_at_end=c.pad_at_end), eps=c.eps)
                spec.sum(axis=-1), (spec ** 2).sum(axis=-1)
            frames += dct.shape[0]
    print(f"corpus build stages, {len(mats)} train utterances ({frames} frames at 30 fps) "
          f"serially; a pool of {CORPUS_BUILD_WORKERS} workers started in {pool_s:.2f} s:\n"
          + timer.report())
    return {"pool_start_s": pool_s, "utterances": len(mats), "frames": frames,
            "stages_s": dict(timer.totals)}


def corpus_on_disk(root: Path, seed: int = 0) -> dict:
    """``write_raw_corpus`` under ``root``, the port's builders on it
    through the ``create_train_files`` twin (in process, its launches
    counted and its {"cli": ...} line printed: the CLI phase takes this
    build as its own), the port's ``AudioVisualSource`` over the processed
    tree -> {split: source}, the raw tree, the data root and processed
    root, and the built statistics."""
    from avvad_tpu_torch.data import AudioVisualSource, load_statistics
    from avvad_tpu_torch.scripts import create_train_files

    raw, data = root / "raw", root / "data"
    out = data / "subset" / "processed"
    write_raw_corpus(raw, CORPUS_SPLITS, seed)
    t0 = time.perf_counter()
    built, _ = cli_run("create_train_files", create_train_files.main,
                       ["--raw-dir", str(raw), "--processed-dir", str(out),
                        "--workers", str(CORPUS_BUILD_WORKERS)], {})
    if built != {f"{s}/{k}": n * (2 if k == "audio" else 1)
                 for s, n in CORPUS_SPLITS.items() for k in ("video", "audio")}:
        raise RuntimeError(f"create_train_files: built {built}")
    build = {"build_s": time.perf_counter() - t0, **corpus_build_stages(raw)}
    stats = {}
    stats["audio_mean"], stats["audio_std"] = load_statistics(
        str(out / "ntcd_timit/Noisy/ntcd_timit_log_power_spec_upsampled_statistics.h5"))
    stats["video_mean"], stats["video_std"] = load_statistics(
        str(out / "ntcd_timit/matlab_raw/ntcd_timit_upsampled_statistics.h5"))
    return {"sources": {s: AudioVisualSource(str(out) + "/", s) for s in CORPUS_SPLITS},
            "raw": str(raw) + "/", "data": str(data), "root": str(out) + "/",
            "stats": stats, "build": build}


def corpus_score(route: dict, classif_dir: str) -> dict:
    """The written predictions of the test split against its labels
    (``score_split``)."""
    from avvad_tpu_torch.evaluate import score_split

    return score_split(route["sources"]["test"], route["root"], classif_dir,
                       save_stats=False, verbose=False, max_workers=8)


def corpus_fit(state, sources, stats, prefetch: bool) -> dict:
    """One epoch of Trainer.fit (the train split at B=16, bucket 128,
    shuffled; the validation split) with its launch counts checked ->
    the epoch's seconds ([Time] of the epoch log, train and eval passes)
    and the call's."""
    from avvad_tpu_torch.data import DataLoader
    from avvad_tpu_torch.ops import lstm_fused
    from avvad_tpu_torch.train import Trainer

    loaders = [DataLoader(sources[s], batch_size=CORPUS_TRAIN_B, bucket=CORPUS_BUCKET,
                          shuffle=s == "train") for s in ("train", "validation")]
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as model_dir:
        reset_counts()
        t0 = time.perf_counter()
        Trainer(state, "av", model_dir, norm_stats=stats, prefetch=prefetch).fit(
            *loaders, end_epoch=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(lstm_fused.launch_counts())
        epoch_log = (Path(model_dir) / "output_epoch.log").read_text()
    n_train, n_valid = (len(loader) for loader in loaders)
    expect = {k: 0 for k in counts}
    expect.update(fwd_train_persist=2 * n_train, bwd_persist=2 * n_train,
                  none_persist=2 * n_valid)
    if counts != expect:
        raise RuntimeError(f"corpus Trainer.fit (prefetch={prefetch}): launch counts "
                           f"{counts}, expected {expect}")
    epoch_s = float(epoch_log.split("[Time]")[1].split("s")[0])
    print(f"corpus Trainer.fit prefetch={prefetch}: epoch {epoch_s} s (train {n_train} "
          f"batches, valid {n_valid}), call {wall:.3f} s, launches {counts}")
    return {"epoch_s": epoch_s, "fit_call_s": wall}


def corpus_plain_check(state, source, stats, classif_dir: str) -> float:
    """The same batches as evaluate_split's through the predict step with
    the plain K2 / K3 and the plain recurrence -> the largest difference
    from the written soft predictions."""
    from avvad_tpu_torch.data import DataLoader
    from avvad_tpu_torch.evaluate import prediction_paths
    from avvad_tpu_torch.ops import lstm_fused
    from avvad_tpu_torch.train import make_predict_step

    loader = DataLoader(source, batch_size=CORPUS_EVAL_B, shuffle=False, bucket=CORPUS_BUCKET,
                        bucket_ladder=True, pad_batch_to_full=True, sort_pool_factor=4)
    predict = make_predict_step("av")
    worst = 0.0
    with plain_k2_k3(), plain_inference(lstm_fused):
        for batch in loader:
            probs = predict(state, batch, stats).cpu().numpy()
            for row, (i, n) in enumerate(zip(batch.indices, batch.lengths)):
                if i < 0 or n == 0:
                    continue
                soft = np.load(prediction_paths(classif_dir, source.rel_path(int(i)))[1])
                worst = max(worst, float(np.abs(soft - probs[row, :n, 0]).max()))
    return worst


def corpus_phase(tmp: str) -> dict:
    """The corpus path at full width, under ``tmp``: the raw tree through
    the port's builders (HDF5 by the port's ``hdf5``) into
    AudioVisualSource, Trainer.fit on DataLoader with and without the
    Prefetcher, calibrate_quant_scales, evaluate_split with the static-int8
    tower for state_quant none and int8, scoring; one {"corpus": ...}
    line -> the route (sources, raw and processed roots, statistics)."""
    from avvad_tpu_torch.data import DataLoader
    from avvad_tpu_torch.evaluate import calibrate_quant_scales, evaluate_split
    from avvad_tpu_torch.models import AVVAD
    from avvad_tpu_torch.ops import conv_fused, stem_fused
    from avvad_tpu_torch.train import create_train_state

    fixtures = hdf5_fixture_check()
    t0 = time.perf_counter()
    route = corpus_on_disk(Path(tmp))
    setup_s = time.perf_counter() - t0
    sources, stats = route["sources"], route["stats"]
    test = sources["test"]
    n_frames_test = sum(test.probe_length(i) for i in range(len(test)))
    print(f"corpus: {', '.join(f'{s} {len(src)}' for s, src in sources.items())} "
          f"utterances ({n_frames_test} test frames by the probe), set up in {setup_s:.1f} s")

    # training: fp32, the trunk frozen, as the training phases
    state = create_train_state(
        AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
              use_kernel_lstm=True, seed=0), freeze_video_trunk=True)
    torch.cuda.reset_peak_memory_stats()
    fits = {f"prefetch_{k}": corpus_fit(state, sources, stats, p)
            for k, p in (("on", True), ("off", False), ("on_again", True))}
    train_peak = torch.cuda.max_memory_allocated() / 2**30

    # evaluation: the trained weights in the static-int8 fused tower
    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                  use_kernel_lstm=True, tower_int8=True, tower_quant_mode="static",
                  tower_pallas=True, seed=0)
    missing, unexpected = model.load_state_dict(state.model.state_dict(), strict=False)
    if unexpected or any(k.split(".")[-1] not in ("q_stem", "q1", "q_out") for k in missing):
        raise RuntimeError(f"corpus: int8 model keys: missing {missing}, "
                           f"unexpected {unexpected}")
    del state
    torch.cuda.empty_cache()
    eval_state = create_train_state(model)
    t0 = time.perf_counter()
    calibrate_quant_scales(eval_state, model, sources["train"], "av", norm_stats=stats)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    trunk = model.tower.features
    print(f"corpus: calibrate_quant_scales on {min(8, len(sources['train']))} train "
          f"utterances in {cal_s:.1f} s; "
          f"q_stem {trunk.q_stem.item():.4f}, layer4_1.q_out {trunk.layer4_1.q_out.item():.4f}")
    n_batches = len(DataLoader(test, batch_size=CORPUS_EVAL_B))
    evals = {}
    for sq in INT8_STATE_QUANTS:
        model.set_lstm_state_quant(sq)
        classif = f"{tmp}/classif_{sq}/"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        report = evaluate_split(eval_state, test, "av", classif, norm_stats=stats,
                                batch_size=CORPUS_EVAL_B, bucket=CORPUS_BUCKET,
                                verbose=False)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect = {**dict.fromkeys(counts, 0), sq + "_persist": 2 * n_batches,
                  conv_fused.KERNEL_NAME: 8 * n_batches,
                  stem_fused.NHWC_KERNEL_NAME: n_batches}
        if counts != expect:
            raise RuntimeError(f"corpus evaluate_split {sq}: launch counts {counts}, "
                               f"expected {expect}")
        n_files = sum(len(fs) for _, _, fs in os.walk(classif))
        if report["n_utterances"] != len(test) or n_files != 2 * len(test):
            raise RuntimeError(f"corpus evaluate_split {sq}: {report}, {n_files} files")
        err = corpus_plain_check(eval_state, test, stats, classif)
        if err > INT8_PROB_TOL:
            raise RuntimeError(f"corpus evaluate_split {sq}: against plain K2/K3 and "
                               f"the plain recurrence {err}")
        evals[sq] = {**{k: report[k] for k in ("n_utterances", "n_frames", "elapsed_s",
                                               "rt_factor")},
                     "launches_per_batch": {k: v // n_batches for k, v in counts.items()
                                            if v},
                     "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "plain_max_abs_diff": err}
        print(f"corpus evaluate_split int8 tower / {sq}: {report['n_utterances']} utts, "
              f"{report['n_frames']} frames in {report['elapsed_s']:.3f} s "
              f"({report['rt_factor']:.1f}x real time), {n_batches} batches, launches "
              f"{counts}, against plain K2/K3 + recurrence {err:.2e} "
              f"(tol {INT8_PROB_TOL:g}), peak {evals[sq]['peak_memory_gib']:.2f} GiB")
    # the host feed alone: evaluate_split's loader over the test split
    t0 = time.perf_counter()
    for _ in DataLoader(test, batch_size=CORPUS_EVAL_B, shuffle=False, bucket=CORPUS_BUCKET,
                        bucket_ladder=True, pad_batch_to_full=True, sort_pool_factor=4):
        pass
    feed_s = time.perf_counter() - t0
    print(f"corpus: the loader alone over the test split (no device work): {feed_s:.3f} s")
    prof = profile_step(lambda: evaluate_split(
        eval_state, test, "av", f"{tmp}/classif_profiled/", norm_stats=stats,
        batch_size=CORPUS_EVAL_B, bucket=CORPUS_BUCKET, verbose=False))
    print(f"corpus evaluate_split under torch.profiler: wall "
          f"{prof['profiled_step_wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {prof['device_idle_share']:.4f}")
    stats_out = corpus_score(route, f"{tmp}/classif_int8/")
    overall = stats_out["overall"]
    if not all(np.isfinite(overall[k]["avg"]) for k in ("accuracy", "precision",
                                                         "recall", "f1")):
        raise RuntimeError(f"corpus scoring: {overall}")
    print(f"corpus scoring (score_split): {json.dumps(overall)}")
    print(json.dumps({"corpus": {
        "route": "on_disk",
        "utterances": {s: len(src) for s, src in sources.items()},
        "setup_s": setup_s, "build": route["build"], "hdf5_fixtures": fixtures,
        "train": fits, "train_peak_memory_gib": train_peak,
        "calibrate_s": cal_s, "evaluate": evals, "test_feed_alone_s": feed_s,
        "evaluate_profiled": {k: prof[k] for k in ("profiled_step_wall_ms", "device_busy_ms",
                                                    "device_idle_share", "top_kernels")},
        "score_overall": overall}}))
    return route


# --- the TCP server, the C++ hub and the raw-waveform family ------------------


def hub_phase(pcm) -> None:
    """The streaming phase's feeds through the C++ hub and its numpy route,
    the two in turns each tick: feed + assemble ms a tick for each, and the
    assembled blocks, peaks and active masks bit-equal; the frames wire on
    float32 samples and the int16 span wire. One {"hub": ...} line."""
    from avvad_tpu_torch.native import StreamHub

    summary = {}
    for wire, dtype, span in (("frames_f32", np.float32, False), ("span_int16", np.int16, True)):
        hubs = {r: StreamHub(STREAMS, 1024, HOP, BLOCK, force_python=r == "numpy", dtype=dtype)
                for r in ("native", "numpy")}
        if [h.is_native for h in hubs.values()] != [True, False]:
            raise RuntimeError(f"hub {wire}: routes {[h.is_native for h in hubs.values()]}")
        ms = {r: [] for r in hubs}
        for k in range(TICKS):
            chunks = pcm[k] if dtype == np.int16 else pcm[k].astype(np.float32) / 32768.0
            got = {}
            for r in (("native", "numpy") if k % 2 else ("numpy", "native")):
                hub = hubs[r]
                t0 = time.perf_counter()
                for i in range(STREAMS):
                    hub.feed(i, chunks[i])
                blocks, peaks, active, n_active = hub.assemble(span=span)
                ms[r].append(1e3 * (time.perf_counter() - t0))
                got[r] = (blocks.copy(), peaks.copy(), active.copy(), n_active)
            a, b = got["native"], got["numpy"]
            if a[3] != STREAMS or b[3] != STREAMS or not all(
                    x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a[:3], b[:3])):
                raise RuntimeError(f"hub {wire} tick {k}: native and numpy differ")
        summary[wire] = {f"{r}_ms_per_tick_{f.__name__}": float(f(v))
                         for r, v in ms.items() for f in (np.min, np.median)}
        print(f"hub {wire}: feed + assemble of {STREAMS} streams a tick over {TICKS} ticks, "
              f"bit-equal; native {np.min(ms['native']):.3f} ms best, "
              f"{np.median(ms['native']):.3f} median; numpy {np.min(ms['numpy']):.3f} best, "
              f"{np.median(ms['numpy']):.3f} median")
    print(json.dumps({"hub": summary}))


def server_data():
    """The streaming phase's data as whole streams for socket clients: int16
    PCM (STREAMS, n) whose first sample is -32768, the largest |sample|, so
    that every stream's running peak is fixed from its first sample
    whatever the server's tick timing; the 30 fps uint8 camera frames; the
    same frames at 62.5 fps; the per-tick cuts of the PCM."""
    pcm, video, up = stream_data()
    pcm = [p.copy() for p in pcm]
    pcm[0][:, 0] = -32768
    return np.concatenate(pcm, axis=1), np.concatenate(video, axis=1), up, pcm


def serve_clients(server, jobs) -> tuple[list, dict]:
    """Run each client on a thread and poll the server from this one until
    every client is done -> (the clients' results, poll statistics). The
    hub's feed and assemble are timed inside the polls."""
    import threading

    hub = server.streamer._hub
    hub_s = [0.0]

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                hub_s[0] += time.perf_counter() - t0
        return run

    hub.feed, hub.assemble = timed(hub.feed), timed(hub.assemble)
    results, errs = [None] * len(jobs), []

    def run(i, job):
        try:
            results[i] = job()
        except Exception as e:  # raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, j), daemon=True)
               for i, j in enumerate(jobs)]
    ticked, polls = [], 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    deadline = t0 + 300
    try:
        while any(t.is_alive() for t in threads) and time.perf_counter() < deadline:
            p0 = time.perf_counter()
            if server.poll(0.001):
                ticked.append(time.perf_counter() - p0)
            polls += 1
        wall = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=5)
    finally:
        del hub.feed, hub.assemble
    if any(t.is_alive() for t in threads) or errs:
        raise RuntimeError(f"server: clients unfinished or failed: {errs}")
    return results, {"wall_s": wall, "polls": polls, "ticks": len(ticked),
                     "ms_per_tick_poll_best": 1e3 * min(ticked),
                     "ms_per_tick_poll_median": 1e3 * float(np.median(ticked)),
                     "hub_ms_total": 1e3 * hub_s[0],
                     "hub_ms_per_tick": 1e3 * hub_s[0] / len(ticked)}


def server_phase(int8_model) -> None:
    """The port's VADServer over sockets at full width: STREAMS localhost
    clients each send a whole stream of the streaming phase's data (TICKS
    blocks) as fast as the socket takes it, and poll() runs here. The AV
    server (MultiStreamAVVAD, the static-int8 tower, P and U messages) with
    the launch counters read around the serving (K3 once and K2 eight times
    a tick, nothing else), then the audio server (MultiStreamVAD, AudioVAD
    fp32, int16 raw wire); every stream against a solo streamer fed the
    same blocks, the hub native. One {"server": ...} line each."""
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.ops import conv_fused, stem_fused
    from avvad_tpu_torch.server import VADServer, av_stream_client, stream_client

    pcm, video, up, cuts = server_data()
    n_out = TICKS * BLOCK
    audio_s = STREAMS * n_out / FRAME_RATE
    span = dict(span_wire=True, hop_dft=True, audio_int16=True, native=True,
                max_backlog_blocks=SERVER_BACKLOG)
    audio = AudioVAD(lstm_hidden_size=H, lstm_layers=2, seed=0)
    for kind, make, client, solo in (
            ("av", lambda: serve.MultiStreamAVVAD(int8_model, STREAMS, block_frames=BLOCK,
                                                  video_fps=30.0, video_uint8=True, **span),
             lambda srv, i: av_stream_client(srv.address, pcm[i], video[i], n_out,
                                             chunk=BLOCK * HOP, frames_per_msg=8, timeout=60,
                                             video_wire="u8", audio_wire="i16"),
             lambda: serve.StreamingAVVAD(int8_model, block_frames=BLOCK, video_uint8=True)),
            ("audio", lambda: serve.MultiStreamVAD(audio, STREAMS, block_frames=BLOCK, **span),
             lambda srv, i: stream_client(srv.address, pcm[i], n_out, chunk=BLOCK * HOP,
                                          timeout=60, audio_wire="i16"),
             lambda: serve.StreamingVAD(audio, block_frames=BLOCK))):
        ms = make()
        if not ms._hub.is_native:
            raise RuntimeError(f"server {kind}: the hub is not native")
        server = VADServer(ms)
        try:
            ms.warmup()
            reset_counts()
            got, stats = serve_clients(server, [lambda i=i: client(server, i)
                                                for i in range(STREAMS)])
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
        finally:
            server.close()
        n = stats["ticks"]
        expect = ({conv_fused.KERNEL_NAME: 8 * n, stem_fused.NHWC_KERNEL_NAME: n}
                  if kind == "av" else {})
        if counts != expect:
            raise RuntimeError(f"server {kind}: launches {counts} over {n} ticks, "
                               f"expected {expect}")
        worst = 0.0
        ref = solo()
        for i in range(STREAMS):
            if got[i].shape != (n_out,) or not np.isfinite(got[i]).all():
                raise RuntimeError(f"server {kind}: stream {i} got {got[i].shape}")
            ref.reset()
            for k in range(TICKS):
                chunk = cuts[k][i].astype(np.float32)  # int-domain values and peak
                frames = up[i, k * BLOCK:(k + 1) * BLOCK]
                want = ref.feed(chunk, frames) if kind == "av" else ref.feed(chunk)
                worst = max(worst, float(np.abs(got[i][k * BLOCK:(k + 1) * BLOCK]
                                                - want).max()))
        tol = SOLO_TOL[kind]
        summary = {"server": kind, "streams": STREAMS, "blocks_per_stream": TICKS,
                   "hub_native": True, **stats, "x_real_time": audio_s / stats["wall_s"],
                   "launches_per_tick": {k: v / n for k, v in counts.items()},
                   "solo_max_abs_diff": worst, "solo_tol": tol}
        print(f"server {kind}: {STREAMS} clients x {n_out} frames in {stats['wall_s']:.3f} s "
              f"({summary['x_real_time']:.0f}x real time through the sockets), {n} ticks in "
              f"{stats['polls']} polls, a ticking poll {stats['ms_per_tick_poll_best']:.2f} ms "
              f"best, {stats['ms_per_tick_poll_median']:.2f} median, hub "
              f"{stats['hub_ms_per_tick']:.3f} ms a tick; launches a tick "
              f"{summary['launches_per_tick']}; every stream against solo: max |diff| "
              f"{worst:.2e} (tol {tol:g})")
        print(json.dumps(summary))
        if worst > tol:
            raise RuntimeError(f"server {kind}: against solo {worst}")
        del ms, server
        torch.cuda.empty_cache()


def raw_model(dtype, h: int = H):
    from avvad_tpu_torch.models import RawAudioVAD

    return RawAudioVAD(lstm_hidden_size=h, lstm_layers=2, out_frames=T, dtype=dtype, seed=0)


def raw_serving_phase() -> None:
    """RawAudioVAD bf16 (WaveNet encoder, 2 x LSTM 1024, out_frames 512)
    through make_waveform_serving_fn at scripts/bench_modalities.py's shape
    (B=64, 131,840 samples an utterance): no kernel launch; probabilities
    checked and 2 utterances against the same model on the CPU; ms/step,
    x real time, peak memory, stage ms by CUDA events (encoder, LSTM, head)
    and one more step under torch.profiler. One {"profile": ...} line."""
    from avvad_tpu_torch.export import make_waveform_serving_fn

    model = raw_model(torch.bfloat16)
    fn = make_waveform_serving_fn(model)
    rng = np.random.default_rng(3)
    wave = torch.from_numpy(rng.standard_normal((B, N_SAMPLES), np.float32) * 0.3).cuda()
    print(f"raw serving: RawAudioVAD bf16, WaveNet receptive field "
          f"{model.wavenet_en.receptive_field}, 2 x LSTM {H} (plain loop), B={B}, "
          f"{N_SAMPLES} samples an utterance -> {T} frames ({B * T / FRAME_RATE:.1f} s a step)")
    reset_counts()
    probs = fn(wave)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts or probs.shape != (B, T, 1) or not torch.isfinite(probs).all() \
            or probs.min() < 0 or probs.max() > 1:
        raise RuntimeError(f"raw serving: {tuple(probs.shape)}, launches {counts}")
    cpu = copy.deepcopy(model).cpu()
    ref = make_waveform_serving_fn(cpu, device="cpu")(wave[:2].cpu())
    err = (probs[:2].cpu() - ref).abs().max().item()
    print(f"raw serving: no kernel launched; 2 utterances against the CPU: max |diff| "
          f"{err:.2e} (tol {RAW_CPU_TOL:g})")
    if not err <= RAW_CPU_TOL:
        raise RuntimeError(f"raw serving: card against CPU {err}")
    del cpu
    torch.cuda.reset_peak_memory_stats()
    reps = [spanned_step(fn, wave) for _ in range(3)]
    reps = [(dt, span_stages(recs, RAW_SERVE_MARKS, RAW_SERVE_STAGES)) for dt, recs in reps]
    step, stage_ms = min(reps, key=lambda r: r[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    audio_s = B * T / FRAME_RATE  # the label frames served, as every x real time here
    print(f"raw serving: {1e3 * step:.2f} ms/step (reps {[round(1e3 * r[0], 2) for r in reps]}), "
          f"{audio_s / step:.1f}x real time, peak mem {peak:.2f} GiB")
    print(json.dumps({"profile": "raw_serving", "ms_per_step": 1e3 * step,
                      "x_real_time": audio_s / step, "peak_mem_gib": peak,
                      "stage_ms": stage_ms, "card_vs_cpu_max_abs_diff": err,
                      **no_stem(profile_step(fn, wave))}))


def no_stem(prof: dict) -> dict:
    """A profile of a path with no int8 tower, without the stem's split."""
    return {k: v for k, v in prof.items() if k != "stem_split_ms"}


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def raw_batch(b: int, seed: int):
    """A seeded waveform batch: b utterances of N_SAMPLES samples, T label
    frames, ragged lengths in [T/2, T] (the first full)."""
    from avvad_tpu_torch.data import Batch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(T // 2, T + 1, size=b)
    lengths[0] = T
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    label = (rng.random((b, T, 1)) > 0.5).astype(np.float32) * mask[..., None]
    wave = (rng.standard_normal((b, N_SAMPLES)) * 0.3).astype(np.float32)
    return Batch(audio=None, video=None, label=label, lengths=lengths, mask=mask,
                 waveform=wave)


def raw_train_phase() -> None:
    """RawAudioVAD fp32 through make_train_step("waveform"), Adam 1e-4, TF32
    off: at B=2 one card step against the same step on the CPU (loss,
    every gradient in relative L2); at B=TRAIN_B no kernel launch, the
    loss finite, ms/step (best of 3 after a warm-up), x real time, peak
    memory, the stage split by CUDA events and one {"profile": ...} line."""
    from avvad_tpu_torch.train import create_train_state, make_train_step

    step = make_train_step("waveform")
    model = raw_model(torch.float32)
    cpu_model = copy.deepcopy(model)
    small = raw_batch(2, seed=5)
    state, metrics = step(create_train_state(model, learning_rate=1e-4), small)
    cpu_state, cpu_metrics = step(create_train_state(cpu_model, learning_rate=1e-4,
                                                     device="cpu"), small)
    loss, cpu_loss = metrics["loss"].item(), cpu_metrics["loss"].item()
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    grads = {n: p.grad for n, p in model.named_parameters()}
    cpu_grads = dict(cpu_model.named_parameters())
    grad_err = max(rel_l2(g.cpu(), cpu_grads[n].grad) for n, g in grads.items())
    print(f"raw train: RawAudioVAD fp32, 2 x LSTM {H}, B=2 against the CPU: loss {loss:.6f} "
          f"rel {loss_err:.2e} (tol {STEP_LOSS_REL_TOL:g}), grads rel L2 {grad_err:.2e} "
          f"(tol {STEP_GRAD_REL_TOL:g}) over {len(grads)} tensors")
    if not (np.isfinite(loss) and loss_err <= STEP_LOSS_REL_TOL
            and grad_err <= STEP_GRAD_REL_TOL):
        raise RuntimeError(f"raw train: card against CPU loss {loss_err}, grads {grad_err}")
    del state, cpu_state, cpu_model, model
    torch.cuda.empty_cache()

    state = create_train_state(raw_model(torch.float32), learning_rate=1e-4)
    batch = raw_batch(TRAIN_B, seed=6)
    reset_counts()
    state, metrics = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    if counts or not np.isfinite(metrics["loss"].item()):
        raise RuntimeError(f"raw train: launches {counts}, loss {metrics['loss'].item()}")
    torch.cuda.reset_peak_memory_stats()
    reps = [timed_train_step(step, state, batch) for _ in range(3)]
    dt, stage_ms = min(reps, key=lambda r: r[0])
    peak = torch.cuda.max_memory_allocated() / 2**30
    audio_s = TRAIN_B * T / FRAME_RATE
    print(f"raw train: B={TRAIN_B} T={T}, no kernel launched, loss "
          f"{metrics['loss'].item():.6f}; {1e3 * dt:.2f} ms/step (reps "
          f"{[round(1e3 * r[0], 2) for r in reps]}), {audio_s / dt:.1f}x real time, "
          f"peak mem {peak:.2f} GiB")
    print(json.dumps({"profile": "train/waveform", "ms_per_step": 1e3 * dt,
                      "x_real_time": audio_s / dt, "peak_mem_gib": peak,
                      "stage_ms": stage_ms, **no_stem(profile_step(step, state, batch))}))


# --- scale-out: the mesh phase ----------------------------------------------

MESH_DIR = BUILD / "mesh"
MESH_RANKS = 2  # gloo ranks on the one card (NCCL refuses two on one device)
MESH_SPAWN_S = 420
MESH_THREADS = 4  # CPU threads a rank: the card's machine has 8 cores
MESH_UTTS = CORPUS_SPLITS["test"]  # the corpus phase's in-script test split
MESH_EVAL_B = CORPUS_EVAL_B
MESH_EVAL_TOL = 1e-4
MESH_SERVE_TOL = 1e-6  # fp32 float parts
# bf16 float parts: read 3.87e-6 on the card (a shard's GEMMs see 16 rows,
# not 32, and a changed fp32 rounding can flip a bf16 rounding of the
# carried state); the bound keeps a margin of ten over that reading
MESH_SERVE_BF16_TOL = 5e-5
MESH_DROPOUT = 0.3  # the dropout rate of the mesh phase's dropout steps


def mesh_av_model(dropout_rate: float = 0.0):
    """The full-width fp32 AV train model of phase 8 (MCB 1024, 2 x LSTM
    1024), from its seed."""
    from avvad_tpu_torch.models import AVVAD

    return AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                 use_kernel_lstm=True, dropout_rate=dropout_rate, seed=0)


def mesh_int8_model(dtype=torch.bfloat16):
    """The int8-tower serving model of phase 6 (its scales loaded from the
    parent's calibrated copy); ``dtype`` of its float parts."""
    from avvad_tpu_torch.models import AVVAD

    return AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                 dtype=dtype, use_kernel_lstm=True, tower_int8=True,
                 tower_quant_mode="static", tower_pallas=True, seed=0)


def nonzero_counts() -> dict:
    return {k: v for k, v in launch_counts().items() if v}


def train_launches(b: int, k4: bool) -> tuple[dict, str]:
    """The K1d / K1e launches of one AV train step at B=b, T=T, H=H, by the
    route ``persistent_plan`` picks, and K4's where ``k4`` (the trunk frozen,
    no data group) -> (expected counts, route)."""
    from avvad_tpu_torch.ops import lstm_fused

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bn = k4_launches() if k4 else {}
    if lstm_fused.persistent_plan(b, H, sms) is not None:
        return {"fwd_train_persist": 2, "bwd_persist": 2, **bn}, "persistent"
    return {"fwd_train": 2 * T, "bwd": 2 * (T + 1), **bn}, "per-step"


def mesh_nccl_phase() -> None:
    """(a) NCCL, world size 1, mesh 1 x 1: Trainer(mesh=) takes one
    full-width AV train step (phase 8's model and batch); the updated
    parameters and BatchNorm statistics equal the unmeshed step's bit for
    bit (both on cuDNN's deterministic algorithms). Then the same step with
    dropout (``mesh_dropout``)."""
    import torch.distributed as dist

    from avvad_tpu_torch.parallel import initialize_multihost, make_mesh
    from avvad_tpu_torch.parallel.distributed import free_port
    from avvad_tpu_torch.train import Trainer, create_train_state, make_train_step

    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl", device="cuda:0")
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(1, 1, devices=["cuda:0"])
        batch = train_batch(T, TRAIN_B, "av", seed=8)
        ref = create_train_state(mesh_av_model(), learning_rate=1e-4, freeze_video_trunk=True)
        make_train_step("av")(ref, batch)
        state = create_train_state(mesh_av_model(), learning_rate=1e-4,
                                   freeze_video_trunk=True, device="cuda:0")
        trainer = Trainer(state, "av", str(MESH_DIR / "nccl"), mesh=mesh)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_epoch([batch], epoch=1)
        torch.cuda.synchronize()
        counts = nonzero_counts()
        expect, route = train_launches(TRAIN_B, k4=True)  # world 1: no data group
        got, want = state.model.state_dict(), ref.model.state_dict()
        unequal = [k for k in want if not torch.equal(got[k], want[k])]
        del ref
        torch.cuda.empty_cache()
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            reps.append(1e3 * (time.perf_counter() - t0))
        line = {"mesh": "a/nccl_world1", "backend": dist.get_backend(), "axes": [1, 1],
                "b": TRAIN_B, "t": T, "launches": counts, "k1de_route": route,
                "bit_equal": not unequal, "tensors_compared": len(want),
                "ms": min(reps), "ms_reps": reps,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        del trainer, state
        torch.cuda.empty_cache()
        line["dropout"] = mesh_dropout(mesh, batch)
        print(json.dumps(line))
        if unequal or counts != expect or not line["dropout"]["bit_equal"]:
            raise RuntimeError(f"mesh (a): unequal {unequal[:5]}, launches {counts} "
                               f"against {expect}, dropout {line['dropout']}")
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()


def mesh_dropout(mesh, batch) -> dict:
    """(a) with dropout at MESH_DROPOUT after the LSTM stack: the meshed
    step (world 1) against the unmeshed one, bit for bit (the masks drawn
    on the card from the same (seed, step)); the step's ms against the
    step without dropout in the same call, and the draw of the global
    batch's mask alone (CUDA events)."""
    from avvad_tpu_torch.models.vad_nets import DropoutRNG, dropout_generator
    from avvad_tpu_torch.parallel import shard_opt_state, shard_params
    from avvad_tpu_torch.train import create_train_state, make_train_step

    ms, states = {}, {}
    for label, rate, m in (("no_dropout", 0.0, None), ("unmeshed", MESH_DROPOUT, None),
                           ("meshed", MESH_DROPOUT, mesh)):
        state = create_train_state(mesh_av_model(rate), learning_rate=1e-4,
                                   freeze_video_trunk=True, device="cuda:0")
        if m is not None:
            shard_params(m, state.model)
            shard_opt_state(m, state.optimizer)
        step = make_train_step("av", dropout=rate > 0, dropout_seed=11, mesh=m)
        step(state, batch)
        states[label] = {k: v.clone() for k, v in state.model.state_dict().items()}
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            reps.append(1e3 * (time.perf_counter() - t0))
        ms[label] = min(reps)
        del state, step
        torch.cuda.empty_cache()
    got, want = states["meshed"], states["unmeshed"]
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    shape = (TRAIN_B, T, H)  # the dropout site: the LSTM stack's output
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    draws = []
    for k in range(6):
        rng = DropoutRNG(dropout_generator(11, k, "cuda:0"))
        start.record()
        keep = rng.keep(shape, 1.0 - MESH_DROPOUT)
        end.record()
        torch.cuda.synchronize()
        draws.append(start.elapsed_time(end))
    return {"rate": MESH_DROPOUT, "bit_equal": not unequal, "tensors_compared": len(want),
            "kept_share": keep.float().mean().item(), "draw_entries": int(np.prod(shape)),
            "draw_ms": min(draws[1:]), "step_ms": ms["meshed"],
            "step_ms_unmeshed": ms["unmeshed"], "step_ms_no_dropout": ms["no_dropout"]}


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-30)).item()


def mesh_rank(out_dir: str) -> dict:
    """(b) One of two gloo ranks on the one card: the full-width AV train
    step at data 2 (B=8 a rank), at model 2 (the (1024, 4096) w_ih /
    w_hh column-sharded, B=16 on both ranks) and at data 2 with dropout
    (each rank keeps its rows of the global batch's mask), each against
    the single-process step on the global batch (rank 0 runs it), with
    the rank's K1d / K1e launches and a checkpoint round trip under the
    mesh (not repeated for dropout)."""
    import torch.distributed as dist

    from avvad_tpu_torch.parallel import (initialize_multihost, make_mesh, shard_batch,
                                          shard_opt_state, shard_params)
    from avvad_tpu_torch.parallel.mesh import (full_optimizer_state, full_state_dict,
                                               gather_columns, is_sharded, unsharded_name)
    from avvad_tpu_torch.train import (create_train_state, make_train_step,
                                       restore_checkpoint, save_checkpoint)

    initialize_multihost(backend="gloo")
    rank = dist.get_rank()
    batch = train_batch(T, TRAIN_B, "av", seed=8)
    refs = {}
    if rank == 0:
        for rate in (0.0, MESH_DROPOUT):
            ref_state = create_train_state(mesh_av_model(rate), learning_rate=1e-4,
                                           freeze_video_trunk=True, device="cuda:0")
            _, m = make_train_step("av", dropout=rate > 0, dropout_seed=11)(ref_state, batch)
            refs[rate] = ({n: p.grad for n, p in ref_state.model.named_parameters()
                           if p.grad is not None}, m["loss"].item())
            del ref_state
    out = {"rank": rank}
    for label, n_data, n_model, rate in (("data2", 2, 1, 0.0), ("model2", 1, 2, 0.0),
                                         ("data2_dropout", 2, 1, MESH_DROPOUT)):
        ref = refs.get(rate)
        mesh = make_mesh(n_data, n_model, devices=["cuda:0"] * MESH_RANKS)
        state = create_train_state(mesh_av_model(rate), learning_rate=1e-4,
                                   freeze_video_trunk=True, device="cuda:0")
        shard_params(mesh, state.model)
        shard_opt_state(mesh, state.optimizer)
        step = make_train_step("av", dropout=rate > 0, dropout_seed=11, mesh=mesh)
        local = shard_batch(mesh, batch)
        # a data axis of 2 takes the global batch's statistics on autograd
        expect, route = train_launches(local.audio.shape[0], k4=n_data == 1)
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
        counts = nonzero_counts()
        grads = {}
        for n, p in state.model.named_parameters():
            if p.grad is not None:
                grads[unsharded_name(n)] = (gather_columns(p.grad, mesh.group("model"),
                                                           p.tp_shards)
                                            if is_sharded(p) else p.grad)
        res = {"axes": [n_data, n_model], "b_rank": int(local.audio.shape[0]), "dropout": rate,
               "k1de_route": route, "launches": counts, "launches_ok": counts == expect,
               "loss": m["loss"].item(), "first_step_ms": first_ms,
               "sharded": sorted(unsharded_name(n) for n, p in state.model.named_parameters()
                                 if is_sharded(p))}
        if ref is not None:
            res["loss_rel"] = abs(res["loss"] - ref[1]) / abs(ref[1])
            res["grad_rel_l2"] = max(_rel_l2(grads[k], ref[0][k]) for k in ref[0])
            res["grads_compared"] = len(ref[0]) if set(grads) == set(ref[0]) else -1
        reps = []
        for _ in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, local)
            torch.cuda.synchronize()
            reps.append(1e3 * (time.perf_counter() - t0))
        res.update(ms=min(reps), ms_reps=reps,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        out[label] = res
        if rate > 0:
            del state, grads
            torch.cuda.empty_cache()
            continue
        # checkpoint round trip: rank 0 writes the gathered state, every
        # rank restores it into a fresh sharded state
        saved = full_state_dict(state.model)
        saved_opt = full_optimizer_state(state.optimizer, mesh.group("model"))
        path = save_checkpoint(os.path.join(out_dir, label), state, epoch=1,
                               valid_loss=res["loss"], mesh=mesh)
        fresh = create_train_state(mesh_av_model(), learning_rate=1e-4,
                                   freeze_video_trunk=True, device="cuda:0")
        shard_params(mesh, fresh.model)
        shard_opt_state(mesh, fresh.optimizer)
        restore_checkpoint(path, fresh, mesh=mesh)
        back = full_state_dict(fresh.model)
        back_opt = full_optimizer_state(fresh.optimizer, mesh.group("model"))["state"]
        res["ckpt_bit_equal"] = (set(back) == set(saved)
                                 and all(torch.equal(back[k], saved[k]) for k in saved)
                                 and all(torch.equal(back_opt[i][k].cpu(), v.cpu())
                                         for i, st in saved_opt["state"].items()
                                         for k, v in st.items()))
        del state, fresh, grads, saved, saved_opt, back, back_opt
        torch.cuda.empty_cache()
    return out


def mesh_ranks_phase() -> None:
    """(b) Two gloo ranks on the one card (see ``mesh_rank``): loss within
    1e-5 and every gradient within 1e-3 in relative L2 of the
    single-process step (phase 8's gates), 2 + 2 K1d / K1e launches a rank
    and a step by the route ``persistent_plan`` picks for its rows, the
    checkpoint bit for bit (without dropout)."""
    from avvad_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    results = spawn("chip_smoke:mesh_rank", MESH_RANKS, args=[str(MESH_DIR / "ranks")],
                    timeout_s=MESH_SPAWN_S, threads=MESH_THREADS)
    wall = time.perf_counter() - t0
    for label in ("data2", "model2", "data2_dropout"):
        ranks = [r[label] for r in results]
        r0 = ranks[0]
        line = {"mesh": f"b/gloo_2ranks_one_card/{label}", "backend": "gloo",
                "axes": r0["axes"], "b_per_rank": r0["b_rank"], "t": T,
                "dropout": r0["dropout"],
                "k1de_route": r0["k1de_route"],
                "launches_per_rank": [r["launches"] for r in ranks],
                "loss_rel": r0["loss_rel"], "grad_rel_l2": r0["grad_rel_l2"],
                "grads_compared": r0["grads_compared"], "sharded": r0["sharded"],
                "ckpt_bit_equal": [r.get("ckpt_bit_equal") for r in ranks],
                "ms": [r["ms"] for r in ranks], "ms_reps": [r["ms_reps"] for r in ranks],
                "first_step_ms": [r["first_step_ms"] for r in ranks],
                "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
                "spawn_wall_s": wall}
        print(json.dumps(line))
        bad = (not all(r["launches_ok"] and r.get("ckpt_bit_equal", r["dropout"] > 0)
                       for r in ranks)
               or r0["loss_rel"] > STEP_LOSS_REL_TOL or r0["grad_rel_l2"] > STEP_GRAD_REL_TOL
               or r0["grads_compared"] <= 0 or (label == "model2") != bool(r0["sharded"]))
        if bad:
            raise RuntimeError(f"mesh (b) {label}: {line}")


def mesh_serving_phase(int8_model) -> None:
    """(c) MultiStreamAVVAD with the static-int8 tower (the streaming
    phase's wire: span int16 hop_dft, 30 fps uint8), sharded over
    ["cuda:0"] * 2, against the unsharded server over TICKS ticks of the
    streaming data, K3 2 and K2 16 a tick; with fp32 float parts (the
    calibrated weights and scales of phase 6's model) every stream within
    MESH_SERVE_TOL, with the served bf16 ones within MESH_SERVE_BF16_TOL
    (see there)."""
    fp32 = mesh_int8_model(torch.float32)
    fp32.load_state_dict(int8_model.state_dict())
    for label, model, tol in (("fp32", fp32.cuda(), MESH_SERVE_TOL),
                              ("bf16", int8_model, MESH_SERVE_BF16_TOL)):
        mesh_serving_run(model, label, tol)
    del fp32
    torch.cuda.empty_cache()


def mesh_serving_run(model, label: str, tol: float) -> None:
    from avvad_tpu_torch import serve
    from avvad_tpu_torch.ops import conv_fused, stem_fused
    from avvad_tpu_torch.parallel import make_mesh

    pcm, video, _ = stream_data()
    kw = dict(block_frames=BLOCK, video_fps=30.0, video_uint8=True, span_wire=True,
              hop_dft=True, audio_int16=True)
    plain = serve.MultiStreamAVVAD(model, STREAMS, **kw)
    sharded = serve.MultiStreamAVVAD(model, STREAMS,
                                     mesh=make_mesh(2, 1, devices=["cuda:0"] * 2), **kw)
    plain.warmup()
    sharded.warmup()
    expect = {stem_fused.NHWC_KERNEL_NAME: 2, conv_fused.KERNEL_NAME: 16}
    err, bad_ticks, ms = 0.0, [], {"sharded": [], "plain": []}
    torch.cuda.reset_peak_memory_stats()
    for k in range(TICKS):
        feed_tick(plain, pcm[k], video[k], False)
        feed_tick(sharded, pcm[k], video[k], False)
        reset_counts()
        t0 = time.perf_counter()
        got = sharded.tick()
        ms["sharded"].append(1e3 * (time.perf_counter() - t0))
        counts = nonzero_counts()
        if counts != expect:
            bad_ticks.append((k, counts))
        t0 = time.perf_counter()
        want = plain.tick()
        ms["plain"].append(1e3 * (time.perf_counter() - t0))
        check_tick(got, f"mesh (c) tick {k}")
        err = max(err, max(float(np.abs(got[i] - want[i]).max()) for i in want))
    line = {"mesh": f"c/serving_int8_tower_2shards/{label}", "devices": ["cuda:0", "cuda:0"],
            "streams": STREAMS, "block_frames": BLOCK, "ticks": TICKS,
            "launches_per_tick": expect if not bad_ticks else bad_ticks[:3],
            "max_abs_diff": err, "tol": tol,
            "ms_per_tick_best": {k: min(v) for k, v in ms.items()},
            "ms_per_tick_median": {k: float(np.median(v)) for k, v in ms.items()},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(json.dumps(line))
    if bad_ticks or not err <= tol:
        raise RuntimeError(f"mesh (c): {line}")


def mesh_eval_rank(out_dir: str, weights: str) -> dict:
    """(d) One of two gloo ranks: ``evaluate_split(mesh=)`` of the int8-tower
    model (state_quant none) over the in-script test utterances, with the
    rank's launch counts."""
    from avvad_tpu_torch.evaluate import evaluate_split
    from avvad_tpu_torch.parallel import initialize_multihost, make_mesh
    from avvad_tpu_torch.train.state import TrainState

    initialize_multihost(backend="gloo")
    model = mesh_int8_model()
    model.load_state_dict(torch.load(weights, weights_only=True))
    model.set_lstm_state_quant("none")
    state = TrainState(model.cuda().eval(), None, torch.device("cuda:0"))
    mesh = make_mesh(2, 1, devices=["cuda:0"] * MESH_RANKS)
    src = SyntheticCorpus("test", MESH_UTTS, seed=0)
    # a first pass warms the process (library handles, the tower's fold)
    evaluate_split(state, src, "av", out_dir + "_warm", batch_size=MESH_EVAL_B,
                   verbose=False, mesh=mesh)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    report = evaluate_split(state, src, "av", out_dir, batch_size=MESH_EVAL_B,
                            verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    return {"report": report, "launches": nonzero_counts(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def mesh_evaluate_phase(int8_model) -> None:
    """(d) ``evaluate_split(mesh=)`` over the in-script corpus on two gloo
    ranks (data 2 on the one card) against the unmeshed run: every soft
    prediction within 1e-4, the same files, the launches of each rank (K3
    1, K2 8 and K1a 2 a batch)."""
    from avvad_tpu_torch.evaluate import evaluate_split
    from avvad_tpu_torch.parallel import spawn
    from avvad_tpu_torch.train.state import TrainState

    saved_sq = int8_model.lstm_merged.layer_0.state_quant
    int8_model.set_lstm_state_quant("none")
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    weights = str(MESH_DIR / "int8_model.pt")
    torch.save(int8_model.state_dict(), weights)
    single, meshed = MESH_DIR / "eval_single", MESH_DIR / "eval_meshed"
    src = SyntheticCorpus("test", MESH_UTTS, seed=0)
    reset_counts()
    ref = evaluate_split(TrainState(int8_model, None, torch.device("cuda")), src, "av",
                         str(single), batch_size=MESH_EVAL_B, verbose=False)
    torch.cuda.synchronize()
    ref_counts = nonzero_counts()
    int8_model.set_lstm_state_quant(saved_sq)
    t0 = time.perf_counter()
    ranks = spawn("chip_smoke:mesh_eval_rank", MESH_RANKS, args=[str(meshed), weights],
                  timeout_s=MESH_SPAWN_S, threads=MESH_THREADS)
    wall = time.perf_counter() - t0
    want = sorted(p.relative_to(single) for p in single.rglob("*_soft.npy"))
    got = sorted(p.relative_to(meshed) for p in meshed.rglob("*_soft.npy"))
    err = max(float(np.abs(np.load(meshed / r) - np.load(single / r)).max()) for r in want)
    n_batches = -(-MESH_UTTS // MESH_EVAL_B)
    line = {"mesh": "d/evaluate_split_2ranks_one_card", "backend": "gloo", "axes": [2, 1],
            "utterances": MESH_UTTS, "batch_size": MESH_EVAL_B, "batches": n_batches,
            "files_equal": got == want and len(want) == MESH_UTTS,
            "max_abs_diff": err, "tol": MESH_EVAL_TOL,
            "launches_unmeshed": ref_counts,
            "launches_per_rank": [r["launches"] for r in ranks],
            "ms": {"unmeshed": 1e3 * ref["elapsed_s"],
                   "meshed": 1e3 * ranks[0]["report"]["elapsed_s"]},
            "rt_factor": {"unmeshed": ref["rt_factor"],
                          "meshed": ranks[0]["report"]["rt_factor"]},
            "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
            "spawn_wall_s": wall}
    print(json.dumps(line))
    from avvad_tpu_torch.ops import conv_fused, stem_fused

    for r in ranks:
        c = r["launches"]
        k1 = sum(v for k, v in c.items() if k in ("none", "none_persist"))
        if (c.get(stem_fused.NHWC_KERNEL_NAME) != n_batches
                or c.get(conv_fused.KERNEL_NAME) != 8 * n_batches or k1 != 2 * n_batches
                or r["report"]["n_utterances"] != MESH_UTTS):
            raise RuntimeError(f"mesh (d): rank launches {c}, report {r['report']}")
    if not line["files_equal"] or not err <= MESH_EVAL_TOL:
        raise RuntimeError(f"mesh (d): {line}")


def mesh_phase(int8_model) -> None:
    """Scale-out on the one card: (a) NCCL world 1, (b) two gloo ranks'
    train steps, (c) the sharded AV server, (d) the sharded evaluate_split;
    one {"mesh": ...} line each. The kernels are built once, by this
    process, before the ranks start (``_build.build`` at the top of main):
    two ranks would each run nvcc. Two ranks on one card time-slice it, so
    their times are no scaling figure."""
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    mesh_nccl_phase()
    torch.cuda.empty_cache()
    mesh_ranks_phase()
    mesh_serving_phase(int8_model)
    torch.cuda.empty_cache()
    mesh_evaluate_phase(int8_model)
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s")


# --- the timers (avvad_tpu_torch/scripts/bench*.py) ---------------------------

# short loops: every twin at full width, each program timed a few times
TIMER_ITERS, TIMER_REPS, TIMER_TICKS, TIMER_TRIPWIRE_N = 2, 2, 8, 512
# a timed serving program's first output against the same program on the
# plain K1 / K2 / K3 versions (PROB_TOL's readings); the tripwire's fused
# trunk against plain K2 / K3: bit for bit
TIMER_PROB_TOL = 1e-4
# launch counters -> rows of the kernels line
ROW_OF = {"int8_basic_block": "k2", "stem_epilogue_pool_nhwc": "k3_nhwc",
          "stem_epilogue_pool": "k3", "bn_stats": "k4", "bn_apply": "k4"}


@contextlib.contextmanager
def bench_env(**env):
    """os.environ with ``env`` set (None: unset) for the block."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, str(v))
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


def add_launches(rows: dict, counts: dict) -> None:
    """The timed runs' launches added to the kernels line's rows."""
    for name, n in counts.items():
        key = ROW_OF.get(name, name)
        if n and key in rows:
            rows[key]["launches"] += n


def check_records(records: list, label: str) -> None:
    """Every record has a finite, positive value."""
    if not records:
        raise RuntimeError(f"timers {label}: no record")
    for rec in records:
        json.loads(json.dumps(rec))
        v = rec.get("value")
        if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0):
            raise RuntimeError(f"timers {label}: bad record {rec}")


def first_output_check(fn, expect: dict, label: str, plain: bool = True) -> float:
    """One call of ``fn()`` with the counters at 0: its launches must be
    ``expect``; its output, finite, against the same call on the plain
    K1 / K2 / K3 versions -> max |diff|."""
    from avvad_tpu_torch.ops import lstm_fused

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    expect_launches(launch_counts(), expect, label)
    out = torch.as_tensor(out).float()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{label}: output not finite")
    if not plain:
        return 0.0
    with plain_k2_k3(), plain_inference(lstm_fused):
        ref = torch.as_tensor(fn()).float()
    err = (out - ref).abs().max().item()
    if err > TIMER_PROB_TOL:
        raise RuntimeError(f"{label}: first output vs plain {err} (tol {TIMER_PROB_TOL})")
    return err


def timer_run(rows: dict, name: str, fn, expect: dict | None = None):
    """A twin's ``main`` with the counters at 0 just before -> its records;
    the launches of its timed runs added to ``rows`` and held to ``expect``
    where given; one {"timers": ...} line. ``fn(checked)`` runs the twin;
    ``checked(check)`` wraps a check as the twin's callback: the launches
    so far are taken first, and the check's own are cleared after it."""
    reset_counts()
    seen: dict = {}

    def take():
        torch.cuda.synchronize()
        counts = nonzero_counts()
        add_launches(rows, counts)
        for k, v in counts.items():
            seen[k] = seen.get(k, 0) + v
        reset_counts()

    def checked(check):
        def callback(*args):
            take()
            check(*args)
            reset_counts()
        return callback

    t0 = time.perf_counter()
    records = fn(checked)
    take()
    wall = time.perf_counter() - t0
    records = records if isinstance(records, list) else [records]
    print(json.dumps({"timers": name, "wall_s": wall, "launches": seen,
                      "records": records}))
    if expect is not None and seen != {k: v for k, v in expect.items() if v}:
        raise RuntimeError(f"timers {name}: launches {seen}, expected {expect}")
    return records


def timers_phase(rows: dict) -> None:
    """Each timer twin's main at full width with short loops: bench's serving
    ladder (int8 tower on K3 + 8 x K2; the five candidates), the train
    matrix, the tripwire at N=512, the three modalities, the streaming ticks
    (--av --av-int8 --av-u8 --audio-int16), the wire A/B (audio and AV) and
    the artifact overhead. Every record parses with a finite, positive
    value; the launches a timed call are held to the table of the kernels
    (whole runs where the count is exact, one check call otherwise); each
    timed serving program's first output within TIMER_PROB_TOL of its plain
    route, the tripwire's fused trunk bit for bit."""
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused
    from avvad_tpu_torch.scripts import (bench, bench_artifact_overhead, bench_modalities,
                                         bench_streaming, bench_wire_ab)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k2, k3 = conv_fused.KERNEL_NAME, stem_fused.NHWC_KERNEL_NAME
    tower = {k2: 8, k3: 1}
    loops = dict(AVVAD_BENCH_ITERS=TIMER_ITERS, AVVAD_BENCH_REPS=TIMER_REPS)

    # (1) serving: the AUTO ladder, shipped config
    def serving(checked):
        def check(sb, serves):
            for name, serve in serves.items():
                sq = {"lstm_bf16": "bf16", "lstm_int8": "int8"}.get(name.split("+")[0],
                                                                     "none")
                err = first_output_check(lambda s=serve: s(sb.wave, sb.video),
                                         {**tower, sq + "_persist": 2},
                                         f"timers bench/{name}")
                print(f"timers bench/{name}: first output vs plain K1/K2/K3 {err:.2e}")

        with bench_env(**loops, AVVAD_BENCH_WRITE_HISTORY=None):
            return bench.serving_main(dev, on_serving=checked(check))

    rec = timer_run(rows, "bench", serving)
    check_records(rec, "bench")
    torch.cuda.empty_cache()

    # (2) the train matrix: 1 + REPS x ITERS steps a config, K1d / K1e 2 + 2
    # each, K4's 20 + 17 in each of the frozen AV config's
    steps = 4 * (1 + TIMER_REPS * TIMER_ITERS)
    with bench_env(**loops):
        rec = timer_run(rows, "bench --train-matrix",
                        lambda _c: bench.main(["--train-matrix"]),
                        {"fwd_train_persist": 2 * steps, "bwd_persist": 2 * steps,
                         **k4_launches(steps // 4)})
    check_records(rec[0]["configs"], "train matrix")
    torch.cuda.empty_cache()

    # (3) the tripwire: the fused trunk (K3 + 8 K2 a call) and K3 alone, each
    # 1 + REPS x ITERS calls; the unfused route and the plain K3 launch nothing
    calls = 1 + TIMER_REPS * TIMER_ITERS
    trip = {}

    def tripwire(checked):
        def keep(trunk, x):
            trip.update(trunk=trunk, x=x)

        return bench.kernel_tripwire_main(dev, on_trunk=checked(keep))

    with bench_env(**loops, AVVAD_TRIPWIRE_N=TIMER_TRIPWIRE_N):
        rec = timer_run(rows, "bench --kernel-tripwire", tripwire,
                        {k2: 8 * calls, k3: 2 * calls})
    rows_trip = rec[0]["results"]
    check_records([{"value": r[k]} for r in rows_trip for k in ("kernel_ms", "unfused_ms")],
                  "tripwire")
    trunk, x = trip["trunk"], trip["x"]
    trunk.stages_pallas = True
    with torch.inference_mode():
        fused = trunk(x)
        with plain_k2_k3():
            plain = trunk(x)
    if not torch.equal(fused, plain):
        raise RuntimeError(f"tripwire: fused trunk vs plain K2/K3 "
                           f"{(fused - plain).abs().max().item()}")
    print(f"timers tripwire: fused trunk features (N={TIMER_TRIPWIRE_N}) bit for bit "
          "equal to plain K2/K3")
    del trip, trunk, x
    torch.cuda.empty_cache()

    # (4) the modalities
    lstm = {"none_persist": 2}
    expect_cfg = {"audio": lstm, "wavenet": {}, "video": {**tower, **lstm}}

    def modalities(checked):
        def check(name, serve, inputs):
            err = first_output_check(lambda: serve(*inputs), expect_cfg[name],
                                     f"timers modalities/{name}", plain=name != "wavenet")
            print(f"timers modalities/{name}: first output vs plain {err:.2e}")

        return bench_modalities.main(["--iters", str(TIMER_ITERS), "--rounds",
                                      str(TIMER_REPS)], on_config=checked(check))

    # whole run: 3 + REPS x ITERS calls a configuration; the video model's
    # calibration runs its LSTM once at B=2
    calls = 3 + TIMER_REPS * TIMER_ITERS
    expect = {k2: 8 * calls, k3: calls}
    for variant, n in ((lstm_fused.infer_variant("none", B, H, sms), 4 * calls),
                       (lstm_fused.infer_variant("none", 2, H, sms), 2)):
        expect[variant] = expect.get(variant, 0) + n
    check_records(timer_run(rows, "bench_modalities", modalities, expect), "modalities")
    torch.cuda.empty_cache()

    # (5) the streaming ticks: the AV int8 tick K3 1 + K2 8; the audio tick
    # (a carried plain loop) nothing
    def streaming(checked):
        def check(kind, srv):
            if kind != "av":
                return
            chunk, chunk_i, vchunk = bench_streaming.stream_chunks(srv.block_frames)

            def tick():
                srv.reset()
                for i in range(srv.n):
                    srv.feed(i, pcm=np.concatenate([chunk_i, chunk_i]), video_frames=vchunk)
                out = srv.tick(fetch=True)
                return np.stack([out[i] for i in range(srv.n)])

            err = first_output_check(tick, tower, "timers streaming/av")
            print(f"timers streaming/av: a tick vs plain K2/K3 {err:.2e}")

        return bench_streaming.main(["--av", "--av-int8", "--av-u8", "--audio-int16",
                                     "--ticks", str(TIMER_TICKS)], on_server=checked(check))

    # whole run: the AV ticks (sync and pipelined, 1 + TICKS each) and the
    # calibration's LSTM at B=1; the audio ticks launch nothing
    ticks = 2 * (1 + TIMER_TICKS)
    check_records(timer_run(rows, "bench_streaming", streaming,
                            {k2: 8 * ticks, k3: ticks,
                             lstm_fused.infer_variant("none", 1, H, sms): 2}), "streaming")
    torch.cuda.empty_cache()

    # (6) the wire A/B, audio then AV (K3 1 + K2 8 a tick; 2 arms x (a warm
    # round and one timed round) x (1 + TICKS) ticks; each arm's calibration
    # runs the model once, its LSTM on the inference kernel at B=1)
    ab = ["--ticks", str(TIMER_TICKS), "--rounds", "1"]
    check_records(timer_run(rows, "bench_wire_ab", lambda _c: bench_wire_ab.main(ab), {}),
                  "wire A/B audio")
    ticks = 2 * 2 * (1 + TIMER_TICKS)
    check_records(timer_run(rows, "bench_wire_ab --av",
                            lambda _c: bench_wire_ab.main([*ab, "--av"]),
                            {k2: 8 * ticks, k3: ticks,
                             lstm_fused.infer_variant("none", 1, H, sms): 2 * 2}),
                  "wire A/B AV")
    torch.cuda.empty_cache()

    # (7) the artifact overhead: the live step and the replay, K1a 2 a call
    variant = lstm_fused.infer_variant("none", 8, H, sms)

    def artifact(checked):
        def check(fn, art, wave, video):
            err = first_output_check(lambda: fn(wave, video), {variant: 2},
                                     "timers artifact/live")
            reset_counts()
            replay = art.call("e", wave, video)
            torch.cuda.synchronize()
            expect_launches(launch_counts(), {variant: 2}, "timers artifact/replay")
            if not torch.equal(replay, fn(wave, video)):
                raise RuntimeError("timers artifact: replay differs from the live step")
            print(f"timers artifact: live vs plain {err:.2e}, replay bit for bit")

        return bench_artifact_overhead.main(["--iters", str(TIMER_ITERS)],
                                            on_built=checked(check))

    check_records(timer_run(rows, "bench_artifact_overhead", artifact), "artifact")
    torch.cuda.empty_cache()
    print(f"timers phase: {time.perf_counter() - t_phase:.1f} s")


# --- the command-line entry points -------------------------------------------

CLI_TRAIN_B, CLI_EVAL_B, CLI_CAL_UTTS, CLI_CAL_B = 16, 8, 8, 4
CLI_LR = 1e-4


def cli_reference_pt(path: Path, seed: int = 0) -> None:
    """A reference-layout (DeepVAD_{AV,video,audio}) torch state dict at full
    width (MCB 1024, 2 x LSTM 1024) from the seed,
    ``utils.torch_import.random_reference_state`` with the LSTM and head
    weights at 1/sqrt(H)."""
    from avvad_tpu_torch.utils.torch_import import random_reference_state

    state = random_reference_state(seed, H, 1024, lstm_std=H ** -0.5, head_std=H ** -0.5)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}, path)


def cli_state(model_dir: Path, which: str) -> dict:
    """A port checkpoint's model state dict: the model dir's ``latest`` or
    its ``first`` (by epoch)."""
    from avvad_tpu_torch.train import latest_checkpoint

    ckpt = (latest_checkpoint(str(model_dir)) if which == "latest"
            else str(min(model_dir.glob("epoch_*"))))
    return torch.load(Path(ckpt) / "state.pt", map_location="cpu", weights_only=True)["model"]


def cli_run(name: str, fn, argv: list, expect: dict | None = None):
    """``fn(argv)`` (a twin's ``main`` or ``build_server``) with the launch
    counters set to 0 just before and read just after -> (its result, the
    launches); one {"cli": ...} line. ``expect``: the launches it must
    have made (nothing else)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = nonzero_counts()
    print(json.dumps({"cli": name, "wall_s": wall, "launches": counts}))
    if expect is not None and counts != {k: v for k, v in expect.items() if v}:
        raise RuntimeError(f"cli {name}: launches {counts}, expected {expect}")
    return out, counts


def cli_phase(route: dict, tmp: str) -> None:
    """Each command-line twin's ``main(argv)`` in process at full width
    (AVVAD: ResNet-18, MCB 1024, 2 x LSTM 1024; VideoVAD) on the corpus
    phase's tree (which ``create_train_files`` built there), the launch
    counters read around each: import of a seeded reference ``.pt``, one
    epoch of train --resume, evaluate (static-int8 tower on K3 / K2, int8 state) against
    the in-process evaluate_split bit for bit, run_metrics, reconstruct,
    export_serving (the replay against the live step bit for bit), the
    artifact-driven server (build_server) with STREAMS localhost clients
    against a solo streamer, and stream_demo on one wav. One {"cli": ...}
    line a twin."""
    from avvad_tpu_torch.data import AudioVisualSource, DataLoader
    from avvad_tpu_torch.evaluate import calibrate_quant_scales, evaluate_split
    from avvad_tpu_torch.export import (ServingArtifact, export_multistream_server,
                                        make_waveform_serving_fn)
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused
    from avvad_tpu_torch.scripts import (evaluate, export_serving, import_checkpoint,
                                         reconstruct, run_metrics, serve_server,
                                         stream_demo, train)
    from avvad_tpu_torch.scripts._common import build_model, restore
    from avvad_tpu_torch.serve import MultiStreamAVVAD, StreamingAVVAD
    from avvad_tpu_torch.server import av_stream_client
    from avvad_tpu_torch.train.state import TrainState

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    root = Path(tmp) / "cli"
    root.mkdir()
    ref = root / "reference.pt"
    cli_reference_pt(ref)
    av_dir, video_dir = root / "av", root / "video"
    processed = Path(route["root"])
    for modality, out in (("av", av_dir), ("video", video_dir)):
        cli_run(f"import_checkpoint/{modality}", import_checkpoint.main,
                ["--modality", modality, "--torch-checkpoint", str(ref), "--output-dir",
                 str(out)], {})
    test = route["sources"]["test"]
    n = {s: len(DataLoader(AudioVisualSource(str(processed) + "/", s), batch_size=b))
         for s, b in (("train", CLI_TRAIN_B), ("validation", CLI_TRAIN_B),
                      ("test", CLI_EVAL_B))}
    data_args = ["--data-root", route["data"]]

    # one epoch from the imported checkpoint, the trunk trained
    cli_run("train", train.main,
            ["--modality", "av", *data_args, "--model-dir", str(av_dir), "--resume",
             "--epochs", "1", "--batch-size", str(CLI_TRAIN_B), "--lr", str(CLI_LR)],
            {"fwd_train_persist": 2 * n["train"], "bwd_persist": 2 * n["train"],
             "none_persist": 2 * n["validation"]})
    epoch_log = (av_dir / "output_epoch.log").read_text().splitlines()
    if not epoch_log or epoch_log[0] != "Epoch: 1":
        raise RuntimeError(f"cli train: epoch log {epoch_log}")
    # every trained tensor moved, the trunk's too (its parity with JAX:
    # tests/test_torch_port_cli_train.py)
    before, after = cli_state(av_dir, "first"), cli_state(av_dir, "latest")
    trained = [n for n, p in build_model("av").named_parameters() if p.requires_grad]
    still = [n for n in trained if not (after[n] - before[n]).abs().max() > 0.5 * CLI_LR]
    print(f"cli train: {len(trained) - len(still)} of {len(trained)} trained tensors moved "
          f"by more than lr/2 ({sum(n.startswith('tower.') for n in trained)} of the trunk)")
    if still or not trained:
        raise RuntimeError(f"cli train: tensors that did not move: {still}")

    # evaluate: the static-int8 tower on K3 / K2, the int8 recurrence
    int8_opts = dict(tower_int8=True, tower_quant_mode="static", tower_pallas=True)
    cal = {lstm_fused.infer_variant("int8", CLI_CAL_B, H, sms):
           2 * -(-CLI_CAL_UTTS // CLI_CAL_B)}
    expect = {stem_fused.NHWC_KERNEL_NAME: n["test"], conv_fused.KERNEL_NAME: 8 * n["test"]}
    variant = lstm_fused.infer_variant("int8", CLI_EVAL_B, H, sms)
    expect[variant] = 2 * n["test"] + cal.get(variant, 0)
    expect.update({k: v for k, v in cal.items() if k != variant})
    report, _ = cli_run("evaluate", evaluate.main,
                        ["--modality", "av", *data_args, "--checkpoint", str(av_dir),
                         "--output-dir", str(root / "pred"), "--batch-size",
                         str(CLI_EVAL_B), "--tower-int8", "--tower-quant-mode", "static",
                         "--tower-pallas", "--lstm-state-quant", "int8",
                         "--calibrate-utts", str(CLI_CAL_UTTS)], expect)
    model = build_model("av", lstm_state_quant="int8", **int8_opts)
    stats, _ = restore(str(av_dir), model, torch.device("cuda"))
    state = TrainState(model.eval(), None, torch.device("cuda"))
    calibrate_quant_scales(state, model, AudioVisualSource(str(processed) + "/", "train"),
                           "av", norm_stats=stats, n_utts=CLI_CAL_UTTS)
    evaluate_split(state, test, "av", str(root / "pred_in_process") + "/", norm_stats=stats,
                   batch_size=CLI_EVAL_B, verbose=False)
    soft = sorted(p.relative_to(root / "pred") for p in (root / "pred").rglob("*_soft.npy"))
    same = [np.array_equal(np.load(root / "pred" / r), np.load(root / "pred_in_process" / r))
            for r in soft]
    print(f"cli evaluate: {report['n_utterances']} utterances, {len(soft)} soft files, "
          f"equal to the in-process evaluate_split: {sum(same)} of {len(same)}")
    if len(soft) != len(test) or not all(same):
        raise RuntimeError("cli evaluate: predictions differ from evaluate_split")
    del state, model
    torch.cuda.empty_cache()

    scored, _ = cli_run("run_metrics", run_metrics.main,
                        [*data_args, "--predictions-dir", str(root / "pred")], {})
    overall = scored["overall"]
    if not all(np.isfinite(overall[k]["avg"]) for k in ("accuracy", "f1")):
        raise RuntimeError(f"cli run_metrics: {overall}")

    # reconstruct: VideoVAD, one utterance a step
    rows, counts = cli_run("reconstruct", reconstruct.main,
                           [*data_args, "--checkpoint", str(video_dir), "--output-dir",
                            str(root / "reconstruct")])
    variant = lstm_fused.infer_variant("none", 1, H, sms)
    if (len(rows) != len(test) or set(counts) != {variant}
            or (variant == "none_persist" and counts[variant] != 2 * len(test))
            or not all(np.isfinite(r["soft"]).all() for r in rows)):
        raise RuntimeError(f"cli reconstruct: {len(rows)} utterances, launches {counts}")

    # export_serving: the int8-tower step, replayed against the live step
    art_path = root / "serving.avvadx"
    cli_run("export_serving", export_serving.main,
            ["--modality", "av", "--checkpoint", str(av_dir), "--out", str(art_path),
             "--batch", str(B), "--frames", str(T), "--video-fps", "30", "--tower-int8",
             *data_args, "--calibrate-utts", str(CLI_CAL_UTTS)])
    model = build_model("av", **int8_opts)
    stats, _ = restore(str(av_dir), model, torch.device("cuda"))
    calibrate_quant_scales(TrainState(model.eval(), None, torch.device("cuda")), model,
                           AudioVisualSource(str(processed) + "/", "train"), "av",
                           norm_stats=stats, n_utts=CLI_CAL_UTTS)
    wave, video, idx = serving_inputs()
    live = make_waveform_serving_fn(model, t_frames=T, norm_stats=stats,
                                    video_frame_indices=idx)(wave, video)
    loaded = ServingArtifact.load(str(art_path))
    loaded.call(f"b{B}", wave, video)
    replay, counts = cli_run("export_serving/replay", lambda _: loaded.call(f"b{B}", wave, video),
                             [], {**serving_launches("none"), conv_fused.KERNEL_NAME: 8,
                                  stem_fused.NHWC_KERNEL_NAME: 1})
    check_probs(replay, "cli export_serving replay")
    if not torch.equal(replay, live):
        raise RuntimeError(f"cli export_serving: the replay differs from the live step by "
                           f"{(replay - live).abs().max().item()}")
    print(f"cli export_serving: replay of {art_path.name} bit-equal to the live step")
    del loaded, live, replay
    torch.cuda.empty_cache()

    # serve_server: build_server from a multi-stream artifact of the int8 AV server
    span = dict(span_wire=True, hop_dft=True, audio_int16=True, native=True,
                max_backlog_blocks=SERVER_BACKLOG)
    srv = MultiStreamAVVAD(model, STREAMS, norm_stats=stats, block_frames=BLOCK,
                           video_fps=30.0, video_uint8=True, **span)
    ms_path = root / "server.avvadx"
    export_multistream_server(srv, str(ms_path))
    del srv
    args = serve_server.parse_args(["--artifact", str(ms_path), "--port", "0"])
    server, _ = cli_run("serve_server/build_server", serve_server.build_server, args, {})
    pcm, cam, up, cuts = server_data()
    n_out = TICKS * BLOCK
    try:
        server.streamer.warmup()
        reset_counts()
        got, stats_srv = serve_clients(server, [
            lambda i=i: av_stream_client(server.address, pcm[i], cam[i], n_out,
                                         chunk=BLOCK * HOP, frames_per_msg=8, timeout=60,
                                         video_wire="u8", audio_wire="i16")
            for i in range(STREAMS)])
        torch.cuda.synchronize()
        counts = nonzero_counts()
    finally:
        server.close()
    ticks = stats_srv["ticks"]
    solo = StreamingAVVAD(model, norm_stats=stats, block_frames=BLOCK, video_uint8=True)
    worst = 0.0
    for i in range(STREAMS):
        solo.reset()
        for k in range(TICKS):
            want = solo.feed(cuts[k][i].astype(np.float32), up[i, k * BLOCK:(k + 1) * BLOCK])
            worst = max(worst, float(np.abs(got[i][k * BLOCK:(k + 1) * BLOCK] - want).max()))
    line = {"cli": "serve_server/clients", "streams": STREAMS, "ticks": ticks,
            "wall_s": stats_srv["wall_s"],
            "launches_per_tick": {k: v / ticks for k, v in counts.items()},
            "solo_max_abs_diff": worst, "solo_tol": SOLO_TOL["av"]}
    print(json.dumps(line))
    if (counts != {conv_fused.KERNEL_NAME: 8 * ticks, stem_fused.NHWC_KERNEL_NAME: ticks}
            or not worst <= SOLO_TOL["av"]):
        raise RuntimeError(f"cli serve_server: {line}")
    del model, solo
    torch.cuda.empty_cache()

    # stream_demo: one test wav with its lip video through StreamingAVVAD
    spk, utt = corpus_names("test", 0)
    wav = processed / "ntcd_timit/Noisy/Babble/-5/test" / spk / f"{utt}.wav"
    lips = processed / "ntcd_timit/matlab_raw/test" / spk / f"{utt}_upsampled.h5"
    demo, _ = cli_run("stream_demo", stream_demo.main,
                      [str(wav), "--video", str(lips), "--checkpoint", str(av_dir), "--mcb"])
    if not np.isfinite(demo["probs"]).all() or len(demo["probs"]) == 0:
        raise RuntimeError("cli stream_demo: no probabilities")
    print(f"cli phase: {time.perf_counter() - t_phase:.1f} s")


# --- the complete-corpus rehearsal --------------------------------------------

# the rehearsal's tree at the JAX script's defaults: 14 / 3 / 3 speakers x 10
# utterances, 6 noises x 3 SNRs
REHEARSAL_UTTS = {"train": 140, "validation": 30, "test": 30}
REHEARSAL_CONDITIONS = 18
# the quantization gate on the trained AV model: the static-int8 tower and
# int8 state against the float run, compare_predictions' mean |dp| and share
# of hard flips each under its limit (readings on the H100, four runs: mean
# 0.0056-0.0157, flips 0.59-1.64 %; the AV epoch is not deterministic). Its
# controls, the same run with every calibrated amax multiplied by a factor
# (x0: the scales before calibration), must fail it (readings: x0 mean 0.200,
# flips 19.8 %; x1/8 0.192-0.301, 16.2-26.9 %). Scales too large are not
# caught every time: x8 read 8.3 % and 3.1 %, x2 and x1/2 2.9-3.0 %
INT8_GATE = {"mean": 0.05, "flip_share": 0.05}
INT8_CONTROL_FACTORS = (0.0, 0.125)


def rehearsal_expect(kind: str, batches: dict, sms: int) -> dict:
    """The launches of a rehearsal step: a training epoch (K1d / K1e 2 + 2 a
    train batch, K1a 2 a validation batch at B=16) or a float evaluate (K1a
    2 a batch at B=8), by the routes ``persistent_plan`` picks."""
    from avvad_tpu_torch.ops import lstm_fused

    if kind == "train":
        expect = {"fwd_train_persist": 2 * batches["train"], "bwd_persist": 2 * batches["train"]}
        variant = lstm_fused.infer_variant("none", CORPUS_TRAIN_B, H, sms)
        expect[variant] = expect.get(variant, 0) + 2 * batches["validation"]
        return expect
    return {lstm_fused.infer_variant("none", CORPUS_EVAL_B, H, sms): 2 * batches["test"]}


def upsampling_qa(data: str) -> dict:
    """The upsampling QA twin (no ``--figures``) over the rehearsal's test
    split, its verdict held to the JAX script's rule (|diff| <= 2) on diffs
    computed here from the raw files: "all aligned" where every utterance
    keeps the rule, else the exit that names how many do not -> the
    counts."""
    from avvad_tpu_torch.datasets import speech_list, video_list
    from avvad_tpu_torch.processing import read_wav
    from avvad_tpu_torch.processing.stft import n_stft_frames
    from avvad_tpu_torch.processing.video import fps_resample_indices, read_mat_dct
    from avvad_tpu_torch.scripts import visualization_video_upsampling

    raw = os.path.join(data, "complete", "raw") + os.sep
    diffs = {}
    for mat, wav in zip(video_list(raw, "test"), speech_list(raw, "test")[0]):
        n_up = len(fps_resample_indices(len(read_mat_dct(raw + mat)), 30.0, FRAME_RATE))
        diffs[mat] = n_up - n_stft_frames(len(read_wav(raw + wav)[0]))
    bad = sum(abs(d) > 2 for d in diffs.values())
    t0 = time.perf_counter()
    try:
        got = visualization_video_upsampling.main(["--data-root", data, "--dataset-size",
                                                   "complete"])
        verdict = "all aligned"
    except SystemExit as e:
        if e.code != f"{bad} misaligned utterances":
            raise
        got, verdict = None, e.code
    wall = time.perf_counter() - t0
    if (bad == 0) != (verdict == "all aligned") or (got is not None and got != diffs):
        raise RuntimeError(f"upsampling QA: {verdict}, diffs {diffs}")
    hist = {f"{d:+d}": sum(v == d for v in diffs.values()) for d in sorted(set(diffs.values()))}
    print(f"upsampling QA over {len(diffs)} test utterances in {wall:.2f} s: {verdict} "
          f"(the JAX script's rule |diff| <= 2; upsampled video minus STFT frames: {hist})")
    return {"utterances": len(diffs), "aligned": len(diffs) - bad, "verdict": verdict,
            "diff_histogram": hist}


def figure_twins_phase(data: str, preds: str) -> dict:
    """``run_metrics --figures``, ``visualization_audio`` and
    ``visualization_video`` on the rehearsal's tree: where matplotlib or cv2
    is missing (the card's machine has cv2 and not matplotlib), each twin
    that needs it raises an ImportError that names it before it writes
    anything; where it is present, the twin runs (run_metrics --figures into
    a copy of the predictions)."""
    import importlib.util
    import shutil

    from avvad_tpu_torch.scripts import run_metrics, visualization_audio, visualization_video

    present = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "cv2")}
    out = Path(data) / "figures"
    figs = str(out / "preds")
    common = ["--data-root", data, "--dataset-size", "complete"]
    calls = {"run_metrics --figures": ("matplotlib", figs, lambda: run_metrics.main(
                 [*common, "--predictions-dir", figs, "--figures"])),
             "visualization_audio": ("matplotlib", str(out / "audio"),
                                     lambda: visualization_audio.main(
                                         [*common, "--output-dir", str(out / "audio")])),
             "visualization_video": ("cv2", str(out / "video"),
                                     lambda: visualization_video.main(
                                         [*common, "--output-dir", str(out / "video")]))}
    result = {}
    for name, (package, written, call) in calls.items():
        if present[package]:
            if name.startswith("run_metrics"):
                shutil.copytree(preds, figs)
            t0 = time.perf_counter()
            call()
            n = sum(len(fs) for _, _, fs in os.walk(written))
            result[name] = f"ran in {time.perf_counter() - t0:.1f} s, {n} files"
        else:
            try:
                call()
            except ImportError as e:
                if package not in str(e) or os.path.exists(written):
                    raise
                result[name] = f"raised ImportError: {e}"
            else:
                raise RuntimeError(f"{name} ran without {package}")
        print(f"figure twin {name}: {result[name]}")
    return {"packages_present": present, "twins": result}


def int8_gate_failures(gate: dict) -> list:
    """compare_predictions' readings -> the INT8_GATE limits they break."""
    return [f"{k} {gate[k]:.4g} >= {lim}" for k, lim in INT8_GATE.items()
            if not gate[k] < lim]


@contextlib.contextmanager
def scaled_calibration(factor: float):
    """The evaluate twin's static-int8 calibration with every recorded amax
    (the tower's ``q_*`` buffers) multiplied by ``factor`` afterwards: a
    mis-set calibration, the gate's control."""
    import avvad_tpu_torch.evaluate as ev

    real = ev.calibrate_quant_scales

    def mis_set(state, model, *args, **kw):
        out = real(state, model, *args, **kw)
        scales = [buf for name, buf in model.named_buffers()
                  if name.rsplit(".", 1)[-1] in ("q_stem", "q_in", "q1", "q_out")]
        if not scales:
            raise RuntimeError("scaled_calibration: no int8 scale buffers")
        with torch.no_grad():
            for buf in scales:
                buf.mul_(factor)
        return out

    ev.calibrate_quant_scales = mis_set
    try:
        yield
    finally:
        ev.calibrate_quant_scales = real


def rehearsal_phase(tmp: str) -> None:
    """The complete-corpus rehearsal at the JAX script's defaults, through
    the rehearse_complete twin's stages with the launch counters read
    around each: the raw tree (6 noises x 3 SNRs x 200 utterances), the
    build (one pool of workers), one audio and one AV epoch (AVVAD: MCB
    1024, 2 x LSTM 1024, ResNet-18 trained), evaluate + run_metrics for
    audio and AV (float tower) over the 540-item test grid; then the AV
    test split again with the static-int8 tower on K3 / K2 and the int8
    state (K1b), held to the float predictions by compare_predictions
    within INT8_GATE, and the gate's controls, which must fail it;
    summarize_training on both model dirs; the device STFT check over the
    test split's clean wavs; the upsampling QA; the figure twins. One
    {"rehearsal": ...} line a step and one for the phase."""
    from avvad_tpu_torch.data import AudioSequenceSource, AudioVisualSource, DataLoader
    from avvad_tpu_torch.datasets import speech_list
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused
    from avvad_tpu_torch.processing import read_wav, stft
    from avvad_tpu_torch.processing.audio_io import peak_normalize
    from avvad_tpu_torch.scripts import (compare_predictions, evaluate, rehearse_complete,
                                         summarize_training)
    from avvad_tpu_torch.scripts.visualization_audio import device_stft_check

    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    root = Path(tmp) / "rehearsal"
    args = rehearse_complete.build_parser().parse_args(
        ["--dir", str(root), "--workers", str(CORPUS_BUILD_WORKERS)])
    data, processed = root / "data", str(root / "data" / "complete" / "processed") + "/"
    stages = rehearse_complete.stages(args)
    lines, batches, frames, prof = {}, {}, {}, {}
    for i, (key, banner, fn) in enumerate(stages, 1):
        print(f"=== rehearsal [{i}/{len(stages)}] {banner} ===")
        expect = {}
        if key.startswith("train_"):
            expect = rehearsal_expect("train", batches[key[6:]], sms)
        elif key in ("audio", "av"):
            expect = rehearsal_expect("evaluate", batches[key], sms)
        reset_counts()
        t0 = time.perf_counter()
        if key == "av":
            # the device's share of the AV evaluate: this run under torch.profiler
            real_evaluate = evaluate.main

            def profiled(argv):
                got = {}
                prof.update(profile_step(lambda: got.update(report=real_evaluate(argv))))
                return got["report"]

            evaluate.main = profiled
            try:
                out = fn()
            finally:
                evaluate.main = real_evaluate
        else:
            out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = nonzero_counts()
        line = {"rehearsal": key, "wall_s": wall, "launches": counts}
        if key == "synthesize":
            line["raw_files"] = out["raw_files"]
            want = sum(REHEARSAL_UTTS.values()) * (2 + REHEARSAL_CONDITIONS)
            if out["raw_files"] != want:
                raise RuntimeError(f"rehearsal: {out['raw_files']} raw files, expected {want}")
        elif key == "build":
            line.update(build_s=out["seconds"], processed_files=out["processed_files"],
                        built=out["counts"])
            for modality, cls in (("audio", AudioSequenceSource), ("av", AudioVisualSource)):
                srcs = {s: cls(processed, s, "complete") for s in REHEARSAL_UTTS}
                for s, src in srcs.items():
                    if len(src) != REHEARSAL_UTTS[s] * REHEARSAL_CONDITIONS:
                        raise RuntimeError(f"rehearsal {modality} {s}: {len(src)} items")
                batches[modality] = {s: len(DataLoader(src, batch_size=(
                    CORPUS_EVAL_B if s == "test" else CORPUS_TRAIN_B)))
                    for s, src in srcs.items()}
                frames[modality] = {s: sum(map(src.probe_length, range(len(src))))
                                    for s, src in srcs.items()}
            line["items"] = {s: len(AudioSequenceSource(processed, s, "complete"))
                             for s in REHEARSAL_UTTS}
            line["batches"] = batches["av"]
        elif key.startswith("train_"):
            modality = key[6:]
            log = (root / modality / "output_epoch.log").read_text()
            epoch_s = float(log.split("[Time]")[1].split("s")[0])
            seconds = (frames[modality]["train"] + frames[modality]["validation"]) / FRAME_RATE
            line.update(epoch_s=epoch_s, audio_s=seconds, x_real_time=seconds / epoch_s,
                        train_loss=float(out["train"]["loss"]),
                        valid_loss=float(out["valid"]["loss"]))
        else:
            report, stats = out["evaluate"], out["metrics"]
            conds = {p.relative_to(root / f"{key}_preds").parts[2:4]
                     for p in (root / f"{key}_preds").rglob("*_soft.npy")}
            line.update(rt_factor=report["rt_factor"], elapsed_s=report["elapsed_s"],
                        n_utterances=report["n_utterances"], conditions=len(conds),
                        snr_groups=sorted(stats["by_snr_db"]),
                        noise_groups=sorted(stats["by_noise_type"]),
                        overall={k: v["avg"] for k, v in stats["overall"].items()},
                        under_torch_profiler=key == "av")
            if (len(conds) != REHEARSAL_CONDITIONS or len(stats["by_snr_db"]) != 3
                    or len(stats["by_noise_type"]) != 6):
                raise RuntimeError(f"rehearsal {key}: {len(conds)} conditions scored")
        print(json.dumps(line))
        if counts != {k: v for k, v in expect.items() if v}:
            raise RuntimeError(f"rehearsal {key}: launches {counts}, expected {expect}")
        lines[key] = line

    av_args = ["--modality", "av", "--data-root", str(data), "--dataset-size", "complete",
               "--split", "test", "--checkpoint", str(root / "av"), "--lstm-hidden", str(H)]
    print(f"rehearsal AV evaluate under torch.profiler: wall "
          f"{prof['profiled_step_wall_ms']:.1f} ms, device busy {prof['device_busy_ms']:.1f} "
          f"ms, idle share {prof['device_idle_share']:.4f}")

    # the quantization gate: the int8 tower and state against the float run
    cal = {lstm_fused.infer_variant("int8", CLI_CAL_B, H, sms): 2 * -(-CLI_CAL_UTTS // CLI_CAL_B)}
    n_test = batches["av"]["test"]
    expect = {stem_fused.NHWC_KERNEL_NAME: n_test, conv_fused.KERNEL_NAME: 8 * n_test}
    variant = lstm_fused.infer_variant("int8", CORPUS_EVAL_B, H, sms)
    expect[variant] = 2 * n_test + cal.get(variant, 0)
    expect.update({k: v for k, v in cal.items() if k != variant})
    int8_args = [*av_args, "--tower-int8", "--tower-quant-mode", "static", "--tower-pallas",
                 "--lstm-state-quant", "int8"]
    int8_report, _ = cli_run("rehearsal/evaluate int8", evaluate.main,
                             [*int8_args, "--output-dir", str(root / "av_int8_preds")], expect)
    gate = compare_predictions.main([str(root / "av_preds"), str(root / "av_int8_preds")])
    broken = int8_gate_failures(gate)
    print(f"quantization gate (mean |dp| and hard-flip share under {INT8_GATE}): "
          f"{'passed' if not broken else 'FAILED: ' + ', '.join(broken)}")
    if gate["utterances"] != int8_report["n_utterances"] or broken:
        raise RuntimeError(f"rehearsal compare_predictions: {gate}")
    # the gate's controls: the same int8 run with mis-set calibration scales
    controls = {}
    for factor in INT8_CONTROL_FACTORS:
        out_dir = str(root / f"av_int8_x{factor}_preds")
        with scaled_calibration(factor):
            cli_run(f"rehearsal/evaluate int8, scales x{factor}", evaluate.main,
                    [*int8_args, "--output-dir", out_dir], expect)
        control = controls[f"x{factor}"] = compare_predictions.main(
            [str(root / "av_preds"), out_dir])
        control["gate_breaks"] = int8_gate_failures(control)
        print(f"quantization gate control (scales x{factor}): "
              f"{control['gate_breaks'] or 'PASSED the gate'}")
        if not control["gate_breaks"]:
            raise RuntimeError(f"rehearsal: scales x{factor} passed the quantization gate")

    curves = {m: summarize_training.main([str(root / m)]) for m in ("audio", "av")}

    # the device STFT (fp32 DFT matmul, TF32 off) against the host one
    raw = str(data / "raw") + "/"
    clean = speech_list(raw, "test")[0]
    t0 = time.perf_counter()
    worst = 0.0
    for rel in clean:
        x, fs = read_wav(raw + rel)
        x = peak_normalize(x)
        worst = max(worst, device_stft_check(x, fs, stft(x, fs=fs), "cuda"))
    stft_s = time.perf_counter() - t0
    print(f"device STFT check: {len(clean)} clean test wavs, largest |re|/|im| difference "
          f"{worst:.3e} (atol 5e-3), {stft_s:.2f} s")

    (data / "complete" / "raw").symlink_to(Path("..") / "raw")
    qa = upsampling_qa(str(data))
    figures = figure_twins_phase(str(data), str(root / "av_preds"))
    print(json.dumps({"rehearsal": "phase", "wall_s": time.perf_counter() - t_phase,
                      "steps": {k: {f: v for f, v in line.items() if f != "rehearsal"}
                                for k, line in lines.items()},
                      "av_evaluate_profiled": {k: prof[k] for k in (
                          "profiled_step_wall_ms", "device_busy_ms", "device_idle_share",
                          "top_kernels")},
                      "int8_evaluate": {k: int8_report[k] for k in ("n_utterances", "n_frames",
                                                                    "elapsed_s", "rt_factor")},
                      "int8_vs_float": gate,
                      "int8_controls": controls,
                      "curves": {m: c["final"] for m, c in curves.items()},
                      "device_stft": {"wavs": len(clean), "max_abs_diff": worst,
                                      "atol": 5e-3},
                      "upsampling_qa": qa, "figures": figures}))


# the Orbax phase: the committed fixture of tests/fixtures/make_orbax_fixtures.py
ORBAX_FIXTURES = HDF5_FIXTURES / "orbax_fixtures.json"
# its serving step against JAX's recorded probabilities: the JAX side ran
# the Pallas LSTM (the kernels' arithmetic) on the CPU, the card the
# persistent K1a (tests/test_torch_port_models.py::test_serving_fn_matches_jax's
# bar)
ORBAX_PROB_TOL = 1e-4
# passes of the decoder over the fixture's chunks, for its MB/s
ORBAX_DECODE_PASSES = 20


def orbax_fixture_phase(rows: dict) -> None:
    """Phase 17c (a): the committed real-Orbax checkpoint through the port
    on the card (module docstring)."""
    import hashlib

    from avvad_tpu_torch import native, orbax_io
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AudioVAD
    from avvad_tpu_torch.train import restore_model

    sys.path.insert(0, str(HDF5_FIXTURES))
    from make_orbax_fixtures import waveforms

    meta = json.loads(ORBAX_FIXTURES.read_text())
    path = str(HDF5_FIXTURES / meta["model_dir"] / meta["checkpoint"])
    t0 = time.perf_counter()
    tree = orbax_io.read_checkpoint(path)
    read_s = time.perf_counter() - t0
    for key, digest in meta["arrays_sha256"].items():
        leaf = tree
        for k in key.split("/"):
            leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
        if hashlib.sha256(np.ascontiguousarray(leaf).tobytes()).hexdigest() != digest:
            raise RuntimeError(f"orbax fixture: {key} differs from Orbax's restore")
    wave = waveforms(meta["seed"])
    if hashlib.sha256(wave.tobytes()).hexdigest() != meta["wave_sha256"]:
        raise RuntimeError("orbax fixture: the seeded waveforms differ from the fixture's")
    model = AudioVAD(lstm_hidden_size=meta["lstm_hidden"], lstm_layers=meta["lstm_layers"],
                     use_kernel_lstm=True)
    norm, epoch = restore_model(path, model)
    fn = make_waveform_serving_fn(model, t_frames=meta["t_frames"], norm_stats=norm)
    reset_counts()
    probs = fn(torch.from_numpy(wave).cuda())
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_launches(counts, {"none_persist": 2}, "orbax fixture serving")
    add_launches(rows, counts)
    probs = probs.float().cpu().numpy().reshape(meta["batch"], -1)
    err = float(np.abs(probs - np.asarray(meta["probs"])).max())
    if not err <= ORBAX_PROB_TOL:
        raise RuntimeError(f"orbax fixture: probabilities {err} off JAX's")
    store = orbax_io.read_store(path)
    frames = [v for k, v in store.items()
              if not k.endswith(b".zarray") and v[:4] == native.ZSTD_MAGIC]
    t0 = time.perf_counter()
    decoded = sum(native.zstd_decompress(f).size
                  for _ in range(ORBAX_DECODE_PASSES) for f in frames)
    decode_s = time.perf_counter() - t0
    print(json.dumps({"orbax": "fixture", "arrays": len(meta["arrays_sha256"]),
                      "epoch": epoch, "read_s": read_s, "launches": counts["none_persist"],
                      "max_abs_err_vs_jax": err, "tol": ORBAX_PROB_TOL,
                      "zstd_frames": len(frames),
                      "zstd_mb_decoded": decoded / 1e6 / ORBAX_DECODE_PASSES,
                      "decoder_mb_s": decoded / decode_s / 1e6}))


def _moments_equal(a, b) -> int:
    """Adam's state of two states' parameters, pairwise, bit for bit -> the
    number of parameters compared."""
    n = 0
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state.get(p), b.optimizer.state.get(q)
        if (sa is None) != (sb is None):
            raise RuntimeError("orbax round trip: Adam state on one side only")
        if sa is None:
            continue
        if float(sa["step"]) != float(sb["step"]) or not (
                torch.equal(sa["exp_avg"], sb["exp_avg"])
                and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])):
            raise RuntimeError("orbax round trip: Adam moments differ")
        n += 1
    return n


def _state_equal(want: dict, got: dict, label: str) -> int:
    """Two state dicts bit for bit (BatchNorm's num_batches_tracked aside:
    Flax keeps none, and the momentum rule does not read it) -> tensors
    compared."""
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    if set(keys) != {k for k in got if not k.endswith("num_batches_tracked")}:
        raise RuntimeError(f"{label}: state dict keys differ")
    bad = [k for k in keys if not torch.equal(want[k], got[k])]
    if bad:
        raise RuntimeError(f"{label}: {len(bad)} tensors differ, e.g. {bad[:3]}")
    return len(keys)


def orbax_round_trip_phase(rows: dict) -> None:
    """Phase 17c (b): the full-width round trip through the JAX package's
    checkpoint format on the card (module docstring)."""
    from avvad_tpu_torch.models import AVVAD, VideoVAD
    from avvad_tpu_torch.train import (create_train_state, load_pretrained_trunk,
                                       make_train_step, restore_checkpoint)
    from avvad_tpu_torch.train.checkpoint import export_jax_checkpoint

    def av(seed: int, **kw):
        return AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                     use_kernel_lstm=True, seed=seed, **kw)

    out = {"orbax": "round_trip"}
    step = make_train_step("av")
    batches = [train_batch(T, TRAIN_B, "av", seed=s) for s in (20, 21, 22)]
    rng = np.random.default_rng(3)
    norm = {"audio_mean": rng.standard_normal((513, 1)).astype(np.float32),
            "audio_std": (rng.random((513, 1)) + 0.5).astype(np.float32)}
    state = create_train_state(av(0), learning_rate=1e-4)
    BUILD.mkdir(exist_ok=True)
    # the trunk trains: its weight gradients in one order on both sides
    torch.backends.cudnn.deterministic = True
    try:
        reset_counts()
        for batch in batches[:2]:
            step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        expect_launches(counts, {"fwd_train_persist": 4, "bwd_persist": 4},
                        "orbax round trip: 2 train steps")
        add_launches(rows, counts)
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            t0 = time.perf_counter()
            path = export_jax_checkpoint(tmp, state, norm, epoch=2, valid_loss=0.5)
            out["write_s"] = time.perf_counter() - t0
            out["checkpoint_mb"] = sum(f.stat().st_size for f in Path(path).rglob("*")
                                       if f.is_file()) / 1e6
            fresh = create_train_state(av(1), learning_rate=1e-4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh, norm_back, epoch = restore_checkpoint(tmp, fresh)
            torch.cuda.synchronize()
            out["read_s"] = time.perf_counter() - t0
            out["read_mb_s"] = out["checkpoint_mb"] / out["read_s"]
            if epoch != 2 or fresh.step != state.step or set(norm_back) != set(norm) \
                    or any(not np.array_equal(norm_back[k], norm[k]) for k in norm):
                raise RuntimeError(f"orbax round trip: epoch {epoch}, step {fresh.step}")
            out["tensors_equal"] = _state_equal(state.model.state_dict(),
                                                fresh.model.state_dict(), "restored state")
            out["moments_equal"] = _moments_equal(state, fresh)
            reset_counts()
            _, m_live = step(state, batches[2])
            _, m_back = step(fresh, batches[2])
            torch.cuda.synchronize()
            counts = launch_counts()
            expect_launches(counts, {"fwd_train_persist": 4, "bwd_persist": 4},
                            "orbax round trip: the next step, twice")
            add_launches(rows, counts)
            out["next_step_tensors_equal"] = _state_equal(
                state.model.state_dict(), fresh.model.state_dict(), "the next step")
            _moments_equal(state, fresh)
            if m_live["loss"].item() != m_back["loss"].item():
                raise RuntimeError("orbax round trip: the next step's losses differ")
            out["next_step_loss"] = m_live["loss"].item()
            del fresh
            torch.backends.cudnn.deterministic = False
            int8_round_trip(path, norm_back, rows, out)
            # a VideoVAD checkpoint, its trunk grafted into a frozen-trunk AVVAD
            video = create_train_state(VideoVAD(lstm_hidden_size=H, lstm_layers=2,
                                                use_kernel_lstm=True, seed=3))
            vdir = str(Path(tmp) / "video")
            export_jax_checkpoint(vdir, video, epoch=0)
            frozen = create_train_state(av(4), freeze_video_trunk=True)
            load_pretrained_trunk(vdir, frozen.model)
            trunk = {k: v for k, v in video.model.state_dict().items()
                     if k.startswith("tower.features.")}
            out["trunk_tensors_equal"] = _state_equal(
                trunk, {k: v for k, v in frozen.model.state_dict().items() if k in trunk},
                "grafted trunk")
    finally:
        torch.backends.cudnn.deterministic = False
    print(json.dumps(out))


def int8_round_trip(path: str, norm: dict, rows: dict, out: dict) -> None:
    """restore_model of the float checkpoint into the static-int8-tower AVVAD,
    calibrated; its serving step with int8 state against the plain route."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import AVVAD, calibrate
    from avvad_tpu_torch.ops import conv_fused, lstm_fused, stem_fused
    from avvad_tpu_torch.train import restore_model

    model = AVVAD(lstm_hidden_size=H, lstm_layers=2, use_mcb=True, mcb_output_size=1024,
                  dtype=torch.bfloat16, use_kernel_lstm=True, tower_int8=True,
                  tower_quant_mode="static", tower_pallas=True, seed=5).cuda()
    restore_model(path, model)
    wave, video, idx = serving_inputs()
    calibrate(model, [(torch.zeros(2, T, 513, device="cuda"), video[:2])],
              video_frame_indices=torch.as_tensor(idx, device="cuda"))
    model.set_lstm_state_quant("int8")
    fn = make_waveform_serving_fn(model, t_frames=T, video_frame_indices=idx, norm_stats=norm)
    reset_counts()
    probs = fn(wave, video)
    torch.cuda.synchronize()
    counts = launch_counts()
    expect_launches(counts, {"int8_persist": 2, conv_fused.KERNEL_NAME: 8,
                             stem_fused.NHWC_KERNEL_NAME: 1}, "orbax int8-tower serving")
    add_launches(rows, counts)
    check_probs(probs, "orbax int8-tower serving")
    with plain_k2_k3(), plain_inference(lstm_fused):
        ref = fn(wave, video)
    err = (probs - ref).abs().max().item()
    if not err <= INT8_PROB_TOL:
        raise RuntimeError(f"orbax int8-tower serving: {err} off its plain route")
    out["int8_serving_launches"] = {k: v for k, v in counts.items() if v}
    out["int8_serving_max_abs_err_vs_plain"] = err


def orbax_phase(rows: dict) -> None:
    """Phase 17c: (a) and (b), timed."""
    t0 = time.perf_counter()
    orbax_fixture_phase(rows)
    torch.cuda.empty_cache()
    orbax_round_trip_phase(rows)
    torch.cuda.empty_cache()
    print(f"orbax phase: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(f"card: {card}")
    from avvad_tpu_torch.ops import _build, lstm_fused
    from avvad_tpu_torch.processing import unique_frame_schedule
    from avvad_tpu_torch.tools import lstm_probe as probe_tool

    from avvad_tpu_torch import native

    info = _build.build(force=True)
    print(f"built {info['path']} in {info['seconds']:.1f} s")
    for line in info["ptxas"]:
        print(f"  {line}")
    host = native.build(force=True)
    print(f"built {host['path']} (g++) in {host['seconds']:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = kernel_phase(lstm_fused)
    rows.update(int8_kernel_phase(B * unique_frame_schedule(T)[0]))
    rows.update(bn_kernel_phase())
    torch.cuda.empty_cache()
    float_model = main_path(lstm_fused, rows)
    torch.cuda.empty_cache()
    int8_model = int8_path(rows)
    torch.cuda.empty_cache()
    artifact_phase(int8_model, rows)
    torch.cuda.empty_cache()
    rows.update(train_kernel_phase(lstm_fused))
    state = train_path(rows, "av")
    torch.cuda.empty_cache()
    train_path(rows, "audio")
    torch.cuda.empty_cache()
    train_path(rows, "audio", **OUT_OF_PLAN_STEP)
    torch.cuda.empty_cache()
    trainer_phase(state, "av")
    del state
    torch.cuda.empty_cache()
    rows.update(probe_kernel_phase(lstm_fused, probe_tool))
    probe_tool_phase(lstm_fused, probe_tool, rows)
    frontend_phase()
    streaming_phase(float_model, int8_model)
    server_phase(int8_model)
    del float_model
    torch.cuda.empty_cache()
    # the video-only family and the trunk's backward
    state = train_path(rows, "video")
    torch.cuda.empty_cache()
    remat_phase()
    train_path(rows, "av", frozen=False)
    torch.cuda.empty_cache()
    trainer_phase(state, "video")
    del state
    torch.cuda.empty_cache()
    video_streaming_phase()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        route = corpus_phase(tmp)
        torch.cuda.empty_cache()
        cli_phase(route, tmp)
        torch.cuda.empty_cache()
        rehearsal_phase(tmp)
    torch.cuda.empty_cache()
    raw_serving_phase()
    torch.cuda.empty_cache()
    raw_train_phase()
    torch.cuda.empty_cache()
    mesh_phase(int8_model)
    del int8_model
    torch.cuda.empty_cache()
    timers_phase(rows)
    torch.cuda.empty_cache()
    orbax_phase(rows)
    print(json.dumps({"kernels": [rows[k] for k in (
        *(v for sq in lstm_fused.STATE_QUANTS for v in (sq + "_persist", sq)),
        *lstm_fused.TRAIN_KERNELS, "k2", "k3", "k3_nhwc", "k4",
        *(f"{r}/{m}" for r in ("probe", "probe_persist") for m in lstm_fused.PROBE_MODES))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
