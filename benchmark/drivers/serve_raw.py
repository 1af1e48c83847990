"""Closed-loop batch serving of the raw waveform: one caller sends the next
batch after the previous batch's probabilities have landed in host memory.

The loop of ``drivers/serve.py`` for ``RawAudioVAD``: the program's
``export.make_waveform_serving_fn`` (a ``ServingStep``) takes the raw
waveform (B, n) to speech probabilities (B, frames, 1), the WaveNet encoder
pooling it onto the label frames. Inputs come from a pool of seeded batches
resident on the card, taken in turn. Set-up builds the model with its LSTM
on the hand-written kernels, loads the seeded weights strictly and serves
every pool batch once. After the window every answer is compared with the
plain reference (``reference/raw_audio.py``) twice: with the reference's
whole forward pass, and with the reference's LSTM and head on the pooled
encoder features that the program's step gives the same batch (the numbers
prefixed ``lstm_``), which holds the recurrence to its stated precision
without the encoder's summation order in the way."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..harness import trace as tr
from ..harness import weights as wts
from ..reference import compare
from ..reference import raw_audio as ref
from .serve import _sync, frames_s, make_pool

LSTM = "lstm_"


def program_model(cfg: dict, mix: dict) -> torch.nn.Module:
    from avvad_tpu_torch.models import RawAudioVAD

    wavenet = {k: cfg[k] for k in ("quantization_channels", "residual_channels",
                                   "dilation_channels", "bottleneck_width", "filter_width")}
    return RawAudioVAD(y_dim=cfg["y_dim"], lstm_hidden_size=cfg["lstm_hidden_size"],
                       lstm_layers=cfg["lstm_layers"], out_frames=mix["frames"],
                       wavenet_kwargs={**wavenet, "dilations": tuple(cfg["dilations"])},
                       dtype=getattr(torch, mix["model_dtype"]), use_kernel_lstm=True,
                       lstm_state_quant=mix["lstm_state_quant"])


def build_step(cfg: dict, mix: dict, w: dict, pool: torch.Tensor, device):
    """-> (model, step(i) -> probabilities of pool batch i on the device)."""
    from avvad_tpu_torch.export import make_waveform_serving_fn

    model = program_model(cfg, mix).to(device)
    model.load_state_dict(w, strict=True)
    fn = make_waveform_serving_fn(model, device=device)
    return model, lambda i: fn(pool[i])


def encoder_features(model: torch.nn.Module, step, ids) -> dict:
    """Pool batch i -> the pooled encoder features (B, frames, bottleneck)
    that the program's step gives it, caught by a hook on ``wavenet_en``."""
    caught = []
    hook = model.wavenet_en.register_forward_hook(lambda _m, _a, z: caught.append(z.clone()))
    try:
        for i in ids:
            step(i)
        return dict(zip(ids, caught, strict=True))
    finally:
        hook.remove()


def serve_numbers(outs: list, ids: list, ref_probs: dict, lstm_probs: dict,
                  limits: dict) -> tuple:
    """``compare.serve_numbers`` against the reference's whole forward pass,
    and its numbers prefixed ``lstm_`` against the reference's LSTM and head
    on the program's encoder features -> (numbers, steps that break a limit
    of either)."""
    own = {k[len(LSTM):]: v for k, v in limits.items() if k.startswith(LSTM)}
    numbers, failed = {}, 0
    for out, i in zip(outs, ids):
        whole, bad = compare.serve_numbers([out], [i], ref_probs, limits)
        part, bad_part = compare.serve_numbers([out], [i], lstm_probs, own)
        failed += bool(bad or bad_part)
        for k, v in {**whole, **{LSTM + k: v for k, v in part.items()}}.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers, failed


def run(ctx) -> dict:
    cfg, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
    tr.log_phase(ctx, "start")
    g = wts.generator(ctx.seed, device)
    w = ref.make_weights(cfg, g, device)
    pool = make_pool(cfg, mix, g, device)["wave"]
    tr.log_phase(ctx, "weights_and_inputs")
    model, step = build_step(cfg, mix, w, pool, device)
    tr.log_phase(ctx, "model")
    w_host = wts.to_host(w)
    del w
    n_pool = mix["pool"]
    for i in range(n_pool):          # every batch once: kernels built, shapes seen
        step(i).cpu()
    tr.log_phase(ctx, "warm_up")
    setup_s = time.perf_counter() - ctx.t0
    is_cuda = torch.device(device).type == "cuda"
    setup_peak = 0
    if is_cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    span = torch.profiler.record_function if ctx.trace else (lambda _n: contextlib.nullcontext())
    prof_first, prof_n = mix["profile_from_step"], mix["profile_steps"]
    prof = None
    lat, dispatch, outs, ids = [], [], [], []
    start = time.perf_counter()
    end = start + ctx.seconds
    k = 0
    while True:
        if ctx.trace and k == prof_first:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        i = k % n_pool
        with span(tr.STEP_SPAN):
            t_a = time.perf_counter()
            with span("bench.dispatch"):
                out = step(i)
            t_b = time.perf_counter()
            with span("bench.to_host"):
                host = out.cpu()
            t_c = time.perf_counter()
        lat.append(t_c - t_a)
        dispatch.append(t_b - t_a)
        outs.append(host)
        ids.append(i)
        k += 1
        if prof is not None and k == prof_first + prof_n:
            prof.stop()
        if t_c >= end:
            break
    window_s = t_c - start
    if prof is not None and k < prof_first + prof_n:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    record = None
    if ctx.trace:
        _sync(device)
        record = {"config": cfg, "mix": mix, "marks": None,
                  "dispatch_s": dispatch, "window_peak_bytes": peak,
                  "profile": tr.reduce_profile(prof) if prof is not None else {}}
    served = sorted(set(ids))
    feats = encoder_features(model, step, served)
    del model, step, out
    if is_cuda:
        torch.cuda.empty_cache()

    # the plain reference on every pool batch that the window served
    dtype = getattr(torch, mix["model_dtype"])
    w = wts.to_device(w_host, device)
    ref_probs = {i: ref.serve_probs(w, cfg, pool[i], mix["frames"], dtype).cpu()
                 for i in served}
    lstm_probs = {i: ref.lstm_probs(w, cfg, feats[i], dtype).cpu() for i in served}
    numbers, failed = serve_numbers(outs, ids, ref_probs, lstm_probs, ctx.cell.limits)
    correct, checks = compare.judge(numbers, ctx.cell.limits)
    steps = len(lat)
    audio_s = steps * mix["batch"] * mix["frames"] * frames_s(cfg)
    return {"correct": correct, "attempted": steps, "failed": failed,
            "numbers": numbers, "checks": checks, "record": record,
            "memory_peak_bytes": max(peak, setup_peak),
            "end_to_end": {"serve_audio_s_per_s": audio_s / window_s,
                           "serve_step_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                           "setup_s": setup_s}}
