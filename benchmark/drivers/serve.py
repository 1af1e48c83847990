"""Closed-loop batch serving: one caller sends the next batch after the
previous batch's probabilities have landed in host memory.

The entry under test is the program's ``export.make_waveform_serving_fn``
(a ``ServingStep``): the raw waveform (and, for AVVAD, the unique
camera-rate lip frames with the frame schedule) in, speech probabilities
per frame out. Inputs come from a pool of seeded batches resident on the
card, taken in turn. Set-up builds the model, loads the seeded weights,
calibrates the int8 tower's scales on the first two utterances of the first
batch (as ``scripts/bench.py`` does) and serves every pool batch once.
After the window every answer is compared with the plain reference."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..harness import trace as tr
from ..harness import weights as wts
from ..reference import compare
from ..reference import model as ref


def frames_s(cfg: dict) -> float:
    """Seconds of audio per STFT frame."""
    return cfg["hop"] / cfg["fs"]


def program_model(cfg: dict, mix: dict) -> torch.nn.Module:
    from avvad_tpu_torch.models import AVVAD, AudioVAD

    common = dict(y_dim=cfg["y_dim"], lstm_hidden_size=cfg["lstm_hidden_size"],
                  lstm_layers=cfg["lstm_layers"], num_audio_features=cfg["x_dim"],
                  dtype=getattr(torch, mix["model_dtype"]), use_kernel_lstm=True,
                  lstm_state_quant=mix["lstm_state_quant"])
    if cfg["model"] == "AudioVAD":
        return AudioVAD(**common)
    return AVVAD(use_mcb=True, mcb_output_size=cfg["mcb_output_size"],
                 num_video_features=cfg["num_video_features"], eps=cfg["fusion_eps"],
                 tower_int8=mix["tower"] == "int8_static_fused",
                 tower_quant_mode="static", tower_pallas=mix["tower"] == "int8_static_fused",
                 mcb_precision=mix["mcb_precision"], **common)


def load_weights(model: torch.nn.Module, w: dict) -> None:
    """The seeded weights into the program's model; only the int8 scales
    (set by calibration) and BatchNorm counters may stay unloaded."""
    missing, unexpected = model.load_state_dict(w, strict=False)
    left = [k for k in missing if not (k.rsplit(".", 1)[-1].startswith("q_")
                                       or k.endswith((".q1", "num_batches_tracked")))]
    if left or unexpected:
        raise RuntimeError(f"weights do not fit the model: missing {left}, unexpected {unexpected}")


def make_pool(cfg: dict, mix: dict, g: torch.Generator, device) -> dict:
    """{"wave": (P, B, n), "video": (P, B, T_v, 67, 67) or None, "idx"}."""
    b, t, p = mix["batch"], mix["frames"], mix["pool"]
    n = cfg["hop"] * (t - 1) + cfg["nfft"]
    pool = {"wave": torch.randn(p, b, n, generator=g, device=device), "video": None, "idx": None}
    if cfg["model"] == "AVVAD":
        t_src, idx = ref.frame_schedule(t, cfg["video_fps"], cfg["fs"] / cfg["hop"])
        s = cfg["lip_size"]
        pool["video"] = torch.randn(p, b, t_src, s, s, generator=g, device=device)
        pool["idx"] = torch.as_tensor(idx, device=device)
    return pool


def build_step(cfg: dict, mix: dict, w: dict, pool: dict, device):
    """-> (model, step(i) -> probabilities of pool batch i on the device)."""
    from avvad_tpu_torch.export import make_waveform_serving_fn
    from avvad_tpu_torch.models import calibrate

    model = program_model(cfg, mix).to(device)
    load_weights(model, w)
    t = mix["frames"]
    if pool["video"] is not None and mix["tower"] == "int8_static_fused":
        calibrate(model, [(torch.zeros(2, t, cfg["x_dim"], device=device),
                           pool["video"][0, :2])], video_frame_indices=pool["idx"])
    fn = make_waveform_serving_fn(model, t_frames=t, fs=cfg["fs"],
                                  wlen_sec=cfg["nfft"] / cfg["fs"],
                                  hop_percent=cfg["hop"] / cfg["nfft"],
                                  video_frame_indices=None if pool["idx"] is None
                                  else pool["idx"].cpu().numpy(), device=device)
    if pool["video"] is None:
        return model, lambda i: fn(pool["wave"][i])
    return model, lambda i: fn(pool["wave"][i], pool["video"][i])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    cfg, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
    tr.log_phase(ctx, "start")
    g = wts.generator(ctx.seed, device)
    w = wts.make_weights(cfg, g, device)
    pool = make_pool(cfg, mix, g, device)
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

    marks = tr.Marks() if ctx.trace and is_cuda else None
    hooks = []
    if marks:
        if hasattr(model, "tower"):
            hooks += tr.module_hooks(marks, model.tower, "tower")
        hooks += tr.module_hooks(marks, getattr(model, "lstm_merged", None)
                                 or model.lstm_audio, "lstm")
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
            if marks:
                marks.begin()
            with span("bench.dispatch"):
                out = step(i)
            if marks:
                marks.end()
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
    for h in hooks:
        h.remove()
    if prof is not None and k < prof_first + prof_n:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    record = None
    if ctx.trace:
        _sync(device)
        record = {"config": cfg, "mix": mix, "marks": marks,
                  "dispatch_s": dispatch, "window_peak_bytes": peak,
                  "profile": tr.reduce_profile(prof) if prof is not None else {}}
    del model, step, out
    if is_cuda:
        torch.cuda.empty_cache()

    # the plain reference on every pool batch that the window served, with
    # TF32 off whatever the program left switched on
    dtype = getattr(torch, mix["model_dtype"])
    w = wts.to_device(w_host, device)
    scales, ref_probs = None, {}
    with torch.no_grad(), ref.tf32(False):
        if pool["video"] is not None:
            scales = ref.calibrate(w, cfg, pool["video"][0, :2], dtype)
        for i in sorted(set(ids)):
            ref_probs[i] = ref.serve_probs(
                w, cfg, pool["wave"][i], None if pool["video"] is None else pool["video"][i],
                pool["idx"], mix["frames"], scales, dtype).cpu()
    numbers, failed = compare.serve_numbers(outs, ids, ref_probs, ctx.cell.limits)
    correct, checks = compare.judge(numbers, ctx.cell.limits)
    steps = len(lat)
    audio_s = steps * mix["batch"] * mix["frames"] * frames_s(cfg)
    return {"correct": correct, "attempted": steps, "failed": failed,
            "numbers": numbers, "checks": checks, "record": record,
            "memory_peak_bytes": max(peak, setup_peak),
            "end_to_end": {"serve_audio_s_per_s": audio_s / window_s,
                           "serve_step_p95_ms": 1e3 * float(np.percentile(lat, 95)),
                           "setup_s": setup_s}}
