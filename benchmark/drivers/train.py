"""Closed-loop training: one researcher's loop that reads each step's loss
before it sends the next batch.

The entry under test is the program's ``train.make_train_step(modality)``
on ``train.create_train_state(model, lr, freeze_video_trunk=...)``: fp32,
TF32 off, Adam. Batches come from a pool of seeded batches resident on the
card, taken in turn (features, video at frame rate, labels, mask). Set-up
builds the one train state, drives it through the window's own step call on
the first three pool batches (rows that all differ), keeping each loss, the
first gradient as Adam's first moment holds it after one step, and the
trained leaves after the third step, and hands the same state to the window.
After the window the program takes one more step, on a seeded batch that no
step has seen, from the state that the window left. The plain reference then
follows the three first steps from the same weights, and that last step from
the program's weights and Adam moments as the window left them."""

from __future__ import annotations

import contextlib
import math
import time

import torch

from ..harness import trace as tr
from ..harness import weights as wts
from ..reference import compare
from ..reference import train as ref_train
from .serve import frames_s, load_weights

CHECKED_STEPS = 3


def program_state(cfg: dict, mix: dict, w: dict, device):
    from avvad_tpu_torch.models import AVVAD, AudioVAD
    from avvad_tpu_torch.train import create_train_state

    common = dict(y_dim=cfg["y_dim"], lstm_hidden_size=cfg["lstm_hidden_size"],
                  lstm_layers=cfg["lstm_layers"], num_audio_features=cfg["x_dim"],
                  use_kernel_lstm=True)
    if cfg["model"] == "AudioVAD":
        model = AudioVAD(**common)
    else:
        model = AVVAD(use_mcb=True, mcb_output_size=cfg["mcb_output_size"],
                      num_video_features=cfg["num_video_features"], eps=cfg["fusion_eps"],
                      **common)
    state = create_train_state(model, mix["learning_rate"],
                               freeze_video_trunk=mix["freeze_video_trunk"]
                               and cfg["model"] == "AVVAD", device=device)
    load_weights(state.model, w)
    return state


def make_pool(cfg: dict, mix: dict, g: torch.Generator, device) -> list:
    """The P batches that the window takes in turn (``draw_batches``)."""
    if mix["pool"] <= CHECKED_STEPS:
        raise ValueError(f"a pool of {mix['pool']} batches: the window needs more than the "
                         f"{CHECKED_STEPS} checked steps take")
    return draw_batches(cfg, mix, mix["pool"], g, device)


def draw_batches(cfg: dict, mix: dict, p: int, g: torch.Generator, device) -> list:
    """P batches as dicts of tensors on ``device``: audio features (B, T, x_dim),
    video (B, T, 67, 67) for AVVAD, speech / non-speech labels in runs of
    20-120 frames, and a mask of each row's valid frames (lengths from T/2
    to T)."""
    b, t = mix["batch"], mix["frames"]
    audio = torch.randn(p, b, t, cfg["x_dim"], generator=g, device=device)
    video = None
    if cfg["model"] == "AVVAD":
        s = cfg["lip_size"]
        video = torch.randn(p, b, t, s, s, generator=g, device=device)
    period = torch.randint(20, 121, (p, b, 1), generator=g, device=device)
    phase = torch.randint(0, 120, (p, b, 1), generator=g, device=device)
    frames = torch.arange(t, device=device).view(1, 1, t)
    label = (((frames + phase) // period) % 2).float()[..., None]
    lengths = torch.randint(t // 2, t + 1, (p, b, 1), generator=g, device=device)
    mask = (frames < lengths).float()
    return [{"audio": audio[i], "video": None if video is None else video[i],
             "label": label[i], "mask": mask[i]} for i in range(p)]


def as_batch(batch: dict):
    from avvad_tpu_torch.data import Batch

    lengths = batch["mask"].sum(dim=1).to("cpu", torch.int32).numpy()
    return Batch(audio=batch["audio"], video=batch["video"], label=batch["label"],
                 lengths=lengths, mask=batch["mask"])


def modality(cfg: dict) -> str:
    return "audio" if cfg["model"] == "AudioVAD" else "av"


def build_step(cfg: dict, mix: dict):
    """-> step(state, batch) -> (state, metrics): the program's train step."""
    from avvad_tpu_torch.train import make_train_step

    return make_train_step(modality(cfg))


def adam_state(state, names: list, params: dict) -> dict:
    """Host copies of the trained leaves and of Adam's moments and step count."""
    opt = state.optimizer.state
    cpu = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    return {"params": {n: cpu(params[n]) for n in names},
            "m": {n: cpu(opt[params[n]]["exp_avg"]) for n in names},
            "v": {n: cpu(opt[params[n]]["exp_avg_sq"]) for n in names},
            "t": int(opt[params[names[0]]]["step"])}


def first_moment_grads(before: dict | None, after: dict, b1: float) -> dict:
    """The gradient of the step between two Adam states, read back from the
    first moment: (m_after - b1 m_before) / (1 - b1); ``before`` None: a
    fresh optimizer's zeros."""
    return {n: ((m.double() - (0.0 if before is None else b1 * before["m"][n].double()))
                / (1.0 - b1)).float() for n, m in after["m"].items()}


def host(result: dict) -> dict:
    """A reference run's tensors on the host."""
    return {"losses": result["losses"],
            "grads1": {k: v.cpu() for k, v in result["grads1"].items()},
            "params": {k: v.cpu() for k, v in result["params"].items()}}


def train_marks(marks: tr.Marks, state) -> list:
    """Marks at the tower's and the LSTM stack's edges, when the logits'
    gradient is formed (the backward pass starts) and around Adam's step."""
    model, opt = state.model, state.optimizer

    def on_logits(_m, _i, logits):
        if logits.requires_grad:
            logits.register_hook(lambda _g: marks.mark("backward_start"))

    hooks = []
    if hasattr(model, "tower"):
        hooks += tr.module_hooks(marks, model.tower, "tower")
    hooks += tr.module_hooks(marks, getattr(model, "lstm_merged", None) or model.lstm_audio,
                             "lstm")
    hooks += [model.register_forward_hook(on_logits),
              opt.register_step_pre_hook(lambda *_: marks.mark("optimizer_start")),
              opt.register_step_post_hook(lambda *_: marks.mark("optimizer_end"))]
    return hooks


def run(ctx) -> dict:
    cfg, mix, device = ctx.cell.config, ctx.cell.mix, ctx.device
    tr.log_phase(ctx, "start")
    g = wts.generator(ctx.seed, device)
    w = wts.make_weights(cfg, g, device)
    pool = make_pool(cfg, mix, g, device)
    fresh = draw_batches(cfg, mix, 1, g, device)[0]   # for the step after the window
    batches = [as_batch(b) for b in pool]
    tr.log_phase(ctx, "weights_and_inputs")
    state = program_state(cfg, mix, w, device)
    tr.log_phase(ctx, "model")
    w_host = wts.to_host(w)
    del w
    step = build_step(cfg, mix)
    names = ref_train.trainable(cfg)
    params = dict(state.model.named_parameters())
    prog = {"losses": []}
    for k in range(CHECKED_STEPS):   # the checked steps, through the window's own call
        state, metrics = step(state, batches[k])
        prog["losses"].append(float(metrics["loss"]))
        if k == 0:
            prog["grads1"] = first_moment_grads(None, adam_state(state, names, params),
                                                mix["adam_b1"])
    prog["params"] = {n: params[n].detach().to("cpu", copy=True) for n in names}
    tr.log_phase(ctx, "checked_steps")
    is_cuda = torch.device(device).type == "cuda"
    setup_s = time.perf_counter() - ctx.t0
    setup_peak = 0
    if is_cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    marks = tr.Marks() if ctx.trace and is_cuda else None
    hooks = train_marks(marks, state) if marks else []
    span = torch.profiler.record_function if ctx.trace else (lambda _n: contextlib.nullcontext())
    prof_first, prof_n = mix["profile_from_step"], mix["profile_steps"]
    prof, n_pool = None, mix["pool"]
    steps, k, bad = 0, CHECKED_STEPS, 0
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        if ctx.trace and steps == prof_first:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        with span(tr.STEP_SPAN):
            if marks:
                marks.begin()
            state, metrics = step(state, batches[k % n_pool])
            if marks:
                marks.end()
            with span("bench.read_loss"):
                loss = float(metrics["loss"])
        bad += not math.isfinite(loss)
        t_c = time.perf_counter()
        steps += 1
        k += 1
        if prof is not None and steps == prof_first + prof_n:
            prof.stop()
        if t_c >= end:
            break
    window_s = t_c - start
    for h in hooks:
        h.remove()
    if prof is not None and steps < prof_first + prof_n:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if is_cuda else 0
    record = None
    if ctx.trace:
        record = {"config": cfg, "mix": mix, "marks": marks,
                  "window_peak_bytes": peak,
                  "profile": tr.reduce_profile(prof) if prof is not None else {}}

    # one step after the window, from the state that the window left, on a
    # batch that no step has seen: the pool's own rows are learnt by then,
    # and their small gradients would read more rounding the longer it ran
    start_state = adam_state(state, names, params)
    state, metrics = step(state, as_batch(fresh))
    late_prog = {"losses": [float(metrics["loss"])],
                 "params": {n: params[n].detach().to("cpu", copy=True) for n in names},
                 "grads1": first_moment_grads(start_state, adam_state(state, names, params),
                                              mix["adam_b1"])}
    del state, step, metrics, batches, params
    if is_cuda:
        torch.cuda.empty_cache()

    lr = mix["learning_rate"]
    stand_in = getattr(ctx, "stand_in", None)   # the readings tool's control or fault
    w0 = wts.to_device(w_host, device)
    refr = host(ref_train.run(w0, cfg, pool[:CHECKED_STEPS], lr))
    if stand_in is not None:
        prog = host(stand_in(w0, cfg, pool[:CHECKED_STEPS], lr))
    w_late = wts.to_device({**w_host, **start_state["params"]}, device)
    adam = {"m": wts.to_device(start_state["m"], device),
            "v": wts.to_device(start_state["v"], device), "t": start_state["t"]}
    late_ref = host(ref_train.run(w_late, cfg, [fresh], lr, adam=adam))
    if stand_in is not None:
        late_prog = host(stand_in(w_late, cfg, [fresh], lr, adam=adam))
    numbers = {**compare.train_numbers(prog, refr, w_host),
               **compare.late_numbers(late_prog, late_ref, start_state["params"])}
    correct, checks = compare.judge(numbers, ctx.cell.limits)
    correct = correct and not bad
    audio_s = steps * mix["batch"] * mix["frames"] * frames_s(cfg)
    return {"correct": correct, "attempted": steps, "failed": bad,
            "numbers": numbers, "checks": checks, "record": record,
            "memory_peak_bytes": max(peak, setup_peak),
            "end_to_end": {"train_audio_s_per_s": audio_s / window_s, "setup_s": setup_s}}
