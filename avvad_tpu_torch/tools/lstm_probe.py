"""LSTM recurrence micro-probe: where does a layer's time go?

Counterpart of scripts/bench_lstm_probe.py. It splits the cost of a step of
the LSTM inference kernel that serving runs at the shape into its parts, on
the card. Where ``persistent_plan`` takes the shape (the default one does)
that is the persistent kernel, one cooperative launch a layer
(``lstm_probe_persist``), and the modes are compile-time variants of it:

  full        the shipped arithmetic (fp32 h, bf16 W_hh): ``lstm_f32h_persist``
              itself
  matmul_only gate math removed (h = the i columns of the product): the
              barrier round, the exchange's loads of h, the contraction and
              the reduction
  gates_only  exchange loads and product removed (gates = x_proj only): the
              barrier round, the sigmoid / tanh / elementwise cost and the
              streaming of x_proj and y
  h_bf16      h rounded to bf16 for the product: ``lstm_bf16h_persist``
              itself (the tensor-core kernel)

Outside the plan the modes are those of the per-step ``lstm_f32h`` /
``lstm_bf16h`` instantiation, one launch a time step. Then it times the
serving op ``lstm_layer_fused`` for state_quant none / bf16 / int8 (the same
route), and the log-power frontend on the direct route against ``hop_dft``
at the serving shape.

    python -m avvad_tpu_torch.tools.lstm_probe [--b 64] [--t 512] [--h 1024]
        [--iters 30] [--modes full,matmul_only,gates_only,h_bf16] [--device cpu]

Runs on the CUDA card (each time is CUDA events around ``--iters`` calls,
after a warm-up, ending in a synchronise) unless ``--device cpu``, where the
plain versions run and the host clock times them: that checks the tool, it
measures nothing of the card.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops.lstm_fused import PROBE_MODES, STATE_QUANTS, lstm_layer_fused, lstm_probe
from ..ops.stft import log_power_frontend
from ..utils import profiling


def _timeit(fn, iters: int, dev: torch.device) -> float:
    """ms per call of ``fn()`` over ``iters`` calls after one warm-up."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def probe_inputs(b: int, t: int, h: int, dev: torch.device, seed: int = 0):
    """The probe's draws (scripts/bench_lstm_probe.py:145-149), batch-major:
    x_proj (B, T, 4H) x 0.1, W_hh (H, 4H) x 0.02, zero h0 and c0."""
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(rng.normal(size=(t, b, 4 * h)).astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.normal(size=(h, 4 * h)).astype(np.float32) * 0.02)
    return (xp.transpose(0, 1).contiguous().to(dev), w.to(dev),
            torch.zeros(b, h, device=dev), torch.zeros(b, h, device=dev))


@torch.inference_mode()
def run(b: int = 64, t: int = 512, h: int = 1024, iters: int = 30,
        modes: tuple = ("full", "matmul_only", "gates_only", "h_bf16"),
        device: str | torch.device | None = None, out=print) -> dict:
    """Time everything and print one line each through ``out`` ->
    {"probe": {mode: ms}, "probe_launches": {mode: kernel launches made for
    that mode, persistent or per step, 0 on the CPU}, "h_bf16_vs_full":
    max |dh| or None,
    "lstm_layer_fused": {state_quant: ms}, "frontend": {"direct": ms,
    "hop_dft": ms}}."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for m in modes:
        if m not in PROBE_MODES:
            raise ValueError(f"probe mode {m!r}: one of {PROBE_MODES}")
    xp, w, h0, c0 = probe_inputs(b, t, h, dev)
    flops = t * b * h * 4 * h * 2
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu (plain versions)"
    out(f"B={b} T={t} H={h} on {where}; recurrent matmul = "
        f"{flops / 1e9:.1f} GFLOP/layer")
    res = {"probe": {}, "probe_launches": {}, "h_bf16_vs_full": None,
           "lstm_layer_fused": {}, "frontend": {}}
    base = None
    # lstm_probe and lstm_probe_persist
    probe_count = lambda: sum(profiling.counters("launch.lstm_probe").values())  # noqa: E731
    for mode in modes:
        before = probe_count()
        ms = _timeit(lambda: lstm_probe(xp, w, h0, c0, mode), iters, dev)
        res["probe"][mode] = ms
        note = (f"  {flops / (ms * 1e-3) / 1e12:6.2f} TFLOP/s"
                if mode != "gates_only" and dev.type == "cuda" else "")
        out(f"{mode:12s} {ms:8.3f} ms  {1e3 * ms / t:7.2f} us/step{note}")
        if mode == "full":
            base = lstm_probe(xp, w, h0, c0, mode)
        if mode == "h_bf16" and base is not None:
            d = (lstm_probe(xp, w, h0, c0, mode) - base).abs().max().item()
            res["h_bf16_vs_full"] = d
            out(f"             h_bf16 max|dh| vs full: {d:.3e}")
        res["probe_launches"][mode] = probe_count() - before
    for sq in STATE_QUANTS:
        ms = _timeit(lambda: lstm_layer_fused(xp, w, state_quant=sq), iters, dev)
        res["lstm_layer_fused"][sq] = ms
        note = f"  {flops / (ms * 1e-3) / 1e12:6.2f} TFLOP/s" if dev.type == "cuda" else ""
        out(f"lstm_layer_fused[{sq:4s}] {ms:8.3f} ms{note}")
    # frontend: direct vs hop-block DFT at the serving shape
    fs, hop = 16000, 256
    n = hop * (t - 1) + 1024
    rng = np.random.default_rng(1)
    wave = torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32) * 0.3).to(dev)
    for hd in (False, True):
        fn = functools.partial(log_power_frontend, wave, fs=fs, wlen_sec=64e-3,
                               hop_percent=0.25, center=False, pad_at_end=True,
                               hop_dft=hd)
        ms = _timeit(fn, iters, dev)
        res["frontend"]["hop_dft" if hd else "direct"] = ms
        out(f"frontend hop_dft={hd!s:5s} {ms:8.3f} ms")
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--modes", default="full,matmul_only,gates_only,h_bf16",
                    help="comma list of probe-kernel modes")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return run(args.b, args.t, args.h, args.iters,
               tuple(m for m in args.modes.split(",") if m), args.device)


if __name__ == "__main__":
    main()
