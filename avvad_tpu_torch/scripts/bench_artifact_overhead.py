"""Serving-artifact overhead of the port: an exported program against the
live step (counterpart of scripts/bench_artifact_overhead.py).

``export.ServingArtifact`` holds the serving step as a ``torch.export``
program, the kernels as custom ops; its ``call`` should run at the speed of
the live ``make_waveform_serving_fn`` step it was exported from. Both are
timed at a small serving shape (B=8, T=64) on AVVAD bf16 (MCB, 2 x LSTM
1024, the float tower), each with bench.py's chained timing (``bench.
time_serve``): warm-ups, then ``--iters`` steps each fed wave + carry x 0,
the carry the previous output's first value, and a value fetch at the end.

Prints the JAX script's line, then one json record (``metric``
"artifact_overhead", ``value`` the artifact's ms over the live step's).

    python -m avvad_tpu_torch.scripts.bench_artifact_overhead [--b 8] [--t 64]
        [--iters 20] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` (the plain versions; the
numbers measure nothing there).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from ._common import add_device_flag, device_of
from .bench import n_samples, time_serve


def build(b: int, t: int, device: torch.device, state_dict: Optional[dict] = None,
          lstm_hidden: int = 1024, inputs: Optional[tuple] = None) -> tuple:
    """The JAX script's model and inputs (bench_artifact_overhead.py:62-70):
    AVVAD bf16, MCB, 2 x LSTM, float tower, video at the audio frame rate
    -> (live step, artifact, wave, video) on ``device``."""
    from ..export import ServingArtifact, make_waveform_serving_fn
    from ..models import AVVAD

    model = AVVAD(lstm_hidden_size=lstm_hidden, lstm_layers=2, use_mcb=True,
                  use_kernel_lstm=True, dtype=torch.bfloat16)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    if inputs is None:
        rng = np.random.default_rng(0)
        inputs = (rng.standard_normal((b, n_samples(t)), np.float32),
                  rng.standard_normal((b, t, 67, 67), np.float32))
    wave, video = (torch.as_tensor(np.asarray(x, np.float32), device=device) for x in inputs)
    fn = make_waveform_serving_fn(model, t_frames=t, device=device)
    art = ServingArtifact.build({"e": (fn, (wave, video))})
    return fn, art, wave, video


def main(argv=None, on_built=None) -> dict:
    """-> the record. ``on_built(live step, artifact, wave, video)``, if
    given, is called once the timing is done."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    fn, art, wave, video = build(args.b, args.t, device)
    d = time_serve(fn, (wave, video), args.iters, 1)[0]
    a = time_serve(lambda w, v: art.call("e", w, v), (wave, video), args.iters, 1)[0]
    print(f"direct: {d * 1e3:.2f} ms; artifact.call: {a * 1e3:.2f} ms; "
          f"overhead: {(a - d) * 1e3:+.2f} ms ({(a / d - 1) * 100:+.1f}%)")
    rec = {"metric": "artifact_overhead", "value": a / d, "unit": "artifact ms over live ms",
           "direct_ms": d * 1e3, "artifact_ms": a * 1e3, "overhead_ms": (a - d) * 1e3,
           "b": args.b, "t": args.t}
    print(json.dumps(rec), flush=True)
    if on_built is not None:
        on_built(fn, art, wave, video)
    return rec


if __name__ == "__main__":
    main()
