"""Readings for setting a cell's limits: the numbers ``correct`` compares,
on many seeds in one process, for the program as the cell runs it and for
its lower-precision control or a planted fault. Prints one JSON line a seed.

    python3 -m benchmark.harness.readings --workload avvad.serve_b64 \\
        --mode control --seeds 11 12 13 --seconds 3

Modes: ``program`` (the cell as it runs); ``control``: for a serving cell
the program with its bf16-state LSTM path on (K1c: h rounded to bf16, where
the configuration states fp32 h), for a training cell the reference computed
with TF32 on, put in the program's place; ``half_batch`` (training): the
reference in the program's place trained on half of each batch, its loss
the mean over the rows it kept scaled to the whole batch. In a training cell
the stand-in takes the program's place in the three first steps and in the
step after the window, which starts from the program's state. A run needs
the card, as the benchmark does."""

from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from ..reference import train as ref_train
from .spec import Cell

def half_batch(batch: dict) -> dict:
    b = batch["mask"].shape[0] // 2
    return {k: None if v is None else v[:b] for k, v in batch.items()}


def stand_in(mode: str):
    """The reference in the program's place: TF32 on, or half of each batch."""
    if mode == "control":
        return lambda w, cfg, batches, lr, **kw: ref_train.run(w, cfg, batches, lr,
                                                                use_tf32=True, **kw)
    return lambda w, cfg, batches, lr, **kw: ref_train.run(
        w, cfg, [half_batch(b) for b in batches], lr, loss_scale=2.0, **kw)


def run_seed(cell, seed: int, mode: str, device, seconds: float) -> dict:
    """One run of the cell's driver, the program or its stand-in compared."""
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=False,
                          device=device, t0=time.perf_counter())
    if cell.mix["driver"] == "train" and mode != "program":
        ctx.stand_in = stand_in(mode)
    return cell.driver().run(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "control", "half_batch"),
                   default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = Cell(args.workload)
    if args.mode == "control" and cell.mix["driver"] == "serve":
        cell.mix = dict(cell.mix, lstm_state_quant="bf16")
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = run_seed(cell, seed, args.mode, device, args.seconds)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          **res["numbers"], "attempted": res["attempted"],
                          **res["end_to_end"], "wall_s": time.perf_counter() - t0}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
