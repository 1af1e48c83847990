"""Run one benchmark cell once on the card and print its result line.

    python3 benchmark/run.py --workload avvad.serve_b64 --seed 7 --seconds 30 --trace 0

Loads and warms up (``setup_s``), measures for ``--seconds``, checks every
answer of the window against the plain reference, and prints one JSON object
as the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``; the
numbers compared, each beside its limit, come last there and as the last
lines of standard error. Without a CUDA card it fails and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "avvad_tpu")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def per_layer(cell, record: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, res: dict, trace: bool, device) -> dict:
    import torch

    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        metrics = per_layer(cell, res["record"])
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res["end_to_end"].items()
                   if k in units}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell.chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    prof = (res.get("record") or {}).get("profile") or {}
    if trace and prof:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        line["breakdown"] = {k: [[n[:120], s] for n, s in prof[k]]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = {name: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for name, v, lim in res["checks"]}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.harness.spec import Cell

    print(f"setup imports {time.perf_counter() - T0:.3f} s", file=sys.stderr, flush=True)

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    ctx = SimpleNamespace(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, t0=T0)
    res = cell.driver().run(ctx)
    line = result_line(cell, res, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for name, v, lim in res["checks"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
