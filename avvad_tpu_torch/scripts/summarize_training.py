"""Summarize a training run's output_epoch.log into learning curves (port
of scripts/summarize_training.py).

Emits one JSON object (per-epoch train/valid loss + F1, best epochs) and
a compact markdown table sampled at a fixed stride — the learning-curve
evidence QUALITY.md cites. Reads files only (no device); prints and
writes what the JAX script does. Usage:

  python -m avvad_tpu_torch.scripts.summarize_training runs/quality/audio_aug [--stride 10]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re

_EPOCH = re.compile(r"^Epoch:\s*(\d+)")
_ROW = re.compile(r"^\[(Train|Validation)\]\s+Loss:\s*([-\d.na]+)\s+"
                  r"Accuracy:\s*([-\d.na]+)\s+Precision:\s*([-\d.na]+)\s+"
                  r"Recall:\s*([-\d.na]+)\s+F1_score:\s*([-\d.na]+)")


def _num(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return float("nan")


def parse_log(path: str) -> list:
    epochs = []
    cur = None
    with open(path) as f:
        for line in f:
            m = _EPOCH.match(line)
            if m:
                cur = {"epoch": int(m.group(1))}
                epochs.append(cur)
                continue
            m = _ROW.match(line)
            if m and cur is not None:
                tag = "train" if m.group(1) == "Train" else "valid"
                cur[f"{tag}_loss"] = _num(m.group(2))
                cur[f"{tag}_f1"] = _num(m.group(6))
    return epochs


def main(argv=None) -> dict:
    """-> the summary written to ``curve.json`` (or ``--json-out``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("--stride", type=int, default=10)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    log = os.path.join(args.model_dir, "output_epoch.log")
    if not os.path.exists(log):
        raise SystemExit(f"no epoch log at {log}")
    epochs = parse_log(log)
    if not epochs:
        raise SystemExit("no epochs parsed")
    valid = [e for e in epochs if not math.isnan(e.get("valid_loss", float("nan")))]
    best = min(valid, key=lambda e: e["valid_loss"]) if valid else None
    summary = {
        "model_dir": args.model_dir,
        "n_epochs": len(epochs),
        "best_valid_loss": best and {"epoch": best["epoch"],
                                     "loss": best["valid_loss"],
                                     "f1": best.get("valid_f1")},
        "final": epochs[-1],
        "curve": epochs,
    }
    out = args.json_out or os.path.join(args.model_dir, "curve.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)

    print(f"{args.model_dir}: {len(epochs)} epochs; best vloss "
          f"{best['valid_loss']:.3f} @ {best['epoch']}" if best else "n/a")
    print("| epoch | train loss | train F1 | valid loss | valid F1 |")
    print("|---|---|---|---|---|")
    shown = [e for e in epochs
             if e["epoch"] % args.stride == 0 or e is epochs[-1]
             or (best and e["epoch"] == best["epoch"])]
    for e in shown:
        star = " *" if best and e["epoch"] == best["epoch"] else ""
        print(f"| {e['epoch']}{star} | {e.get('train_loss', float('nan')):.3f} "
              f"| {e.get('train_f1', float('nan')):.3f} "
              f"| {e.get('valid_loss', float('nan')):.3f} "
              f"| {e.get('valid_f1', float('nan')):.3f} |")
    return summary


if __name__ == "__main__":
    main()
