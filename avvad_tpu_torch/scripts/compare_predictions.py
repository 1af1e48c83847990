"""Compare two prediction dirs frame by frame (quantization gates) (port
of scripts/compare_predictions.py).

Pairs `<utt>_y_hat_{soft,hard}.npy` files written by the evaluate twin
(layout mirrors the reference's torch.save scheme, the reference's
scripts/evaluate_AV_net.py:249-250) across two runs of the same split —
e.g. the f32 tower vs `--tower-int8 --tower-quant-mode static
[--tower-stem-int8]` — and prints the per-frame soft-probability deltas
and hard-decision flips that back the quantization quality gates in
QUALITY.md. Reads files only (no device); prints what the JAX script
prints.

Usage: python -m avvad_tpu_torch.scripts.compare_predictions REF_DIR TEST_DIR
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> dict:
    """-> {"utterances", "frames", "mean", "p99", "max" (of |dp|), "flips",
    "flip_share"}; ``SystemExit(2)`` where nothing can be compared."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ref_dir", type=Path)
    p.add_argument("test_dir", type=Path)
    args = p.parse_args(argv)

    refs = sorted(args.ref_dir.rglob("*_y_hat_soft.npy"))
    if not refs:
        print(f"no *_y_hat_soft.npy under {args.ref_dir}", file=sys.stderr)
        raise SystemExit(2)
    n_frames = 0
    n_flips = 0
    abs_dp: list[np.ndarray] = []
    missing = 0
    for ref_path in refs:
        rel = ref_path.relative_to(args.ref_dir)
        test_path = args.test_dir / rel
        if not test_path.exists():
            missing += 1
            continue
        a = np.load(ref_path).ravel()
        b = np.load(test_path).ravel()
        if a.shape != b.shape:
            print(f"shape mismatch {rel}: {a.shape} vs {b.shape}", file=sys.stderr)
            raise SystemExit(2)
        abs_dp.append(np.abs(a - b))
        n_frames += a.size
        n_flips += int(np.sum((a > 0.5) != (b > 0.5)))
    if missing:
        print(f"warning: {missing}/{len(refs)} utterances missing from "
              f"{args.test_dir}", file=sys.stderr)
    if not n_frames:
        print("no overlapping utterances", file=sys.stderr)
        raise SystemExit(2)
    dp = np.concatenate(abs_dp)
    out = {"utterances": len(abs_dp), "frames": n_frames, "mean": float(dp.mean()),
           "p99": float(np.percentile(dp, 99)), "max": float(dp.max()),
           "flips": n_flips, "flip_share": n_flips / n_frames}
    print(f"utterances compared: {len(abs_dp)}")
    print(f"frames:              {n_frames}")
    print(f"mean |dp|:           {dp.mean():.6f}")
    print(f"p99  |dp|:           {np.percentile(dp, 99):.6f}")
    print(f"max  |dp|:           {dp.max():.6f}")
    print(f"hard flips:          {n_flips} ({100.0 * n_flips / n_frames:.3f}%)")
    return out


if __name__ == "__main__":
    main()
