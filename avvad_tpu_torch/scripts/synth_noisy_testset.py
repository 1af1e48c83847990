"""Render a synthetic full-noise-grid split into the processed tree (port
of scripts/synth_noisy_testset.py).

The subset fixture ships ONE noise condition (Babble @ -5 dB). This writes
noisy wavs for the full 6-noise x 3-SNR grid (synthesized noise families,
avvad_tpu_torch.data.augment) under Noisy/<kind>/<snr>/<split>/, mirroring
the corpus layout (the reference's packages/dataset/ntcd_timit.py:330-334)
— after which the evaluate / run_metrics twins with ``--dataset-size
complete`` score all 18 conditions with the reference's grouped-stats
machinery (per-SNR / per-noise / per-speaker tables). Host numpy; the
same seed writes the JAX script's bytes.

Usage:
  python -m avvad_tpu_torch.scripts.synth_noisy_testset --data-root runs/quality/data \\
      --splits test --seed 123
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data-root", required=True,
                    help="parent of subset/processed (quality-pipeline layout)")
    ap.add_argument("--dataset-size", default="subset")
    ap.add_argument("--splits", nargs="+", default=["test"])
    ap.add_argument("--seed", type=int, default=123)
    return ap


def main(argv=None) -> int:
    """-> the number of noisy wavs written."""
    args = build_parser().parse_args(argv)
    from ..data.augment import NOISE_KINDS, SNRS_DB, mix_at_snr, synth_noise
    from ..processing import read_wav, write_wav

    processed = os.path.join(args.data_root, args.dataset_size, "processed")
    split_dir = {"train": "train", "validation": "dev", "test": "test"}
    n_written = 0
    for split in args.splits:
        clean_root = os.path.join(processed, "ntcd_timit/Clean", split_dir[split])
        cleans = []
        for dirpath, _dirs, files in os.walk(clean_root):
            for f in sorted(files):
                if f.endswith(".wav"):
                    cleans.append(os.path.join(dirpath, f))
        if not cleans:
            raise SystemExit(f"no clean wavs under {clean_root}")
        pool = [read_wav(p)[0].astype(np.float32) for p in cleans]
        for ci, path in enumerate(cleans):
            clean, fs = read_wav(path)
            clean = clean.astype(np.float32)
            rel = os.path.relpath(path, clean_root)
            for ki, kind in enumerate(NOISE_KINDS):
                for si, snr in enumerate(SNRS_DB):
                    out = os.path.join(processed, "ntcd_timit/Noisy", kind,
                                       str(int(snr)), split_dir[split], rel)
                    if os.path.exists(out):
                        continue  # keep corpus-rendered conditions
                    rng = np.random.default_rng(np.random.SeedSequence(
                        [args.seed, ci, ki, si]))
                    noise = synth_noise(kind, len(clean), rng, pool)
                    mixed = mix_at_snr(clean, noise, snr)
                    peak = float(np.max(np.abs(mixed)))
                    if peak > 0.98:  # headroom for int16 (load re-normalizes)
                        mixed = mixed * (0.98 / peak)
                    os.makedirs(os.path.dirname(out), exist_ok=True)
                    write_wav(out, mixed, fs)
                    n_written += 1
    print(f"wrote {n_written} synthetic noisy wavs")
    return n_written


if __name__ == "__main__":
    main()
