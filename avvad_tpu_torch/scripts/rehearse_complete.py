"""Complete-corpus dress rehearsal (port of scripts/rehearse_complete.sh).

Synthesize a full NTCD-TIMIT-shaped raw tree (6 noises x 3 SNRs x 20
speakers x 10 utts — thousands of files in the reference's u/drspeech
raw-noisy layout), then drive the ENTIRE offline + training + evaluation
chain at --dataset-size complete through the twins' ``main``s, in this
process: create_train_files (audio + video builders with per-bin
statistics), one audio and one AV training epoch, evaluate over the
complete test split and run_metrics with the grouped per-SNR / per-noise
tables, for audio and then AV. Everything only the subset layout
exercises — path resolution at grid scale, builder throughput, bucketed
loading over ~540-item splits — runs here.

The shell script's environment (``REHEARSAL_DIR``, ``REHEARSAL_EPOCHS``)
are the flags ``--dir`` and ``--epochs``; its speaker and utterance counts
are flags at its values; the utterances' lengths are the synthesizer's
defaults (a raw tree already under ``--dir`` is kept, as the shell script
keeps it, so synthesize one first with ``synth_complete_corpus`` for other
lengths). ``--config`` is the shell script's ``configs/reference_av.yaml``
unless given a smaller copy, as a CPU run needs; evaluate takes the
model's widths from it, as the shell script's defaults equal the reference
configuration's. ``--device`` is passed to every step: the card unless
given ``--device cpu``.

Example (a tiny rehearsal on the CPU):
  python -m avvad_tpu_torch.scripts.rehearse_complete --dir runs/rehearsal_cpu \\
      --train-speakers 2 --dev-speakers 1 --test-speakers 1 --utts 2 \\
      --config my_tiny.yaml --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

from ._common import add_device_flag, device_of

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir", default="runs/rehearsal",
                   help="the rehearsal's root (raw tree, processed tree, models, "
                        "predictions)")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--config", default=os.path.join(REPO, "configs/reference_av.yaml"))
    p.add_argument("--train-speakers", type=int, default=14)
    p.add_argument("--dev-speakers", type=int, default=3)
    p.add_argument("--test-speakers", type=int, default=3)
    p.add_argument("--utts", type=int, default=10)
    p.add_argument("--workers", type=int, default=0,
                   help="the builders' process pool (0 = serial)")
    add_device_flag(p)
    return p


def _count_files(root: str) -> int:
    return sum(len(files) for _, _, files in os.walk(root))


def stages(args) -> list:
    """The rehearsal's six steps in order -> [(key, banner, fn)], each
    ``fn()`` running its twins' ``main``s and returning their results."""
    from ..config import load_yaml
    from . import (create_train_files, evaluate, run_metrics, synth_complete_corpus,
                   train)

    root = args.dir
    raw, proc = os.path.join(root, "data", "raw"), os.path.join(root, "data", "processed")
    data = os.path.join(root, "data")
    dev = ["--device", args.device] if args.device else []
    model = load_yaml(args.config).model
    widths = ["--lstm-hidden", str(model.lstm_hidden_size), "--lstm-layers",
              str(model.lstm_layers), "--mcb" if model.use_mcb else "--no-mcb"]

    def synthesize():
        out = None
        if not os.path.exists(os.path.join(raw, "ntcd_timit")):
            out = synth_complete_corpus.main([
                "--out", raw, "--train-speakers", str(args.train_speakers),
                "--dev-speakers", str(args.dev_speakers), "--test-speakers",
                str(args.test_speakers), "--utts", str(args.utts)])
        n = _count_files(raw)
        print(f"raw files: {n}")
        return {"raw_files": n, "synth": out}

    def build():
        t0 = time.perf_counter()
        counts = create_train_files.main([
            "--raw-dir", raw, "--processed-dir", proc, "--dataset-size", "complete",
            "--splits", "train", "validation", "test", "--workers", str(args.workers),
            *dev])
        wall = time.perf_counter() - t0
        line = f"builder wall: {int(wall)} s"
        print(line)
        with open(os.path.join(root, "builder_time.txt"), "w") as f:
            f.write(line + "\n")
        n = _count_files(proc)
        print(f"processed files: {n}")
        # train / evaluate read the quality-pipeline layout (<root>/<size>/processed)
        os.makedirs(os.path.join(data, "complete"), exist_ok=True)
        link = os.path.join(data, "complete", "processed")
        if not os.path.lexists(link):
            os.symlink(os.path.join("..", "processed"), link)
        return {"counts": counts, "seconds": wall, "processed_files": n}

    def fit(modality):
        return lambda: train.main([
            "--config", args.config, "--modality", modality, "--data-root", data,
            "--dataset-size", "complete", "--epochs", str(args.epochs),
            "--model-dir", os.path.join(root, modality), *dev])

    def score(modality):
        def run():
            preds = os.path.join(root, f"{modality}_preds")
            report = evaluate.main([
                "--modality", modality, "--data-root", data, "--dataset-size",
                "complete", "--split", "test", "--checkpoint",
                os.path.join(root, modality), "--output-dir", preds, *widths, *dev])
            out = os.path.join(root, f"{modality}_metrics.txt")
            with open(out, "w") as f, contextlib.redirect_stdout(f):
                stats = run_metrics.main([
                    "--data-root", data, "--dataset-size", "complete", "--split",
                    "test", "--predictions-dir", preds, *dev])
            with open(out) as f:
                print("".join(f.readlines()[:8]), end="")
            return {"evaluate": report, "metrics": stats}
        return run

    return [("synthesize", "synthesize the raw complete-mode tree", synthesize),
            ("build", "offline builders at complete size", build),
            ("train_audio", "audio training epoch(s) at complete size", fit("audio")),
            ("train_av", "AV training epoch(s) at complete size", fit("av")),
            ("audio", "evaluate + metrics over the complete test grid", score("audio")),
            ("av", "AV evaluate + metrics", score("av"))]


def main(argv=None) -> dict:
    """-> {stage key: its result}."""
    args = build_parser().parse_args(argv)
    device_of(args)
    steps = stages(args)
    results = {}
    for i, (key, banner, fn) in enumerate(steps, 1):
        print(f"=== [{i}/{len(steps)}] {banner} ===")
        results[key] = fn()
    print("COMPLETE-CORPUS REHEARSAL DONE")
    return results


if __name__ == "__main__":
    main()
