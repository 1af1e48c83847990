"""Build the processed dataset tree from a raw NTCD-TIMIT corpus: decoded +
upsampled lip videos, VAD/IBM labels, clean/noisy wav copies, and train-set
normalization statistics (port of scripts/create_train_files.py).

CLI covering both offline builders of the reference
(the reference's scripts/create_video_train_files_upsampled.py and
create_audio_train_files.py), without the ffmpeg dependency. The work is
host numpy (``builders``); the lip videos and labels are HDF5 files
written by the port's own ``hdf5``. ``--device`` names the card the
build belongs to: it computes nothing there, but a run without a card
raises as every entry point does, unless given ``--device cpu``.

Example (rebuild the subset tree):
  python -m avvad_tpu_torch.scripts.create_train_files --raw-dir data/subset/raw \\
      --processed-dir data/subset/processed --dataset-size subset \\
      --splits train validation test
"""

from __future__ import annotations

import argparse
import os
import time

from ._common import add_device_flag, device_of


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--raw-dir", required=True)
    p.add_argument("--processed-dir", required=True)
    p.add_argument("--dataset-size", choices=["subset", "complete"], default="subset")
    p.add_argument("--labels", choices=["vad_labels", "ibm_labels"],
                   default="vad_labels")
    p.add_argument("--splits", nargs="+",
                   default=["train", "validation", "test"])
    p.add_argument("--hop-percent", type=float, default=0.25)
    p.add_argument("--upsampled-suffix", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="name labels *_<labels>_upsampled.h5 (the naming the "
                        "reference's live AV config expects)")
    p.add_argument("--workers", type=int, default=None,
                   help="process pool size (0 = serial)")
    p.add_argument("--what", choices=["all", "video", "audio"], default="all")
    add_device_flag(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..builders import BuildConfig, build_audio_split, build_video_split, worker_pool
    from ..config import LabelConfig, STFTConfig

    device_of(args)
    cfg = BuildConfig(
        raw_dir=args.raw_dir if args.raw_dir.endswith(os.sep) else args.raw_dir + os.sep,
        processed_dir=(args.processed_dir if args.processed_dir.endswith(os.sep)
                       else args.processed_dir + os.sep),
        dataset_size=args.dataset_size,
        stft=STFTConfig(hop_percent=args.hop_percent),
        label=LabelConfig(kind=args.labels),
        upsampled_suffix=args.upsampled_suffix,
        max_workers=args.workers,
    )
    counts = {}
    with worker_pool(cfg.max_workers):
        for split in args.splits:
            t0 = time.perf_counter()
            if args.what in ("all", "video"):
                n = counts[f"{split}/video"] = build_video_split(cfg, split)
                print(f"[{split}] video: {n} utterances "
                      f"({time.perf_counter() - t0:.1f}s)")
            if args.what in ("all", "audio"):
                t1 = time.perf_counter()
                n = counts[f"{split}/audio"] = build_audio_split(cfg, split)
                print(f"[{split}] audio: {n} files "
                      f"({time.perf_counter() - t1:.1f}s)")
    return counts


if __name__ == "__main__":
    main()
