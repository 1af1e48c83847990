"""Score saved predictions: per-utterance accuracy/precision/recall/F1 +
95% CI tables grouped by SNR / noise type / speaker (port of
scripts/run_metrics.py).

CLI covering run_metrics_{dnn,video}_classif.py
(the reference's scripts/run_metrics_dnn_classif.py:102-367). The scoring
is host numpy. ``--figures`` needs the JAX package's ``visualization``
(matplotlib), which the port does not have yet: it raises.
"""

from __future__ import annotations

import argparse
import os

from ._common import add_device_flag, device_of, processed_root


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset-size", choices=["subset", "complete"], default="subset")
    p.add_argument("--labels", default="vad_labels")
    p.add_argument("--upsampled", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--split", default="test")
    p.add_argument("--predictions-dir", required=True,
                   help="classif_data_dir holding *_y_hat_*.npy files")
    p.add_argument("--figures", action="store_true",
                   help="render wav/spectrogram/mask PNG per utterance (not "
                        "ported: raises)")
    p.add_argument("--confidence", type=float, default=0.95)
    p.add_argument("--video-classif", action="store_true",
                   help="score matlab_raw-keyed video-net predictions "
                        "(run_metrics_video_classif.py equivalent)")
    add_device_flag(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..data import AudioSequenceSource, VideoSequenceSource
    from ..evaluate import score_split, score_video_split

    device_of(args)
    if args.figures:
        raise SystemExit("--figures: the per-utterance figures need visualization.py "
                         "(matplotlib), which the port does not have yet")
    processed = processed_root(args.data_root, args.dataset_size)
    if args.video_classif:
        vsource = VideoSequenceSource(processed, args.split, args.labels,
                                      upsampled=args.upsampled)
        print(f"{args.split} utterances: {len(vsource)}")
        stats = score_video_split(vsource, processed, args.predictions_dir + os.sep,
                                  confidence=args.confidence)
    else:
        source = AudioSequenceSource(processed, args.split, args.dataset_size,
                                     args.labels, upsampled=args.upsampled)
        print(f"{args.split} utterances: {len(source)}")
        stats = score_split(source, processed, args.predictions_dir + os.sep,
                            confidence=args.confidence)
    print("stats.json ->", os.path.join(args.predictions_dir, "stats.json"))
    return stats


if __name__ == "__main__":
    main()
