"""Score saved predictions: per-utterance accuracy/precision/recall/F1 +
95% CI tables grouped by SNR / noise type / speaker (port of
scripts/run_metrics.py).

CLI covering run_metrics_{dnn,video}_classif.py
(the reference's scripts/run_metrics_dnn_classif.py:102-367). The scoring
is host numpy. ``--figures`` renders one ``*_hard_mask.png`` an utterance
through the port's ``visualization``, which needs matplotlib: where it is
missing the run raises a named ``ImportError`` before it scores anything.
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
                   help="render wav/spectrogram/mask PNG per utterance")
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
    if args.figures and not args.video_classif:
        from ..visualization import pyplot

        pyplot("run_metrics --figures")
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
        if args.figures:
            write_figures(source, processed, args.predictions_dir)
    print("stats.json ->", os.path.join(args.predictions_dir, "stats.json"))
    return stats


def write_figures(source, processed: str, predictions_dir: str) -> None:
    """One ``<utt>_hard_mask.png`` an utterance under ``predictions_dir``:
    the noisy wav, its spectrogram and its label mask beside the hard
    predictions."""
    import numpy as np

    from ..data.records import load_label
    from ..evaluate.classify import compute_metrics_utt
    from ..processing import read_wav, stft
    from ..processing.audio_io import peak_normalize
    from ..visualization import display_multiple_signals, pyplot

    plt, _ = pyplot("run_metrics --figures")
    for i in range(len(source)):
        noisy_rel = source.rel_path(i)
        m = compute_metrics_utt(processed, predictions_dir + os.sep, noisy_rel,
                                source.label_rel_path(i))
        x, fs = read_wav(os.path.join(processed, noisy_rel))
        x = peak_normalize(x)
        s = stft(x, fs=fs)
        y = load_label(os.path.join(processed, source.label_rel_path(i))).T
        y_hat = np.atleast_2d(m["y_hat_soft"].T > 0.5).astype(np.float32)
        fig = display_multiple_signals([[x, s, y], [None, None, y_hat]], fs=fs,
                                       last_only_label=False)
        out = os.path.join(predictions_dir,
                           os.path.splitext(noisy_rel)[0] + "_hard_mask.png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        fig.savefig(out)
        plt.close(fig)
        print("wrote", out)


if __name__ == "__main__":
    main()
