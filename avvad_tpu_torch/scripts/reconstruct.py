"""Sequential single-utterance video-net inference with on-the-spot F1 and
.npy prediction dumps (port of scripts/reconstruct.py).

Covers the reference's scripts/reconstruct_dnn_classif.py (which, as
committed, crashes on a missing y_dim argument — reconstruct_dnn_classif.py:103;
this one runs). Functionally it is evaluate+score in one pass over the
video modality, printing per-utterance metrics as it goes. On the card the
LSTM runs in the hand-written inference kernel (K1a).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ._common import add_device_flag, build_model, device_of, processed_root, restore


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset-size", default="subset")
    p.add_argument("--labels", default="vad_labels")
    p.add_argument("--upsampled", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--split", default="test")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--bucket", type=int, default=128)
    add_device_flag(p)
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    from ..config import LabelConfig
    from ..data import DataLoader, VideoSequenceSource
    from ..models.losses import f1_metrics
    from ..train import make_predict_step
    from ..train.state import TrainState

    device = device_of(args)
    processed = processed_root(args.data_root, args.dataset_size)
    src = VideoSequenceSource(processed, args.split, args.labels,
                              upsampled=args.upsampled)
    print(f"{args.split}: {len(src)} utterances")

    model = build_model("video", LabelConfig(kind=args.labels).y_dim, args.lstm_hidden,
                        args.lstm_layers)
    norm_stats, _ = restore(args.checkpoint, model, device)
    state = TrainState(model.eval(), None, device)
    predict = make_predict_step("video")

    loader = DataLoader(src, batch_size=1, shuffle=False, bucket=args.bucket)
    rows = []
    for i, batch in enumerate(loader):
        y_soft = predict(state, batch, norm_stats).float().cpu().numpy()[0]
        length = int(batch.lengths[0])
        y_soft = y_soft[:length]
        y_hard = (y_soft > 0.5).astype(np.float32)
        y_true = np.asarray(batch.label[0, :length])
        acc, prec, rec, f1 = (float(v) for v in f1_metrics(
            torch.from_numpy(y_hard), torch.from_numpy(y_true)))
        out = os.path.join(args.output_dir,
                           os.path.splitext(src.rel_path(i))[0] + "_y_hat_hard.npy")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.save(out, y_hard[..., 0] if y_hard.shape[-1] == 1 else y_hard.T)
        print(f"{src.rel_path(i)}: acc={acc:.3f} prec={prec:.3f} "
              f"rec={rec:.3f} f1={f1:.3f} -> {out}")
        rows.append({"rel_path": src.rel_path(i), "accuracy": acc, "precision": prec,
                     "recall": rec, "f1": f1, "soft": y_soft})
    return rows


if __name__ == "__main__":
    main()
