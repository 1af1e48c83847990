"""Per-utterance classification scoring.

The reference's run_metrics_dnn_classif.py:102-170 loads each utterance's
target h5 and saved predictions, computes frame-level
accuracy/precision/recall/F1, parses SNR/noise/speaker from the path, and
aggregates with compute_stats (:359-367). Same flow here over the .npy
prediction files, as plain functions (no process pool needed — this is
numpy-light). Port of avvad_tpu/evaluate/classify.py: the frame metrics
are the port's ``models.losses.f1_metrics`` on CPU tensors."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.records import load_label
from ..data.sources import parse_utt_metadata
from ..models.losses import f1_metrics
from .predict import prediction_paths
from .stats import compute_stats, roc_auc

METRIC_KEYS = ("accuracy", "precision", "recall", "f1", "auc")


def compute_metrics_utt(processed_dir: str, classif_data_dir: str,
                        proc_noisy_rel: str, label_rel: str,
                        parse_meta: bool = True) -> dict:
    """Score one utterance's saved hard predictions against its target."""
    y = load_label(os.path.join(processed_dir, label_rel))  # (T, y)
    hard_path, soft_path = prediction_paths(classif_data_dir, proc_noisy_rel)
    y_hat_hard = np.load(hard_path)
    y_hat_soft = np.load(soft_path)
    if y_hat_hard.ndim == 2 and y_hat_hard.shape[0] == y.shape[1]:
        y_hat_hard = y_hat_hard.T  # feature-major on disk -> time-major
        y_hat_soft = y_hat_soft.T
    t = min(len(y), len(y_hat_hard))
    acc, prec, rec, f1 = (
        float(v) for v in f1_metrics(
            torch.from_numpy(y_hat_hard[:t].reshape(t, -1).astype(np.float32)),
            torch.from_numpy(np.ascontiguousarray(y[:t].reshape(t, -1))),
        )
    )
    auc = roc_auc(y[:t], y_hat_soft[:t].reshape(t, -1))
    meta = parse_utt_metadata(proc_noisy_rel) if parse_meta else {}
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1,
            "auc": auc, "y_hat_soft": y_hat_soft[:t], **meta}


def score_video_split(source, processed_dir: str, classif_data_dir: str,
                      confidence: float = 0.95, save_stats: bool = True,
                      verbose: bool = True) -> dict:
    """Score matlab_raw-keyed predictions (video-only pipeline, as written
    by scripts/reconstruct.py) with speaker-grouped stats — the
    run_metrics_video_classif.py capability (clean video has no SNR/noise
    axes to group by)."""
    rows, speakers = [], []
    for i in range(len(source)):
        rel = source.rel_path(i)
        m = compute_metrics_utt(processed_dir, classif_data_dir,
                                rel, source.label_rel_path(i),
                                parse_meta=False)
        rows.append([m[k] for k in METRIC_KEYS])
        speakers.append(rel.replace(os.sep, "/").split("/")[-2])
    return compute_stats(
        METRIC_KEYS, rows,
        model_data_dir=classif_data_dir if save_stats else None,
        confidence=confidence, all_speakers=speakers, verbose=verbose,
    )


def score_split(source, processed_dir: str, classif_data_dir: str,
                confidence: float = 0.95, save_stats: bool = True,
                verbose: bool = True, max_workers: int = 0) -> dict:
    """Score every utterance of a source and aggregate grouped stats.

    `max_workers` > 0 fans the per-utterance scoring out over a thread
    pool (the reference used a ProcessPoolExecutor here,
    run_metrics_dnn_classif.py:341-342; file reads and numpy release the GIL)."""
    args = [(processed_dir, classif_data_dir, source.rel_path(i),
             source.label_rel_path(i)) for i in range(len(source))]
    if max_workers:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            metrics = list(pool.map(lambda a: compute_metrics_utt(*a), args))
    else:
        metrics = [compute_metrics_utt(*a) for a in args]

    rows, snrs, noises, speakers = [], [], [], []
    for m in metrics:
        rows.append([m[k] for k in METRIC_KEYS])
        snrs.append(float(m["snr_db"]))
        noises.append(m["noise_type"])
        speakers.append(m["speaker"])

    return compute_stats(
        METRIC_KEYS, rows,
        model_data_dir=classif_data_dir if save_stats else None,
        confidence=confidence,
        all_snr_db=np.asarray(snrs),
        all_noise_types=noises,
        all_speakers=speakers,
        verbose=verbose,
    )
