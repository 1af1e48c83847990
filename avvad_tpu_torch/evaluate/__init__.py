"""Evaluation (port of avvad_tpu/evaluate): prediction writers,
per-utterance scoring and statistics.

- ``predict``: run a trained model over a split on the card and save each
  utterance's hard and soft predictions (``.npy``, the reference's names);
  ``calibrate_quant_scales`` records the static-int8 tower's scales first;
- ``classify``: per-utterance accuracy, precision, recall, F1 and AUC
  against the targets, aggregated by SNR, noise type and speaker;
- ``stats``: 95 % t-confidence intervals, grouped aggregation, ROC-AUC and
  the SI-SDR family.

The JAX package's ``prewarm_predict`` (XLA compiles ahead, in parallel)
has no PyTorch counterpart and is not ported.
"""

from .classify import compute_metrics_utt, score_split, score_video_split
from .predict import (calibrate_quant_scales, evaluate_split, planned_bucket_shapes,
                      prediction_paths, write_predictions)
from .stats import (compute_stats, energy_ratios, mean_confidence_interval, roc_auc,
                    si_sdr_components)

__all__ = ["calibrate_quant_scales", "compute_metrics_utt", "compute_stats",
           "energy_ratios", "evaluate_split", "mean_confidence_interval",
           "planned_bucket_shapes", "prediction_paths", "roc_auc", "score_split",
           "score_video_split", "si_sdr_components", "write_predictions"]
