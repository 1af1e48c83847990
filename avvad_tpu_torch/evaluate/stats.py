"""Statistics: confidence intervals, grouped aggregation, SI-SDR family.

Same math as the reference's packages/metrics.py:5-131, with two upgrades:
`compute_stats` returns the full nested stats dict (overall + per-group)
and optionally writes it as JSON — the reference only printed tables and
left its json dump commented out (metrics.py:86-88).

A copy of avvad_tpu/evaluate/stats.py.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import scipy.stats


def mean_confidence_interval(data, confidence: float = 0.95):
    """(mean, half-width of the t-distribution CI), both rounded to 3."""
    a = 1.0 * np.array(data)
    n = len(a)
    m, se = np.mean(a), scipy.stats.sem(a)
    h = se * scipy.stats.t.ppf((1 + confidence) / 2.0, n - 1)
    return np.round(m, 3), np.round(h, 3)


def si_sdr_components(s_hat: np.ndarray, s: np.ndarray, n: np.ndarray):
    """Decompose s_hat = alpha_s*s + alpha_n*n + e_art."""
    alpha_s = np.dot(s_hat, s) / np.linalg.norm(s) ** 2
    s_target = alpha_s * s
    alpha_n = np.dot(s_hat, n) / np.linalg.norm(n) ** 2
    e_noise = alpha_n * n
    e_art = s_hat - s_target - e_noise
    return s_target, e_noise, e_art


def energy_ratios(s_hat: np.ndarray, s: np.ndarray, n: np.ndarray):
    """(SI-SDR, SI-SIR, SI-SAR) in dB."""
    s_target, e_noise, e_art = si_sdr_components(s_hat, s, n)
    si_sdr = 10 * np.log10(
        np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise + e_art) ** 2
    )
    si_sir = 10 * np.log10(
        np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_noise) ** 2
    )
    si_sar = 10 * np.log10(
        np.linalg.norm(s_target) ** 2 / np.linalg.norm(e_art) ** 2
    )
    return si_sdr, si_sir, si_sar


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Frame-level ROC-AUC via the rank statistic (ties averaged).

    The upstream paper reports per-condition AUC (Ariav & Cohen 2019,
    cited at the reference's README.md:3-5) but the reference code never
    computes it; provided here for headline-metric parity with the paper.
    """
    y = np.asarray(y_true).ravel() > 0.5
    s = np.asarray(y_score, dtype=np.float64).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, y.size + 1)
    # average ranks over score ties
    sorted_s = s[order]
    i = 0
    while i < y.size:
        j = i
        while j + 1 < y.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _table(metrics: dict, confidence: float, out_lines: list) -> dict:
    stats = {}
    out_lines.append("{:<10} {:<10} {:<10}".format("METRIC", "AVERAGE", "CONF. INT."))
    for key, values in metrics.items():
        m, h = mean_confidence_interval(values, confidence=confidence)
        stats[key] = {"avg": float(m), "+/-": float(h)}
        out_lines.append("{:<10} {:<10} {:<10}".format(key, m, h))
    out_lines.append("")
    return stats


def compute_stats(
    metrics_keys: Sequence[str],
    all_metrics: Sequence[Sequence[float]],
    model_data_dir: Optional[str] = None,
    confidence: float = 0.95,
    all_snr_db=None,
    all_noise_types=None,
    all_speakers=None,
    verbose: bool = True,
) -> dict:
    """Aggregate per-utterance metric tuples: overall and grouped by SNR /
    noise type / speaker. Prints the reference-format tables; returns (and
    optionally saves) the nested stats dict."""
    metrics = {key: [row[i] for row in all_metrics]
               for i, key in enumerate(metrics_keys)}

    lines: list[str] = []
    result = {"overall": _table(metrics, confidence, lines)}

    def grouped(tag, group_values):
        out = {}
        for g in sorted(set(group_values), key=str):
            lines.append(f"{tag} = {g}")
            sub = {
                k: [v for v, gv in zip(vals, group_values) if gv == g]
                for k, vals in metrics.items()
            }
            out[str(g)] = _table(sub, confidence, lines)
        return out

    if all_snr_db is not None:
        result["by_snr_db"] = grouped("Input SNR", list(all_snr_db))
    if all_noise_types is not None:
        result["by_noise_type"] = grouped("Noise type", list(all_noise_types))
    if all_speakers is not None:
        result["by_speaker"] = grouped("Speaker", list(all_speakers))

    if verbose:
        print("\n".join(lines))
    if model_data_dir:
        os.makedirs(model_data_dir, exist_ok=True)
        with open(os.path.join(model_data_dir, "stats.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result
