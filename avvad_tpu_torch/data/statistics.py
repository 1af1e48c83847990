"""Train-set normalization statistics (a copy of
avvad_tpu/data/statistics.py, HDF5 read and written by the port's own
``hdf5``).

The reference accumulates per-frequency-bin (n, sum, sum^2) across workers
and saves empirical mean/std to `*_statistics.h5` with keys
`X_train_mean` / `X_train_std` shaped (dim, 1)
(the reference's scripts/create_audio_train_files.py:340-392). Same storage
format here (so either framework can consume the other's statistics files),
with a map-reduce merge helper for parallel builders.
"""

from __future__ import annotations

import os

import numpy as np

from .. import hdf5


def welford_merge(stats: list[tuple[float, np.ndarray, np.ndarray]]):
    """Merge (n, sum, sum_sq) partials -> (mean, empirical std).

    std uses the 1/(n-1) empirical estimator, matching
    create_audio_train_files.py:367-368."""
    n = sum(s[0] for s in stats)
    total = sum(s[1] for s in stats)
    total_sq = sum(s[2] for s in stats)
    mean = total / n
    std = np.sqrt((1.0 / (n - 1)) * (total_sq - n * mean**2))
    return mean, std


def save_statistics(path: str, mean: np.ndarray, std: np.ndarray,
                    dataset_type: str = "train") -> None:
    mean = np.atleast_1d(np.asarray(mean, dtype=np.float32))
    std = np.atleast_1d(np.asarray(std, dtype=np.float32))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with hdf5.File(path, "w") as f:
        f.create_dataset(f"X_{dataset_type}_mean", data=mean[..., None])
        f.create_dataset(f"X_{dataset_type}_std", data=std[..., None])


def load_statistics(path: str, dataset_type: str = "train"):
    """-> (mean, std), each (dim, 1) float32 — the shape consumers broadcast
    against the feature axis via `.T` (train_AV_net.py:286-291)."""
    with hdf5.File(path, "r") as f:
        mean = f[f"X_{dataset_type}_mean"][:]
        std = f[f"X_{dataset_type}_std"][:]
    return mean.astype(np.float32), std.astype(np.float32)
