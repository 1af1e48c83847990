"""Prediction writers: run a trained model over a split, save per-utterance
hard and soft frame predictions (port of avvad_tpu/evaluate/predict.py).

The reference fans batch-1 inference out over a spawn pool of GPUs
(the reference's scripts/evaluate_AV_net.py:252-339) and torch.saves
``<utt>_y_hat_{hard,soft}.pt`` under ``data/<size>/models/<classif_name>/``
(:239-250). Here, as in the JAX package, utterances are length-sorted into
bucketed, padded batches and classified by one predict step a batch, with
the same ``.npy`` names and directory layout.

Not ported: ``prewarm_predict`` and ``evaluate_split(prewarm=)``, which
compile the XLA programs of every bucket ahead and in parallel (eager
PyTorch compiles nothing per shape), and ``evaluate_split(mesh=)`` (the
utterance axis sharded over devices), which waits for the port's
``torch.distributed`` scale-out.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data import DataLoader, Prefetcher
from ..data.batching import bucket_length
from ..models.quantize import calibrate
from ..train.steps import _forward_inputs, _tensor, make_predict_step


def prediction_paths(classif_data_dir: str, proc_noisy_rel_path: str):
    """-> (hard_path, soft_path) for one utterance, reference layout."""
    stem = os.path.splitext(os.path.join(classif_data_dir, proc_noisy_rel_path))[0]
    return stem + "_y_hat_hard.npy", stem + "_y_hat_soft.npy"


def write_predictions(classif_data_dir: str, proc_noisy_rel_path: str,
                      y_hat_soft: np.ndarray) -> None:
    """Save hard/soft predictions for one utterance; (T,) or (T, y)."""
    hard_path, soft_path = prediction_paths(classif_data_dir, proc_noisy_rel_path)
    os.makedirs(os.path.dirname(hard_path), exist_ok=True)
    y_hat_hard = (y_hat_soft > 0.5).astype(np.int32)
    np.save(hard_path, y_hat_hard)
    np.save(soft_path, y_hat_soft)


def calibrate_quant_scales(state, model, source, modality: str,
                           norm_stats: Optional[dict] = None,
                           n_utts: int = 8, batch_size: int = 4,
                           bucket: int = 128, eps: float = 1e-8):
    """Record int8 activation scales for ``tower_quant_mode="static"``.

    Runs up to ``n_utts`` utterances from ``source`` (normally the train
    split), on the state's device and normalised exactly as the predict
    step normalises them, through ``model`` with its int8 towers in
    "calibrate" mode on the unfused path (``models.quantize.calibrate``),
    which keeps the running max |x| of each quantisation point in the
    tower's scale buffers. JAX returns the state with its ``quant``
    collection filled; here the scales are buffers of ``model`` (normally
    ``state.model``: the JAX signature carries the module because a flax
    state holds none), updated in place, and ``state`` is returned.
    """
    loader = DataLoader(source, batch_size=batch_size, shuffle=False,
                        bucket=bucket, pad_batch_to_full=True)

    def inputs():
        seen = 0
        for batch in loader:
            yield _forward_inputs(modality, batch, norm_stats, eps, state.device)
            seen += int((np.asarray(batch.indices) >= 0).sum())
            if seen >= n_utts:
                return

    calibrate(model, inputs())
    return state


def planned_bucket_shapes(loader) -> list[int]:
    """Distinct padded time lengths `loader`'s batch plan will produce.

    Uses header-only length probes (no feature loads): the padded length of
    each planned batch is the bucketed max of its members' lengths."""
    shapes = set()
    for b in loader.batch_plan():
        t = max(loader._probe_length(int(i)) for i in b)
        shapes.add(bucket_length(t, loader.bucket, loader.bucket_ladder))
    return sorted(shapes)


def _start_download(y: torch.Tensor):
    """Queue ``y``'s copy into a pinned host tensor behind the kernels that
    compute it -> (host tensor, event recorded after the copy); a CPU
    tensor is its own host copy."""
    if y.device.type != "cuda":
        return y, None
    host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    host.copy_(y, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _finish_download(host: torch.Tensor, done) -> np.ndarray:
    if done is not None:
        done.synchronize()
    return host.numpy()


def evaluate_split(
    state,
    source,
    modality: str,
    classif_data_dir: str,
    norm_stats: Optional[dict] = None,
    batch_size: int = 8,
    bucket: int = 128,
    bucket_ladder: bool = True,
    eps: float = 1e-8,
    verbose: bool = True,
) -> dict:
    """Classify every utterance of `source`, write predictions, return a
    wall-clock report (the reference's perf_counter harness,
    evaluate_AV_net.py:336-342).

    Batches go to the state's device through the ``Prefetcher`` (pinned
    memory, a side stream), and the normalisation statistics once, before
    the loop: a pageable upload inside the loop would wait for the previous
    batch's kernels and make the two-deep drain below a serial loop."""
    predict = make_predict_step(modality, eps)
    dev = state.device
    stats = (None if norm_stats is None else
             {k: _tensor(v, dev) for k, v in norm_stats.items()})
    # length-sorted pooling minimizes padding waste; safe with any batch
    # order because utterance identity rides on Batch.indices. The
    # geometric bucket ladder (default on) caps the number of distinct
    # padded shapes; outputs are identical because eval-mode forwards are
    # trailing-pad-invariant (causal LSTM, per-frame towers, running-stat
    # BN) and padded frames are dropped at write time.
    loader = DataLoader(source, batch_size=batch_size, shuffle=False,
                        bucket=bucket, bucket_ladder=bucket_ladder,
                        pad_batch_to_full=True, sort_pool_factor=4)

    t0 = time.perf_counter()
    n_utts = 0
    n_frames = 0

    def drain(y_soft, row_indices, lengths):
        """Write one batch's predictions, (B, T, y) numpy."""
        nonlocal n_utts, n_frames
        for row in range(len(row_indices)):
            src_i = int(row_indices[row])
            length = int(lengths[row])
            if src_i < 0 or length == 0:
                continue  # padded batch row
            noisy_rel = source.rel_path(src_i)
            pred = y_soft[row, :length]
            if pred.shape[-1] == 1:
                pred = pred[..., 0]
            else:
                pred = pred.T  # (y, T): reference feature-major layout
            write_predictions(classif_data_dir, noisy_rel, pred)
            n_utts += 1
            n_frames += length

    # the rows' identities stay on the host, in loader order
    meta = collections.deque()

    def host_batches():
        for batch in loader:
            meta.append((np.asarray(batch.indices), np.asarray(batch.lengths)))
            yield batch

    # two-deep pipeline (the JAX package's order): queue batch N-1's copy to
    # the host BEFORE dispatching batch N, then write N-1's files while N
    # computes, so the card does not wait on file I/O
    pending = None  # (device predictions, row indices, lengths)
    for batch in Prefetcher(host_batches(), device=dev):
        row_indices, lengths = meta.popleft()
        download = None if pending is None else _start_download(pending[0])
        y_dev = predict(state, batch, stats)
        if pending is not None:
            drain(_finish_download(*download), *pending[1:])
        pending = (y_dev, row_indices, lengths)
    if pending is not None:
        drain(_finish_download(*_start_download(pending[0])), *pending[1:])

    elapsed = time.perf_counter() - t0
    report = {
        "n_utterances": n_utts,
        "n_frames": n_frames,
        "elapsed_s": elapsed,
        "audio_seconds": n_frames / 62.5,
        "rt_factor": (n_frames / 62.5) / elapsed if elapsed > 0 else float("inf"),
    }
    if verbose:
        print(f"evaluate_split: {n_utts} utts, {n_frames} frames in "
              f"{elapsed:.2f}s ({report['rt_factor']:.1f}x real time)")
    return report
