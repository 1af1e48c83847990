"""Padded, bucketed batch assembly (numpy; a copy of
avvad_tpu/data/batching.py: ``Batch``, ``bucket_length``, ``pad_batch``).

Batches stay numpy on the host; the train, eval and predict steps move
their arrays to the step's device. Layouts, mask explicit:
  audio   (B, T, 513)    video (B, T, 67, 67)    label (B, T, y_dim)
  lengths (B,) int32     mask  (B, T) float32 (1 on valid frames)
``bucket`` rounds T up to a multiple (``ladder``: onto a geometric ladder
of multiples) so that a run sees few distinct shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Batch(NamedTuple):
    """A padded batch. Unused modalities are None."""

    audio: Optional[np.ndarray]
    video: Optional[np.ndarray]
    label: Optional[np.ndarray]
    lengths: np.ndarray
    mask: np.ndarray
    waveform: Optional[np.ndarray] = None
    time_lengths: Optional[np.ndarray] = None
    # source indices of each row ((B,) int32, -1 on padded rows) so
    # consumers (e.g. the prediction writer) can identify utterances
    # without re-deriving the loader's batch plan
    indices: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def max_frames(self) -> int:
        return int(self.mask.shape[1])


def bucket_length(t: int, bucket: Optional[int],
                  ladder: bool = False) -> int:
    """Round t up to a multiple of `bucket` (identity if bucket is falsy).

    With `ladder=True` the multiple is further rounded up onto the
    geometric ladder {1, 2, 3, 4, 6, 8, 12, 16, ...}·bucket (alternating
    x1.5/x1.33 steps): distinct padded lengths grow O(log T) instead of
    O(T/bucket), at <50% padded-frame overhead."""
    if not bucket:
        return t
    m = (t + bucket - 1) // bucket
    if ladder and m > 4:
        # smallest element of {4, 6, 8, 12, 16, 24, ...} = {2^k, 3*2^k} >= m
        c, half_step = 4, True
        while c < m:
            c = c * 3 // 2 if half_step else c * 4 // 3
            half_step = not half_step
        m = c
    return m * bucket


def _pad_time(arrs: list[np.ndarray], t_pad: int) -> np.ndarray:
    out = np.zeros((len(arrs), t_pad) + arrs[0].shape[1:], dtype=np.float32)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def pad_batch(items: list[dict], bucket: Optional[int] = None,
              bucket_ladder: bool = False,
              pad_batch_to: Optional[int] = None,
              source_indices: Optional[list] = None) -> Batch:
    """Zero-pad a list of utterance dicts into a Batch.

    `bucket` buckets the time dimension (`bucket_ladder` snaps the
    multiple onto the geometric ladder, see bucket_length);
    `pad_batch_to` pads the batch
    dimension with repeated last items masked to length 0 (a fixed batch
    size for the final partial batch). `source_indices` (one per item)
    are carried on the Batch, -1 on padded rows.
    """
    lengths = np.asarray([it["length"] for it in items], dtype=np.int32)
    n_real = len(items)
    indices = None
    if source_indices is not None:
        if len(source_indices) != n_real:
            raise ValueError(
                f"{len(source_indices)} source_indices for {n_real} items")
        indices = np.asarray(source_indices, dtype=np.int32)
    if pad_batch_to and len(items) < pad_batch_to:
        items = items + [items[-1]] * (pad_batch_to - len(items))
        lengths = np.concatenate(
            [lengths, np.zeros(pad_batch_to - n_real, dtype=np.int32)]
        )
    if indices is not None and len(items) > n_real:
        indices = np.concatenate(
            [indices, np.full(len(items) - n_real, -1, dtype=np.int32)]
        )

    t_pad = bucket_length(max(it["length"] for it in items), bucket,
                          ladder=bucket_ladder)

    def maybe(key):
        if key not in items[0]:
            return None
        return _pad_time(
            [np.asarray(it[key], dtype=np.float32)[: it["length"]] for it in items],
            t_pad,
        )

    audio = maybe("audio")
    video = maybe("video")
    label = maybe("label")

    waveform = None
    time_lengths = None
    if "waveform" in items[0]:
        time_lengths = np.asarray([it["time_length"] for it in items], dtype=np.int32)
        # mask out padded batch rows
        if pad_batch_to and n_real < len(items):
            time_lengths[n_real:] = 0
        wt = int(max(it["time_length"] for it in items))
        waveform = np.zeros((len(items), wt), dtype=np.float32)
        for i, it in enumerate(items):
            waveform[i, : it["time_length"]] = it["waveform"]

    mask = (np.arange(t_pad)[None, :] < lengths[:, None]).astype(np.float32)
    return Batch(audio=audio, video=video, label=label, lengths=lengths,
                 mask=mask, waveform=waveform, time_lengths=time_lengths,
                 indices=indices)
