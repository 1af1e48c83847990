"""Frame-rate schedules (copies of avvad_tpu/processing/video.py:97-144)."""

from __future__ import annotations

import numpy as np


def fps_resample_indices(n_in: int, rate_in: float, rate_out: float) -> np.ndarray:
    """ffmpeg `fps` filter duplication schedule: output index -> input index.

    Input frame i occupies output indices [start(i), start(i+1)) with
    start(i) = round-half-away-from-zero(i * rate_out / rate_in)
    (ffmpeg AV_ROUND_NEAR_INF). Output length = start(n_in).
    """
    starts = np.floor(np.arange(n_in + 1) * rate_out / rate_in + 0.5).astype(np.int64)
    n_out = int(starts[-1])
    return np.searchsorted(starts, np.arange(n_out), side="right") - 1


def fps_block_schedule(k0: int, n_out: int, rate_in: float,
                       rate_out: float) -> tuple[int, np.ndarray]:
    """Streaming counterpart of `fps_resample_indices`: the schedule for
    one block of output frames [k0, k0 + n_out).

    Returns ``(src_lo, rel)`` where output frame k0 + j duplicates source
    frame ``src_lo + rel[j]`` (rel int32, non-decreasing, rel[0] == 0).
    Identical to slicing `fps_resample_indices`'s whole-sequence schedule
    at [k0, k0+n_out) for any rates and any stream position: it evaluates
    the same start(i) = floor(i*rate_out/rate_in + 0.5) formula on just
    the block's source neighbourhood.
    """
    r = rate_in / rate_out
    i_lo = max(int(k0 * r) - 2, 0)
    i_hi = int((k0 + n_out) * r) + 3
    i = np.arange(i_lo, i_hi + 1, dtype=np.int64)
    starts = np.floor(i * rate_out / rate_in + 0.5).astype(np.int64)
    ks = np.arange(k0, k0 + n_out, dtype=np.int64)
    src = i_lo + np.searchsorted(starts, ks, side="right") - 1
    return int(src[0]), (src - src[0]).astype(np.int32)


def fps_block_src_max(n_out: int, rate_in: float, rate_out: float,
                      horizon_blocks: int = 4096) -> int:
    """Max distinct source frames any [k0, k0+n_out) block needs when k0
    advances in steps of n_out. Scanned over `horizon_blocks` phases plus
    the analytic bound; for rational rate ratios the phase pattern cycles
    well inside the default horizon."""
    bound = int(np.ceil(n_out * rate_in / rate_out)) + 1
    best = 0
    for t in range(horizon_blocks):
        _, rel = fps_block_schedule(t * n_out, n_out, rate_in, rate_out)
        best = max(best, int(rel[-1]) + 1)
        if best == bound:
            break
    return best


def unique_frame_schedule(t_frames: int, video_fps: float = 30.0,
                          frame_rate: float = 62.5) -> tuple[int, np.ndarray]:
    """-> (t_src, indices): the fewest camera-rate source frames that cover
    ``t_frames`` audio frames, and the (t_frames,) gather onto the audio
    timeline (the serving layout of bench.py:433-438)."""
    t_src = int(np.ceil(t_frames * video_fps / frame_rate))
    while len(fps_resample_indices(t_src, video_fps, frame_rate)) < t_frames:
        t_src += 1
    return t_src, fps_resample_indices(t_src, video_fps, frame_rate)[:t_frames]
