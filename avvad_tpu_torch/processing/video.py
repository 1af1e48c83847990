"""Frame-rate schedule (copy of avvad_tpu/processing/video.py:97)."""

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


def unique_frame_schedule(t_frames: int, video_fps: float = 30.0,
                          frame_rate: float = 62.5) -> tuple[int, np.ndarray]:
    """-> (t_src, indices): the fewest camera-rate source frames that cover
    ``t_frames`` audio frames, and the (t_frames,) gather onto the audio
    timeline (the serving layout of bench.py:433-438)."""
    t_src = int(np.ceil(t_frames * video_fps / frame_rate))
    while len(fps_resample_indices(t_src, video_fps, frame_rate)) < t_frames:
        t_src += 1
    return t_src, fps_resample_indices(t_src, video_fps, frame_rate)[:t_frames]
