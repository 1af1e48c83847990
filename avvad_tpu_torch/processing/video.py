"""Lip-video decode and temporal upsampling (host numpy; a copy of
avvad_tpu/processing/video.py).

The NTCD-TIMIT ``matlab_raw/*.mat`` files hold per-frame 2-D DCT
coefficients (frames, 4489). ``decode_dct_frames`` decodes them with the
unnormalised type-2 IDCT as two matrix products, min-max normalises to
[0, 255] (per frame by default, as the reference's shipped fixtures are)
and rotates 90 degrees clockwise. ``fps_resample_indices`` is ffmpeg's
``fps`` filter's duplication schedule, exactly, which re-times the 30 fps
camera to the 62.5 fps STFT rate without ffmpeg; the block schedules serve
the streaming servers. The .mat files are MATLAB v7.3, that is HDF5:
``read_mat_dct`` reads them through the port's own ``hdf5``.
"""

from __future__ import annotations

import numpy as np

from .. import hdf5


def make_idct_matrix(n: int, dtype=np.float64) -> np.ndarray:
    """Matrix M with M @ x == scipy.fftpack.idct(x, type=2, norm=None).

    idct2(x)[k] = x[0] + 2 * sum_{j>=1} x[j] cos(pi j (2k+1) / (2n)).
    """
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = 2.0 * np.cos(np.pi * j * (2 * k + 1) / (2 * n))
    m[:, 0] = 1.0
    return m.astype(dtype)


_IDCT_CACHE: dict[int, np.ndarray] = {}


def idct2(x: np.ndarray) -> np.ndarray:
    """Separable 2-D unnormalized type-2 IDCT of (..., n, n) frames.

    Equivalent to the reference's idct(idct(X).T).T composition."""
    n = x.shape[-1]
    if n not in _IDCT_CACHE:
        _IDCT_CACHE[n] = make_idct_matrix(n)
    m = _IDCT_CACHE[n]
    return np.einsum("ij,...jk,lk->...il", m, x, m)


def read_mat_dct(path: str) -> np.ndarray:
    """Read an NTCD-TIMIT .mat (v7.3/HDF5) file -> (frames, 4489) float array."""
    with hdf5.File(path, "r") as f:
        arrays = [np.array(v) for v in f.values()]
    if len(arrays) != 1:
        raise ValueError(f"{path}: expected a single dataset, got {len(arrays)}")
    return arrays[0]


def decode_dct_frames(
    matlab_frames: np.ndarray,
    width: int = 67,
    height: int = 67,
    norm: str = "frame",
) -> np.ndarray:
    """DCT coefficients (frames, width*height) -> decoded video (frames, h, w).

    Pipeline per the reference builder: reshape -> IDCT^2 -> min-max
    normalize to [0, 255] -> rot90(·, 3). `norm="frame"` is per-frame
    min-max (matches the shipped fixtures); `norm="global"` uses the global
    min and the max per-frame range (the current builder code,
    create_video_train_files_upsampled.py:156).
    """
    a = idct2(matlab_frames.reshape(-1, width, height))
    if norm == "frame":
        lo = a.min(axis=(-2, -1), keepdims=True)
        hi = a.max(axis=(-2, -1), keepdims=True)
        out = (a - lo) / (hi - lo) * 255.0
    elif norm == "global":
        scale = (a.max(axis=(-2, -1)) - a.min(axis=(-2, -1))).max()
        out = (a - a.min()) / scale * 255.0
    else:
        raise ValueError(f"unknown norm mode: {norm}")
    # rot90(·, 3) on each frame (axes (-2, -1)), matching video.py:15
    return np.rot90(out, 3, axes=(-2, -1)).astype(np.float32)


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


def upsample_video(
    video: np.ndarray, rate_in: float = 30.0, rate_out: float = 62.5
) -> np.ndarray:
    """Re-time (frames, h, w) video from rate_in to rate_out by frame
    duplication (the reference's ffmpeg `fps=62.5` behavior)."""
    idx = fps_resample_indices(video.shape[0], rate_in, rate_out)
    return video[idx]


def decode_and_upsample(
    mat_path: str,
    width: int = 67,
    height: int = 67,
    rate_in: float = 30.0,
    rate_out: float = 62.5,
    norm: str = "frame",
) -> np.ndarray:
    """Full offline video path: .mat -> decoded, upsampled (h, w, frames)
    float32, the layout the reference stores in `*_upsampled.h5` ("X")."""
    frames = decode_dct_frames(read_mat_dct(mat_path), width, height, norm=norm)
    up = upsample_video(frames, rate_in, rate_out)
    return np.ascontiguousarray(np.moveaxis(up, 0, -1))


def overlay_vad_square(frame: np.ndarray, active: bool, size: int = 9) -> np.ndarray:
    """White square marker in the bottom-right corner when VAD is active
    (the reference's visualization overlay, video.py:18-19)."""
    out = frame.copy()
    if active:
        out[-size:, -size:] = 255
    return out
