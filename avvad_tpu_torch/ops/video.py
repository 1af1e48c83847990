"""Lip-video ops on the card (port of avvad_tpu/ops/video.py).

``idct2_decode``: the 67 x 67 type-2 IDCT of each frame as two fp32
matrix products over all (..., T) frames at once, then the min-max
normalisation to [0, 255] and the clockwise quarter turn of
``processing.video.decode_dct_frames``. ``fps_resample``: the 30 -> 62.5
fps frame duplication as one gather whose indices depend only on the frame
count. The JAX package computes both outside any Pallas kernel; here they
are plain ``torch`` operations, with TF32 off for the products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..processing.video import fps_resample_indices, make_idct_matrix


@functools.lru_cache(maxsize=8)
def _idct(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(make_idct_matrix(n), dtype=torch.float32, device=device)


def idct2_decode(dct_frames: torch.Tensor, norm: str = "frame") -> torch.Tensor:
    """(..., T, n*n) DCT coefficients -> (..., T, n, n) decoded frames in
    [0, 255]. ``norm``: "frame" (each frame's own min and max) or "global"
    (the global min and the largest frame range)."""
    if norm not in ("frame", "global"):
        raise ValueError(f"unknown norm mode: {norm}")
    n = int(np.sqrt(dct_frames.shape[-1]))
    m = _idct(n, dct_frames.device)
    x = dct_frames.reshape(*dct_frames.shape[:-1], n, n).float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.matmul(torch.matmul(m, x), m.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    lo = a.amin(dim=(-2, -1), keepdim=True)
    hi = a.amax(dim=(-2, -1), keepdim=True)
    if norm == "frame":
        out = (a - lo) / (hi - lo) * 255.0
    else:
        out = (a - a.min()) / (hi - lo).max() * 255.0
    return torch.rot90(out, 3, dims=(-2, -1))


def fps_resample(video: torch.Tensor, rate_in: float = 30.0,
                 rate_out: float = 62.5) -> torch.Tensor:
    """(..., T, h, w) video -> the same at ``rate_out`` by ffmpeg's ``fps``
    duplication schedule (``processing.video.fps_resample_indices``)."""
    idx = fps_resample_indices(video.shape[-3], rate_in, rate_out)
    return torch.index_select(video, -3, torch.as_tensor(idx, device=video.device))
