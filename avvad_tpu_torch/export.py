"""The raw-input AV serving step (port of avvad_tpu/export.py:370-445,
``make_waveform_serving_fn`` for ``AVVAD``)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ._device import resolve_device
from .models.vad_nets import AVVAD
from .ops.stft import log_power_frontend


def _stat(norm_stats: Optional[dict], device, *keys):
    for k in keys:
        v = (norm_stats or {}).get(k)
        if v is not None:
            return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                                   device=device)
    return None


def make_waveform_serving_fn(model: AVVAD, *, t_frames: int, fs: int = 16000,
                             wlen_sec: float = 64e-3, hop_percent: float = 0.25,
                             norm_stats: Optional[dict] = None,
                             eps: float = 1e-8, video_frame_indices=None,
                             device: str | torch.device | None = None) -> Callable:
    """-> ``fn(wave (B, n), video (B, T_src, 67, 67)) -> probs (B, T, 1)``.

    The model moves to ``device`` (the card unless ``device="cpu"``) in
    eval mode. ``norm_stats`` with audio_mean/audio_std (or mean/std) and
    video_mean/video_std applies ``(x - mean) / (std + eps)``. The frontend
    runs with center=False, pad_at_end=True and keeps the first
    ``t_frames`` frames. ``video_frame_indices`` ((t_frames,) int) gathers
    camera-rate tower features onto the audio timeline.

    TF32 stays off for matmuls and cuDNN convolutions: the JAX package pins
    fp32 (Precision.HIGHEST) in the STFT DFT and the MCB matmuls, and its
    float convs run in the model dtype, never in TF32."""
    if not isinstance(model, AVVAD):
        raise TypeError(f"unsupported model for serving: {type(model)!r}")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model.to(dev).eval()
    a_mean = _stat(norm_stats, dev, "audio_mean", "mean")
    a_std = _stat(norm_stats, dev, "audio_std", "std")
    v_mean, v_std = _stat(norm_stats, dev, "video_mean"), _stat(norm_stats, dev, "video_std")
    idx = (None if video_frame_indices is None
           else torch.as_tensor(np.asarray(video_frame_indices), dtype=torch.long,
                                device=dev))

    @torch.inference_mode()
    def fn(wave, video):
        wave = torch.as_tensor(wave, device=dev)
        video = torch.as_tensor(video, device=dev, dtype=torch.float32)
        feats = log_power_frontend(wave, fs=fs, wlen_sec=wlen_sec,
                                   hop_percent=hop_percent, center=False,
                                   pad_at_end=True)[:, :t_frames, :]
        if a_mean is not None:
            feats = (feats - a_mean) / (a_std + eps)
        if v_mean is not None:
            video = (video - v_mean) / (v_std + eps)
        return torch.sigmoid(model(feats, video, video_frame_indices=idx))

    return fn
