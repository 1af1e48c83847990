"""The raw-input serving step (port of avvad_tpu/export.py:370-445,
``make_waveform_serving_fn`` for ``AVVAD``, ``AudioVAD`` and
``VideoVAD``)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ._device import resolve_device
from .models.vad_nets import AVVAD, AudioVAD, VideoVAD
from .ops.stft import log_power_frontend


def _stat(norm_stats: Optional[dict], device, *keys):
    for k in keys:
        v = (norm_stats or {}).get(k)
        if v is not None:
            return torch.as_tensor(np.asarray(v, np.float32).reshape(-1),
                                   device=device)
    return None


def make_waveform_serving_fn(model: AVVAD | AudioVAD | VideoVAD, *,
                             t_frames: Optional[int] = None,
                             fs: int = 16000,
                             wlen_sec: float = 64e-3, hop_percent: float = 0.25,
                             hop_dft: bool = False,
                             norm_stats: Optional[dict] = None,
                             eps: float = 1e-8, video_frame_indices=None,
                             device: str | torch.device | None = None) -> Callable:
    """AVVAD: -> ``fn(wave (B, n), video (B, T_src, 67, 67)) -> probs
    (B, T, 1)``, ``t_frames`` required; AudioVAD: -> ``fn(wave) -> probs``;
    VideoVAD: -> ``fn(video) -> probs`` (the audio options unused).

    The model moves to ``device`` (the card unless ``device="cpu"``) in
    eval mode. ``norm_stats`` with audio_mean/audio_std (or mean/std) and
    video_mean/video_std applies ``(x - mean) / (std + eps)``. The frontend
    runs with center=False, pad_at_end=True (``hop_dft``: on the
    hop-block DFT route of ``ops.stft``) and keeps the first ``t_frames``
    frames. ``video_frame_indices`` ((t_frames,) int) gathers
    camera-rate tower features onto the audio timeline.

    TF32 stays off for matmuls and cuDNN convolutions: the JAX package pins
    fp32 (Precision.HIGHEST) in the STFT DFT and the MCB matmuls, and its
    float convs run in the model dtype, never in TF32."""
    if not isinstance(model, (AVVAD, AudioVAD, VideoVAD)):
        raise TypeError(f"unsupported model for serving: {type(model)!r}")
    if isinstance(model, AVVAD) and t_frames is None:
        raise TypeError("AVVAD serving needs t_frames")
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

    def norm_video(video):
        video = torch.as_tensor(video, device=dev, dtype=torch.float32)
        if v_mean is not None:
            video = (video - v_mean) / (v_std + eps)
        return video

    if isinstance(model, VideoVAD):
        @torch.inference_mode()
        def video_fn(video):
            return torch.sigmoid(model(norm_video(video), video_frame_indices=idx))

        return video_fn

    def frontend(wave):
        wave = torch.as_tensor(wave, device=dev)
        feats = log_power_frontend(wave, fs=fs, wlen_sec=wlen_sec,
                                   hop_percent=hop_percent, center=False,
                                   pad_at_end=True, hop_dft=hop_dft)[:, :t_frames, :]
        if a_mean is not None:
            feats = (feats - a_mean) / (a_std + eps)
        return feats

    if isinstance(model, AudioVAD):
        @torch.inference_mode()
        def audio_fn(wave):
            return torch.sigmoid(model(frontend(wave)))

        return audio_fn

    @torch.inference_mode()
    def fn(wave, video):
        return torch.sigmoid(model(frontend(wave), norm_video(video),
                                   video_frame_indices=idx))

    return fn
