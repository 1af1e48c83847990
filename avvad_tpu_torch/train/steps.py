"""Train, eval and predict steps, by modality (port of
avvad_tpu/train/steps.py).

A step takes a ``Batch`` (numpy, or tensors) and the dataset's
normalisation statistics, moves them to the state's device, and runs:
normalisation -> forward -> masked per-sequence BCE -> (train) backward
and Adam -> frame metrics. The train step runs the model in train mode,
as JAX's ``train=True``: BatchNorm on batch statistics, running
statistics updated; under autograd the LSTM runs its training kernels.
Eval and predict run in eval mode without autograd: the inference
kernel. The modalities are "audio" (``AudioVAD``), "video" (``VideoVAD``,
its ResNet-18 trained with the rest) and "av" (``AVVAD``, the trunk frozen
or not); the JAX package's "waveform" (``RawAudioVAD``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.losses import batch_mean_f1_metrics, masked_sequence_bce

MODALITIES = ("audio", "video", "av")


def _tensor(a, device) -> torch.Tensor | None:
    """A batch array (numpy, or a tensor already uploaded, as a prefetcher
    leaves it) -> float32 on ``device``."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def normalize(x: torch.Tensor, mean, std, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps), with (dim, 1)- or (dim,)-shaped statistics
    against (B, T, dim) features (train_AV_net.py:286-291)."""
    m, s = (torch.as_tensor(np.asarray(v, np.float32), device=x.device)
            for v in (mean, std))
    m = m[..., 0] if m.ndim == 2 else m
    s = s[..., 0] if s.ndim == 2 else s
    return (x - m) / (s + eps)


def _forward_inputs(modality: str, batch, norm_stats, eps: float, device) -> tuple:
    """The model's positional inputs for a batch, on ``device``, normalised
    where the statistics are given."""
    audio, video = _tensor(batch.audio, device), _tensor(batch.video, device)
    stats = norm_stats or {}
    if audio is not None and stats.get("audio_mean") is not None:
        audio = normalize(audio, stats["audio_mean"], stats["audio_std"], eps)
    if video is not None and stats.get("video_mean") is not None:
        video = normalize(video, stats["video_mean"], stats["video_std"], eps)
    return {"audio": (audio,), "video": (video,), "av": (audio, video)}[modality]


def _metrics(logits, label, mask, loss, eps: float) -> dict:
    y_hat_hard = (torch.sigmoid(logits) > 0.5).float()
    acc, prec, rec, f1 = batch_mean_f1_metrics(y_hat_hard, label, mask, eps)
    return {"loss": loss, "accuracy": acc, "precision": prec, "recall": rec,
            "f1": f1}


def _make_forward(modality: str, eps: float, train: bool):
    """-> ``forward(state, batch, norm_stats) -> (logits, label, mask)`` on
    the state's device, the model in train or eval mode."""
    if modality not in MODALITIES:
        raise ValueError(f"modality {modality!r} is not ported (have {MODALITIES})")

    def forward(state, batch, norm_stats):
        dev = state.device
        inputs = _forward_inputs(modality, batch, norm_stats, eps, dev)
        state.model.train(train)
        return state.model(*inputs), _tensor(batch.label, dev), _tensor(batch.mask, dev)

    return forward


def make_train_step(modality: str, eps: float = 1e-8):
    """-> ``step(state, batch, norm_stats) -> (state, metrics)``: one Adam
    step on the masked BCE; ``state`` is updated in place and returned.
    Metrics are 0-d tensors on the state's device."""
    forward = _make_forward(modality, eps, train=True)

    def train_step(state, batch, norm_stats=None):
        logits, label, mask = forward(state, batch, norm_stats)
        loss = masked_sequence_bce(logits, label, mask, eps)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return state, _metrics(logits.detach(), label, mask, loss.detach(), eps)

    return train_step


def make_eval_step(modality: str, eps: float = 1e-8):
    """-> ``step(state, batch, norm_stats) -> (metrics, y_hat_soft)``:
    BatchNorm on running statistics, no state change."""
    forward = _make_forward(modality, eps, train=False)

    @torch.no_grad()
    def eval_step(state, batch, norm_stats=None):
        logits, label, mask = forward(state, batch, norm_stats)
        loss = masked_sequence_bce(logits, label, mask, eps)
        return _metrics(logits, label, mask, loss, eps), torch.sigmoid(logits)

    return eval_step


def make_predict_step(modality: str, eps: float = 1e-8):
    """-> ``step(state, batch, norm_stats) -> y_hat_soft (B, T, y)``: pure
    inference, no labels needed."""
    forward = _make_forward(modality, eps, train=False)

    @torch.no_grad()
    def predict_step(state, batch, norm_stats=None):
        return torch.sigmoid(forward(state, batch, norm_stats)[0])

    return predict_step
