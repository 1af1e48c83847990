"""Frame losses, classification metrics and the auxiliary losses (port of
avvad_tpu/models/losses.py).

The eps sits INSIDE the logs, after the sigmoid, as in the reference, and
``1 - sigmoid(r)`` is computed as ``sigmoid(-r)``: the literal
``1 - p + eps`` can be reassociated to ``(1 + eps) - p``, where
``1 + 1e-8 == 1`` in fp32, so saturated logits give log(0) and NaN (the
JAX package saw AV training diverge that way). Masks are (B, T) float, 1
on valid frames; the per-sequence loss and metrics replace the
reference's per-sequence python loops. The auxiliary losses, ``onehot``,
``enumerate_discrete`` and ``init_normal`` are kept for capability parity
with the reference's utilities (utils.py:5-26, 57-162).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def _bce_elementwise(logits: torch.Tensor, targets: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """t log(sigmoid(r) + eps) + (1 - t) log(sigmoid(-r) + eps)."""
    return (targets * torch.log(torch.sigmoid(logits) + eps)
            + (1.0 - targets) * torch.log(torch.sigmoid(-logits) + eps))


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """-mean(t log(sigmoid(r) + eps) + (1 - t) log(1 - sigmoid(r) + eps))."""
    return -torch.mean(_bce_elementwise(logits, targets, eps))


def binary_cross_entropy_2classes(p1: torch.Tensor, p2: torch.Tensor,
                                  targets: torch.Tensor,
                                  eps: float = 1e-8) -> torch.Tensor:
    """-mean(sum_t(t log(p1 + eps) + (1 - t) log(p2 + eps))) (utils.py:116)."""
    return -torch.mean(torch.sum(targets * torch.log(p1 + eps)
                                 + (1 - targets) * torch.log(p2 + eps), dim=-1))


def masked_sequence_bce(logits: torch.Tensor, targets: torch.Tensor,
                        mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """logits / targets (B, T, y), mask (B, T) -> the sum over sequences of
    each one's BCE mean over its valid frames (an all-padding row adds 0)."""
    elt = _bce_elementwise(logits, targets, eps) * mask[..., None]
    frames = mask.sum(dim=1)
    denom = torch.clamp(frames * logits.shape[-1], min=1.0)
    per_seq = -elt.sum(dim=(1, 2)) / denom
    return torch.sum(per_seq * (frames > 0))


def _confusion_metrics(y_hat_hard, y_true, mask, dims, eps):
    y_pred = y_hat_hard.float()
    y = y_true.float()
    if mask is None:
        m = torch.ones_like(y)
    else:
        m = (mask[..., None] if mask.ndim == y.ndim - 1 else mask).expand_as(y).float()
    tp = torch.sum(y * y_pred * m, dim=dims)
    tn = torch.sum((1 - y) * (1 - y_pred) * m, dim=dims)
    fp = torch.sum((1 - y) * y_pred * m, dim=dims)
    fn = torch.sum(y * (1 - y_pred) * m, dim=dims)
    accuracy = (tp + tn) / (tp + tn + fp + fn + eps)
    precision = tp / (tp + fp + eps)
    recall = tp / (tp + fn + eps)
    f1 = 2 * (precision * recall) / (precision + recall + eps)
    return accuracy, precision, recall, f1


def f1_metrics(y_hat_hard: torch.Tensor, y_true: torch.Tensor,
               mask: torch.Tensor | None = None, eps: float = 1e-8) -> tuple:
    """(accuracy, precision, recall, F1) from hard predictions, the
    reference's confusion-matrix arithmetic; ``mask`` is y's shape or y's
    without its last axis."""
    return _confusion_metrics(y_hat_hard, y_true, mask,
                              tuple(range(y_true.ndim)), eps)


def batch_f1_sums(y_hat_hard: torch.Tensor, y_true: torch.Tensor,
                  mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(5,): the sums over the sequences with a valid frame of their
    (accuracy, precision, recall, F1), and the number of such sequences.
    A data-parallel step adds these over its ranks before dividing."""
    per_seq = torch.stack(_confusion_metrics(
        y_hat_hard, y_true, mask, tuple(range(1, y_true.ndim)), eps), dim=1)
    valid = (mask.sum(dim=1) > 0).float()
    return torch.cat([(per_seq * valid[:, None]).sum(dim=0), valid.sum()[None]])


def mean_from_sums(sums: torch.Tensor) -> tuple:
    """``batch_f1_sums`` (of one batch or of all ranks') -> the means."""
    return tuple(sums[:4] / torch.clamp(sums[4], min=1.0))


def batch_mean_f1_metrics(y_hat_hard: torch.Tensor, y_true: torch.Tensor,
                          mask: torch.Tensor, eps: float = 1e-8) -> tuple:
    """Per-sequence metrics of (B, T, y) inputs averaged over the sequences
    with a valid frame (the reference's training-loop reporting)."""
    return mean_from_sums(batch_f1_sums(y_hat_hard, y_true, mask, eps))


# --- auxiliary losses kept for capability parity (utils.py:119-162) ---


def itakura_saito_divergence(r: torch.Tensor, x: torch.Tensor,
                             eps: float = 1e-8) -> torch.Tensor:
    return torch.sum(x / r - torch.log(x + eps) + torch.log(r) - 1.0, dim=-1)


def elbo(x, r, mu, logvar, eps: float = 1e-8) -> tuple:
    """-> (recon + kl, recon, kl)."""
    recon = torch.mean(itakura_saito_divergence(r, x, eps))
    kl = -0.5 * torch.mean(torch.sum(logvar - mu ** 2 - torch.exp(logvar), dim=-1))
    return recon + kl, recon, kl


def mean_square_error_signal(x, y, y_hat) -> torch.Tensor:
    return torch.mean(torch.sum(torch.square((y - y_hat) * x), dim=-1))


def mean_square_error_mask(y, y_hat) -> torch.Tensor:
    return torch.mean(torch.sum(torch.square(y - y_hat), dim=-1))


def magnitude_spectrum_approximation_loss(x, s, y_hat) -> torch.Tensor:
    """mean(sum(|s - y_hat x|^2)); complex input gives a complex result
    with zero imaginary part, as in JAX (d * conj(d))."""
    d = s - y_hat * x
    return torch.mean(torch.sum(d * d.conj() if d.is_complex() else d * d, dim=-1))


def log_sum_exp(tensor: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """LSE with the reference's +1e-8 stabiliser (utils.py:96-105); keeps
    the reduced axis."""
    m = torch.amax(tensor, dim=dim, keepdim=True)
    return torch.log(torch.sum(torch.exp(tensor - m), dim=dim, keepdim=True) + 1e-8) + m


def onehot(k: int) -> Callable[[int], torch.Tensor]:
    """1-of-k encoder factory (utils.py:82-94); labels >= k encode to zeros."""

    def encode(label: int) -> torch.Tensor:
        y = torch.zeros(k, dtype=torch.float32)
        if label < k:
            y[label] = 1.0
        return y

    return encode


def enumerate_discrete(x: torch.Tensor, y_dim: int) -> torch.Tensor:
    """All one-hot labels tiled over the batch (utils.py:57-80):
    (y_dim * batch, y_dim), batch copies of label 0, then label 1, ..."""
    return torch.repeat_interleave(torch.eye(y_dim, dtype=torch.float32),
                                   x.shape[0], dim=0)


_NORMS = (nn.modules.batchnorm._BatchNorm, nn.GroupNorm, nn.LayerNorm)


def init_normal(model: nn.Module, generator: torch.Generator, mean: float = 0.0,
                std: float = 0.005) -> nn.Module:
    """Re-initialise ``model``'s parameters in place by the reference's
    weights_init_normal (utils.py:5-26), as the JAX ``init_normal``: the
    kernels of linear and conv layers ~ N(mean, std), norm scales
    ~ N(1, 0.02), biases zeroed; every parameter under a module whose path
    names an LSTM keeps its value (the reference's LSTM branch never matched
    its own class name). Draws come from ``generator`` (a CPU generator),
    in ``named_modules`` order. Buffers (running statistics, sketches) are
    left alone. -> ``model``."""
    with torch.no_grad():
        for path, module in model.named_modules():
            if "lstm" in path.lower():
                continue
            for name, p in module.named_parameters(recurse=False):
                if name == "weight" and isinstance(module, _NORMS):
                    draw = 1.0 + 0.02 * torch.randn(p.shape, generator=generator)
                elif name == "weight":
                    draw = mean + std * torch.randn(p.shape, generator=generator)
                elif name == "bias":
                    draw = torch.zeros(p.shape)
                else:
                    continue
                p.copy_(draw.to(p.dtype))
    return model
