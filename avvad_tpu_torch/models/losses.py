"""Frame losses and classification metrics (port of
avvad_tpu/models/losses.py:17-101).

The eps sits INSIDE the logs, after the sigmoid, as in the reference, and
``1 - sigmoid(r)`` is computed as ``sigmoid(-r)``: the literal
``1 - p + eps`` can be reassociated to ``(1 + eps) - p``, where
``1 + 1e-8 == 1`` in fp32, so saturated logits give log(0) and NaN (the
JAX package saw AV training diverge that way). Masks are (B, T) float, 1
on valid frames; the per-sequence loss and metrics replace the
reference's per-sequence python loops.
"""

from __future__ import annotations

import torch


def _bce_elementwise(logits: torch.Tensor, targets: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """t log(sigmoid(r) + eps) + (1 - t) log(sigmoid(-r) + eps)."""
    return (targets * torch.log(torch.sigmoid(logits) + eps)
            + (1.0 - targets) * torch.log(torch.sigmoid(-logits) + eps))


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """-mean(t log(sigmoid(r) + eps) + (1 - t) log(1 - sigmoid(r) + eps))."""
    return -torch.mean(_bce_elementwise(logits, targets, eps))


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


def batch_mean_f1_metrics(y_hat_hard: torch.Tensor, y_true: torch.Tensor,
                          mask: torch.Tensor, eps: float = 1e-8) -> tuple:
    """Per-sequence metrics of (B, T, y) inputs averaged over the sequences
    with a valid frame (the reference's training-loop reporting)."""
    per_seq = torch.stack(_confusion_metrics(
        y_hat_hard, y_true, mask, tuple(range(1, y_true.ndim)), eps), dim=1)
    valid = (mask.sum(dim=1) > 0).float()
    n = torch.clamp(valid.sum(), min=1.0)
    return tuple((per_seq * valid[:, None]).sum(dim=0) / n)
