"""Train state: the model, its Adam optimizer and the step count (port of
avvad_tpu/train/state.py).

The JAX state is a pytree of params, batch stats and optimizer moments;
here the model's parameters and buffers (BatchNorm running statistics,
MCB sketches) live in the module, and the moments in the optimizer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .._device import resolve_device
from ..utils.profiling import setup_span


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    device: torch.device
    step: int = 0


def pin_fp32() -> None:
    """Full fp32 matmuls and cuDNN convolutions (TF32 off), as the JAX
    package's fp32 model runs its convs and HIGHEST-precision matmuls."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_optimizer(params, learning_rate: float = 1e-4, b1: float = 0.9,
                   b2: float = 0.999) -> torch.optim.Adam:
    """optax.adam: bias-corrected moments, eps 1e-8 added outside the
    square root. Mirrors the reference's Adam(lr=1e-4)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=1e-8)


def trainable_except_video_trunk(model: nn.Module) -> list:
    """Freeze the ResNet trunk ``model.tower.features`` (requires_grad off:
    no gradient is formed for it) -> the parameters that still train. The
    port's form of optax.set_to_zero on the 'features' subtree
    (state.py:39-70); the reference freezes the pretrained trunk
    (train_AV_net.py:241-245)."""
    model.tower.features.requires_grad_(False)
    return [p for p in model.parameters() if p.requires_grad]


@setup_span("setup.train_state")
def create_train_state(model: nn.Module, learning_rate: float = 1e-4,
                       freeze_video_trunk: bool = False,
                       device: str | torch.device | None = None) -> TrainState:
    """Move ``model`` to ``device`` (the card unless ``device="cpu"``; no
    card -> raises) and give it Adam over its trainable parameters. The
    call is the ``setup.train_state`` set-up span (Adam's constructor
    imports ``torch._dynamo``)."""
    dev = resolve_device(device)
    pin_fp32()
    model.to(dev)
    params = (trainable_except_video_trunk(model) if freeze_video_trunk
              else [p for p in model.parameters() if p.requires_grad])
    return TrainState(model, make_optimizer(params, learning_rate), dev)
