"""WaveNet-style dilated convolution encoder (port of
avvad_tpu/models/wavenet.py).

A causal entry conv, a stack of [ReLU -> dilated conv -> ReLU -> 1x1
dense] blocks with residual adds over the time-aligned tail slice, a 1x1
bottleneck + ReLU, and an adaptive average pool to a fixed output length:
the raw-waveform frontend of the paper's audio branch (``RawAudioVAD``).

The convolutions are ``nn.Conv1d`` in NCW with VALID padding and
dilation (cuDNN on the card); no TPU kernel stands behind them. Children
keep the JAX parameter tree's names (``causal_entry``, ``dilated_{i}``,
``dense_{i}``, ``bottleneck``); ``convert.from_flax_variables`` turns a
Flax Conv1D kernel (W, I, O) into a ``Conv1d`` weight (O, I, W). In bf16
the inputs, weights and biases are cast to bf16, as Flax's
``nn.Conv(dtype=bf16)`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import lecun_normal_


def adaptive_avg_pool1d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """torch.nn.AdaptiveAvgPool1d on (..., T, C): output bin k averages
    input[floor(k*T/out) : ceil((k+1)*T/out)], JAX's bins."""
    *lead, t, c = x.shape
    y = F.adaptive_avg_pool1d(x.reshape(-1, t, c).transpose(1, 2), output_size)
    return y.transpose(1, 2).reshape(*lead, output_size, c)


class WaveNetEncoder(nn.Module):
    """(B, T, quantization_channels) -> (B, pool_kernel_size, bottleneck)."""

    def __init__(self, filter_width: int = 3, quantization_channels: int = 256,
                 dilations: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
                 residual_channels: int = 32, dilation_channels: int = 32,
                 bottleneck_width: int = 16, pool_kernel_size: int = 100,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.filter_width = filter_width
        self.dilations = tuple(dilations)
        self.pool_kernel_size = pool_kernel_size
        self.dtype = dtype
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def conv(cin, cout, width, dil):
            c = nn.Conv1d(cin, cout, width, dilation=dil, bias=use_bias)
            lecun_normal_(c.weight, g)
            if use_bias:
                nn.init.zeros_(c.bias)
            return c

        self.causal_entry = conv(quantization_channels, residual_channels,
                                 filter_width, 1)
        for i, dil in enumerate(self.dilations):
            self.add_module(f"dilated_{i}", conv(residual_channels, dilation_channels,
                                                 filter_width, dil))
            self.add_module(f"dense_{i}", conv(dilation_channels, residual_channels, 1, 1))
        self.bottleneck = conv(residual_channels, bottleneck_width, 1, 1)

    @property
    def receptive_field(self) -> int:
        return (self.filter_width - 1) * (sum(self.dilations) + 1) + 1

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        c = getattr(self, name)
        dt = self.dtype
        bias = None if c.bias is None else c.bias.to(dt)
        return F.conv1d(x, c.weight.to(dt), bias, dilation=c.dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._conv("causal_entry", x.to(self.dtype).transpose(1, 2))  # NCW
        for i in range(len(self.dilations)):
            y = self._conv(f"dilated_{i}", torch.relu(x))
            y = self._conv(f"dense_{i}", torch.relu(y))
            # align the residual to the (shorter) conv output: keep the tail
            x = y + x[..., x.shape[-1] - y.shape[-1]:]
        x = torch.relu(self._conv("bottleneck", x))
        return adaptive_avg_pool1d(x.transpose(1, 2), self.pool_kernel_size)
