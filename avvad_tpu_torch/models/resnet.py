"""ResNet-18 feature trunk, float path (port of avvad_tpu/models/resnet.py).

NCHW for cuDNN; the converter transposes the JAX package's HWIO kernels to
OIHW. Same topology and numerics as the JAX float trunk: gray stem (the
(64, 3, 7, 7) kernel summed over its input channels), BatchNorm eps 1e-5
computed in fp32, a -inf-padded 3x3/2 max pool, four stages of two
BasicBlocks (64, 128, 256, 512) with 1x1/2 downsample shortcuts (flax
``SAME`` at 17 -> 9 -> 5 -> 3 pads nothing, as torch's padding 0), and a
global mean pool. With ``dtype=bfloat16`` the convs run in bf16 and every
BatchNorm output is fp32, as in the JAX module. The convs are plain cuDNN
convolutions: the JAX package leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1/fan_in) over every axis but the output one (OIHW / (out, in))."""
    fan_in = math.prod(w.shape[1:])
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(fan_in))


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
          dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), w.to(dtype), stride=stride, padding=padding)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return bn(x.float())


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity / 1x1-downsample shortcut."""

    def __init__(self, in_features: int, features: int, stride: int,
                 dtype: torch.dtype, norm_eps: float,
                 generator: torch.Generator):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_features, features, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=norm_eps)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=norm_eps)
        convs = [self.conv1, self.conv2]
        self.has_downsample = stride != 1 or in_features != features
        if self.has_downsample:
            self.downsample_conv = nn.Conv2d(in_features, features, 1, stride,
                                             0, bias=False)
            self.downsample_bn = nn.BatchNorm2d(features, eps=norm_eps)
            convs.append(self.downsample_conv)
        for c in convs:
            lecun_normal_(c.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(_bn(self.bn1, _conv(x, self.conv1.weight, self.stride, 1, dt)))
        y = _bn(self.bn2, _conv(y, self.conv2.weight, 1, 1, dt))
        residual = x
        if self.has_downsample:
            residual = _bn(self.downsample_bn, _conv(
                x, self.downsample_conv.weight, self.stride, 0, dt))
        return F.relu(y + residual)


class _StemGray(nn.Module):
    """7x7/2 stem for one-channel input: the torchvision-shaped
    (64, 3, 7, 7) kernel summed over its input channels (exact for a
    channel-replicated gray image)."""

    def __init__(self, dtype: torch.dtype, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(64, 3, 7, 7))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k1 = self.weight.sum(dim=1, keepdim=True)
        return _conv(x, k1, 2, 3, self.dtype)


class ResNet18(nn.Module):
    """Gray input (N, 1, H, W) -> (N, 512) pooled features, float32."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32, norm_eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.conv1 = _StemGray(dtype, generator)
        self.bn1 = nn.BatchNorm2d(64, eps=norm_eps)
        self.block_names = []
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, widths)):
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, BasicBlock(cin, width, stride, dtype,
                                                 norm_eps, generator))
                self.block_names.append(name)
                cin = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_bn(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3)).float()
