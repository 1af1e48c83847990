"""Unidirectional LSTM stacks (port of avvad_tpu/models/lstm.py).

Weights keep the JAX package's layout: ``w_ih`` (D, 4H), ``w_hh`` (H, 4H)
and one ``bias`` (4H,), gate order [i, f, g, o]. The input projection of
all time steps is hoisted into one matmul; the recurrence runs through
``ops.lstm_fused.lstm_layer_fused`` (the CUDA kernels on the card) unless
carries are given or requested (streaming), where it is a plain loop, as
the JAX module falls back to its scan (lstm.py:72): the kernels read a
bf16-rounded W_hh, the scan the weight in the model dtype. Under autograd that op runs
the training kernels with JAX's custom VJP (``LSTMRecurrence``): W_hh,
W_ih, the bias and the input all get their gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.lstm_fused import lstm_layer_fused


def uniform_(t: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * scale) - scale)


class LSTMCellFused(nn.Module):
    """One LSTM layer over a full (B, T, D) sequence."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32, use_kernel: bool = False,
                 state_quant: str = "none",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        h = hidden_size
        self.hidden_size = h
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.state_quant = state_quant
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * h))
        self.w_hh = nn.Parameter(torch.empty(h, 4 * h))
        self.bias = nn.Parameter(torch.empty(4 * h))
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        scale = 1.0 / math.sqrt(h)  # torch's LSTM default
        for p in (self.w_ih, self.w_hh, self.bias):
            uniform_(p, scale, g)

    def forward(self, x: torch.Tensor, h0: Optional[tuple] = None,
                return_carry: bool = False):
        dt = self.dtype
        x_proj = x.to(dt) @ self.w_ih.to(dt) + self.bias.to(dt)
        if self.use_kernel and h0 is None and not return_carry:
            return lstm_layer_fused(x_proj.float().contiguous(), self.w_hh,
                                    state_quant=self.state_quant).to(dt)
        b, t, _ = x.shape
        if h0 is None:
            hh = torch.zeros(b, self.hidden_size, dtype=dt, device=x.device)
            cc = torch.zeros_like(hh)
        else:
            hh, cc = h0
        # float32 carries into a bf16 layer promote the product to float32
        # over the bf16-rounded weight, as JAX's type promotion does
        w_hh = self.w_hh.to(dt).to(torch.promote_types(dt, hh.dtype))
        ys = []
        for step in range(t):
            gates = x_proj[:, step] + hh @ w_hh
            i, f, g, o = gates.chunk(4, dim=-1)
            cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(g)
            hh = torch.sigmoid(o) * torch.tanh(cc)
            ys.append(hh)
        out = torch.stack(ys, dim=1)
        return (out, (hh, cc)) if return_carry else out


class LSTMStack(nn.Module):
    """num_layers stacked LSTMs, input (B, T, D) -> (B, T, H). Layers are
    children ``layer_0``, ``layer_1``, ... as in the JAX parameter tree."""

    def __init__(self, input_size: int, hidden_size: int = 1024,
                 num_layers: int = 2, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False, state_quant: str = "none",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in range(num_layers):
            d = input_size if layer == 0 else hidden_size
            self.add_module(f"layer_{layer}", LSTMCellFused(
                d, hidden_size, dtype=dtype, use_kernel=use_kernel,
                state_quant=state_quant, generator=generator))

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, carries: Optional[list] = None,
                return_carries: bool = False):
        """carries: per-layer (h, c) from a previous chunk; with
        return_carries=True returns (outputs, new_carries)."""
        new_carries = []
        for layer, cell in enumerate(self.layers()):
            h0 = carries[layer] if carries is not None else None
            out = cell(x, h0=h0, return_carry=return_carries)
            if return_carries:
                x, carry = out
                new_carries.append(carry)
            else:
                x = out
        return (x, new_carries) if return_carries else x


def select_last(outputs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, H), (B,) -> (B, H): each sequence's last valid step."""
    idx = torch.clamp(lengths.long() - 1, 0, outputs.shape[1] - 1)
    return outputs[torch.arange(outputs.shape[0], device=outputs.device), idx]
