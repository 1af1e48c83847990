"""Audio-visual VAD model (port of avvad_tpu/models/vad_nets.py: _VideoTower
and AVVAD, float tower, inference).

Children carry the JAX parameter tree's names (``tower.features``,
``mcb``, ``mcb_bn``, ``lstm_merged``, ``vad_merged``) so
``convert.from_flax_variables`` maps one onto the other by rule. The
post-MCB BatchNorm normalises every (batch, time) position per channel
with eps 1e-8, and the L2 norm before it is taken over the WHOLE tensor:
the batch rows couple through it, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .lstm import LSTMStack
from .mcb import CompactBilinearPooling, global_l2_normalize, signed_sqrt
from .resnet import ResNet18, lecun_normal_


class _VideoTower(nn.Module):
    """Gray (B, T, H, W) -> (B, T, 512) ResNet features. ``chunk``: run the
    trunk over slices of at most ``chunk`` frames (bounds activation
    memory; frames are independent through the trunk)."""

    def __init__(self, dtype: torch.dtype = torch.float32, chunk: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.chunk = chunk
        self.features = ResNet18(dtype=dtype, generator=generator)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t, h, w = video.shape
        frames = video.reshape(b * t, 1, h, w)
        n = b * t
        if self.chunk and n > self.chunk:
            feats = torch.cat([self.features(frames[i:i + self.chunk])
                               for i in range(0, n, self.chunk)])
        else:
            feats = self.features(frames)
        return feats.reshape(b, t, -1)


class AVVAD(nn.Module):
    """Video tower + audio features, fused by MCB (-> signed sqrt -> L2 ->
    BatchNorm) or concatenation, -> LSTM stack -> Dense logits."""

    def __init__(self, y_dim: int = 1, lstm_hidden_size: int = 1024,
                 lstm_layers: int = 2, use_mcb: bool = True,
                 mcb_output_size: int = 1024, num_audio_features: int = 513,
                 num_video_features: int = 512, eps: float = 1e-8,
                 dtype: torch.dtype = torch.float32,
                 use_kernel_lstm: bool = False, lstm_state_quant: str = "none",
                 tower_chunk: int = 0, mcb_folded_vars: bool = False,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.use_mcb = use_mcb
        self.eps = eps
        self.tower = _VideoTower(dtype=dtype, chunk=tower_chunk, generator=g)
        if use_mcb:
            self.mcb = CompactBilinearPooling(
                num_audio_features, num_video_features, mcb_output_size,
                folded_vars=mcb_folded_vars)
            self.mcb_bn = nn.BatchNorm1d(mcb_output_size, eps=eps)
            fused = mcb_output_size
        else:
            fused = num_audio_features + num_video_features
        self.lstm_merged = LSTMStack(fused, lstm_hidden_size, lstm_layers,
                                     dtype=dtype, use_kernel=use_kernel_lstm,
                                     state_quant=lstm_state_quant, generator=g)
        self.vad_merged = nn.Linear(lstm_hidden_size, y_dim)
        lecun_normal_(self.vad_merged.weight, g)
        nn.init.zeros_(self.vad_merged.bias)

    def set_lstm_state_quant(self, state_quant: str) -> None:
        for cell in self.lstm_merged.layers():
            cell.state_quant = state_quant

    def _fuse(self, audio: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if not self.use_mcb:
            return torch.cat([audio, v], dim=-1)
        y = global_l2_normalize(signed_sqrt(self.mcb(audio, v), self.eps))
        c = y.shape[-1]
        return self.mcb_bn(y.reshape(-1, c)).reshape(y.shape)

    def forward(self, audio: torch.Tensor, video: torch.Tensor,
                video_frame_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
        """audio (B, T, 513) log-power features, video (B, T_v, 67, 67).
        With ``video_frame_indices`` ((T,) int, one per audio frame) the
        video holds unique camera-rate frames and the tower features are
        gathered onto the audio timeline."""
        v = self.tower(video)
        if video_frame_indices is not None:
            v = v.index_select(1, video_frame_indices.to(v.device).long())
        y = self.lstm_merged(self._fuse(audio.float(), v))
        return self.vad_merged(y.float())
