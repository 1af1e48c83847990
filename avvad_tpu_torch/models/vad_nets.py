"""The VAD models (port of avvad_tpu/models/vad_nets.py: AudioVAD,
RawAudioVAD, _VideoTower, VideoVAD and AVVAD), with the float tower or, for
inference, the W8A8 tower (``tower_int8``; fused kernels with
``tower_pallas`` and static scales). Each model but RawAudioVAD has a
``streaming_head`` that advances one block with carried LSTM state
(``serve.py``).

Children carry the JAX parameter tree's names (``wavenet_en``,
``lstm_audio``, ``vad_audio``, ``tower.features``, ``mcb``, ``mcb_bn``,
``lstm_merged``, ``vad_merged``) so ``convert.from_flax_variables`` maps
one onto the other by rule. The post-MCB BatchNorm normalises every (batch, time)
position per channel with eps 1e-8, padded frames included, and the L2
norm before it is taken over the WHOLE tensor: the batch rows couple
through it, as in the reference. ``model.train()`` is JAX's
``train=True``: every BatchNorm (the frozen trunk's too) takes batch
statistics and updates its running ones (``resnet.batch_norm``).
``tower_stem_int8``: the int8 tower's W8A8 stem (``ResNet18.stem_int8``);
``mcb_precision`` on AVVAD: "highest" (fp32 MCB matmuls, the default) or
"default" (bf16 operands, fp32 sums: the TPU's Precision.DEFAULT).
``dropout_rate`` on AudioVAD, VideoVAD and AVVAD: flax's ``nn.Dropout`` at
the JAX sites, after the LSTM stack and before the Dense, in train mode
only, its mask drawn from the ``DropoutRNG`` the caller passes
(``train.steps.make_train_step(dropout=True)``), never from torch's global
generator.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from .lstm import LSTMStack, select_last
from .mcb import CompactBilinearPooling, global_l2_normalize, signed_sqrt
from .resnet import ResNet18, batch_norm, lecun_normal_, running_stats_frozen
from .wavenet import WaveNetEncoder


class _VideoTower(nn.Module):
    """Gray (B, T, H, W) -> (B, T, 512) ResNet features. ``chunk``: run the
    trunk over slices of at most ``chunk`` frames (bounds activation
    memory; frames are independent through the trunk). An int8 tower
    chunks only with static scales: "calibrate" would record per-chunk
    maxima in turn (harmless) but "dynamic" scales would become per chunk
    (vad_nets.py:155-162). ``remat``: in training, the trunk's activations
    are recomputed in the backward pass (``torch.utils.checkpoint``) instead
    of kept, flax's ``nn.remat``; the recompute leaves the BatchNorm running
    statistics alone (``resnet.running_stats_frozen``). ``gray_stem=False``:
    the frames repeated to 3 channels through the whole stem kernel
    (vad_nets.py:131-148)."""

    def __init__(self, dtype: torch.dtype = torch.float32, chunk: int = 0,
                 generator: Optional[torch.Generator] = None,
                 quant_int8: bool = False, quant_mode: str = "dynamic",
                 stages_pallas: bool = False, remat: bool = False,
                 gray_stem: bool = True, stem_int8: bool = False):
        super().__init__()
        self.chunk = chunk
        self.remat = remat
        self.gray_stem = gray_stem
        self.features = ResNet18(dtype=dtype, generator=generator,
                                 quant_int8=quant_int8, quant_mode=quant_mode,
                                 stages_pallas=stages_pallas, gray_input=gray_stem,
                                 stem_int8=stem_int8)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        with span("tower"):
            return self._forward(video)

    def _forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t, h, w = video.shape
        frames = video.reshape(b * t, 1, h, w)
        if not self.gray_stem:
            frames = frames.expand(-1, 3, -1, -1)
        n = b * t
        trunk = self.features
        # training takes the BatchNorm statistics over the whole frame batch
        chunkable = not (self.training or (trunk.quant_int8
                                           and trunk.quant_mode != "static"))
        if chunkable and self.chunk and n > self.chunk:
            feats = torch.cat([self.features(frames[i:i + self.chunk])
                               for i in range(0, n, self.chunk)])
        elif self.remat and self.training and torch.is_grad_enabled():
            feats = checkpoint(trunk, frames, use_reentrant=False,
                               context_fn=_recompute_frozen)
        else:
            feats = self.features(frames)
        return feats.reshape(b, t, -1)


def _recompute_frozen():
    """checkpoint's (forward, recompute) contexts."""
    return contextlib.nullcontext(), running_stats_frozen()


def _tower(dtype, chunk, g, tower_int8, tower_quant_mode, tower_pallas,
           remat, gray_stem, stem_int8):
    return _VideoTower(dtype=dtype, chunk=chunk, generator=g,
                       quant_int8=tower_int8, quant_mode=tower_quant_mode,
                       stages_pallas=tower_pallas, remat=remat, gray_stem=gray_stem,
                       stem_int8=stem_int8)


def draw_keep(generator: torch.Generator, shape: tuple, keep_prob: float) -> torch.Tensor:
    """A Bernoulli(keep_prob) keep mask of ``shape`` (bool), drawn on the
    generator's device."""
    return torch.rand(shape, generator=generator, device=generator.device) < keep_prob


class DropoutRNG:
    """Where a train step's dropout masks come from: a generator on the
    step's device (seeded per step, see ``dropout_generator``), and, under data
    parallelism, the global batch size and this rank's rows. Each mask is
    drawn for the whole global batch and the rank keeps its rows, so a
    meshed step drops exactly what the unmeshed step drops. Masks are
    drawn in the order the model calls ``keep``."""

    def __init__(self, generator: torch.Generator, rows: Optional[slice] = None,
                 global_batch: Optional[int] = None):
        self.generator, self.rows, self.global_batch = generator, rows, global_batch

    def keep(self, shape: tuple, keep_prob: float) -> torch.Tensor:
        full = (self.global_batch or shape[0], *shape[1:])
        mask = draw_keep(self.generator, full, keep_prob)
        return mask if self.rows is None else mask[self.rows]


def dropout_generator(seed: int, step: int, device: str | torch.device) -> torch.Generator:
    """The generator of step ``step`` on ``device``: the port's counterpart
    of JAX's ``fold_in(PRNGKey(seed), step)`` (its stream is not JAX's, and
    a card's stream is not the CPU's). Every rank on the same kind of
    device draws the same masks."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) & (2 ** 63 - 1))


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode with rate > 0, each entry is
    kept with probability 1 - rate and scaled by 1 / (1 - rate), else
    zeroed; identity otherwise."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout_rate {rate} outside [0, 1]")
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if rng is None:
            raise ValueError(f"dropout_rate={self.rate} in train mode needs a "
                             "dropout_rng: build the step with "
                             "make_train_step(..., dropout=True)")
        keep_prob = 1.0 - self.rate
        keep = rng.keep(tuple(x.shape), keep_prob).to(x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _head(hidden: int, y_dim: int, g: torch.Generator) -> nn.Linear:
    dense = nn.Linear(hidden, y_dim)
    lecun_normal_(dense.weight, g)
    nn.init.zeros_(dense.bias)
    return dense


class AudioVAD(nn.Module):
    """Log-power frames (B, T, 513) -> LSTM stack -> Dense logits
    (B, T, y_dim) (vad_nets.py:35-66), the reference's audio-only model."""

    def __init__(self, y_dim: int = 1, lstm_hidden_size: int = 1024,
                 lstm_layers: int = 2, num_audio_features: int = 513,
                 dtype: torch.dtype = torch.float32,
                 use_kernel_lstm: bool = False, lstm_state_quant: str = "none",
                 dropout_rate: float = 0.0, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lstm_hidden_size, self.lstm_layers = lstm_hidden_size, lstm_layers
        self.lstm_audio = LSTMStack(num_audio_features, lstm_hidden_size,
                                    lstm_layers, dtype=dtype,
                                    use_kernel=use_kernel_lstm,
                                    state_quant=lstm_state_quant, generator=g)
        self.dropout = Dropout(dropout_rate)
        self.vad_audio = _head(lstm_hidden_size, y_dim, g)

    def forward(self, audio: torch.Tensor,
                dropout_rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = self.lstm_audio(audio.float())
        with span("head"):
            return self.vad_audio(self.dropout(x.float(), dropout_rng))

    def streaming_head(self, feats: torch.Tensor, carries: list):
        """One streaming block: features (N, Tc, 513) and per-layer (h, c)
        carries -> (logits (N, Tc, y_dim), new carries). With carries the
        recurrence is the plain loop of ``LSTMCellFused``."""
        out, new_carries = self.lstm_audio(feats.float(), carries=carries,
                                           return_carries=True)
        return self.vad_audio(out.float()), new_carries


class RawAudioVAD(nn.Module):
    """Raw waveform (B, n) -> WaveNet encoder -> LSTM stack -> Dense logits
    (B, out_frames, y_dim) (vad_nets.py:69-102), the paper's raw-waveform
    branch. The encoder's adaptive pool re-times the waveform to
    ``out_frames`` label frames, set once at construction as in JAX.

    By default the LSTM runs its plain loop: the JAX module keeps
    ``LSTMStack``'s default ``use_pallas=False``, a ``lax.scan`` over W_hh in
    the model dtype. ``use_kernel_lstm`` puts the recurrence on the
    hand-written kernels (K1a for ``lstm_state_quant="none"``: fp32 h and c
    against a bf16-rounded W_hh), as on the other models."""

    def __init__(self, y_dim: int = 1, lstm_hidden_size: int = 1024,
                 lstm_layers: int = 2, out_frames: int = 128,
                 wavenet_kwargs: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32,
                 use_kernel_lstm: bool = False, lstm_state_quant: str = "none",
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lstm_hidden_size, self.lstm_layers = lstm_hidden_size, lstm_layers
        self.out_frames = out_frames
        kw = dict(quantization_channels=1, residual_channels=32,
                  dilation_channels=32, bottleneck_width=64, filter_width=3,
                  dilations=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
        kw.update(wavenet_kwargs or {})
        self.wavenet_en = WaveNetEncoder(pool_kernel_size=out_frames, dtype=dtype,
                                         generator=g, **kw)
        self.lstm_audio = LSTMStack(kw["bottleneck_width"], lstm_hidden_size,
                                    lstm_layers, dtype=dtype,
                                    use_kernel=use_kernel_lstm,
                                    state_quant=lstm_state_quant, generator=g)
        self.vad_audio = _head(lstm_hidden_size, y_dim, g)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        with span("encoder"):
            x = self.wavenet_en(waveform[..., None])  # (B, out_frames, bottleneck)
        x = self.lstm_audio(x)
        with span("head"):
            return self.vad_audio(x.float())


class VideoVAD(nn.Module):
    """Video tower -> LSTM stack -> Dense logits (vad_nets.py:191-239),
    with the ``return_last`` last-valid-step mode. ``remat`` and
    ``gray_stem``: see ``_VideoTower``."""

    def __init__(self, y_dim: int = 1, lstm_hidden_size: int = 1024,
                 lstm_layers: int = 2, dtype: torch.dtype = torch.float32,
                 use_kernel_lstm: bool = False, lstm_state_quant: str = "none",
                 tower_int8: bool = False, tower_quant_mode: str = "dynamic",
                 tower_pallas: bool = False, tower_chunk: int = 0,
                 num_video_features: int = 512, remat: bool = False,
                 gray_stem: bool = True, tower_stem_int8: bool = False,
                 dropout_rate: float = 0.0, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lstm_hidden_size, self.lstm_layers = lstm_hidden_size, lstm_layers
        self.tower = _tower(dtype, tower_chunk, g, tower_int8, tower_quant_mode,
                            tower_pallas, remat, gray_stem, tower_stem_int8)
        self.lstm_video = LSTMStack(num_video_features, lstm_hidden_size,
                                    lstm_layers, dtype=dtype,
                                    use_kernel=use_kernel_lstm,
                                    state_quant=lstm_state_quant, generator=g)
        self.dropout = Dropout(dropout_rate)
        self.vad_video = _head(lstm_hidden_size, y_dim, g)

    def forward(self, video: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                return_last: bool = False,
                video_frame_indices: Optional[torch.Tensor] = None,
                dropout_rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """video (B, T_v, 67, 67) -> logits (B, T, y_dim), or (B, y_dim) at
        each sequence's last valid step with ``return_last`` (needs
        ``lengths``). ``video_frame_indices``: as in AVVAD.forward."""
        x = self.tower(video)
        if video_frame_indices is not None:
            x = x.index_select(1, video_frame_indices.to(x.device).long())
        x = self.lstm_video(x)
        if return_last:
            if lengths is None:
                raise ValueError("return_last requires lengths")
            x = select_last(x, lengths.to(x.device))
        with span("head"):
            return self.vad_video(self.dropout(x.float(), dropout_rng))

    def streaming_head(self, video: torch.Tensor, carries: list,
                       video_frame_indices: Optional[torch.Tensor] = None):
        """One streaming block: raw lip frames (N, Tc, 67, 67) and per-layer
        (h, c) carries -> (logits (N, Tc, y_dim), new carries). The tower is
        frame-local, so the carries are the only state. With
        ``video_frame_indices`` ((N, Tc) int, per stream) the video holds
        unique camera-rate frames (N, S, 67, 67), and the tower runs on
        those and its features are gathered per stream, as in
        ``AVVAD.streaming_head``. Call in eval mode."""
        x = self.tower(video)
        if video_frame_indices is not None:
            idx = video_frame_indices.to(x.device).long()
            x = torch.take_along_dim(x, idx[:, :, None], dim=1)
        out, new_carries = self.lstm_video(x, carries=carries, return_carries=True)
        return self.vad_video(out.float()), new_carries


class AVVAD(nn.Module):
    """Video tower + audio features, fused by MCB (-> signed sqrt -> L2 ->
    BatchNorm) or concatenation, -> LSTM stack -> Dense logits. ``remat``
    and ``gray_stem``: see ``_VideoTower``; ``mcb_precision``: see
    ``CompactBilinearPooling``."""

    def __init__(self, y_dim: int = 1, lstm_hidden_size: int = 1024,
                 lstm_layers: int = 2, use_mcb: bool = True,
                 mcb_output_size: int = 1024, num_audio_features: int = 513,
                 num_video_features: int = 512, eps: float = 1e-8,
                 dtype: torch.dtype = torch.float32,
                 use_kernel_lstm: bool = False, lstm_state_quant: str = "none",
                 tower_chunk: int = 0, mcb_folded_vars: bool = False,
                 tower_int8: bool = False, tower_quant_mode: str = "dynamic",
                 tower_pallas: bool = False, remat: bool = False,
                 gray_stem: bool = True, tower_stem_int8: bool = False,
                 mcb_precision: str = "highest", dropout_rate: float = 0.0,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.lstm_hidden_size, self.lstm_layers = lstm_hidden_size, lstm_layers
        self.use_mcb = use_mcb
        self.eps = eps
        self.tower = _tower(dtype, tower_chunk, g, tower_int8, tower_quant_mode,
                            tower_pallas, remat, gray_stem, tower_stem_int8)
        if use_mcb:
            self.mcb = CompactBilinearPooling(
                num_audio_features, num_video_features, mcb_output_size,
                folded_vars=mcb_folded_vars, precision=mcb_precision)
            self.mcb_bn = nn.BatchNorm1d(mcb_output_size, eps=eps)
            fused = mcb_output_size
        else:
            fused = num_audio_features + num_video_features
        self.lstm_merged = LSTMStack(fused, lstm_hidden_size, lstm_layers,
                                     dtype=dtype, use_kernel=use_kernel_lstm,
                                     state_quant=lstm_state_quant, generator=g)
        self.dropout = Dropout(dropout_rate)
        self.vad_merged = _head(lstm_hidden_size, y_dim, g)

    def set_lstm_state_quant(self, state_quant: str) -> None:
        for cell in self.lstm_merged.layers():
            cell.state_quant = state_quant

    def _fuse(self, audio: torch.Tensor, v: torch.Tensor,
              per_sample_norm: bool = False) -> torch.Tensor:
        """``per_sample_norm``: the L2 norm over each batch row only, so
        independent streams batched through one step do not couple (a solo
        run's "whole tensor" is that one stream)."""
        if not self.use_mcb:
            return torch.cat([audio, v], dim=-1)
        y = signed_sqrt(self.mcb(audio, v), self.eps)
        y = global_l2_normalize(
            y, axes=tuple(range(1, y.ndim)) if per_sample_norm else None)
        c = y.shape[-1]
        # two-pass variance: flax's use_fast_variance=False (vad_nets.py:304-310)
        return batch_norm(self.mcb_bn, y.reshape(-1, c),
                          fast_variance=False).reshape(y.shape)

    def forward(self, audio: torch.Tensor, video: torch.Tensor,
                video_frame_indices: Optional[torch.Tensor] = None,
                dropout_rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """audio (B, T, 513) log-power features, video (B, T_v, 67, 67).
        With ``video_frame_indices`` ((T,) int, one per audio frame) the
        video holds unique camera-rate frames and the tower features are
        gathered onto the audio timeline."""
        v = self.tower(video)
        with span("fusion"):
            if video_frame_indices is not None:
                v = v.index_select(1, video_frame_indices.to(v.device).long())
            y = self._fuse(audio.float(), v)
        y = self.lstm_merged(y)
        with span("head"):
            return self.vad_merged(self.dropout(y.float(), dropout_rng))

    def streaming_head(self, audio_feats: torch.Tensor, video: torch.Tensor,
                       carries: list, per_stream_norm: bool = False,
                       video_frame_indices: Optional[torch.Tensor] = None):
        """One streaming block: normalised audio features (N, Tc, 513) and
        raw video frames (N, Tc, 67, 67) -> (logits, new carries).

        With ``video_frame_indices`` ((N, Tc) int, per stream) the video
        holds unique camera-rate frames (N, S, 67, 67) and the tower
        features are gathered per stream onto the audio timeline (each
        stream carries its own resample phase). The MCB path's L2 norm is
        taken per block, not per utterance; ``per_stream_norm`` takes it
        per batch row, as N > 1 independent streams need. Call in eval
        mode: the BatchNorms use their running statistics."""
        v = self.tower(video)
        if video_frame_indices is not None:
            idx = video_frame_indices.to(v.device).long()
            v = torch.take_along_dim(v, idx[:, :, None], dim=1)
        y = self._fuse(audio_feats.float(), v, per_sample_norm=per_stream_norm)
        out, new_carries = self.lstm_merged(y, carries=carries,
                                            return_carries=True)
        return self.vad_merged(out.float()), new_carries
