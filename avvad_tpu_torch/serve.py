"""Streaming VAD serving (port of avvad_tpu/serve.py: ``StreamingVAD``,
``MultiStreamVAD``, ``StreamingAVVAD``, ``MultiStreamAVVAD``,
``StreamingVideoVAD``, ``MultiStreamVideoVAD``).

A stateful streaming classifier accepts raw PCM (and lip frames) in chunks
of any size and emits frame-level speech probabilities with bounded
latency:

- the host keeps only sample buffers and a running peak for normalisation
  (``native.StreamHub`` for the multi-stream servers: the C++ hub, or with
  ``native=False`` its numpy route);
- one device step per fixed frame block: windowed-DFT log-power frontend,
  dataset normalisation, (video tower, fusion,) LSTM with carried (h, c)
  per layer, Dense, sigmoid. The recurrent state crosses block boundaries,
  so the output equals offline classification of the concatenated stream,
  up to the causal running peak (and, with MCB fusion, the per-block L2
  norm), which are inherent to streaming.

Each class takes a port model that already carries its weights, moves it
to ``device`` (the card unless ``device="cpu"``) in eval mode, and runs
its step under ``torch.inference_mode()``. With carries the LSTM
recurrence is the plain loop of ``models.lstm.LSTMCellFused`` (JAX leaves
its Pallas kernel for ``lax.scan`` there too); with ``tower_pallas`` the
static-int8 tower of an ``AVVAD`` or a ``VideoVAD`` runs on its
hand-written kernels.

Not ported yet: the ``mesh=`` and ``step_override=`` options.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .config import STFTConfig
from .models.vad_nets import AVVAD, AudioVAD, VideoVAD
from .native import StreamHub
from .ops.stft import _dft_hop_blocks, _on, _windowed_dft_bases, frame_signal
from .processing.video import fps_block_schedule, fps_block_src_max


def _norm_stat(norm_stats: Optional[dict], key: str, device) -> Optional[torch.Tensor]:
    """Dataset-normalisation vector (or None) as a device tensor."""
    if norm_stats and norm_stats.get(key) is not None:
        return torch.as_tensor(np.asarray(norm_stats[key], np.float32).reshape(-1),
                               device=device)
    return None


def _to_wire_video(frames, dtype) -> np.ndarray:
    """Cast lip frames to the streamer's wire dtype. uint8 wire: frames are
    min-max normalised to [0, 255] by construction, so a rounded uint8
    carries them at a quarter of float32's host-to-device payload, with a
    quantisation error <= 0.5/255 of full scale."""
    frames = np.asarray(frames)
    if dtype == np.uint8 and frames.dtype != np.uint8:
        return np.clip(np.round(frames), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(frames, dtype=dtype)


def _normalize_video(video: torch.Tensor, mean, std, eps: float) -> torch.Tensor:
    """Wire frames (uint8 or float32) -> float32, dataset-normalised where
    the statistics are given (uint8: dequantised on the device, so the
    transfer stays a quarter of float32's)."""
    v = video.float()
    if mean is not None:
        v = (v - mean) / (std + eps)
    return v


def _upload(x, device: torch.device) -> torch.Tensor:
    """Host array (or scalar) -> device tensor through a private copy.

    The hub reuses its assemble buffers, and ``torch.from_numpy`` aliases
    host memory: a tick left in flight (``tick(fetch=False)``,
    ``tick_pipelined``) would otherwise read whatever the NEXT assemble
    wrote over them. On the card the copy lands in a pinned staging tensor
    of this tick's own (the caching host allocator hands its memory out
    again only once the queued upload has run), so the upload is
    asynchronous and race-free."""
    if device.type != "cuda":
        return torch.from_numpy(np.array(x, copy=True))
    src = torch.from_numpy(np.asarray(x))
    staging = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    staging.copy_(src)
    return staging.to(device, non_blocking=True)


def _span_feats(spans, peaks, nfft, hop, n_frames, cos_b, sin_b, eps,
                mean, std, hop_dft):
    """Streaming frontend for the SPAN wire: ``spans`` is (N, span) raw
    contiguous samples, the un-inflated signal of a frame block
    (span = (n_frames-1)*hop + nfft), about nfft/hop smaller on the
    host-to-device link than the (N, n_frames, nfft) windows of
    ``_log_power_feats``. The default path frames on the device (a view)
    and runs the identical windowed-DFT arithmetic: exact against the
    frames wire. ``hop_dft`` skips framing: one K=hop DFT per hop block and
    the radix assembly (``ops.stft._dft_hop_blocks``). ``spans`` may be
    int16 PCM: the cast-then-divide by the int-domain running peak is the
    once-rounded quotient of the same real ratio as the float wire's, so it
    is exact for int16-origin sources."""
    spans = spans.float()
    if hop_dft:
        x = spans / torch.clamp(peaks[..., None], min=1e-12)
        re, im = _dft_hop_blocks(x, nfft, hop, n_frames)
        feats = torch.log(re * re + im * im + eps)
        if mean is not None:
            feats = (feats - mean) / (std + eps)
        return feats
    frames = frame_signal(spans, nfft, hop)  # (N, n_frames, nfft)
    return _log_power_feats(frames, peaks[..., None, None], cos_b, sin_b,
                            eps, mean, std)


def _log_power_feats(frames, peaks, cos_b, sin_b, eps, mean, std):
    """Shared streaming frontend: peak-normalised raw sample frames ->
    (optionally dataset-normalised) log-power features. ``peaks`` is a
    device tensor that broadcasts against ``frames`` (a true division, not
    a multiplication by a host scalar's reciprocal); the DFT matmuls are
    fp32 with TF32 off."""
    x = frames / torch.clamp(peaks, min=1e-12)
    re = torch.matmul(x, cos_b)
    im = torch.matmul(x, sin_b)
    feats = torch.log(re * re + im * im + eps)
    if mean is not None:
        feats = (feats - mean) / (std + eps)
    return feats


def _place(model, device):
    """-> (device, model on it in eval mode), with TF32 off for matmuls and
    cuDNN convolutions as the serving step of ``export`` keeps it."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev, model.to(dev).eval()


def _zero_carries(model, n: int, device) -> list:
    h = model.lstm_hidden_size
    return [(torch.zeros(n, h, device=device), torch.zeros(n, h, device=device))
            for _ in range(model.lstm_layers)]


def _cut_frames(buf: np.ndarray, nfft: int, hop: int):
    """-> (the completed windows of a sample buffer (n, nfft), the rest)."""
    n_new = 1 + (len(buf) - nfft) // hop if len(buf) >= nfft else 0
    if n_new <= 0:
        return np.zeros((0, nfft), np.float32), buf
    idx = np.arange(n_new)[:, None] * hop + np.arange(nfft)[None, :]
    return buf[idx], buf[n_new * hop:]


class StreamingVAD:
    """Stateful streaming frame classifier around an ``AudioVAD``.

    feed(pcm) -> float32 array of speech probabilities for every STFT frame
    completed by this chunk (possibly empty).
    """

    def __init__(self, model: AudioVAD, norm_stats: Optional[dict] = None,
                 stft_cfg: STFTConfig = STFTConfig(), block_frames: int = 16,
                 fixed_peak: Optional[float] = None,
                 device: str | torch.device | None = None):
        self._dev, self.model = _place(model, device)
        self.cfg = stft_cfg
        self.block_frames = block_frames
        self.fixed_peak = fixed_peak
        self._nfft = stft_cfg.nfft
        self._hop = stft_cfg.hopsamp
        self._cos, self._sin = _on(self._dev, _windowed_dft_bases, self._nfft)
        self._mean = _norm_stat(norm_stats, "audio_mean", self._dev)
        self._std = _norm_stat(norm_stats, "audio_std", self._dev)
        self.reset()

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)
        self._frames = np.zeros((0, self._nfft), dtype=np.float32)
        self._peak = self.fixed_peak or 0.0
        self._carries = _zero_carries(self.model, 1, self._dev)

    @torch.inference_mode()
    def _step(self, frames: np.ndarray) -> np.ndarray:
        """One (block, nfft) block of raw sample windows, normalised by the
        running peak -> (block,) probabilities; advances the carries."""
        feats = _log_power_feats(_upload(frames, self._dev),
                                 _upload(np.float32(self._peak), self._dev),
                                 self._cos, self._sin, self.cfg.eps,
                                 self._mean, self._std)[None]  # (1, block, F)
        logits, self._carries = self.model.streaming_head(feats, self._carries)
        return torch.sigmoid(logits[0, :, 0]).cpu().numpy()

    def feed(self, pcm: np.ndarray) -> np.ndarray:
        """Push a chunk of samples; returns probabilities of newly completed
        frames (in order). Call flush() at stream end for the tail."""
        pcm = np.asarray(pcm, dtype=np.float32)
        if self.fixed_peak is None and pcm.size:
            self._peak = max(self._peak, float(np.max(np.abs(pcm))))
        new, self._buf = _cut_frames(np.concatenate([self._buf, pcm]),
                                     self._nfft, self._hop)
        self._frames = np.concatenate([self._frames, new])
        outs = []
        while len(self._frames) >= self.block_frames:
            block = self._frames[: self.block_frames]
            self._frames = self._frames[self.block_frames:]
            outs.append(self._step(block))
        return np.concatenate(outs) if outs else np.zeros(0, dtype=np.float32)

    def flush(self) -> np.ndarray:
        """Classify remaining frames (zero-padding the final block)."""
        n = len(self._frames)
        if n == 0:
            return np.zeros(0, dtype=np.float32)
        pad = self.block_frames - n
        block = np.concatenate(
            [self._frames, np.zeros((pad, self._nfft), np.float32)])
        self._frames = self._frames[:0]
        return self._step(block)[:n]


class _Pending:
    """A dispatched tick whose probabilities are still on the device: the
    (N, block) device tensor, a private copy of the active mask, the event
    recorded behind the tick, and, once a download was started, the pinned
    host buffer with the event behind that copy."""

    __slots__ = ("probs", "active", "ready", "host", "done")

    def __init__(self, probs, active, ready):
        self.probs, self.active, self.ready = probs, active, ready
        self.host = self.done = None


class _MultiStreamBase:
    """State shared by the multi-stream servers: the LSTM carries as (N, H)
    device tensors, per-row carry recycling, the per-tick carry masking
    that keeps inactive (padded) streams' recurrent state untouched, and
    the two-deep pipelined tick."""

    def _init_streams(self, model, n_streams: int, block_frames: int,
                      max_backlog_blocks: int, device) -> None:
        self._dev, self.model = _place(model, device)
        self.n = n_streams
        self.block_frames = block_frames
        self.max_backlog_blocks = max_backlog_blocks
        self._pending_tick = self._raw_tick = None
        # downloads of pending results run beside the next tick's compute
        self._side = torch.cuda.Stream(self._dev) if self._dev.type == "cuda" else None

    @torch.inference_mode()
    def _clear_carry_row(self, stream_idx: int) -> None:
        cleared = []
        for h, c in self._carries:
            h, c = h.clone(), c.clone()  # a tensor of its own per layer and state
            h[stream_idx] = 0.0
            c[stream_idx] = 0.0
            cleared.append((h, c))
        self._carries = cleared

    @staticmethod
    def _mask_carries(active, new_carries, carries):
        """Restore carries of inactive (padded) streams after a step."""
        a = active[:, None]
        return [(a * hn + (1 - a) * ho, a * cn + (1 - a) * co)
                for (hn, cn), (ho, co) in zip(new_carries, carries)]

    def _finish_tick(self, probs, active, fetch):
        """Tail shared by every tick(): stash the raw tick for the
        pipelined path, then return per-stream results. fetch=None is the
        raw mode tick_pipelined uses (no per-row slicing). ``active`` is
        copied: the hub reuses its assemble buffers, so the stashed mask
        would otherwise be zeroed in place by the NEXT tick."""
        ready = None
        if self._side is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self._dev))
        self._raw_tick = _Pending(probs, np.array(active, copy=True), ready)
        if fetch is None:
            return True
        if fetch:
            probs = probs.cpu().numpy()
        return {i: probs[i] for i in range(self.n) if active[i]}

    def _start_download(self, prev: _Pending) -> None:
        """Queue the device-to-host copy of a pending tick's probabilities
        on the side stream, behind that tick's own event only."""
        if self._side is None or prev.host is not None:
            return
        prev.host = torch.empty(prev.probs.shape, dtype=prev.probs.dtype,
                                pin_memory=True)
        self._side.wait_event(prev.ready)
        prev.probs.record_stream(self._side)
        with torch.cuda.stream(self._side):
            prev.host.copy_(prev.probs, non_blocking=True)
            prev.done = torch.cuda.Event()
            prev.done.record(self._side)

    def _fetch_pending(self, prev: Optional[_Pending]) -> dict:
        if prev is None:
            return {}
        if prev.host is not None:
            prev.done.synchronize()
            probs = prev.host.numpy().copy()
        else:
            probs = prev.probs.cpu().numpy()
        return {i: probs[i] for i in range(self.n) if prev.active[i]}

    def tick_pipelined(self) -> dict:
        """Two-deep pipelined tick: dispatch THIS tick asynchronously and
        return the PREVIOUS tick's (by now computed) probabilities.

        While the device runs tick N, the host assembles and uploads tick
        N+1's blocks and downloads tick N-1's results, so per-tick wall
        time approaches max(compute, transfer) instead of their sum, at
        the cost of exactly one block (block_frames/62.5 s) of extra
        result latency. Returns {} for the first tick (nothing pending
        yet); call flush_pipelined() after the last tick to drain the
        tail. reset_stream(i) scrubs stream i from the pending tick and
        reset() drops it entirely: pre-reset results are never delivered
        to a recycled slot."""
        prev = self._pending_tick
        if prev is not None:
            # start the download of the pending results BEFORE dispatching
            # this tick, and on a side stream that waits for the pending
            # tick's event only: a copy queued on the compute stream after
            # the new tick would wait for the NEW compute too
            self._start_download(prev)
        self._raw_tick = None
        out = self.tick(fetch=None)
        self._pending_tick = self._raw_tick if out else None
        return self._fetch_pending(prev)

    def flush_pipelined(self) -> dict:
        """Fetch the pending pipelined tick (if any) without dispatching."""
        prev, self._pending_tick = self._pending_tick, None
        return self._fetch_pending(prev)

    def pending_streams(self) -> set:
        """Stream indices with results still in flight from the last
        tick_pipelined (so a server knows not to drop a draining
        connection whose final block's output has not been fetched yet)."""
        prev = self._pending_tick
        if prev is None:
            return set()
        return {i for i in range(self.n) if prev.active[i]}

    def cancel_pending(self, stream_idx: int) -> None:
        """Scrub one stream from the pending pipelined tick. A recycled
        slot (reset_stream) must not deliver its in-flight result: the
        probabilities predate the reset, and a server that reassigns the
        slot before the next fetch would otherwise send the OLD stream's
        output to the NEW connection. The stashed ``active`` mask is a
        private copy, so zeroing in place is safe."""
        if self._pending_tick is not None:
            self._pending_tick.active[stream_idx] = 0.0

    def _cancel_all_pending(self) -> None:
        """Whole-streamer reset: drop any in-flight pipelined tick."""
        self._pending_tick = None

    def _init_audio(self, stft_cfg, norm_stats, span_wire, hop_dft, audio_int16,
                    native):
        """Wire options, hub and frontend constants of the audio side."""
        if hop_dft and not span_wire:
            raise ValueError("hop_dft frontend requires span_wire=True "
                             "(it consumes the contiguous sample span)")
        if audio_int16 and not span_wire:
            raise ValueError("audio_int16 requires span_wire=True (the "
                             "frames wire is float32-only)")
        self.span_wire = span_wire
        self.hop_dft = hop_dft
        self.audio_int16 = audio_int16
        self._adtype = np.int16 if audio_int16 else np.float32
        self.cfg = stft_cfg
        self._nfft = stft_cfg.nfft
        self._hop = stft_cfg.hopsamp
        self._hub = StreamHub(self.n, self._nfft, self._hop, self.block_frames,
                              force_python=not native, dtype=self._adtype)
        self._cos, self._sin = _on(self._dev, _windowed_dft_bases, self._nfft)
        self._a_mean = _norm_stat(norm_stats, "audio_mean", self._dev)
        self._a_std = _norm_stat(norm_stats, "audio_std", self._dev)

    def _audio_feats(self, frames, peaks):
        """frames (N, block, nfft), or the raw (N, span) sample span on the
        span wire; peaks (N,) -> features (N, block, F)."""
        if self.span_wire:
            return _span_feats(frames, peaks, self._nfft, self._hop,
                               self.block_frames, self._cos, self._sin,
                               self.cfg.eps, self._a_mean, self._a_std,
                               self.hop_dft)
        return _log_power_feats(frames, peaks[:, None, None], self._cos,
                                self._sin, self.cfg.eps, self._a_mean,
                                self._a_std)

    def _audio_shape(self) -> tuple:
        return ((self.n, self._hub.span) if self.span_wire
                else (self.n, self.block_frames, self._nfft))

    def _feed_audio(self, stream_idx: int, pcm) -> None:
        # enforce on the POST-feed count: checking only the pre-feed state
        # would let a single large message overshoot the bound by its full
        # size. On the raise the offending samples are still buffered: the
        # serving front drops the connection, and reset_stream reclaims
        # the slot.
        pcm = (np.asarray(pcm) if self.audio_int16
               else np.asarray(pcm, dtype=np.float32))
        if self._hub.feed(stream_idx, pcm) > self.max_backlog_blocks * self.block_frames:
            raise ValueError(f"stream {stream_idx} audio backlog exceeds "
                             f"{self.max_backlog_blocks} blocks")


class MultiStreamVAD(_MultiStreamBase):
    """N concurrent independent audio streams through ONE device step.

    Each call to tick() advances every stream that has a full frame block
    ready; streams without enough buffered frames are padded and their
    LSTM carries are mask-restored, so a stream's results do not depend on
    the others (every row of the batched step is independent; against a
    solo ``StreamingVAD`` they agree to matmul rounding, since a BLAS may
    pick another kernel for N rows than for one).

    span_wire: ship each tick's raw (N, (bf-1)*hop + nfft) sample span
    instead of materialised (N, bf, nfft) windows; framing moves onto the
    device, exactly. hop_dft (requires span_wire): the hop-block DFT
    frontend on the span. audio_int16 (requires span_wire): buffer and
    ship raw int16 PCM, half the float span's payload, exact for 16-bit
    sources; feed() then takes np.int16 samples. native: the samples buffer
    in the C++ hub (built at first use; raises if it cannot be built);
    False takes the hub's numpy route, which assembles the same blocks."""

    def __init__(self, model: AudioVAD, n_streams: int,
                 norm_stats: Optional[dict] = None,
                 stft_cfg: STFTConfig = STFTConfig(), block_frames: int = 16,
                 max_backlog_blocks: int = 32, span_wire: bool = False,
                 hop_dft: bool = False, audio_int16: bool = False,
                 native: bool = True,
                 device: str | torch.device | None = None):
        self._init_streams(model, n_streams, block_frames, max_backlog_blocks,
                           device)
        self._init_audio(stft_cfg, norm_stats, span_wire, hop_dft, audio_int16,
                         native)
        self.reset()

    def reset(self) -> None:
        self._hub.reset()
        self._carries = _zero_carries(self.model, self.n, self._dev)
        self._cancel_all_pending()

    @torch.inference_mode()
    def _step(self, frames, peaks, active, carries):
        feats = self._audio_feats(frames, peaks)
        logits, new_carries = self.model.streaming_head(feats, carries)
        return (torch.sigmoid(logits[..., 0]),
                self._mask_carries(active, new_carries, carries))

    def warmup(self) -> None:
        """Run the tick step once before serving traffic (library handles,
        the kernels' build). State is untouched: the step runs on zero
        inputs with active=0, so every stream's carries are mask-restored."""
        dev = self._dev
        self._step(_upload(np.zeros(self._audio_shape(), self._adtype), dev),
                   torch.ones(self.n, device=dev), torch.zeros(self.n, device=dev),
                   self._carries)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def feed(self, stream_idx: int, pcm: np.ndarray) -> None:
        """Buffer samples for one stream (no compute). With audio_int16
        ``pcm`` must be np.int16. Raises ValueError when the stream's
        backlog exceeds max_backlog_blocks: a client pushing far ahead of
        real time must not grow server memory without bound."""
        self._feed_audio(stream_idx, pcm)

    def has_full_block(self, stream_idx: int) -> bool:
        """True when the stream could produce output on the next tick."""
        return self._hub.frames_ready(stream_idx) >= self.block_frames

    def reset_stream(self, stream_idx: int) -> None:
        """Recycle one stream slot: clear its buffer/peak and zero its LSTM
        carries (other streams are untouched)."""
        self._hub.reset_stream(stream_idx)
        self._clear_carry_row(stream_idx)
        self.cancel_pending(stream_idx)

    def tick(self, fetch: Optional[bool] = True) -> dict:
        """Advance every stream with >= block_frames buffered; returns
        {stream_idx: probs} for the streams that produced output.
        ``fetch=False`` returns device tensors without synchronising."""
        blocks, peaks, active, n_active = self._hub.assemble(span=self.span_wire)
        if n_active == 0:
            return {}
        dev = self._dev
        probs, self._carries = self._step(
            _upload(blocks, dev), _upload(peaks, dev), _upload(active, dev),
            self._carries)
        return self._finish_tick(probs, active, fetch)


class StreamingAVVAD:
    """Stateful streaming audio-visual classifier around an ``AVVAD``.

    feed(pcm, video_frames) accepts raw PCM samples and STFT-rate-aligned
    (62.5 fps) lip frames (T, 67, 67); both buffer independently and a
    device step fires whenever ``block_frames`` of BOTH modalities are
    ready. The fusion and LSTM state carries across blocks. For 30 fps
    camera input, re-time frames with
    ``processing.video.fps_resample_indices`` before feeding.
    """

    def __init__(self, model: AVVAD, norm_stats: Optional[dict] = None,
                 stft_cfg: STFTConfig = STFTConfig(), block_frames: int = 16,
                 fixed_peak: Optional[float] = None, video_uint8: bool = False,
                 device: str | torch.device | None = None):
        self._dev, self.model = _place(model, device)
        self.cfg = stft_cfg
        self.block_frames = block_frames
        self.fixed_peak = fixed_peak
        self.video_uint8 = video_uint8
        self._vdtype = np.uint8 if video_uint8 else np.float32
        self._nfft = stft_cfg.nfft
        self._hop = stft_cfg.hopsamp
        self._cos, self._sin = _on(self._dev, _windowed_dft_bases, self._nfft)
        self._a_mean = _norm_stat(norm_stats, "audio_mean", self._dev)
        self._a_std = _norm_stat(norm_stats, "audio_std", self._dev)
        self._v_mean = _norm_stat(norm_stats, "video_mean", self._dev)
        self._v_std = _norm_stat(norm_stats, "video_std", self._dev)
        self.reset()

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)
        self._frames = np.zeros((0, self._nfft), dtype=np.float32)
        self._vframes = np.zeros((0, 67, 67), dtype=self._vdtype)
        self._peak = self.fixed_peak or 0.0
        self._carries = _zero_carries(self.model, 1, self._dev)

    @torch.inference_mode()
    def _step(self, frames: np.ndarray, video: np.ndarray) -> np.ndarray:
        feats = _log_power_feats(_upload(frames, self._dev),
                                 _upload(np.float32(self._peak), self._dev),
                                 self._cos, self._sin, self.cfg.eps,
                                 self._a_mean, self._a_std)[None]
        v = _normalize_video(_upload(video, self._dev)[None], self._v_mean,
                             self._v_std, self.cfg.eps)
        logits, self._carries = self.model.streaming_head(feats, v, self._carries)
        return torch.sigmoid(logits[0, :, 0]).cpu().numpy()

    def feed(self, pcm: np.ndarray, video_frames: np.ndarray) -> np.ndarray:
        """Push synchronised chunks; returns probs of completed frames."""
        pcm = np.asarray(pcm, dtype=np.float32)
        if self.fixed_peak is None and pcm.size:
            self._peak = max(self._peak, float(np.max(np.abs(pcm))))
        if len(video_frames):
            self._vframes = np.concatenate(
                [self._vframes, _to_wire_video(video_frames, self._vdtype)])
        new, self._buf = _cut_frames(np.concatenate([self._buf, pcm]),
                                     self._nfft, self._hop)
        self._frames = np.concatenate([self._frames, new])
        outs, bf = [], self.block_frames
        while len(self._frames) >= bf and len(self._vframes) >= bf:
            fb, vb = self._frames[:bf], self._vframes[:bf]
            self._frames, self._vframes = self._frames[bf:], self._vframes[bf:]
            outs.append(self._step(fb, vb))
        return np.concatenate(outs) if outs else np.zeros(0, dtype=np.float32)

    def flush(self) -> np.ndarray:
        n = min(len(self._frames), len(self._vframes))
        if n == 0:
            return np.zeros(0, dtype=np.float32)
        pad = self.block_frames - n
        fb = np.concatenate([self._frames[:n],
                             np.zeros((pad, self._nfft), np.float32)])
        vb = np.concatenate([self._vframes[:n],
                             np.zeros((pad, 67, 67), self._vdtype)])
        self._frames = self._frames[:0]
        self._vframes = self._vframes[:0]
        return self._step(fb, vb)[:n]


class _CameraRateVideoMixin:
    """Camera-rate video ingestion: a per-stream resample phase over the
    exact ffmpeg duplication schedule (processing.video.fps_block_schedule).
    Each tick ships only the block's unique source frames
    (N, src_max, 67, 67) plus per-stream gather indices (N, bf); the tower
    features gather onto the 62.5 fps label timeline on the device, which
    equals feeding pre-upsampled frames at about rate_out/rate_in less
    payload and tower compute."""

    def _init_camera_video(self, video_fps: Optional[float], out_fps: float,
                           n_streams: int, block_frames: int, vdtype) -> None:
        self.video_fps = video_fps
        if not video_fps:
            self._vout = np.zeros((n_streams, block_frames, 67, 67), vdtype)
            return
        self._out_fps = out_fps
        if video_fps > out_fps:
            raise ValueError(
                f"video_fps {video_fps} exceeds the {out_fps} fps label "
                "timeline (the schedule only duplicates frames)")
        self._vsrc_max = fps_block_src_max(block_frames, video_fps, out_fps)
        self._vout = np.zeros((n_streams, self._vsrc_max, 67, 67), vdtype)
        self._vidx = np.zeros((n_streams, block_frames), np.int32)

    def _camera_reset(self) -> None:
        if self.video_fps:
            # per-stream resample phase: next output-frame index, and the
            # absolute source index of _vbufs[i][0]
            self._vpos = np.zeros(self.n, np.int64)
            self._vbase = np.zeros(self.n, np.int64)

    def _camera_reset_stream(self, stream_idx: int) -> None:
        if self.video_fps:
            self._vpos[stream_idx] = 0
            self._vbase[stream_idx] = 0

    def _video_cap(self, cap_blocks_frames: int) -> int:
        """Backlog cap in buffered frames; counts SOURCE frames in
        camera-rate mode."""
        if not self.video_fps:
            return cap_blocks_frames
        return int(np.ceil(cap_blocks_frames * self.video_fps
                           / self._out_fps)) + self._vsrc_max

    def _video_block_need(self, stream_idx: int):
        """Camera-rate mode: (src_lo, rel_idx) for this stream's pending
        block, from its resample phase."""
        return fps_block_schedule(int(self._vpos[stream_idx]),
                                  self.block_frames, self.video_fps,
                                  self._out_fps)

    def _video_ready(self, stream_idx: int) -> bool:
        if not self.video_fps:
            return len(self._vbufs[stream_idx]) >= self.block_frames
        lo, rel = self._video_block_need(stream_idx)
        need = lo - int(self._vbase[stream_idx]) + int(rel[-1]) + 1
        return len(self._vbufs[stream_idx]) >= need

    def _consume_video(self, i: int) -> None:
        """Move one block of video for stream i into the device-bound
        buffers and advance its state."""
        bf = self.block_frames
        if not self.video_fps:
            self._vout[i] = self._vbufs[i][:bf]
            self._vbufs[i] = self._vbufs[i][bf:]
            return
        lo, rel = self._video_block_need(i)
        off = lo - int(self._vbase[i])
        cnt = int(rel[-1]) + 1
        self._vout[i, :cnt] = self._vbufs[i][off:off + cnt]
        self._vidx[i] = rel
        # advance phase; keep source frames the NEXT block still needs
        # (a source frame can straddle the block boundary)
        self._vpos[i] += bf
        next_lo, _ = self._video_block_need(i)
        drop = next_lo - int(self._vbase[i])
        self._vbufs[i] = self._vbufs[i][drop:]
        self._vbase[i] = next_lo


class MultiStreamAVVAD(_MultiStreamBase, _CameraRateVideoMixin):
    """N concurrent independent AUDIO-VISUAL streams through ONE device
    step (the AV counterpart of MultiStreamVAD).

    Per stream, raw PCM and lip frames buffer independently; a tick()
    advances every stream that has a full ``block_frames`` block of BOTH
    modalities ready (the hub's gated assemble holds back streams whose
    video lags, keeping their samples buffered). Padded/inactive streams
    have their LSTM carries mask-restored, and the MCB path's L2 norm is
    taken per stream, so streams do not couple. With ``video_fps`` (e.g.
    30.0) feed() takes lip frames at the camera's rate: each tick ships
    only the block's unique source frames with a per-stream gather
    schedule, the tower runs on the uniques, and features are gathered
    onto the 62.5 fps timeline on the device. span_wire / hop_dft /
    audio_int16 / native: see MultiStreamVAD. video_uint8: lip frames
    travel as uint8 and are dequantised on the device."""

    def __init__(self, model: AVVAD, n_streams: int,
                 norm_stats: Optional[dict] = None,
                 stft_cfg: STFTConfig = STFTConfig(), block_frames: int = 16,
                 max_backlog_blocks: int = 32, video_uint8: bool = False,
                 span_wire: bool = False, hop_dft: bool = False,
                 video_fps: Optional[float] = None, audio_int16: bool = False,
                 native: bool = True,
                 device: str | torch.device | None = None):
        self._init_streams(model, n_streams, block_frames, max_backlog_blocks,
                           device)
        self._init_audio(stft_cfg, norm_stats, span_wire, hop_dft, audio_int16,
                         native)
        self.video_uint8 = video_uint8
        self._vdtype = np.uint8 if video_uint8 else np.float32
        self._v_mean = _norm_stat(norm_stats, "video_mean", self._dev)
        self._v_std = _norm_stat(norm_stats, "video_std", self._dev)
        self._init_camera_video(video_fps, stft_cfg.fs / stft_cfg.hopsamp,
                                n_streams, block_frames, self._vdtype)
        self.reset()

    def reset(self) -> None:
        self._hub.reset()
        self._vbufs = [np.zeros((0, 67, 67), self._vdtype)
                       for _ in range(self.n)]
        self._camera_reset()
        self._carries = _zero_carries(self.model, self.n, self._dev)
        self._cancel_all_pending()

    @torch.inference_mode()
    def _step(self, frames, video, vidx, peaks, active, carries):
        """video (N, bf, 67, 67), or the block's unique
        (N, src_max, 67, 67) camera-rate frames with their per-stream
        gather schedule vidx (N, bf) (None otherwise)."""
        feats = self._audio_feats(frames, peaks)
        v = _normalize_video(video, self._v_mean, self._v_std, self.cfg.eps)
        logits, new_carries = self.model.streaming_head(
            feats, v, carries, per_stream_norm=True, video_frame_indices=vidx)
        return (torch.sigmoid(logits[..., 0]),
                self._mask_carries(active, new_carries, carries))

    def warmup(self) -> None:
        """Run the tick step once before serving traffic (see
        MultiStreamVAD.warmup). State is untouched (active=0)."""
        dev = self._dev
        vidx = _upload(np.zeros_like(self._vidx), dev) if self.video_fps else None
        self._step(_upload(np.zeros(self._audio_shape(), self._adtype), dev),
                   _upload(np.zeros_like(self._vout), dev), vidx,
                   torch.ones(self.n, device=dev), torch.zeros(self.n, device=dev),
                   self._carries)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def feed(self, stream_idx: int, pcm: Optional[np.ndarray] = None,
             video_frames: Optional[np.ndarray] = None) -> None:
        """Buffer samples and/or lip frames for one stream (no compute).

        Raises ValueError when either modality's backlog exceeds
        max_backlog_blocks. The gated assemble holds audio in the hub
        while video lags (and vice versa), so a client streaming one
        modality much faster than the other would otherwise grow server
        memory without limit."""
        if pcm is not None and len(pcm):
            self._feed_audio(stream_idx, pcm)
        if video_frames is not None and len(video_frames):
            cap = self.max_backlog_blocks * self.block_frames
            if len(self._vbufs[stream_idx]) + len(video_frames) \
                    > self._video_cap(cap):
                raise ValueError(
                    f"stream {stream_idx} video backlog exceeds "
                    f"{self.max_backlog_blocks} blocks")
            self._vbufs[stream_idx] = np.concatenate(
                [self._vbufs[stream_idx],
                 _to_wire_video(video_frames, self._vdtype)])

    def has_full_block(self, stream_idx: int) -> bool:
        """True when the stream could produce output on the next tick
        (both modalities have a full block buffered)."""
        return (self._hub.frames_ready(stream_idx) >= self.block_frames
                and self._video_ready(stream_idx))

    def reset_stream(self, stream_idx: int) -> None:
        """Recycle one stream slot (buffers, peak, LSTM carries)."""
        self._hub.reset_stream(stream_idx)
        self._vbufs[stream_idx] = np.zeros((0, 67, 67), self._vdtype)
        self._camera_reset_stream(stream_idx)
        self._clear_carry_row(stream_idx)
        self.cancel_pending(stream_idx)

    def tick(self, fetch: Optional[bool] = True) -> dict:
        """Advance every stream with a full audio AND video block; returns
        {stream_idx: probs} for streams that produced output.
        ``fetch=False`` returns device tensors without synchronising."""
        gate = np.fromiter((1.0 if self._video_ready(i) else 0.0
                            for i in range(self.n)), np.float32, self.n)
        blocks, peaks, active, n_active = \
            self._hub.assemble(gate=gate, span=self.span_wire)
        if n_active == 0:
            return {}
        for i in range(self.n):
            if active[i]:
                self._consume_video(i)
        dev = self._dev
        vidx = _upload(self._vidx, dev) if self.video_fps else None
        probs, self._carries = self._step(
            _upload(blocks, dev), _upload(self._vout, dev), vidx,
            _upload(peaks, dev), _upload(active, dev), self._carries)
        return self._finish_tick(probs, active, fetch)


class StreamingVideoVAD:
    """Stateful streaming video-only classifier around a ``VideoVAD``.

    feed(video_frames) accepts label-rate (62.5 fps) lip frames (T, 67, 67);
    a device step fires per ``block_frames``. The tower is frame-local, so
    the LSTM carries are the only state. For 30 fps camera input, re-time
    frames with ``processing.video.fps_resample_indices`` before feeding.
    """

    def __init__(self, model: VideoVAD, norm_stats: Optional[dict] = None,
                 block_frames: int = 16, video_uint8: bool = False,
                 device: str | torch.device | None = None):
        self._dev, self.model = _place(model, device)
        self.block_frames = block_frames
        self.video_uint8 = video_uint8
        self._vdtype = np.uint8 if video_uint8 else np.float32
        self._v_mean = _norm_stat(norm_stats, "video_mean", self._dev)
        self._v_std = _norm_stat(norm_stats, "video_std", self._dev)
        self._eps = STFTConfig().eps
        self.reset()

    def reset(self) -> None:
        self._vframes = np.zeros((0, 67, 67), dtype=self._vdtype)
        self._carries = _zero_carries(self.model, 1, self._dev)

    @torch.inference_mode()
    def _step(self, video: np.ndarray) -> np.ndarray:
        v = _normalize_video(_upload(video, self._dev)[None], self._v_mean,
                             self._v_std, self._eps)
        logits, self._carries = self.model.streaming_head(v, self._carries)
        return torch.sigmoid(logits[0, :, 0]).cpu().numpy()

    def feed(self, video_frames: np.ndarray) -> np.ndarray:
        """Push lip frames; returns probabilities of completed blocks."""
        if len(video_frames):
            self._vframes = np.concatenate(
                [self._vframes, _to_wire_video(video_frames, self._vdtype)])
        outs, bf = [], self.block_frames
        while len(self._vframes) >= bf:
            vb, self._vframes = self._vframes[:bf], self._vframes[bf:]
            outs.append(self._step(vb))
        return np.concatenate(outs) if outs else np.zeros(0, dtype=np.float32)

    def flush(self) -> np.ndarray:
        """Classify the remaining frames (zero-padding the final block)."""
        n = len(self._vframes)
        if n == 0:
            return np.zeros(0, dtype=np.float32)
        vb = np.concatenate([self._vframes, np.zeros(
            (self.block_frames - n, 67, 67), self._vdtype)])
        self._vframes = self._vframes[:0]
        return self._step(vb)[:n]


class MultiStreamVideoVAD(_MultiStreamBase, _CameraRateVideoMixin):
    """N concurrent video-only streams through ONE device step (the video
    twin of MultiStreamVAD). Masked carries keep each batched stream equal
    to a solo ``StreamingVideoVAD`` run. ``video_fps`` (e.g. 30.0) takes
    lip frames at the camera's rate (see ``_CameraRateVideoMixin``): the
    tower, which is the whole cost of a video-only model but the LSTM, runs
    on the unique frames only. video_uint8: lip frames travel as uint8 and
    are dequantised on the device. With the static-int8 tower on its fused
    kernels (``tower_int8``, ``tower_quant_mode="static"``,
    ``tower_pallas``) a tick runs the channels-last K3 once and K2 eight
    times on its unique frames. The JAX streamer's ``mesh=`` and
    ``step_override=`` are not ported."""

    def __init__(self, model: VideoVAD, n_streams: int,
                 norm_stats: Optional[dict] = None, block_frames: int = 16,
                 max_backlog_blocks: int = 32, video_uint8: bool = False,
                 video_fps: Optional[float] = None,
                 device: str | torch.device | None = None):
        self._init_streams(model, n_streams, block_frames, max_backlog_blocks,
                           device)
        self.video_uint8 = video_uint8
        self._vdtype = np.uint8 if video_uint8 else np.float32
        self._v_mean = _norm_stat(norm_stats, "video_mean", self._dev)
        self._v_std = _norm_stat(norm_stats, "video_std", self._dev)
        cfg = STFTConfig()
        self._eps = cfg.eps
        self._init_camera_video(video_fps, cfg.fs / cfg.hopsamp, n_streams,
                                block_frames, self._vdtype)
        self.reset()

    def reset(self) -> None:
        self._vbufs = [np.zeros((0, 67, 67), self._vdtype)
                       for _ in range(self.n)]
        self._camera_reset()
        self._carries = _zero_carries(self.model, self.n, self._dev)
        self._cancel_all_pending()

    @torch.inference_mode()
    def _step(self, video, vidx, active, carries):
        """video (N, bf, 67, 67), or the block's unique (N, src_max, 67, 67)
        camera-rate frames with their per-stream gather schedule vidx
        (N, bf) (None otherwise)."""
        v = _normalize_video(video, self._v_mean, self._v_std, self._eps)
        logits, new_carries = self.model.streaming_head(
            v, carries, video_frame_indices=vidx)
        return (torch.sigmoid(logits[..., 0]),
                self._mask_carries(active, new_carries, carries))

    def warmup(self) -> None:
        """Run the tick step once before serving traffic (see
        MultiStreamVAD.warmup). State is untouched (active=0)."""
        dev = self._dev
        vidx = _upload(np.zeros_like(self._vidx), dev) if self.video_fps else None
        self._step(_upload(np.zeros_like(self._vout), dev), vidx,
                   torch.zeros(self.n, device=dev), self._carries)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def feed(self, stream_idx: int, pcm: Optional[np.ndarray] = None,
             video_frames: Optional[np.ndarray] = None) -> None:
        """Buffer lip frames for one stream (no compute). PCM is rejected: a
        serving front drops a client that sends audio to a video-only
        server. Raises ValueError when the stream's backlog would exceed
        max_backlog_blocks (the bound is on the post-feed count)."""
        if pcm is not None and len(pcm):
            raise ValueError("video-only server: audio payload rejected")
        if video_frames is None or not len(video_frames):
            return
        cap = self.max_backlog_blocks * self.block_frames
        if len(self._vbufs[stream_idx]) + len(video_frames) > self._video_cap(cap):
            raise ValueError(f"stream {stream_idx} video backlog exceeds "
                             f"{self.max_backlog_blocks} blocks")
        self._vbufs[stream_idx] = np.concatenate(
            [self._vbufs[stream_idx], _to_wire_video(video_frames, self._vdtype)])

    def has_full_block(self, stream_idx: int) -> bool:
        """True when the stream could produce output on the next tick."""
        return self._video_ready(stream_idx)

    def reset_stream(self, stream_idx: int) -> None:
        """Recycle one stream slot (buffer, resample phase, LSTM carries)."""
        self._vbufs[stream_idx] = np.zeros((0, 67, 67), self._vdtype)
        self._camera_reset_stream(stream_idx)
        self._clear_carry_row(stream_idx)
        self.cancel_pending(stream_idx)

    def tick(self, fetch: Optional[bool] = True) -> dict:
        """Advance every stream with a full video block; returns
        {stream_idx: probs} for the streams that produced output.
        ``fetch=False`` returns device tensors without synchronising."""
        active = np.fromiter((1.0 if self._video_ready(i) else 0.0
                              for i in range(self.n)), np.float32, self.n)
        if not active.any():
            return {}
        for i in range(self.n):
            if active[i]:
                self._consume_video(i)
        dev = self._dev
        vidx = _upload(self._vidx, dev) if self.video_fps else None
        probs, self._carries = self._step(_upload(self._vout, dev), vidx,
                                          _upload(active, dev), self._carries)
        return self._finish_tick(probs, active, fetch)
