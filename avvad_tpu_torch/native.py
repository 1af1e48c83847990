"""Host-side stream buffering for the streaming servers: ``StreamHub``,
the numpy implementation of avvad_tpu/native/__init__.py:177-340. The JAX
package also has a C++ hub behind the same interface; that is host code,
not a device kernel, and is not ported yet, so there is no ``native=``
switch here."""

from __future__ import annotations

from typing import Optional

import numpy as np


class StreamHub:
    """Per-stream sample buffers and one-call block assembly.

    Per tick, ``assemble()`` writes every ready stream's next frame block
    into one preallocated array: (n_streams, block_frames, nfft)
    materialised windows, or with ``span=True`` the (n_streams, span)
    contiguous samples the windows are cut from.

    dtype: float32, or int16 for raw 16-bit PCM buffered and
    span-assembled as int16 (half the host-to-device payload; peaks then
    hold max |sample| in the int16 domain). int16 supports the span wire
    only."""

    def __init__(self, n_streams: int, nfft: int, hop: int, block_frames: int,
                 dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.int16)):
            raise ValueError(f"StreamHub dtype must be float32 or int16, "
                             f"got {self.dtype}")
        self._i16 = self.dtype == np.int16
        self.n = n_streams
        self.nfft = nfft
        self.hop = hop
        self.block_frames = block_frames
        self._out = (None if self._i16 else
                     np.zeros((n_streams, block_frames, nfft), np.float32))
        self.span = (block_frames - 1) * hop + nfft
        self._out_span = None  # (N, span), allocated on first span assemble
        self._peaks = np.zeros(n_streams, np.float32)
        self._active = np.zeros(n_streams, np.float32)
        self._frame_idx = (np.arange(block_frames)[:, None] * hop
                           + np.arange(nfft)[None, :])
        self.reset()

    def reset(self) -> None:
        self._bufs = [np.zeros(0, self.dtype) for _ in range(self.n)]
        self._run_peaks = np.zeros(self.n, np.float32)

    def reset_stream(self, stream: int) -> None:
        """Clear one stream's buffer and peak (connection recycling)."""
        self._bufs[stream] = np.zeros(0, self.dtype)
        self._run_peaks[stream] = 0.0

    def frames_ready(self, stream: int) -> int:
        n = len(self._bufs[stream])
        return 0 if n < self.nfft else 1 + (n - self.nfft) // self.hop

    def feed(self, stream: int, pcm: np.ndarray) -> int:
        """Buffer samples; returns complete frames now buffered. An int16
        hub requires int16 input (an implicit float->int16 cast would
        silently truncate samples: the caller quantises explicitly)."""
        pcm = np.asarray(pcm)
        if self._i16 and pcm.dtype != np.int16:
            raise TypeError(f"int16 StreamHub.feed requires int16 PCM, "
                            f"got {pcm.dtype}")
        pcm = np.ascontiguousarray(pcm, dtype=self.dtype)
        if pcm.size:
            # abs in float: np.abs(int16 -32768) overflows in-dtype
            peak = float(np.max(np.abs(pcm.astype(np.float32))))
            self._run_peaks[stream] = max(self._run_peaks[stream], peak)
        self._bufs[stream] = np.concatenate([self._bufs[stream], pcm])
        return self.frames_ready(stream)

    def assemble(self, gate: Optional[np.ndarray] = None, span: bool = False):
        """-> (blocks, peaks (N,), active (N,), n_active).

        ``gate`` ((N,) float, optional): streams with gate == 0 are held
        back even when audio-ready, their samples staying buffered (an
        audio-visual server gates on the video side having a full block).
        The returned arrays are reused across calls: copy or upload them
        before the next assemble."""
        if self._i16 and not span:
            raise ValueError("int16 StreamHub supports the span wire only "
                             "(frames assemble is float32)")
        if span and self._out_span is None:
            self._out_span = np.zeros((self.n, self.span), self.dtype)
        out = self._out_span if span else self._out
        n_active = 0
        bf = self.block_frames
        for i in range(self.n):
            self._peaks[i] = self._run_peaks[i]
            if (gate is not None and gate[i] == 0.0) or self.frames_ready(i) < bf:
                self._active[i] = 0.0
                continue
            buf = self._bufs[i]
            out[i] = buf[: self.span] if span else buf[self._frame_idx]
            self._bufs[i] = buf[bf * self.hop:]
            self._active[i] = 1.0
            n_active += 1
        return out, self._peaks, self._active, n_active
