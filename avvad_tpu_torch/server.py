"""TCP serving front for streaming VAD (port of avvad_tpu/server.py).

One TCP connection per stream, full-duplex: raw PCM (or framed audio and
lip-frame messages) in, speech-probability frames out, around the port's
multi-stream servers (``serve.MultiStreamVAD``, ``MultiStreamAVVAD``,
``MultiStreamVideoVAD``). The wire protocol is the JAX package's byte for
byte, so a client of either package talks to a server of either.

Wire protocol:
  audio-only (MultiStreamVAD):
    client -> server: raw samples, any chunking (16 kHz mono): float32
                      LE, or int16 LE PCM when the streamer was built
                      with audio_int16 (half the payload; exact for 16-bit
                      sources)
  audio-visual (MultiStreamAVVAD) and video-only (MultiStreamVideoVAD):
    client -> server: framed messages  [1-byte type][u32 LE byte length]
                      [payload]: type b"A" float32 LE samples; b"P" int16
                      LE PCM samples; b"V" float32 LE 67x67 lip frames;
                      b"U" uint8 67x67 lip frames (any count a message).
                      Modalities interleave freely; the server holds a
                      stream back until both have a full block. "V" frames
                      are quantised server-side when the streamer runs the
                      uint8 video wire; "A" samples are quantised
                      (round-to-nearest) on an audio_int16 streamer, and
                      "P" samples dequantised exactly on a float32 one. A
                      video-only server drops a client that sends audio.
  server -> client (every mode): raw float32 LE per-frame speech
                    probabilities, in frame order, sent as each
                    block_frames block completes.

Design: one selector loop multiplexes every connection onto one
multi-stream server. Sockets drain into its ``StreamHub`` (the C++ hub by
default), then one device step a tick advances every stream with a full
block. Connections map to stream slots; a closed connection recycles its
slot (buffer, peak and LSTM carries reset). With every slot busy, a new
connection is refused.
"""

from __future__ import annotations

import selectors
import socket
from typing import Optional

import numpy as np

from .serve import (MultiStreamAVVAD, MultiStreamVAD, MultiStreamVideoVAD,
                    _to_wire_video)

_BYTES_PER_SAMPLE = 4
_RECV_CHUNK = 1 << 16
_VIDEO_FRAME_BYTES = 67 * 67 * 4
_VIDEO_FRAME_BYTES_U8 = 67 * 67
_MAX_MSG_BYTES = 1 << 24  # 16 MB; a full 16-frame A/V block is ~290 KB


class VADServer:
    """Serve a MultiStreamVAD (raw-PCM protocol), MultiStreamAVVAD
    (framed A/V protocol) or MultiStreamVideoVAD (framed protocol, V/U
    messages only — A payloads drop the connection) over TCP; one
    connection = one stream."""

    def __init__(self, streamer, host: str = "127.0.0.1",
                 port: int = 0, pipelined: bool = False):
        # pipelined: poll with the two-deep tick (serve.tick_pipelined):
        # results ship one block (block_frames/62.5 s) later, while the
        # upload, compute and download of consecutive ticks overlap
        self.streamer = streamer
        self.pipelined = pipelined
        self._av = isinstance(streamer,
                              (MultiStreamAVVAD, MultiStreamVideoVAD))
        # audio sample wire dtype follows the streamer (audio_int16)
        self._a_int16 = bool(getattr(streamer, "audio_int16", False))
        self._a_bytes = 2 if self._a_int16 else _BYTES_PER_SAMPLE
        self._a_dt = "<i2" if self._a_int16 else "<f4"
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen()
        self._listener.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._free = list(range(streamer.n - 1, -1, -1))
        self._conn_slot: dict = {}   # conn -> stream idx
        self._slot_conn: dict = {}   # stream idx -> conn
        self._partial: dict = {}     # conn -> trailing bytes (< 4)
        self._closing: set = set()   # half-closed conns draining buffered blocks
        self._running = False

    @property
    def address(self):
        return self._listener.getsockname()

    # -- connection lifecycle ------------------------------------------------

    def _accept(self):
        conn, _ = self._listener.accept()
        if not self._free:
            # half-closed connections whose buffered blocks have drained
            # are only dropped at end-of-poll; reclaim them now so a new
            # client is not refused for a slot that is effectively free.
            # Mirror poll()'s drain rule: a draining client whose final
            # block's result is still in flight (pipelined) keeps its slot
            # until that result has been delivered.
            pending = (self.streamer.pending_streams() if self.pipelined
                       else ())
            for c in list(self._closing):
                slot = self._conn_slot.get(c)
                if slot is None or (not self.streamer.has_full_block(slot)
                                    and slot not in pending):
                    self._drop(c)
        if not self._free:
            conn.close()  # all stream slots busy
            return
        conn.setblocking(False)
        slot = self._free.pop()
        self._conn_slot[conn] = slot
        self._slot_conn[slot] = conn
        self._partial[conn] = b""
        self._sel.register(conn, selectors.EVENT_READ, "data")

    def _drop(self, conn):
        slot = self._conn_slot.pop(conn, None)
        self._partial.pop(conn, None)
        self._closing.discard(conn)
        if slot is not None:
            self._slot_conn.pop(slot, None)
            self.streamer.reset_stream(slot)
            self._free.append(slot)
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        conn.close()

    def _read(self, conn):
        slot = self._conn_slot.get(conn)
        if slot is None:
            return
        chunks = [self._partial.get(conn, b"")]
        closed = False
        try:
            while True:
                data = conn.recv(_RECV_CHUNK)
                if not data:
                    closed = True  # EOF: process drained bytes, then drop
                    break
                chunks.append(data)
                if len(data) < _RECV_CHUNK:
                    break
        except BlockingIOError:
            pass
        except ConnectionError:
            self._drop(conn)
            return
        buf = b"".join(chunks)
        if self._av:
            try:
                rest = self._feed_av(slot, buf)
            except ValueError:
                self._drop(conn)  # malformed frame stream / backlog abuse
                return
            if closed:
                self._begin_close(conn)
                return
            if conn in self._partial:
                self._partial[conn] = rest
            return
        usable = len(buf) - (len(buf) % self._a_bytes)
        if usable:
            pcm = np.frombuffer(buf[:usable], dtype=self._a_dt)
            try:
                self.streamer.feed(slot, pcm)
            except ValueError:
                self._drop(conn)  # backlog cap exceeded
                return
        if closed:
            self._begin_close(conn)
            return
        if conn in self._partial:
            self._partial[conn] = buf[usable:]

    def _begin_close(self, conn):
        """EOF with payload possibly still buffered: stop reading the dead
        socket but keep the slot alive so subsequent ticks emit every block
        that was fully buffered at close time (a client that half-closes —
        shutdown(SHUT_WR) — after sending must still receive its tail
        probabilities). poll() drops the connection once no full block
        remains."""
        try:
            self._sel.unregister(conn)
        except (KeyError, ValueError):
            pass
        self._closing.add(conn)

    def _feed_av(self, slot: int, buf: bytes) -> bytes:
        """Parse framed A/V messages; feed complete ones; return leftover.

        Strict protocol: unknown message types, oversized lengths
        (> _MAX_MSG_BYTES — a full 16-frame block is ~290 KB, so anything
        in the tens of MB is a corrupt or hostile header, and an
        unvalidated u32 would let one header make the server buffer GBs),
        and payloads that are not whole samples/frames all raise — the
        caller drops the connection. Silent truncation is never correct
        here: dropping tail bytes would bit-shift every following float
        and permanently desync the A/V timelines."""
        off = 0
        while len(buf) - off >= 5:
            mtype = buf[off:off + 1]
            if mtype not in (b"A", b"P", b"V", b"U"):
                raise ValueError(f"bad message type {mtype!r}")
            length = int.from_bytes(buf[off + 1:off + 5], "little")
            if length > _MAX_MSG_BYTES:
                raise ValueError(f"message length {length} exceeds cap")
            if len(buf) - off - 5 < length:
                break
            payload = buf[off + 5:off + 5 + length]
            off += 5 + length
            if mtype == b"A":
                if length % _BYTES_PER_SAMPLE:
                    raise ValueError(f"A payload of {length} bytes is not "
                                     f"whole float32 samples")
                if length:
                    pcm = np.frombuffer(payload, dtype="<f4")
                    if self._a_int16:  # quantize for the int16 device wire
                        pcm = quantize_pcm_int16(pcm)
                    self.streamer.feed(slot, pcm=pcm)
            elif mtype == b"P":
                if length % 2:
                    raise ValueError(f"P payload of {length} bytes is not "
                                     f"whole int16 samples")
                if length:
                    pcm = np.frombuffer(payload, dtype="<i2")
                    if not self._a_int16:  # exact dequant for the f32 wire
                        pcm = pcm.astype(np.float32) / 32768.0
                    self.streamer.feed(slot, pcm=pcm)
            elif mtype == b"V":
                if length % _VIDEO_FRAME_BYTES:
                    raise ValueError(f"V payload of {length} bytes is not "
                                     f"whole 67x67 float32 frames")
                if length:
                    frames = np.frombuffer(payload, dtype="<f4")
                    self.streamer.feed(
                        slot, video_frames=frames.reshape(-1, 67, 67))
            else:
                if length % _VIDEO_FRAME_BYTES_U8:
                    raise ValueError(f"U payload of {length} bytes is not "
                                     f"whole 67x67 uint8 frames")
                if length:
                    frames = np.frombuffer(payload, dtype=np.uint8)
                    self.streamer.feed(
                        slot, video_frames=frames.reshape(-1, 67, 67))
        return buf[off:]

    # -- serving loop --------------------------------------------------------

    def poll(self, timeout: float = 0.005) -> int:
        """One server iteration: drain sockets, run one device tick, send
        results. Returns the number of streams that produced output."""
        for key, _ in self._sel.select(timeout):
            if key.data == "accept":
                self._accept()
            else:
                self._read(key.fileobj)
        results = (self.streamer.tick_pipelined() if self.pipelined
                   else self.streamer.tick(fetch=True))
        for slot, probs in results.items():
            conn = self._slot_conn.get(slot)
            if conn is None:
                continue
            try:
                conn.sendall(np.asarray(probs, dtype="<f4").tobytes())
            except (BlockingIOError, ConnectionError):
                self._drop(conn)
        # drained half-closed connections: drop once no full block remains
        # (pipelined: nor a result still in flight from the last dispatch)
        pending = (self.streamer.pending_streams() if self.pipelined
                   else ())
        for conn in list(self._closing):
            slot = self._conn_slot.get(conn)
            if slot is None or (not self.streamer.has_full_block(slot)
                                and slot not in pending):
                self._drop(conn)
        return len(results)

    def serve_forever(self, max_iterations: Optional[int] = None,
                      timeout: float = 0.005, warmup: bool = True):
        """`warmup` runs the device step once before the first poll (library
        handles, the kernels' build) so that a cold server does not stall
        its first tick; early connections buffer meanwhile."""
        if warmup:
            self.streamer.warmup()
        self._running = True
        n = 0
        while self._running:
            self.poll(timeout)
            n += 1
            if max_iterations is not None and n >= max_iterations:
                break

    def stop(self):
        self._running = False

    def close(self):
        self.stop()
        for conn in list(self._conn_slot):
            self._drop(conn)
        self._sel.unregister(self._listener)
        self._listener.close()
        self._sel.close()


def av_frame(mtype: bytes, payload: bytes) -> bytes:
    """Frame one A/V protocol message."""
    return mtype + len(payload).to_bytes(4, "little") + payload


def quantize_pcm_int16(pcm: np.ndarray) -> np.ndarray:
    """Float PCM -> int16 grid: float64 multiply, round-to-nearest, clip.

    The one quantizer for every float->int16 hop (server A-message
    handler, client wire helper, benchmarks): rounding in float64 keeps
    samples near an LSB boundary from landing on different sides
    depending on which side of the wire quantized them."""
    return np.clip(np.round(np.asarray(pcm, np.float64) * 32768.0),
                   -32768, 32767).astype(np.int16)


def _wire_pcm(pcm: np.ndarray, audio_wire: str):
    """-> (message type, wire bytes, bytes/sample) for an audio payload.
    "i16" ships int16 PCM (type P, half the payload): int16 input rides
    untouched; float input is quantized round-to-nearest."""
    if audio_wire == "i16":
        pcm = np.asarray(pcm)
        if pcm.dtype != np.int16:
            pcm = quantize_pcm_int16(pcm)
        return b"P", pcm.astype("<i2").tobytes(), 2
    return b"A", np.asarray(pcm, dtype="<f4").tobytes(), _BYTES_PER_SAMPLE


def av_stream_client(address, pcm: np.ndarray, video: np.ndarray,
                     n_expected: int, chunk: int = 4000,
                     frames_per_msg: int = 16,
                     timeout: float = 30.0,
                     video_wire: str = "f32",
                     audio_wire: str = "f32") -> np.ndarray:
    """Minimal AV reference client: interleave framed PCM and 67x67 lip
    frames, collect n_expected probs. `video_wire="u8"` sends lip frames
    as rounded uint8 (type U, 1/4 the payload); `audio_wire="i16"` sends
    int16 PCM (type P, half the payload — pass int16 samples for a
    lossless ride onto an audio_int16 server)."""
    atype, pcm_b, a_sz = _wire_pcm(pcm, audio_wire)
    if video_wire == "u8":
        # one definition of the wire quantization (serve._to_wire_video),
        # shared with the server's V->uint8 ingest path
        vtype = b"U"
        vid = _to_wire_video(video, np.uint8).reshape(-1, 67, 67)
    else:
        vtype = b"V"
        vid = np.asarray(video, dtype="<f4").reshape(-1, 67, 67)
    with socket.create_connection(address, timeout=timeout) as s:
        s.settimeout(timeout)
        out = b""
        want = n_expected * _BYTES_PER_SAMPLE
        a_off, v_off = 0, 0
        a_step = chunk * a_sz
        while a_off < len(pcm_b) or v_off < len(vid):
            if a_off < len(pcm_b):
                s.sendall(av_frame(atype, pcm_b[a_off:a_off + a_step]))
                a_off += a_step
            if v_off < len(vid):
                part = vid[v_off:v_off + frames_per_msg]
                s.sendall(av_frame(vtype, part.tobytes()))
                v_off += len(part)
            try:
                s.settimeout(0.0)
                part = s.recv(1 << 20)
                if part:
                    out += part
            except (BlockingIOError, socket.timeout):
                pass
            finally:
                s.settimeout(timeout)
        while len(out) < want:
            part = s.recv(1 << 20)
            if not part:
                break
            out += part
    return np.frombuffer(out[:want], dtype="<f4")


def video_stream_client(address, video: np.ndarray, n_expected: int,
                        frames_per_msg: int = 16,
                        timeout: float = 30.0,
                        video_wire: str = "f32") -> np.ndarray:
    """Minimal video-only reference client: framed 67x67 lip-frame
    messages (type V, or rounded uint8 type U with video_wire="u8"),
    collect n_expected probs. One wire loop on purpose: with empty PCM,
    av_stream_client sends only V/U messages — byte-identical."""
    return av_stream_client(address, np.zeros(0, np.float32), video,
                            n_expected, frames_per_msg=frames_per_msg,
                            timeout=timeout, video_wire=video_wire)


def stream_client(address, pcm: np.ndarray, n_expected: int,
                  chunk: int = 4000, timeout: float = 30.0,
                  audio_wire: str = "f32") -> np.ndarray:
    """Minimal reference client: send pcm, collect n_expected probs.
    The raw protocol has no framing, so `audio_wire` must match the
    server's streamer config ("i16" for an audio_int16 server)."""
    with socket.create_connection(address, timeout=timeout) as s:
        s.settimeout(timeout)
        _, data, a_sz = _wire_pcm(pcm, audio_wire)
        out = b""
        want = n_expected * _BYTES_PER_SAMPLE
        for off in range(0, len(data), chunk * a_sz):
            s.sendall(data[off: off + chunk * a_sz])
            try:
                s.settimeout(0.0)
                part = s.recv(1 << 20)
                if part:
                    out += part
            except (BlockingIOError, socket.timeout):
                pass
            finally:
                s.settimeout(timeout)
        while len(out) < want:
            part = s.recv(1 << 20)
            if not part:
                break
            out += part
    return np.frombuffer(out[:want], dtype="<f4")
