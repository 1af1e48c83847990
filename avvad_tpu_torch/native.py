"""Host-side C++ core for the streaming servers and WAV reading (port of
avvad_tpu/native/__init__.py): ``build``, ``load``, ``available``,
``wav_info``, ``read_wav``, ``frame_energy_vad``, ``lzf_decompress`` (the
HDF5 reader's LZF chunks), ``zstd_decompress`` and ``crc32c`` (the Orbax
checkpoint reader's zstd frames and OCDBT checksums) and ``StreamHub``.

``csrc/avvad_io.cpp`` is the port's own copy of the JAX package's
``native/avvad_io.cpp``, plus an LZF decoder (``lzf_decompress``) for the
port's HDF5 reader and a zstd decoder (RFC 8878, with the XXH64 content
checksum) and CRC-32C for its Orbax checkpoints (``orbax_io.py``): no
zstd package or system ``libzstd`` is used, here or on the card. It is built at first use with ``g++`` and the
flags of ``native/Makefile`` into ``build/avvad_tpu_torch/libavvad_io.so``,
rebuilt when the source is newer, and bound with ``ctypes``. Nothing is
built at import time.

Unlike the JAX bindings, nothing falls back quietly: where the library
cannot be built or loaded, ``load()`` raises with the compiler's output,
and a ``StreamHub`` takes its numpy route only when asked
(``force_python=True``, the servers' ``native=False``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "avvad_io.cpp"
LIB_PATH = _PKG.parent / "build" / "avvad_tpu_torch" / "libavvad_io.so"
# native/Makefile's flags, so that both packages' hubs are the same program
CXXFLAGS = ["-O3", "-march=native", "-ffast-math", "-fPIC", "-std=c++17", "-shared"]

_F = ctypes.POINTER(ctypes.c_float)
_I16 = ctypes.POINTER(ctypes.c_int16)
_H, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# C entry point -> (restype, argtypes)
SIGNATURES = {
    "wav_info": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_I32),
                                ctypes.POINTER(_I32), ctypes.POINTER(_I64)]),
    "wav_read_f32": (_I64, [ctypes.c_char_p, _F, _I64, ctypes.POINTER(_I32)]),
    "peak_normalize": (None, [_F, _I64]),
    "frame_energy_vad": (_I64, [_F, _I64, _I32, _I32, _I32, ctypes.c_double,
                                _F, _I64]),
    "lzf_decompress": (_I64, [ctypes.c_char_p, _I64, ctypes.c_void_p, _I64]),
    "zstd_decompress": (_I64, [ctypes.c_char_p, _I64, ctypes.c_void_p, _I64]),
    "zstd_bound": (_I64, [ctypes.c_char_p, _I64]),
    "zstd_error_name": (ctypes.c_char_p, [_I64]),
    "crc32c": (ctypes.c_uint32, [ctypes.c_char_p, _I64, ctypes.c_uint32]),
    "hub_create": (_H, [_I32] * 4),
    "hub_create_i16": (_H, [_I32] * 4),
    "hub_destroy": (None, [_H]),
    "hub_reset": (None, [_H]),
    "hub_reset_stream": (_I32, [_H, _I32]),
    "hub_feed": (_I64, [_H, _I32, _F, _I64]),
    "hub_feed_i16": (_I64, [_H, _I32, _I16, _I64]),
    "hub_frames_ready": (_I64, [_H, _I32]),
    "hub_assemble": (_I32, [_H, _F, _F, _F]),
    "hub_assemble_gated": (_I32, [_H, _F, _F, _F, _F]),
    "hub_assemble_span_gated": (_I32, [_H, _F, _F, _F, _F]),
    "hub_assemble_span_gated_i16": (_I32, [_H, _F, _I16, _F, _F]),
}

_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the host library is built with the "
                           "system C++ compiler")
    return cxx


def build(force: bool = False) -> dict:
    """Compile the library if missing or older than its source ->
    {"path", "seconds"} (seconds 0.0 when nothing was rebuilt). Atomic: the
    compiler writes a file of its own that replaces the library in one
    step, so concurrent builds and loads see the old or the new library."""
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime):
        return {"path": str(LIB_PATH), "seconds": 0.0}
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp.so", dir=LIB_PATH.parent)
    os.close(fd)
    tmp = Path(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run([_cxx(), *CXXFLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return {"path": str(LIB_PATH), "seconds": time.perf_counter() - t0}


def load() -> ctypes.CDLL:
    """The bound library, built on first use; raises if it cannot be built
    or loaded."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (a probe: it raises
    nothing)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def wav_info(path: str) -> tuple[int, int, int]:
    """-> (sample_rate, channels, samples per channel)."""
    sr, ch, n = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = load().wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                         ctypes.byref(n))
    if rc != 0:
        raise IOError(f"wav_info({path}) failed: rc={rc}")
    return int(sr.value), int(ch.value), int(n.value)


def read_wav(path: str, normalize: bool = False) -> tuple[np.ndarray, int]:
    """C++ WAV decode -> (float32 channel-0 signal, sample_rate), scaled as
    ``processing.audio_io.read_wav``; ``normalize``: divided by its peak."""
    lib = load()
    _, _, n = wav_info(path)
    out = np.empty(n, dtype=np.float32)
    sr = ctypes.c_int32()
    rc = lib.wav_read_f32(path.encode(), out.ctypes.data_as(_F), n, ctypes.byref(sr))
    if rc < 0:
        raise IOError(f"wav_read_f32({path}) failed: rc={rc}")
    if normalize:
        lib.peak_normalize(out.ctypes.data_as(_F), n)
    return out, int(sr.value)


def frame_energy_vad(x: np.ndarray, nfft: int, hop: int, pad_end: int,
                     threshold_log10: float = 1.70) -> np.ndarray:
    """Frame-energy VAD (``processing.targets.clean_speech_VAD``'s rule);
    x float32 -> (n_frames,) float32 of 0 / 1."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    max_frames = 1 + (len(x) + pad_end) // hop
    out = np.empty(max_frames, dtype=np.float32)
    n = lib.frame_energy_vad(x.ctypes.data_as(_F), len(x), nfft, hop, pad_end,
                             threshold_log10, out.ctypes.data_as(_F), max_frames)
    if n < 0:
        raise ValueError(f"frame_energy_vad failed: rc={n}")
    return out[:n]


def lzf_decompress(data: bytes, out_len: int) -> bytes:
    """LZF-compressed ``data`` -> exactly ``out_len`` bytes (the HDF5 LZF
    filter's chunks: ``hdf5.lzf_decompress_py`` is the plain twin)."""
    out = ctypes.create_string_buffer(out_len)
    n = load().lzf_decompress(bytes(data), len(data), out, out_len)
    if n != out_len:
        raise ValueError(f"LZF chunk: decoded {n} bytes, expected {out_len} "
                         "(-1: corrupt input, -2: output longer than expected)")
    return out.raw


class ZstdError(ValueError):
    """A zstd input that is malformed, truncated, fails its checksum or
    needs what the decoder does not cover (a dictionary)."""


# the first four bytes of a zstd frame
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def zstd_decompress(data: bytes) -> np.ndarray:
    """Every zstd frame in ``data`` (RFC 8878; skippable frames skipped) ->
    the decoded bytes as a uint8 array. Raises ``ZstdError`` on anything
    malformed; the decoder reads nothing outside ``data``."""
    lib = load()
    data = bytes(data)
    cap = lib.zstd_bound(data, len(data))
    if cap < 0:
        raise ZstdError(f"zstd: {lib.zstd_error_name(cap).decode()}")
    out = np.empty(max(cap, 1), np.uint8)
    n = lib.zstd_decompress(data, len(data), out.ctypes.data, cap)
    if n < 0:
        raise ZstdError(f"zstd: {lib.zstd_error_name(n).decode()}")
    return out[:n]


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return int(load().crc32c(data, len(data), crc))


class StreamHub:
    """Per-stream sample buffers and one-call block assembly.

    Per tick, ``assemble()`` writes every ready stream's next frame block
    into one preallocated array: (n_streams, block_frames, nfft)
    materialised windows, or with ``span=True`` the (n_streams, span)
    contiguous samples the windows are cut from. By default the buffers
    live in the C++ library (one call a tick, no per-stream Python);
    ``force_python=True`` takes the numpy route, which gives the same
    arrays bit for bit.

    dtype: float32, or int16 for raw 16-bit PCM buffered and
    span-assembled as int16 (half the host-to-device payload; peaks then
    hold max |sample| in the int16 domain). int16 supports the span wire
    only."""

    def __init__(self, n_streams: int, nfft: int, hop: int, block_frames: int,
                 force_python: bool = False, dtype=np.float32):
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
        self._lib = None if force_python else load()
        if self._lib is not None:
            create = self._lib.hub_create_i16 if self._i16 else self._lib.hub_create
            self._h = create(n_streams, nfft, hop, block_frames)
            if not self._h:
                raise RuntimeError("hub_create failed")
        else:
            self._frame_idx = (np.arange(block_frames)[:, None] * hop
                               + np.arange(nfft)[None, :])
            self.reset()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.hub_destroy(self._h)
            self._h = None

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def reset(self) -> None:
        if self._lib is not None:
            self._lib.hub_reset(self._h)
            return
        self._bufs = [np.zeros(0, self.dtype) for _ in range(self.n)]
        self._run_peaks = np.zeros(self.n, np.float32)

    def reset_stream(self, stream: int) -> None:
        """Clear one stream's buffer and peak (connection recycling)."""
        if self._lib is not None:
            rc = self._lib.hub_reset_stream(self._h, stream)
            if rc < 0:
                raise ValueError(f"hub_reset_stream failed: rc={rc}")
            return
        self._bufs[stream] = np.zeros(0, self.dtype)
        self._run_peaks[stream] = 0.0

    def frames_ready(self, stream: int) -> int:
        if self._lib is not None:
            return int(self._lib.hub_frames_ready(self._h, stream))
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
        if self._lib is not None:
            if self._i16:
                rc = self._lib.hub_feed_i16(self._h, stream,
                                            pcm.ctypes.data_as(_I16), len(pcm))
            else:
                rc = self._lib.hub_feed(self._h, stream, pcm.ctypes.data_as(_F),
                                        len(pcm))
            if rc < 0:
                raise ValueError(f"hub_feed failed: rc={rc}")
            return int(rc)
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
        if self._lib is not None:
            if self._i16:
                fn, out_p = self._lib.hub_assemble_span_gated_i16, out.ctypes.data_as(_I16)
            else:
                fn = (self._lib.hub_assemble_span_gated if span
                      else self._lib.hub_assemble_gated)
                out_p = out.ctypes.data_as(_F)
            if gate is not None:
                gate = np.ascontiguousarray(gate, dtype=np.float32)
            gate_p = ctypes.cast(None, _F) if gate is None else gate.ctypes.data_as(_F)
            n_active = fn(self._h, gate_p, out_p, self._peaks.ctypes.data_as(_F),
                          self._active.ctypes.data_as(_F))
            if n_active < 0:
                raise ValueError(f"hub assemble failed: rc={n_active}")
            return out, self._peaks, self._active, int(n_active)
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
