"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

``nvcc`` compiles every ``avvad_tpu_torch/csrc/*.cu`` for sm_90a, one
process per source, all started together, and links the objects into one
library, ``build/avvad_tpu_torch/libavvad_kernels.so``, at first use, from
the repository's own sources (each build counted as ``build.nvcc``). The
library exposes ``extern "C"`` functions that take raw device pointers and
the stream, so the build needs no PyTorch headers and takes seconds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils import profiling

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "avvad_tpu_torch"
LIB_PATH = BUILD_DIR / "libavvad_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "lstm_f32h": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lstm_bf16h": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "lstm_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # xp, w, h0, c, y, c_seq, gates, B, T, H, stream
    "lstm_fwd_train_f32h": [_P] * 7 + [_I] * 3 + [_P],
    # dy, gates, c_seq, c_prev, w^T, d_gates, dh0, dc, B, T, H, stream
    "lstm_bwd_f32h": [_P] * 8 + [_I] * 3 + [_P],
    # the two above as one cooperative launch a layer: the same arguments
    # with the grid barrier's zeroed 32-bit counter before B
    "lstm_fwd_train_persist": [_P] * 8 + [_I] * 3 + [_P],
    "lstm_bwd_persist": [_P] * 9 + [_I] * 3 + [_P],
    # lstm_f32h as one cooperative launch a layer: xp, w, h0, c, y, the
    # barrier's counters, B, T, H, stream
    "lstm_f32h_persist": [_P] * 6 + [_I] * 3 + [_P],
    # lstm_bf16h / lstm_int8 as one cooperative launch a layer: xp, w (bf16),
    # or wq (row-major int8) and ws, h0, c, y, the exchange of the rounded h,
    # the barrier's counters, B, T, H, stream
    "lstm_bf16h_persist": [_P] * 7 + [_I] * 3 + [_P],
    "lstm_int8_persist": [_P] * 8 + [_I] * 3 + [_P],
    # xp, w, h0, c, y, scratch (B, 4H), B, T, H, mode, stream
    "lstm_probe": [_P] * 6 + [_I] * 4 + [_P],
    # the same on the persistent frame, with the exchange and the barriers'
    # counters after scratch
    "lstm_probe_persist": [_P] * 8 + [_I] * 4 + [_P],
    # x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, out,
    # N, H, W, Cin, Cout, stride, frames per block, ring slots, shared
    # memory bytes (the three from conv_fused.block_plan), stream
    "int8_basic_block": [_P] * 12 + [_I] * 9 + [_P],
    # x, a, b, out, N, C, strides (N, C, H, W) in elements, is_bf16, stream
    "stem_epilogue_pool": [_P] * 4 + [_I] * 7 + [_P],
    # x (channels-last), a, b, out, N, C, channels of a unit, ring slots
    # (the two from stem_fused.nhwc_plan), is_bf16, stream
    "stem_epilogue_pool_nhwc": [_P] * 4 + [_I] * 5 + [_P],
}

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(force: bool = False) -> dict:
    """Compile the library if missing or older than its newest source.
    -> {"path", "seconds", "ptxas"} (ptxas: the -Xptxas -v lines, empty
    when nothing was rebuilt)."""
    srcs = sorted(CSRC.glob("*.cu"))
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)):
        return {"path": str(LIB_PATH), "seconds": 0.0, "ptxas": []}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    profiling.count("build.nvcc")
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *ARCH, "-Xptxas", "-v", "-c", "-o", str(o),
                               str(s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    ptxas = []
    for s, p in zip(srcs, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {s.name} ({p.returncode}):\n{err}")
        ptxas += [f"{s.name}: {ln}" for ln in err.splitlines() if "ptxas" in ln]
    tmp = LIB_PATH.with_suffix(f".{tag}.tmp.so")
    proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    return {"path": str(LIB_PATH), "seconds": time.perf_counter() - t0,
            "ptxas": ptxas}


def kernel_lib() -> ctypes.CDLL:
    """The bound library, built on first use (the ``setup.kernels`` span)."""
    global _lib
    if _lib is None:
        with profiling.setup_span("setup.kernels"):
            build()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _lib = lib
    return _lib
