"""Build and bind the port's CUDA kernels (plain C interface + ctypes).

``nvcc`` compiles ``avvad_tpu_torch/csrc/lstm_recurrence.cu`` for sm_90a
into ``build/avvad_tpu_torch/liblstm.so`` at first use, from the
repository's own sources. The library exposes ``extern "C"`` functions that
take raw device pointers and the stream, so the build needs no PyTorch
headers and takes seconds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "lstm_recurrence.cu"
BUILD_DIR = _PKG.parent / "build" / "avvad_tpu_torch"
LIB_PATH = BUILD_DIR / "liblstm.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build(force: bool = False) -> dict:
    """Compile liblstm.so if missing or older than its source.
    -> {"path", "seconds", "ptxas"} (ptxas: the -Xptxas -v lines, empty
    when nothing was rebuilt)."""
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime):
        return {"path": str(LIB_PATH), "seconds": 0.0, "ptxas": []}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    ptxas = [ln for ln in proc.stderr.splitlines() if "ptxas" in ln]
    return {"path": str(LIB_PATH), "seconds": seconds, "ptxas": ptxas}


def lstm_lib() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("lstm_f32h", "lstm_bf16h"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, p, i, i, i, p]
            fn.restype = i
        lib.lstm_int8.argtypes = [p, p, p, p, p, p, i, i, i, p]
        lib.lstm_int8.restype = i
        _lib = lib
    return _lib
