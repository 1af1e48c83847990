"""Where a step of the persistent quantised LSTM kernels goes, on the card.

``lstm_bf16h_persist`` (K1c) and ``lstm_int8_persist`` (K1b) run the whole
sequence in one launch, so no profiler sees a step. This tool builds copies
of ``csrc/lstm_persistent.cu`` with one part of every step cut out and
times each beside the kernel as shipped, all in turns on the same inputs:

  full          the kernel as shipped
  no_wait       the barrier's wait cut (every CTA still arrives): the CTAs
                of a row slice no longer wait for each other
  no_product    the tensor-core product cut (loads and gate math stay)
  no_load       the exchange's loads into the ring cut
  barrier_only  everything of a step but its barrier round cut: T rounds of
                arrive and wait over the same grid, the serial floor

and copies with another geometry, which compute the same values:

  int8_16_units the int8 kernel with 16 units a CTA (the bf16 grid)
  ring_3        three ring chunks (two ahead of the mma) where there are four
  chunk_256     ring chunks of 256 bytes a row, eight of them

The cut copies compute wrong values: they time, they check nothing. Each
time is CUDA events around ``--reps`` launches after a warm-up; us/step is
that over T.

    python -m avvad_tpu_torch.tools.lstm_step_split [--b 64] [--t 512]
        [--h 1024] [--reps 5] [--rounds 2]

Needs the card and ``nvcc``; the copies are built into
``build/avvad_tpu_torch/step_split/``, one ``nvcc`` each, all started
together.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..ops import _build, lstm_fused

# copy -> [(text of csrc/lstm_persistent.cu, its replacement)]; each text
# occurs once in the source (tests/test_torch_port_quant_persist.py)
PATCHES = {
    "full": [],
    "no_wait": [("      grid_wait(my_bar, gridDim.x * (unsigned)(t + 2));", "")],
    "no_product": [("for (int ks = kg; ks < nks; ks += G::KG) {",
                    "for (int ks = kg; ks < 0; ks += G::KG) {")],
    "no_load": [("cp_async16(dst + r * ARS,", "if (T < 0) cp_async16(dst + r * ARS,")],
    "barrier_only": [("    for (int gi = 0; gi < ngroup; ++gi) {\n      const int mt",
                      "    for (int gi = 0; gi < 0; ++gi) {\n      const int mt")],
    "int8_16_units": [("constexpr int UQ_INT8 = 32;", "constexpr int UQ_INT8 = 16;")],
    "ring_3": [("constexpr int QSTAGE = 4;", "constexpr int QSTAGE = 3;")],
    "chunk_256": [("constexpr int KCB = 512;", "constexpr int KCB = 256;"),
                  ("constexpr int QSTAGE = 4;", "constexpr int QSTAGE = 8;")],
}
ENTRIES = ("lstm_bf16h_persist", "lstm_int8_persist")


def patched_source(cut: str) -> str:
    src = (_build.CSRC / "lstm_persistent.cu").read_text()
    for old, new in PATCHES[cut]:
        if src.count(old) != 1:
            raise RuntimeError(f"{cut}: the text to cut is not in the source once: {old!r}")
        src = src.replace(old, new)
    return src


def build_cuts(cuts) -> dict:
    """One shared library per cut -> {cut: CDLL with the two entries bound}."""
    out = _build.BUILD_DIR / "step_split"
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for cut in cuts:
        path = out / f"{cut}.cu"
        path.write_text(patched_source(cut))
        procs[cut] = subprocess.Popen([nvcc, *_build.ARCH, "-shared", "-o",
                                       str(out / f"{cut}.so"), str(path)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for cut, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {cut} copy:\n{err}")
        lib = ctypes.CDLL(str(out / f"{cut}.so"))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
        libs[cut] = lib
    return libs


def layer_call(lib, variant: str, b: int, t: int, h: int, seed: int = 0):
    """A closure that runs one layer of ``variant`` through ``lib`` on
    seeded inputs on the card (the wrapper's arguments, made once)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    xp = torch.randn(b, t, 4 * h, generator=g).to(dev)
    w = (torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(dev)
    h0, c = torch.zeros(b, h, device=dev), torch.zeros(b, h, device=dev)
    y = torch.empty(b, t, h, device=dev)
    hx = torch.zeros(2, b, lstm_fused.quant_row_bytes(h, variant), dtype=torch.uint8,
                     device=dev)
    bar = lstm_fused._barrier(dev, b)
    if variant == "int8_persist":
        wq, ws = lstm_fused._quant_weights(w)
        weights = [wq.contiguous(), ws]
    else:
        weights = [w.to(torch.bfloat16).contiguous()]
    fn = getattr(lib, lstm_fused.KERNEL_NAMES[variant])

    def call():  # holds the inputs alive
        hx.zero_()
        bar.zero_()
        rc = fn(xp.data_ptr(), *(a.data_ptr() for a in weights), h0.data_ptr(), c.data_ptr(),
                y.data_ptr(), hx.data_ptr(), bar.data_ptr(), b, t, h,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{variant}: cudaError {rc}")
    return call


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(b: int = 64, t: int = 512, h: int = 1024, reps: int = 5, rounds: int = 2,
        out=print) -> dict:
    """Time every cut of both kernels, ``rounds`` times in turns (the order
    reversed every other round) -> {variant: {cut: best ms}}, and one line
    each through ``out``."""
    if not torch.cuda.is_available():
        raise SystemExit("lstm_step_split: no CUDA device")
    libs = build_cuts(PATCHES)
    calls = {v: {cut: layer_call(lib, v, b, t, h) for cut, lib in libs.items()}
             for v in lstm_fused.QUANT_ELEMENT_BYTES}
    times = {v: {cut: [] for cut in libs} for v in calls}
    for rnd in range(rounds):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for cut in order:
            for v in calls:
                times[v][cut].append(cuda_ms(calls[v][cut], reps))
    res = {v: {cut: min(ms) for cut, ms in by_cut.items()} for v, by_cut in times.items()}
    for v, by_cut in res.items():
        full = by_cut["full"]
        for cut, ms in by_cut.items():
            out(f"{lstm_fused.KERNEL_NAMES[v]} B={b} T={t} H={h} {cut:12s} {ms:8.3f} ms "
                f"{1e3 * ms / t:6.2f} us/step ({ms / full:.3f} of full; reps "
                f"{[round(x, 3) for x in times[v][cut]]})")
    out(json.dumps({"step_split": res, "b": b, "t": t, "h": h,
                    "card": torch.cuda.get_device_name(0)}))
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    return run(args.b, args.t, args.h, args.reps, args.rounds)


if __name__ == "__main__":
    main()
