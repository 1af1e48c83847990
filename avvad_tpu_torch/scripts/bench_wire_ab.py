"""Interleaved A/B of the streaming audio wires in one process (counterpart
of scripts/bench_wire_ab.py).

The float32 span wire against the int16 PCM span wire: both servers are
built and warmed first, then their timed rounds alternate (min of
``--rounds`` rounds an arm), so drift of the host and the card falls on both
arms alike. With ``--av`` the arms are AV ticks (the uint8 video wire, the
static-int8 tower on the fused kernels, 30 fps camera frames) instead of
audio-only ones. The servers and the timing are the
``bench_streaming`` twin's.

Each line is printed as in the JAX script; then one json record an arm
(``metric`` "wire_ab_ms_per_tick") and one for the pair ("wire_ab", its
``value`` the f32 arm's ms over the i16 arm's).

    python -m avvad_tpu_torch.scripts.bench_wire_ab [--streams 32] [--av] [--rounds 3]
        [--device cpu]

Runs on the CUDA card unless ``--device cpu`` (the plain versions; the
numbers measure nothing there).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ._common import add_device_flag, device_of
from .bench_streaming import HOP, FS, make_av_server, make_server, run, run_av, stream_chunks


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--block-frames", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=12, help="ticks per timed round")
    ap.add_argument("--rounds", type=int, default=3,
                    help="alternating rounds per arm (min is reported)")
    ap.add_argument("--av", action="store_true",
                    help="A/B the AV tick (uint8 + int8 tower, 30 fps camera video)")
    ap.add_argument("--hop-dft", action="store_true", default=True)
    ap.add_argument("--no-hop-dft", dest="hop_dft", action="store_false")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    block_sec = args.block_frames * HOP / FS
    chunk, chunk_i, vchunk = stream_chunks(args.block_frames)

    arms = {}
    for name, i16 in (("f32", False), ("i16", True)):
        c = chunk_i if i16 else chunk
        if args.av:
            srv = make_av_server(args.streams, args.block_frames, int8=True, u8_wire=True,
                                 span_wire=True, hop_dft=args.hop_dft, video_fps=30.0,
                                 audio_int16=i16, device=device)
            arms[name] = (srv, lambda s=srv, c=c: run_av(s, args.ticks, c, vchunk,
                                                         video_fps=30.0))
        else:
            srv = make_server(args.streams, args.block_frames, native=True, span_wire=True,
                              hop_dft=args.hop_dft, audio_int16=i16, device=device)
            arms[name] = (srv, lambda s=srv, c=c: run(s, args.ticks, c, True))

    for name, (_, timed) in arms.items():  # warm both arms before any timed round
        t0 = time.perf_counter()
        timed()
        print(f"warm {name}: {time.perf_counter() - t0:.1f} s", flush=True)

    best = {name: float("inf") for name in arms}
    rounds = {name: [] for name in arms}
    for r in range(args.rounds):
        for name, (srv, timed) in arms.items():
            srv.reset()
            dt = timed()
            best[name] = min(best[name], dt)
            rounds[name].append(dt * 1e3)
            print(f"round {r} {name}: {dt * 1e3:6.1f} ms/tick", flush=True)

    kind = "AV" if args.av else "audio"
    records = []
    for name, dt in best.items():
        agg = args.streams * block_sec / dt
        print(f"BEST {kind} {name}: {dt * 1e3:6.1f} ms/tick | {agg:6.1f}x aggregate rt")
        records.append({"metric": "wire_ab_ms_per_tick", "kind": kind, "arm": name,
                        "value": dt * 1e3, "unit": "ms", "x_realtime": agg,
                        "rounds_ms": rounds[name], "streams": args.streams})
    f32, i16 = best["f32"], best["i16"]
    print(f"int16 wire delta: {(f32 - i16) * 1e3:+.1f} ms/tick "
          f"({(f32 / i16 - 1) * 100:+.1f}% throughput)")
    records.append({"metric": "wire_ab", "kind": kind, "value": f32 / i16,
                    "unit": "f32 ms over i16 ms", "delta_ms": (f32 - i16) * 1e3})
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
