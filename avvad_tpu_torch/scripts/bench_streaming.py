"""Streaming-serving timers of the port: multi-stream server ticks
(counterpart of scripts/bench_streaming.py).

Times a tick of N concurrent real-time streams, each pushing one block of
16 kHz PCM (``--block-frames`` STFT frames, 256 ms at 16) a tick, through
``serve.MultiStreamVAD`` (AudioVAD fp32, 2 x LSTM 1024), in three modes:

- sync:      ``tick(fetch=True)``, every tick returns numpy probabilities;
- pipelined: ``tick_pipelined()``, tick N-1's results fetched while tick N
             runs (one block of extra latency);
- lazy:      ``tick(fetch=False)``, results left on the device.

With ``--av`` (and ``--av-int8``, ``--av-u8``, ``--av-pallas``,
``--av-mcb-hoist``, ``--av-video-fps``) also ``serve.MultiStreamAVVAD``
ticks (AVVAD fp32, MCB 1024), sync and pipelined; the int8 tower is the
calibrated static-int8 one on the fused kernels (the stem epilogue kernel
once, the int8 BasicBlock kernel 8 times a tick), which ``--av-pallas``
names too. The wires: ``--audio-span`` (the raw sample span), ``--hop-dft``
(the hop-block DFT frontend on it), ``--audio-int16`` (int16 PCM on it).
Before the ticks: the host's block assembly alone, the C++ hub against its
numpy route; after them the dispatch floor, the tick's upload through a
trivial reduction fetched each tick.

Each line is printed as in the JAX script, followed by a json record
(``metric``, ``value``, ``unit`` and the line's facts).

    python -m avvad_tpu_torch.scripts.bench_streaming [--streams 32] [--ticks 40]
        [--av --av-int8 --av-u8 --audio-int16 ...] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` (the plain versions; the
numbers measure nothing there).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ._common import add_device_flag, device_of

HOP, NFFT, FS = 256, 1024, 16000
REPS_ASSEMBLY = 50


def make_server(n_streams: int, block_frames: int, native: bool, span_wire: bool = False,
                hop_dft: bool = False, audio_int16: bool = False,
                device: Optional[torch.device] = None, state_dict: Optional[dict] = None,
                lstm_hidden: int = 1024):
    """The audio server of bench_streaming.py:38-48: AudioVAD fp32, 2 x LSTM
    (``lstm_hidden``), with the given wire; ``state_dict`` where given."""
    from ..models import AudioVAD
    from ..serve import MultiStreamVAD

    model = AudioVAD(y_dim=1, lstm_hidden_size=lstm_hidden, lstm_layers=2,
                     use_kernel_lstm=True)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return MultiStreamVAD(model, n_streams, block_frames=block_frames, native=native,
                          span_wire=span_wire, hop_dft=hop_dft, audio_int16=audio_int16,
                          device=device)


def _fetch(out) -> None:
    """The barrier: a value fetch of a tick's first result."""
    v = next(iter(out.values())) if isinstance(out, dict) else out
    np.asarray(v.cpu() if torch.is_tensor(v) else v)


def run(server, n_ticks: int, chunk: np.ndarray, mode) -> float:
    """Feed every stream one block a tick -> seconds a tick (bench_streaming
    .py:51-78). ``mode``: True sync, False lazy, "pipelined"."""
    n = server.n
    for i in range(n):  # warm-up: the first block also needs nfft - hop samples
        server.feed(i, chunk)
        server.feed(i, chunk)
    out = server.tick(fetch=True)
    assert len(out) == n
    t0 = time.perf_counter()
    last = None
    for _ in range(n_ticks):
        for i in range(n):
            server.feed(i, chunk)
        if mode == "pipelined":
            last = server.tick_pipelined()
        else:
            last = server.tick(fetch=mode)
    if mode == "pipelined":
        last = server.flush_pipelined()
    _fetch(last)
    return (time.perf_counter() - t0) / n_ticks


def make_av_server(n_streams: int, block_frames: int, int8: bool = False,
                   u8_wire: bool = False, pallas_tower: bool = False,
                   mcb_hoist: bool = False, span_wire: bool = False, hop_dft: bool = False,
                   video_fps: float = 0.0, audio_int16: bool = False,
                   device: Optional[torch.device] = None,
                   state_dict: Optional[dict] = None, lstm_hidden: int = 1024,
                   mcb_output_size: int = 1024):
    """The AV server of bench_streaming.py:81-120: AVVAD fp32, MCB, 2 x LSTM;
    with ``int8`` (or ``pallas_tower``) the static-int8 tower on the fused
    kernels, its scales calibrated on one block of normal audio features and
    uniform [0, 255) frames from ``default_rng(0)``; ``mcb_hoist``: the
    sketches pre-folded."""
    from .._device import resolve_device
    from ..models import AVVAD, calibrate
    from ..serve import MultiStreamAVVAD
    from ._common import hoist_mcb

    int8 = int8 or pallas_tower

    def make(**kw):
        return AVVAD(y_dim=1, lstm_hidden_size=lstm_hidden, lstm_layers=2, use_mcb=True,
                     mcb_output_size=mcb_output_size, use_kernel_lstm=True,
                     tower_int8=int8, tower_quant_mode="static" if int8 else "dynamic",
                     tower_pallas=int8, **kw)

    dev = resolve_device(device)
    model = make()
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.to(dev)
    if int8:
        rng = np.random.default_rng(0)
        cal_a = rng.normal(size=(1, block_frames, 513)).astype(np.float32)
        cal_v = rng.uniform(0, 255, size=(1, block_frames, 67, 67)).astype(np.float32)
        calibrate(model, [(torch.from_numpy(cal_a).to(dev), torch.from_numpy(cal_v).to(dev))])
    if mcb_hoist:
        model = hoist_mcb(model, make)
    return MultiStreamAVVAD(model, n_streams, block_frames=block_frames,
                            video_uint8=u8_wire, span_wire=span_wire, hop_dft=hop_dft,
                            video_fps=video_fps or None, audio_int16=audio_int16,
                            device=dev)


def run_av(server, n_ticks: int, chunk: np.ndarray, vchunk: np.ndarray,
           video_fps: float = 0.0, mode=True) -> float:
    """bench_streaming.py:123-160: every stream one block of audio and its
    video a tick (camera-rate frames paced so each stream stays one block
    ahead) -> seconds a tick."""
    n = server.n
    bf = server.block_frames
    ratio = (video_fps or 62.5) / 62.5
    fed = [0]

    def vfeed(total_blocks):
        want = int(np.ceil(total_blocks * bf * ratio)) + 2
        k, fed[0] = want - fed[0], want
        return k

    vstock = np.concatenate([vchunk, vchunk])
    k0 = vfeed(2)
    for i in range(n):
        server.feed(i, pcm=np.concatenate([chunk, chunk]), video_frames=vstock[:k0])
    out = server.tick(fetch=True)
    assert len(out) == n
    t0 = time.perf_counter()
    last = None
    for t in range(n_ticks):
        vf = vstock[:vfeed(3 + t)]
        for i in range(n):
            server.feed(i, pcm=chunk, video_frames=vf)
        if mode == "pipelined":
            last = server.tick_pipelined()
        else:
            last = server.tick(fetch=mode)
    if mode == "pipelined":
        last = server.flush_pipelined()
    _fetch(last)
    return (time.perf_counter() - t0) / n_ticks


def stream_chunks(block_frames: int, seed: int = 0) -> tuple:
    """(float chunk, its int16 grid, the AV lip frames): one block a stream,
    drawn as bench_streaming.py:205-211 and :241-242 draw them."""
    from ..server import quantize_pcm_int16

    rng = np.random.default_rng(seed)
    chunk = rng.normal(size=block_frames * HOP).astype(np.float32) * 0.1
    vchunk = rng.uniform(0, 255, size=(block_frames, 67, 67)).astype(np.float32)
    return chunk, quantize_pcm_int16(chunk), vchunk


def _emit(records: list, line: str, **rec) -> None:
    print(line, flush=True)
    records.append(rec)
    print(json.dumps(rec), flush=True)


def tick_record(records: list, kind: str, mode: str, tag: str, dt: float, streams: int,
                block_sec: float) -> None:
    agg, budget = streams * block_sec / dt, block_sec / dt
    label = f"AV {mode}{tag}" if kind == "av" else f"{mode}{tag}"
    _emit(records, f"tick ({label}): {dt * 1e3:6.1f} ms | {streams} streams x "
          f"{block_sec * 1e3:.0f} ms blocks -> {agg:6.1f}x aggregate real time | "
          f"latency budget headroom {budget:4.1f}x",
          metric="tick_ms", server=kind, mode=mode, wire=tag.strip(), value=dt * 1e3,
          unit="ms", x_realtime=agg, streams=streams)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--block-frames", type=int, default=16)
    ap.add_argument("--av", action="store_true", help="also time MultiStreamAVVAD ticks")
    ap.add_argument("--av-int8", action="store_true",
                    help="AV tick with the calibrated static-int8 tower")
    ap.add_argument("--av-u8", action="store_true", help="AV tick with the uint8 video wire")
    ap.add_argument("--av-pallas", action="store_true",
                    help="AV tick with the fused int8 kernels (implies --av-int8; the "
                         "int8 tower's route here in any case)")
    ap.add_argument("--av-mcb-hoist", action="store_true",
                    help="AV tick with pre-folded MCB sketches")
    ap.add_argument("--audio-span", action="store_true", help="span audio wire")
    ap.add_argument("--hop-dft", action="store_true",
                    help="hop-block DFT frontend on the span (implies --audio-span)")
    ap.add_argument("--audio-int16", action="store_true",
                    help="int16 PCM span wire (implies --audio-span)")
    ap.add_argument("--av-video-fps", type=float, default=0.0,
                    help="camera-rate AV video wire, e.g. 30 (implies --av)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.av_video_fps:
        args.av = True
    if args.hop_dft or args.audio_int16:
        args.audio_span = True
    if args.av_pallas:
        args.av_int8 = True
    if args.av_int8 or args.av_u8:
        args.av = True
    return args


def main(argv=None, on_server=None) -> list:
    """-> the records. ``on_server(kind, server)``, if given, is called
    with each timed server ("audio", "av") after its ticks."""
    args = parse(argv)
    device = device_of(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    block_sec = args.block_frames * HOP / FS
    chunk, chunk_i, vchunk = stream_chunks(args.block_frames)
    wire_chunk = chunk_i if args.audio_int16 else chunk
    records: list = []

    # host-side assembly alone: the C++ hub against its numpy route
    for native in (True, False):
        srv = make_server(args.streams, args.block_frames, native=native, device=device)
        kind = "native" if srv._hub.is_native else "python"
        for i in range(args.streams):
            srv.feed(i, np.concatenate([chunk, chunk]))
        t0 = time.perf_counter()
        for _ in range(REPS_ASSEMBLY):
            for i in range(args.streams):
                srv.feed(i, chunk)
            srv._hub.assemble()
        dt = (time.perf_counter() - t0) / REPS_ASSEMBLY
        _emit(records, f"host assembly ({kind:6s}): {dt * 1e3:7.2f} ms/tick",
              metric="host_assembly_ms", hub=kind, value=dt * 1e3, unit="ms")
        del srv

    srv = make_server(args.streams, args.block_frames, native=True,
                      span_wire=args.audio_span, hop_dft=args.hop_dft,
                      audio_int16=args.audio_int16, device=device)
    wire = "".join([" span" if args.audio_span else "", " hop-dft" if args.hop_dft else "",
                    " i16" if args.audio_int16 else ""])
    for mode, fetch in (("sync", True), ("pipelined", "pipelined"), ("lazy", False)):
        srv.reset()
        tick_record(records, "audio", mode, wire, run(srv, args.ticks, wire_chunk, fetch),
                    args.streams, block_sec)
    if on_server is not None:
        on_server("audio", srv)
    del srv

    if args.av:
        av = make_av_server(args.streams, args.block_frames, int8=args.av_int8,
                            u8_wire=args.av_u8, pallas_tower=args.av_pallas,
                            mcb_hoist=args.av_mcb_hoist, span_wire=args.audio_span,
                            hop_dft=args.hop_dft, video_fps=args.av_video_fps,
                            audio_int16=args.audio_int16, device=device)
        tag = "".join([" int8" if args.av_int8 else "", " pallas" if args.av_pallas else "",
                       " u8" if args.av_u8 else "",
                       " mcb-hoist" if args.av_mcb_hoist else "", wire,
                       f" cam{args.av_video_fps:g}" if args.av_video_fps else ""]) or " f32"
        for mode, fetch in (("sync", True), ("pipelined", "pipelined")):
            av.reset()
            dt = run_av(av, args.ticks, wire_chunk, vchunk, video_fps=args.av_video_fps,
                        mode=fetch)
            tick_record(records, "av", mode, tag, dt, args.streams, block_sec)
        if on_server is not None:
            on_server("av", av)
        del av

    # dispatch floor: the tick's upload through a trivial reduction, fetched
    # each tick
    blocks = np.zeros((args.streams, args.block_frames, NFFT), np.float32)

    def trivial():
        return torch.as_tensor(blocks, device=device).sum(dim=(1, 2)).cpu().numpy()

    trivial()
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        trivial()
    floor = (time.perf_counter() - t0) / args.ticks
    _emit(records, f"dispatch+transfer floor (same input shape, trivial op): "
          f"{floor * 1e3:6.1f} ms/tick", metric="dispatch_floor_ms", value=floor * 1e3,
          unit="ms")
    return records


if __name__ == "__main__":
    main()
