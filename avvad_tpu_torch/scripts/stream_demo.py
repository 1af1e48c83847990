"""Streaming VAD demo: feed a WAV file through the stateful streaming
classifier in real-time-sized chunks and print detected speech segments
(port of scripts/stream_demo.py).

A serving capability beyond the reference (which only wrote per-utterance
prediction files offline). The LSTM carries its state across blocks and
runs as a plain loop, as in the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np

from ._common import add_device_flag, build_model, device_of, restore


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("wav", help="input wav file (16 kHz)")
    p.add_argument("--video", default=None,
                   help="upsampled lip-video h5 (X, (67,67,T) @62.5fps) for "
                        "audio-visual streaming")
    p.add_argument("--checkpoint", default=None,
                   help="port checkpoint (the model's seeded init if omitted)")
    p.add_argument("--mcb", action="store_true",
                   help="AV model uses MCB fusion (default concat)")
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--chunk-ms", type=float, default=100.0)
    p.add_argument("--block-frames", type=int, default=16)
    p.add_argument("--threshold", type=float, default=0.5)
    add_device_flag(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..processing import read_wav
    from ..serve import StreamingAVVAD, StreamingVAD

    device = device_of(args)
    x, fs = read_wav(args.wav)
    print(f"{args.wav}: {len(x)/fs:.2f}s @ {fs} Hz")

    if args.video:
        from ..data.records import load_video

        frames = load_video(args.video)
        print(f"{args.video}: {len(frames)} lip frames")
        model = build_model("av", 1, args.lstm_hidden, args.lstm_layers, mcb=args.mcb)
    else:
        model = build_model("audio", 1, args.lstm_hidden, args.lstm_layers)
    model.to(device)
    norm_stats = None
    if args.checkpoint:
        norm_stats, _ = restore(args.checkpoint, model, device)
        print(f"loaded {args.checkpoint}")

    chunk = int(fs * args.chunk_ms / 1000)
    probs = []
    if args.video:
        sv = StreamingAVVAD(model, norm_stats=norm_stats, block_frames=args.block_frames,
                            device=device)
        vchunk = max(1, int(62.5 * args.chunk_ms / 1000))
        vpos = 0
        for s in range(0, len(x), chunk):
            probs.append(sv.feed(x[s:s + chunk], frames[vpos:vpos + vchunk]))
            vpos += vchunk
        probs.append(sv.feed(np.zeros(0, np.float32), frames[vpos:]))
        probs.append(sv.flush())
    else:
        sv = StreamingVAD(model, norm_stats=norm_stats, block_frames=args.block_frames,
                          device=device)
        for s in range(0, len(x), chunk):
            probs.append(sv.feed(x[s:s + chunk]))
        probs.append(sv.flush())
    probs = np.concatenate(probs)

    frame_sec = 256 / fs
    active = probs > args.threshold
    print(f"{len(probs)} frames, {active.mean():.1%} speech")
    # contiguous segments
    edges = np.flatnonzero(np.diff(np.concatenate([[0], active, [0]])))
    segments = []
    for start, end in edges.reshape(-1, 2):
        segments.append((float(start * frame_sec), float(end * frame_sec)))
        print(f"  speech {start * frame_sec:7.2f}s - {end * frame_sec:7.2f}s "
              f"(p_mean={probs[start:end].mean():.2f})")
    return {"probs": probs, "segments": segments}


if __name__ == "__main__":
    main()
