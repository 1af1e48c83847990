"""Streaming VAD TCP server (port of scripts/serve_server.py).

Serves a trained checkpoint over TCP, one connection per stream. Audio
mode (AudioVAD): raw float32 LE PCM in. Audio-visual mode (AVVAD,
--modality av): framed messages ([type][u32 len][payload], A = float32
PCM, P = int16 PCM, V = 67x67 float32 lip frames, U = uint8 lip frames)
interleaved per connection. Video-only mode (VideoVAD, --modality
video): the framed protocol restricted to V/U messages. All emit raw
float32 LE per-frame speech probabilities (see avvad_tpu_torch.server for
the wire protocol). A serving capability the reference lacks entirely (its
closest analogue is the batch prediction writer,
evaluate_audio_net.py:107-180). A server rebuilt from an artifact of a
static-int8 tower server runs its trunk in the K3 / K2 kernels on the
card; the LSTM, which carries its state across ticks, runs as a plain
loop, as in the JAX package.

``build_server(args)`` makes the ``VADServer``; ``main`` serves it until
interrupted.

Example:
  python -m avvad_tpu_torch.scripts.serve_server --checkpoint runs/audio \\
      --port 7474 --streams 32 --block-frames 16
  python -m avvad_tpu_torch.scripts.serve_server --modality av \\
      --checkpoint runs/av --streams 16
"""

from __future__ import annotations

import argparse

from ._common import add_device_flag, build_model, device_of, hoist_mcb, restore


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--modality", choices=["audio", "video", "av"],
                   default="audio")
    p.add_argument("--checkpoint",
                   help="AudioVAD/AVVAD/VideoVAD checkpoint (model dir or epoch dir)")
    p.add_argument("--artifact",
                   help="serve from an exported multistream artifact "
                        "(export.export_multistream_server) instead of a "
                        "checkpoint: no model code, no restore; geometry "
                        "(streams/block/modality) comes from the artifact")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7474)
    p.add_argument("--streams", type=int, default=32,
                   help="max concurrent connections (one device batch row each)")
    p.add_argument("--block-frames", type=int, default=16,
                   help="frames per device step (latency/throughput knob)")
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--y-dim", type=int, default=1)
    p.add_argument("--mcb", action=argparse.BooleanOptionalAction, default=True,
                   help="AV fusion: MCB (default) or concat")
    p.add_argument("--mcb-hoist", action="store_true",
                   help="pre-fold MCB sketches into the DFT bases "
                        "(identical math, fewer per-tick matmuls; av only)")
    p.add_argument("--audio-span", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="span audio wire: ship each tick's raw contiguous "
                        "sample span to the device (on-device framing, "
                        "bit-exact; audio/av). Default ON for audio/av")
    p.add_argument("--audio-int16", action="store_true",
                   help="int16 PCM device wire (requires the span audio "
                        "wire): half the audio payload, bit-exact for "
                        "16-bit sources; clients should send type-P "
                        "(int16) audio messages, or raw int16 in audio "
                        "mode — float A payloads are quantized "
                        "server-side")
    p.add_argument("--hop-dft", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="hop-block DFT frontend on the span (implies "
                        "--audio-span; ~4x fewer frontend matmul FLOPs). "
                        "Default ON for audio/av")
    p.add_argument("--video-fps", type=float, default=0.0,
                   help="video/av: ingest camera-rate video (e.g. 30) — "
                        "clients send source-rate lip frames, the tower "
                        "runs on each block's unique frames, features "
                        "gather onto the 62.5 fps timeline on the device")
    p.add_argument("--pipelined", action="store_true",
                   help="two-deep pipelined ticks: results ship one block "
                        "later, consecutive ticks' transfers and compute "
                        "overlap")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard streams over a data-axis mesh of this many "
                        "local cards (must divide --streams; per-stream ticks "
                        "need no collectives)")
    add_device_flag(p)
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if not args.checkpoint and not args.artifact:
        p.error("one of --checkpoint / --artifact is required")
    # span + hop-DFT default ON for the modalities they apply to;
    # video-only servers have no audio wire
    if args.audio_span is None:
        args.audio_span = args.modality != "video"
    if args.hop_dft is None:
        args.hop_dft = args.modality != "video"
    if args.hop_dft and not args.audio_span:
        p.error("--hop-dft requires the span audio wire (drop "
                "--no-audio-span or pass --no-hop-dft)")
    if args.audio_int16 and not args.audio_span:
        p.error("--audio-int16 requires the span audio wire")
    if args.audio_int16 and args.modality == "video":
        p.error("--audio-int16 applies to audio/av modalities only")
    if args.audio_span and args.modality == "video":
        p.error("--audio-span applies to audio/av modalities only")
    if args.mcb_hoist and (args.modality != "av" or not args.mcb):
        p.error("--mcb-hoist requires --modality av with --mcb")
    if args.video_fps and args.modality == "audio":
        p.error("--video-fps applies to the video/av modalities only")
    return args


def build_server(args):
    """The ``VADServer`` that ``args`` (``parse_args``) describe, listening
    but not yet serving."""
    from ..server import VADServer

    device = device_of(args)
    if args.artifact:
        from ..export import load_multistream_server

        streamer = load_multistream_server(args.artifact, device=device)
        server = VADServer(streamer, host=args.host, port=args.port,
                           pipelined=args.pipelined)
        print(f"listening on {server.address[0]}:{server.address[1]} "
              f"(artifact {args.artifact}: {streamer.n} stream slots, "
              f"block={streamer.block_frames} frames)")
        return server

    from ..serve import MultiStreamAVVAD, MultiStreamVAD, MultiStreamVideoVAD

    make_streamer = {"audio": MultiStreamVAD, "video": MultiStreamVideoVAD,
                     "av": MultiStreamAVVAD}[args.modality]

    def make(**extra):
        return build_model(args.modality, args.y_dim, args.lstm_hidden, args.lstm_layers,
                           mcb=args.mcb, **extra)

    model = make()
    norm_stats, epoch = restore(args.checkpoint, model, device)
    print(f"serving checkpoint epoch {epoch} "
          f"(norm stats: {sorted(norm_stats) if norm_stats else None})")
    if args.mcb_hoist:
        model = hoist_mcb(model, make)
        print("MCB sketches pre-folded (hoisted fold)")

    mesh = None
    if args.data_parallel:
        from ..parallel import make_mesh

        mesh = make_mesh(n_data=args.data_parallel, n_model=1,
                         devices=(None if device.type == "cuda"
                                  else [device] * args.data_parallel))
        print(f"serving mesh: streams sharded over {args.data_parallel} devices")
    wire_kw = ({"span_wire": args.audio_span, "hop_dft": args.hop_dft,
                "audio_int16": args.audio_int16}
               if args.modality != "video" else {})
    if args.video_fps:
        wire_kw["video_fps"] = args.video_fps
    streamer = make_streamer(model, n_streams=args.streams, norm_stats=norm_stats,
                             block_frames=args.block_frames, device=device, mesh=mesh,
                             **wire_kw)
    server = VADServer(streamer, host=args.host, port=args.port,
                       pipelined=args.pipelined)
    print(f"listening on {server.address[0]}:{server.address[1]} "
          f"({args.modality}, {args.streams} stream slots, "
          f"block={args.block_frames} frames)")
    return server


def main(argv=None) -> None:
    server = build_server(parse_args(argv))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
