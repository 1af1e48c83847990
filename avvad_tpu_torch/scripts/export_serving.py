"""Export a trained checkpoint as a self-contained serving artifact (port
of scripts/export_serving.py).

Builds the full raw-input serving program (STFT frontend + model, weights
baked in) at fixed serving shapes and serializes it with ``torch.export``
into a single zip artifact (``export.ServingArtifact``): deployment then
needs only torch, the port's kernels (custom ops) and the artifact, no
model code and no checkpoint restore. On the card the exported program
calls the hand-written kernels: the LSTM (K1a, K1c or K1b by
``--lstm-state-quant``) and, with ``--tower-int8`` (static), the stem
epilogue (K3) and the BasicBlock (K2). An artifact replays on the kind of
device it was built on.

Example:
  python -m avvad_tpu_torch.scripts.export_serving --modality av \\
      --checkpoint runs/av --batch 64 --frames 512 --out av_serving.avvadx
"""

from __future__ import annotations

import argparse
import os

import torch

from ._common import (add_device_flag, build_model, device_of, hoist_mcb,
                      processed_root, restore)

FS, HOP = 16000, 256


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--modality", choices=["audio", "raw-audio", "video", "av"],
                   required=True)
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir (or a model dir: its best-vloss checkpoint)")
    p.add_argument("--out", required=True, help="artifact path (.avvadx zip)")
    p.add_argument("--batch", type=int, nargs="+", default=[64],
                   help="serving batch size(s); one artifact entry each")
    p.add_argument("--frames", type=int, default=512,
                   help="STFT frames per utterance (static serving length)")
    p.add_argument("--video-fps", type=float, default=0.0,
                   help="if > 0, export the unique-frame serving layout: "
                        "video input at this source rate plus a baked "
                        "fps-resample gather onto the 62.5 fps timeline")
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--y-dim", type=int, default=1,
                   help="label dimension of the trained head (must match "
                        "the checkpoint, e.g. 2 for 2-class IBM labels)")
    p.add_argument("--mcb", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--mcb-hoist", action="store_true",
                   help="pre-fold MCB sketches (identical math, fewer "
                        "per-step matmuls)")
    p.add_argument("--hop-dft", action="store_true",
                   help="hop-block DFT frontend (exact, ~4x fewer "
                        "frontend matmul FLOPs)")
    p.add_argument("--lstm-state-quant", choices=["none", "bf16", "int8"],
                   default="none",
                   help="quantized LSTM recurrence state (quality gates in "
                        "QUALITY.md)")
    p.add_argument("--tower-int8", action="store_true",
                   help="W8A8 video tower (video/av; the shipped serving "
                        "config uses static mode, on the K3 / K2 kernels)")
    p.add_argument("--tower-quant-mode", default="static",
                   choices=["dynamic", "static"],
                   help="static bakes calibrated activation scales into "
                        "the artifact (needs --data-root for calibration)")
    p.add_argument("--tower-stem-int8", action="store_true")
    p.add_argument("--data-root", default="data",
                   help="processed-data root for static-int8 calibration")
    p.add_argument("--dataset-size", choices=["subset", "complete"],
                   default="subset")
    p.add_argument("--labels", default="vad_labels")
    p.add_argument("--calibrate-split", default="train")
    p.add_argument("--calibrate-utts", type=int, default=8)
    add_device_flag(p)
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.mcb_hoist and (args.modality != "av" or not args.mcb):
        p.error("--mcb-hoist requires --modality av with --mcb")
    if args.tower_int8 and args.modality not in ("video", "av"):
        p.error("--tower-int8 requires --modality video/av")
    if args.tower_stem_int8 and not args.tower_int8:
        p.error("--tower-stem-int8 requires --tower-int8")
    return args


def main(argv=None) -> str:
    args = parse_args(argv)
    from ..export import ServingArtifact, make_waveform_serving_fn

    device = device_of(args)
    t = args.frames
    n_samples = HOP * (t - 1) + 1024
    static_int8 = args.tower_int8 and args.tower_quant_mode == "static"
    options = {}
    if args.modality == "raw-audio":
        options["out_frames"] = t
    else:
        options["lstm_state_quant"] = args.lstm_state_quant
    if args.modality in ("video", "av"):
        options.update(tower_int8=args.tower_int8, tower_quant_mode=args.tower_quant_mode,
                       tower_pallas=static_int8, tower_stem_int8=args.tower_stem_int8)

    def make(**extra):
        return build_model(args.modality, args.y_dim, args.lstm_hidden, args.lstm_layers,
                           mcb=args.mcb, **options, **extra)

    model = make()
    norm_stats, epoch = restore(args.checkpoint, model, device)
    print(f"restored checkpoint epoch {epoch}")

    if static_int8:
        # bake calibrated activation scales into the artifact (the shipped
        # serving config), as the evaluate entry point calibrates
        from ..data import AudioVisualSource, VideoSequenceSource
        from ..evaluate import calibrate_quant_scales
        from ..train.state import TrainState

        processed = processed_root(args.data_root, args.dataset_size)
        if args.modality == "video":
            cal_source = VideoSequenceSource(processed, args.calibrate_split, args.labels)
        else:
            cal_source = AudioVisualSource(processed, args.calibrate_split,
                                           args.dataset_size, args.labels)
        calibrate_quant_scales(TrainState(model.eval(), None, device), model, cal_source,
                               args.modality, norm_stats=norm_stats,
                               n_utts=args.calibrate_utts)
        print(f"calibrated int8 scales on {args.calibrate_utts} "
              f"{args.calibrate_split} utterances")
    if args.mcb_hoist:
        model = hoist_mcb(model, make)

    frame_idx = None
    t_video = t
    if args.video_fps > 0 and args.modality in ("video", "av"):
        from ..processing.video import unique_frame_schedule

        t_video, frame_idx = unique_frame_schedule(t, args.video_fps, FS / HOP)

    fn = make_waveform_serving_fn(model, t_frames=t, hop_dft=args.hop_dft,
                                  norm_stats=norm_stats, video_frame_indices=frame_idx,
                                  device=device)

    def example(b):
        wave = torch.zeros((b, n_samples), dtype=torch.float32, device=device)
        video = torch.zeros((b, t_video, 67, 67), dtype=torch.float32, device=device)
        if args.modality in ("audio", "raw-audio"):
            return (wave,)
        if args.modality == "video":
            return (video,)
        return (wave, video)

    artifact = ServingArtifact.build(
        {f"b{b}": (fn, example(b)) for b in args.batch},
        meta={"modality": args.modality, "frames": t,
              "n_samples": n_samples, "video_frames": t_video,
              "checkpoint": os.path.abspath(args.checkpoint),
              "epoch": int(epoch) if epoch is not None else None,
              "hop_dft": args.hop_dft, "mcb_hoist": args.mcb_hoist,
              "tower_int8": args.tower_int8,
              "tower_quant_mode": (args.tower_quant_mode
                                   if args.tower_int8 else None),
              "lstm_state_quant": args.lstm_state_quant,
              "video_fps": args.video_fps or None})
    artifact.save(args.out)
    sizes = {n: artifact.input_shapes(n) for n in artifact.entries}
    print(f"wrote {args.out}: entries {sizes}")
    return args.out


if __name__ == "__main__":
    main()
