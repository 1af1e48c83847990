"""Evaluate a trained VAD model over a split: write per-utterance hard/soft
frame predictions (+ wall-clock throughput report) (port of
scripts/evaluate.py).

CLI covering the reference's evaluate_{audio,video,AV}_net.py scripts
(batch-1 spawn pools there; bucketed batched inference here). On the card
the LSTM runs in the hand-written inference kernels (K1a, K1c or K1b by
``--lstm-state-quant``) and, with ``--tower-int8 --tower-quant-mode static
--tower-pallas``, the trunk in the stem-epilogue (K3) and BasicBlock (K2)
kernels. The JAX script's ``--tower-chunk-unroll`` (a scan or unrolled
XLA subgraphs) is not taken: eager PyTorch runs the chunks in turn.
"""

from __future__ import annotations

import argparse
import os

from ._common import (add_device_flag, build_model, data_parallel_mesh, device_of,
                      hoist_mcb, processed_root, restore)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--modality", choices=["audio", "video", "av"], required=True)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset-size", choices=["subset", "complete"], default="subset")
    p.add_argument("--labels", default="vad_labels",
                   choices=["vad_labels", "ibm_labels"])
    p.add_argument("--upsampled", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--video-variant", default="auto",
                   choices=["auto", "upsampled", "normvideo", "plain"])
    p.add_argument("--split", default="test")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint dir (or a model dir: its best-vloss checkpoint)")
    p.add_argument("--output-dir", required=True,
                   help="where predictions land (classif_data_dir)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--bucket", type=int, default=128)
    p.add_argument("--bucket-ladder", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="snap padded lengths onto the geometric bucket "
                        "ladder (identical predictions; --no-bucket-ladder "
                        "restores linear bucketing)")
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--mcb", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--tower-int8", action="store_true",
                   help="W8A8 video trunk")
    p.add_argument("--tower-quant-mode", default="dynamic",
                   choices=["dynamic", "static"],
                   help="int8 activation scales: per-tensor on the fly, or "
                        "calibrated static scales (int8-resident trunk)")
    p.add_argument("--mcb-fast", action="store_true",
                   help="run the MCB fusion matmuls on bf16-rounded operands "
                        "(fp32 sums) instead of the parity default fp32")
    p.add_argument("--mcb-hoist", action="store_true",
                   help="store MCB sketches pre-folded into the DFT bases "
                        "(av + --mcb only)")
    p.add_argument("--tower-stem-int8", action="store_true",
                   help="quantize the stem conv too (input quantized with a "
                        "calibrated scale)")
    p.add_argument("--tower-chunk", type=int, default=0,
                   help="frames per video-trunk pass (0 = single pass); "
                        "bounds peak tower activation memory")
    p.add_argument("--calibrate-split", default="train",
                   help="split that provides int8 calibration utterances")
    p.add_argument("--calibrate-utts", type=int, default=8)
    p.add_argument("--lstm-state-quant", choices=["none", "bf16", "int8"],
                   default="none",
                   help="quantize the LSTM's recurrence state (inference only; "
                        "int8 = the W8A8 recurrent matmul)")
    p.add_argument("--tower-pallas", action="store_true",
                   help="the hand-written int8 stem-epilogue and BasicBlock "
                        "kernels for the trunk (requires --tower-int8 "
                        "--tower-quant-mode static)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard eval batches over a data-axis mesh of this many "
                        "ranks (a torchrun / parallel.spawn launch; batch-size "
                        "must divide by it)")
    add_device_flag(p)
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.tower_stem_int8 and not args.tower_int8:
        p.error("--tower-stem-int8 requires --tower-int8")
    if args.tower_pallas and not (args.tower_int8
                                  and args.tower_quant_mode == "static"):
        p.error("--tower-pallas requires --tower-int8 "
                "--tower-quant-mode static")
    if args.mcb_hoist and (args.modality != "av" or not args.mcb):
        p.error("--mcb-hoist requires --modality av with --mcb")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..config import LabelConfig
    from ..data import AudioSequenceSource, AudioVisualSource, VideoSequenceSource
    from ..evaluate import calibrate_quant_scales, evaluate_split
    from ..train.state import TrainState

    mesh = None
    if args.data_parallel:
        mesh, device = data_parallel_mesh(args)
        print(f"eval mesh over {mesh.devices.size} ranks")
    else:
        device = device_of(args)
    processed = processed_root(args.data_root, args.dataset_size)
    y_dim = LabelConfig(kind=args.labels).y_dim

    def make_source(split):
        if args.modality == "audio":
            return AudioSequenceSource(processed, split, args.dataset_size,
                                       args.labels, upsampled=args.upsampled)
        if args.modality == "video":
            return VideoSequenceSource(processed, split, args.labels,
                                       upsampled=args.upsampled)
        return AudioVisualSource(processed, split, args.dataset_size,
                                 args.labels, upsampled=args.upsampled,
                                 video_variant=args.video_variant)

    options = {"lstm_state_quant": args.lstm_state_quant}
    if args.modality != "audio":
        options.update(tower_int8=args.tower_int8, tower_quant_mode=args.tower_quant_mode,
                       tower_pallas=args.tower_pallas,
                       tower_stem_int8=args.tower_stem_int8, tower_chunk=args.tower_chunk)
    if args.modality == "av":
        options["mcb_precision"] = "default" if args.mcb_fast else "highest"

    def make(**extra):
        return build_model(args.modality, y_dim, args.lstm_hidden, args.lstm_layers,
                           mcb=args.mcb, **options, **extra)

    source = make_source(args.split)
    model = make()
    print(f"{args.split} utterances: {len(source)}")
    norm_stats, epoch = restore(args.checkpoint, model, device)
    print(f"restored checkpoint epoch {epoch}; norm stats: "
          f"{sorted(norm_stats) if norm_stats else None}")
    state = TrainState(model.eval(), None, device)

    if args.tower_int8 and args.tower_quant_mode == "static":
        cal_source = make_source(args.calibrate_split)
        calibrate_quant_scales(state, model, cal_source, args.modality,
                               norm_stats=norm_stats, n_utts=args.calibrate_utts)
        print(f"calibrated int8 scales on {args.calibrate_utts} "
              f"{args.calibrate_split} utterances")

    if args.modality == "av" and args.mcb_hoist:
        # after restore + calibrate: the loaded sketches folded once
        state = TrainState(hoist_mcb(model, make).eval(), None, device)
        print("MCB sketches pre-folded (hoisted fold)")

    report = evaluate_split(state, source, args.modality, args.output_dir + os.sep,
                            norm_stats=norm_stats, batch_size=args.batch_size,
                            bucket=args.bucket, bucket_ladder=args.bucket_ladder,
                            mesh=mesh)
    print(report)
    return report


if __name__ == "__main__":
    main()
