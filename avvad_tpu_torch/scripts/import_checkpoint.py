"""Convert a reference (PyTorch) checkpoint into a port checkpoint, ready
for ``evaluate`` / ``train --resume`` (port of scripts/import_checkpoint.py).

The reference saved torch state dicts of DeepVAD_{audio,video,AV}
(train_*_net.py torch.save calls); this imports all parameter groups —
ResNet trunk with BatchNorm running stats, LSTMs (gate-order compatible),
heads, and MCB sketch buffers.

Example:
  python -m avvad_tpu_torch.scripts.import_checkpoint --modality av \\
      --torch-checkpoint Video_Net_epoch_005_vloss_3.85.pt \\
      --output-dir runs/imported_av --lstm-hidden 1024 --mcb
"""

from __future__ import annotations

import argparse

from ._common import add_device_flag, build_model, device_of


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--modality", choices=["audio", "video", "av"], required=True)
    p.add_argument("--torch-checkpoint", required=True, help=".pt state dict")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--y-dim", type=int, default=1)
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--mcb", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--epoch", type=int, default=0,
                   help="epoch tag for the output checkpoint name")
    add_device_flag(p)
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    from ..train import create_train_state, save_checkpoint
    from ..utils import (import_reference_audio_vad, import_reference_avvad,
                         import_reference_video_vad, load_torch_state_dict)

    device = device_of(args)
    state_dict = load_torch_state_dict(args.torch_checkpoint)
    print(f"loaded {args.torch_checkpoint}: {len(state_dict)} tensors")
    model = build_model(args.modality, args.y_dim, args.lstm_hidden, args.lstm_layers,
                        mcb=args.mcb)
    if args.modality == "audio":
        sd = import_reference_audio_vad(state_dict, model.state_dict())
    elif args.modality == "video":
        sd = import_reference_video_vad(state_dict, model.state_dict())
    else:
        sd = import_reference_avvad(state_dict, model)
    model.load_state_dict(sd)
    state = create_train_state(model, device=device)
    path = save_checkpoint(args.output_dir, state, epoch=args.epoch, valid_loss=0.0)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
