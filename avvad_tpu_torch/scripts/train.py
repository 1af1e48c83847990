"""Train a VAD model (audio / video / av) (port of scripts/train.py).

CLI covering the reference's three edit-the-constants training scripts
(the reference's scripts/train_{audio,video,AV}_net.py) with real flags.
Canonical reference configuration is the default: batch 16, Adam 1e-4,
2x1024 LSTM, MCB fusion, dataset-level std normalization, frozen
pretrained video trunk for AV. The LSTM's recurrence runs in the
hand-written training kernels (K1d forward, K1e backward) on the card.

``--data-parallel N`` runs one process a mesh position, launched by
``torchrun`` or ``parallel.spawn`` (which set ``MASTER_ADDR``,
``WORLD_SIZE`` and ``RANK``); each rank takes its card (``LOCAL_RANK``),
and the process group runs on nccl (gloo under ``--device cpu``).

Example (subset smoke run):
  python -m avvad_tpu_torch.scripts.train --modality audio --data-root data \\
      --dataset-size subset --epochs 3 --batch-size 3 --lstm-hidden 64 \\
      --model-dir runs/audio_subset
"""

from __future__ import annotations

import argparse
import os

from ._common import (add_device_flag, build_model, data_parallel_mesh, device_of,
                      processed_root)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default=None,
                   help="YAML config (avvad_tpu_torch.config.Config); provides "
                        "defaults that explicit flags override")
    p.add_argument("--modality", choices=["audio", "video", "av"], required=True)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset-size", choices=["subset", "complete"], default="subset")
    p.add_argument("--labels", choices=["vad_labels", "ibm_labels"],
                   default="vad_labels")
    p.add_argument("--upsampled", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--video-variant", default="auto",
                   choices=["auto", "upsampled", "normvideo", "plain"])
    p.add_argument("--model-dir", required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lstm-hidden", type=int, default=1024)
    p.add_argument("--lstm-layers", type=int, default=2)
    p.add_argument("--mcb", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--std-norm", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--bucket", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrained-video", default=None,
                   help="VideoVAD checkpoint dir to load + freeze the trunk from")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --model-dir")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard batches over a data-axis mesh of this many ranks "
                        "(0 = single process; -1 = every rank of the launch)")
    p.add_argument("--augment", action="store_true",
                   help="train on the clean wavs remixed across the "
                        "synthesized 6-noise x 3-SNR grid (emulates the "
                        "reference's full NTCD-TIMIT noise grid; audio/av "
                        "only — see avvad_tpu_torch.data.augment)")
    p.add_argument("--trace-dir", default=None,
                   help="capture a torch.profiler trace of the first "
                        "training epoch into this directory")
    add_device_flag(p)
    return p


def _apply_config_defaults(p, argv=None):
    """Parse once to find --config, load it, and re-parse with its values
    as argparse defaults (explicit flags still win)."""
    pre, _ = p.parse_known_args(argv)
    if not pre.config:
        return p.parse_args(argv)
    from ..config import load_yaml

    cfg = load_yaml(pre.config)
    p.set_defaults(
        dataset_size=cfg.data.dataset_size,
        data_root=cfg.data.data_root,
        labels=cfg.data.labels,
        upsampled=cfg.data.upsampled,
        epochs=cfg.train.end_epoch,
        start_epoch=cfg.train.start_epoch,
        batch_size=cfg.train.batch_size,
        lr=cfg.train.learning_rate,
        lstm_hidden=cfg.model.lstm_hidden_size,
        lstm_layers=cfg.model.lstm_layers,
        mcb=cfg.model.use_mcb,
        std_norm=cfg.train.std_norm,
        bucket=cfg.train.bucket_t,
        seed=cfg.train.seed,
        dtype=cfg.model.dtype,
    )
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = _apply_config_defaults(build_parser(), argv)
    from ..config import LabelConfig
    from ..data import (AudioSequenceSource, AudioVisualSource, DataLoader,
                        VideoSequenceSource, load_statistics)
    from ..train import Trainer, create_train_state
    from ..train.checkpoint import (latest_checkpoint, load_pretrained_trunk,
                                    restore_checkpoint)

    mesh = None
    if args.data_parallel:
        mesh, device = data_parallel_mesh(args)
        print(f"data-parallel mesh over {mesh.devices.size} ranks")
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

    train_src, valid_src = make_source("train"), make_source("validation")
    if args.augment:
        if args.modality == "video":
            raise SystemExit("--augment remixes audio; video-only training "
                             "has no audio path")
        from ..data import AugmentingSource

        train_src = AugmentingSource(train_src, seed=args.seed)
        print(f"augmentation: {len(train_src.inner)} utterances x "
              f"{len(train_src.kinds)} noises x {len(train_src.snrs)} SNRs "
              f"= {len(train_src)} items/epoch")
    print(f"train utterances: {len(train_src)}, valid: {len(valid_src)}")
    train_dl = DataLoader(train_src, args.batch_size, shuffle=True,
                          seed=args.seed, bucket=args.bucket, sort_pool_factor=4)
    valid_dl = DataLoader(valid_src, args.batch_size, shuffle=False,
                          bucket=args.bucket)

    # normalization statistics (reference layout, train_AV_net.py:118-126)
    norm_stats = None
    if args.std_norm:
        norm_stats = {}
        audio_stats = os.path.join(
            processed, "ntcd_timit/Noisy",
            "ntcd_timit_log_power_spec_upsampled_statistics.h5")
        video_stats = os.path.join(
            processed, "ntcd_timit/matlab_raw",
            "ntcd_timit_upsampled_statistics.h5")
        if args.modality in ("audio", "av"):
            if args.augment:
                # the pre-rendered statistics h5 describes the fixture's
                # single Babble@-5 condition; compute per-bin stats over
                # one pass of the augmented grid instead (on --resume the
                # checkpoint holds them)
                if not (args.resume and latest_checkpoint(args.model_dir)):
                    from ..data import feature_stats

                    m, s = feature_stats(train_src)
                    norm_stats["audio_mean"], norm_stats["audio_std"] = m, s
                    print("augmented-grid audio statistics computed")
            elif os.path.exists(audio_stats):
                m, s = load_statistics(audio_stats)
                norm_stats["audio_mean"], norm_stats["audio_std"] = m, s
        if args.modality in ("video", "av") and os.path.exists(video_stats):
            m, s = load_statistics(video_stats)
            norm_stats["video_mean"], norm_stats["video_std"] = m, s
        if not norm_stats:
            if not args.augment:
                print("warning: no statistics h5 found; training "
                      "unnormalized")
            norm_stats = None

    # model + optimizer
    model = build_model(args.modality, y_dim, args.lstm_hidden, args.lstm_layers,
                        mcb=args.mcb, dtype=args.dtype, seed=args.seed)
    freeze = args.modality == "av" and bool(args.pretrained_video)
    state = create_train_state(model, learning_rate=args.lr, freeze_video_trunk=freeze,
                               device=device)

    start_epoch = args.start_epoch
    if args.resume:
        ck = latest_checkpoint(args.model_dir)
        if ck:
            state, restored_norm, epoch = restore_checkpoint(ck, state)
            # the moments come from the checkpoint, the learning rate from
            # the flags (a JAX optimizer state holds no learning rate)
            for group in state.optimizer.param_groups:
                group["lr"] = args.lr
            start_epoch = epoch + 1
            if restored_norm:
                # keys computed this start (e.g. video h5 stats) win;
                # checkpoint stats fill whatever was deferred to resume
                restored_norm.update(norm_stats or {})
                norm_stats = restored_norm
            print(f"resumed from {ck} (next epoch {start_epoch})")
    if (args.std_norm and args.augment
            and (norm_stats is None or "audio_mean" not in norm_stats)):
        # resume path with a checkpoint that predates stats storage
        from ..data import feature_stats

        m, s = feature_stats(train_src)
        norm_stats = dict(norm_stats or {})
        norm_stats["audio_mean"], norm_stats["audio_std"] = m, s
        print("augmented-grid audio statistics computed")

    if args.pretrained_video:
        load_pretrained_trunk(args.pretrained_video, state.model)
        print(f"loaded + froze video trunk from {args.pretrained_video}")

    trainer = Trainer(state, args.modality, args.model_dir, norm_stats=norm_stats,
                      mesh=mesh)
    if args.trace_dir:
        from ..utils import trace

        with trace(args.trace_dir):
            trainer.train_epoch(train_dl, epoch=start_epoch)
        print(f"trace captured in {args.trace_dir}")

    result = trainer.fit(train_dl, valid_dl, start_epoch=start_epoch,
                         end_epoch=args.epochs + 1)
    print("final:", {k: round(v, 4) for k, v in result.get("valid", {}).items()})
    return result


if __name__ == "__main__":
    main()
