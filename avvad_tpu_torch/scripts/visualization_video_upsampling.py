"""Upsampling sanity check: for each utterance, assert the upsampled lip
video's frame count matches the STFT frame count (modulo the builder's
min-truncation), and render a side-by-side strip of original vs upsampled
frames (port of scripts/visualization_video_upsampling.py).

Covers the reference's scripts/visualization_video_upsampling.py (whose
executable invariant was `assert speech_tf.shape[-1] == buf.shape[0]`,
:149-165 — note that script as committed also had a broken import; this
one runs). Prints OK or MISALIGNED an utterance and exits non-zero when
any is misaligned. Host numpy; only ``--figures`` needs matplotlib, and
only ``--figures`` decodes the video (the counts are the ``.mat``'s rows).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset-size", default="subset")
    p.add_argument("--split", default="test")
    p.add_argument("--figures", action="store_true")
    p.add_argument("--output-dir", default=None)
    return p


def main(argv=None) -> dict:
    """-> {mat file: upsampled video frames minus STFT frames}; raises
    ``SystemExit`` with the count where any utterance is misaligned."""
    args = build_parser().parse_args(argv)
    from ..config import STFTConfig
    from ..datasets import speech_list, video_list
    from ..processing import read_wav, stft
    from ..processing.audio_io import peak_normalize
    from ..processing.video import (decode_dct_frames, fps_resample_indices, read_mat_dct,
                                    upsample_video)

    if args.figures:
        from ..visualization import pyplot

        plt, _ = pyplot("visualization_video_upsampling --figures")
    raw = os.path.join(args.data_root, args.dataset_size, "raw/")
    out_root = args.output_dir or os.path.join(
        args.data_root, args.dataset_size, "models", "upsampling_qa")
    cfg = STFTConfig()

    mats = video_list(raw, args.split)
    clean_in, _ = speech_list(raw, args.split)
    diffs = {}
    for mat_rel, clean_rel in zip(mats, clean_in):
        dct = read_mat_dct(os.path.join(raw, mat_rel))
        # the counts need no IDCT: one decoded frame a row of coefficients
        n_frames = dct.shape[0]
        n_up = len(fps_resample_indices(n_frames, 30.0, cfg.frame_rate))

        x, fs = read_wav(os.path.join(raw, clean_rel))
        sxx = stft(peak_normalize(x), fs=fs, wlen_sec=cfg.wlen_sec,
                   hop_percent=cfg.hop_percent, center=cfg.center,
                   pad_at_end=cfg.pad_at_end)

        diff = diffs[mat_rel] = n_up - sxx.shape[-1]
        status = "OK" if abs(diff) <= 2 else "MISALIGNED"
        print(f"{mat_rel}: video 30fps={n_frames} -> "
              f"upsampled={n_up}, stft={sxx.shape[-1]} "
              f"(diff {diff:+d}) {status}")

        if args.figures:
            frames = decode_dct_frames(dct)
            up = upsample_video(frames, 30.0, cfg.frame_rate)
            n_show = 6
            idx30 = np.linspace(0, frames.shape[0] - 1, n_show).astype(int)
            idx_up = np.linspace(0, up.shape[0] - 1, n_show).astype(int)
            fig, axes = plt.subplots(2, n_show, figsize=(2 * n_show, 4.5))
            for k in range(n_show):
                axes[0, k].imshow(frames[idx30[k]], cmap="gray")
                axes[0, k].set_title(f"30fps #{idx30[k]}", fontsize=8)
                axes[1, k].imshow(up[idx_up[k]], cmap="gray")
                axes[1, k].set_title(f"62.5fps #{idx_up[k]}", fontsize=8)
                for ax in (axes[0, k], axes[1, k]):
                    ax.axis("off")
            stem = os.path.join(out_root, os.path.splitext(mat_rel)[0])
            os.makedirs(os.path.dirname(stem), exist_ok=True)
            fig.savefig(stem + "_upsampling.png", dpi=80)
            plt.close(fig)
            print("  wrote", stem + "_upsampling.png")

    failures = sum(abs(d) > 2 for d in diffs.values())
    if failures:
        raise SystemExit(f"{failures} misaligned utterances")
    print("all aligned")
    return diffs


if __name__ == "__main__":
    main()
