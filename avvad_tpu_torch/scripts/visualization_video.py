"""Lip-video label overlay QA: re-encode each utterance's decoded lip video
with a white square in the corner on VAD-active frames, plus the matching
audio track as a sibling wav (port of scripts/visualization_video.py).

Covers the reference's scripts/visualization_video.py (which muxed audio
via ffmpeg-python; no ffmpeg here, so the audio lands as <utt>_audio.wav
next to the <utt>.mp4 — lossless and player-compatible). The video is
written by OpenCV (``cv2``), imported by ``main``: where it is missing the
run raises a named ``ImportError`` before it reads anything.
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
    p.add_argument("--fps", type=float, default=62.5,
                   help="output frame rate (62.5 = STFT-aligned upsampled)")
    p.add_argument("--predictions-dir", default=None,
                   help="overlay saved *_y_hat_hard.npy instead of oracle VAD "
                        "(matlab_raw-keyed layout, as written by "
                        "the reconstruct twin)")
    p.add_argument("--output-dir", default=None)
    return p


def main(argv=None) -> list:
    """-> the written ``.mp4`` paths."""
    args = build_parser().parse_args(argv)
    try:
        import cv2
    except ImportError as e:
        raise ImportError("visualization_video needs cv2 (OpenCV), which is not "
                          "installed") from e
    from ..builders import make_label
    from ..config import LabelConfig, STFTConfig
    from ..datasets import speech_list, video_list
    from ..processing import read_wav
    from ..processing.audio_io import peak_normalize, write_wav
    from ..processing.video import (decode_dct_frames, overlay_vad_square, read_mat_dct,
                                    upsample_video)

    raw = os.path.join(args.data_root, args.dataset_size, "raw/")
    out_root = args.output_dir or os.path.join(
        args.data_root, args.dataset_size, "models",
        "oracle_classif" if not args.predictions_dir else "pred_overlay")

    mats = video_list(raw, args.split)
    clean_in, _ = speech_list(raw, args.split)
    written = []
    for mat_rel, clean_rel in zip(mats, clean_in):
        frames = decode_dct_frames(read_mat_dct(os.path.join(raw, mat_rel)))
        frames = upsample_video(frames, 30.0, args.fps)

        x, fs = read_wav(os.path.join(raw, clean_rel))
        x = peak_normalize(x)

        if args.predictions_dir:
            stem_rel = os.path.splitext(mat_rel)[0]
            pred = np.load(os.path.join(args.predictions_dir,
                                        stem_rel + "_y_hat_hard.npy"))
            vad = np.asarray(pred).reshape(-1)
        else:
            vad = make_label(x, fs, STFTConfig(), LabelConfig("vad_labels"))[0]

        t = min(len(frames), len(vad))
        stem = os.path.join(out_root, os.path.splitext(mat_rel)[0])
        os.makedirs(os.path.dirname(stem), exist_ok=True)

        writer = cv2.VideoWriter(stem + ".mp4", cv2.VideoWriter_fourcc(*"mp4v"),
                                 args.fps, (frames.shape[2], frames.shape[1]))
        if not writer.isOpened():
            raise RuntimeError("cv2 VideoWriter failed to open (mp4v codec)")
        for i in range(t):
            f = overlay_vad_square(frames[i], bool(vad[i] > 0.5))
            f8 = np.clip(f, 0, 255).astype(np.uint8)
            writer.write(cv2.merge([f8] * 3))
        writer.release()
        write_wav(stem + "_audio.wav", x, fs)
        written.append(stem + ".mp4")
        print(f"wrote {stem}.mp4 ({t} frames) + _audio.wav")
    return written


if __name__ == "__main__":
    main()
