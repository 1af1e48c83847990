"""Oracle-label audio QA: render waveform/spectrogram/label figures and
label histograms for each clean utterance of a split, and cross-check the
host STFT against the on-device STFT (port of scripts/visualization_audio.py).

Covers the reference's scripts/visualization_audio.py (which rendered
oracle VAD/IBM figures under models/oracle_classif and kept a librosa-vs-
torch STFT cross-check, :97-133 — here the cross-check is host numpy
against the port's fp32 DFT matmul, ``ops.stft.stft_frames``, on
``--device``, and it asserts). The figures need matplotlib; where it is
missing the run raises a named ``ImportError`` before it reads anything.
``device_stft_check`` is the cross-check alone, which needs no matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ._common import add_device_flag, device_of

# the JAX script's bar for the device STFT against the host one
STFT_ATOL = 5e-3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-root", default="data")
    p.add_argument("--dataset-size", default="subset")
    p.add_argument("--split", default="test")
    p.add_argument("--labels", default="vad_labels",
                   choices=["vad_labels", "ibm_labels"])
    p.add_argument("--output-dir", default=None,
                   help="default: <data-root>/<size>/models/oracle_classif")
    p.add_argument("--check-device-stft", action="store_true",
                   help="assert host and on-device STFT agree")
    add_device_flag(p)
    return p


def device_stft_check(x: np.ndarray, fs: int, sxx: np.ndarray, device, stft_cfg=None,
                      atol: float = STFT_ATOL) -> float:
    """``ops.stft.stft_frames`` of the peak-normalised signal ``x`` on
    ``device`` (fp32, TF32 off) against its host STFT ``sxx`` (n_freq,
    frames): raises where re or im differ by more than ``atol`` -> the
    largest difference."""
    import torch

    from ..config import STFTConfig
    from ..ops.stft import stft_frames

    cfg = stft_cfg or STFTConfig()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        re, im = stft_frames(torch.from_numpy(np.ascontiguousarray(x)).to(device), fs=fs,
                             wlen_sec=cfg.wlen_sec, hop_percent=cfg.hop_percent)
        re, im = re.cpu().numpy().T, im.cpu().numpy().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_allclose(re, sxx.real, atol=atol)
    np.testing.assert_allclose(im, sxx.imag, atol=atol)
    return float(max(np.abs(re - sxx.real).max(), np.abs(im - sxx.imag).max()))


def main(argv=None) -> dict:
    """-> {utterance: the device STFT's largest difference (None without
    ``--check-device-stft``)}."""
    args = build_parser().parse_args(argv)
    from ..builders import make_label
    from ..config import LabelConfig, STFTConfig
    from ..datasets import speech_list
    from ..processing import read_wav, stft
    from ..processing.audio_io import peak_normalize
    from ..visualization import display_wav_spectro_mask, pyplot

    device = device_of(args) if args.check_device_stft else None
    plt, _ = pyplot("visualization_audio")
    raw = os.path.join(args.data_root, args.dataset_size, "raw/")
    out_root = args.output_dir or os.path.join(
        args.data_root, args.dataset_size, "models", "oracle_classif")
    stft_cfg, label_cfg = STFTConfig(), LabelConfig(kind=args.labels)

    clean_in, _ = speech_list(raw, args.split)
    print(f"{args.split}: {len(clean_in)} utterances")
    checked = {}
    for rel in clean_in:
        x, fs = read_wav(os.path.join(raw, rel))
        x = peak_normalize(x)
        sxx = stft(x, fs=fs, wlen_sec=stft_cfg.wlen_sec,
                   hop_percent=stft_cfg.hop_percent, center=stft_cfg.center,
                   pad_at_end=stft_cfg.pad_at_end)
        label = make_label(x, fs, stft_cfg, label_cfg)

        checked[rel] = None
        if args.check_device_stft:
            checked[rel] = device_stft_check(x, fs, sxx, device, stft_cfg)
            print(f"  device STFT parity ok: {rel}")

        stem = os.path.join(out_root, os.path.splitext(rel)[0])
        os.makedirs(os.path.dirname(stem), exist_ok=True)

        fig = display_wav_spectro_mask(x, sxx, label, fs=fs,
                                       hop_percent=stft_cfg.hop_percent)
        fig.savefig(stem + f"_hard_{args.labels}.png")
        plt.close(fig)

        fig, ax = plt.subplots()
        ax.hist(np.asarray(label).ravel(), bins=2)
        ax.set_title(f"{os.path.basename(stem)} {args.labels} "
                     f"(active {float(np.mean(label)):.2%})")
        fig.savefig(stem + "_hist.png")
        plt.close(fig)
        print("wrote", stem + f"_hard_{args.labels}.png")
    return checked


if __name__ == "__main__":
    main()
