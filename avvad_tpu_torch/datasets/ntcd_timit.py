"""NTCD-TIMIT catalog: resolves file lists and noisy/clean/video pairings
from the on-disk corpus layout.

Re-implements the path-resolution semantics of the reference catalog
(the reference's packages/dataset/ntcd_timit.py) — same directory
conventions, same emitted relative paths, same subset/complete noise-grid
behavior — on top of a single shared path-algebra core instead of seven
near-identical glob functions. Output parity is pinned by
tests/test_catalog.py, which runs the reference implementation side by side.

Corpus layout (under a `raw/` or `processed/` root):
  ntcd_timit/matlab_raw/{train,dev,test}/<spk>/<utt>.mat        DCT lip video
  ntcd_timit/Clean/volunteers/<spk>/straightcam/<utt>.wav       raw clean
  ntcd_timit/Clean/{train,dev,test}/<spk>/<utt>.wav             processed clean
  ntcd_timit/u/drspeech/.../Noisy_TCDTIMIT/<noise>/<snr>/volunteers/...  raw noisy
  ntcd_timit/Noisy/<noise>/<snr>/{train,dev,test}/<spk>/<utt>.wav        processed noisy

A copy of avvad_tpu/datasets/ntcd_timit.py.
"""

from __future__ import annotations

import os
from glob import glob

# Full noise grid (6 types x 3 SNRs); `subset` mode restricts to Babble @ -5
# (matches ntcd_timit.py:330-334,352-357).
NTCD_NOISE_TYPES = ("Babble", "Cafe", "Car", "LR", "Street", "White")
NTCD_SNRS = ("-5", "0", "5")

_SPLIT_DIR = {"train": "train", "validation": "dev", "test": "test"}


def _split_dir(dataset_type: str) -> str:
    try:
        return _SPLIT_DIR[dataset_type]
    except KeyError:
        raise ValueError(
            f"dataset_type must be one of {sorted(_SPLIT_DIR)}, got {dataset_type!r}"
        ) from None


def _noise_grid(dataset_size: str):
    if dataset_size == "subset":
        return ("Babble",), ("-5",)
    return NTCD_NOISE_TYPES, NTCD_SNRS


def _rel_sorted_glob(root: str, pattern: str) -> list[str]:
    return [os.path.relpath(p, root) for p in sorted(glob(os.path.join(root, pattern), recursive=True))]


def _spk_utt(path: str) -> tuple[str, str]:
    """Last speaker directory and utterance stem of a catalog path."""
    parts = path.replace(os.sep, "/").split("/")
    return parts[-2], os.path.splitext(parts[-1])[0]


def video_list(input_video_dir: str, dataset_type: str = "train",
               labels: str = "vad_labels", upsampled: bool = False) -> list[str]:
    """All .mat lip-video files of a split, relative to `input_video_dir`."""
    return _rel_sorted_glob(
        input_video_dir, f"ntcd_timit/matlab_raw/{_split_dir(dataset_type)}/**/*.mat"
    )


def kaldi_list(input_video_dir: str, dataset_type: str = "train",
               labels: str = "vad_labels", upsampled: bool = False):
    """(ark_paths, scp_paths) of the kaldi fMLLR features of a split."""
    base = f"ntcd_timit/kaldi_fMLLR/{_split_dir(dataset_type)}"
    return (
        _rel_sorted_glob(input_video_dir, f"{base}/**/*.ark"),
        _rel_sorted_glob(input_video_dir, f"{base}/**/*.scp"),
    )


def speech_list(input_speech_dir: str, dataset_type: str = "train"):
    """(raw clean wav paths, processed clean wav paths) aligned to the
    split's .mat video list.

    Raw clean audio lives under Clean/volunteers/<spk>/straightcam/; the
    processed output path is Clean/<split>/<spk>/<utt>.wav.
    """
    mats = video_list(input_speech_dir, dataset_type)
    raw, proc = [], []
    for mat in mats:
        spk, utt = _spk_utt(mat)
        raw.append(f"ntcd_timit/Clean/volunteers/{spk}/straightcam/{utt}.wav")
        split = mat.replace(os.sep, "/").split("/")[-3]
        proc.append(os.path.join("ntcd_timit/Clean/", f"{split}/{spk}/{utt}.wav"))
    return raw, proc


def proc_video_audio_pair_dict(input_video_dir: str, dataset_type: str = "train",
                               labels: str = "vad_labels", upsampled: bool = False,
                               dct: bool = False, norm_video: bool = False):
    """(processed video h5 list, processed label h5 list) for a split."""
    split = _split_dir(dataset_type)
    if upsampled:
        vpat = f"ntcd_timit/matlab_raw/{split}/**/*_upsampled.h5"
    elif dct:
        vpat = f"ntcd_timit/matlab_raw/{split}/**/*_dct.h5"
    elif norm_video:
        vpat = f"ntcd_timit/matlab_raw/{split}/**/*_normvideo.h5"
    else:
        # Plain decoded videos: exclude the suffixed variants. Intentional
        # divergence from the reference: its glob
        # `*[!dct][!upsampled][!normvideo].h5` (ntcd_timit.py:182) is a
        # char-class pattern that also drops legitimate files whose stem
        # ends in any of those letters (e.g. sa1.h5, since 'a' is in
        # "upsampled"); here the suffixes are matched as real suffixes.
        vids = _rel_sorted_glob(input_video_dir, f"ntcd_timit/matlab_raw/{split}/**/*.h5")
        vids = [v for v in vids
                if not any(v.endswith(s + ".h5") for s in ("_upsampled", "_dct", "_normvideo"))]
        auds = _rel_sorted_glob(input_video_dir, f"ntcd_timit/Clean/{split}/**/*_{labels}.h5")
        return vids, auds
    return (
        _rel_sorted_glob(input_video_dir, vpat),
        _rel_sorted_glob(input_video_dir, f"ntcd_timit/Clean/{split}/**/*_{labels}.h5"),
    )


def _video_aligned_shortpaths(input_dir: str, dataset_type: str):
    """For each split .mat: (raw-noisy shortpath, processed shortpath)."""
    mats = video_list(input_dir, dataset_type)
    raw_short, proc_short = [], []
    for mat in mats:
        spk, utt = _spk_utt(mat)
        raw_short.append(f"{spk}/straightcam/{utt}.wav")
        split = mat.replace(os.sep, "/").split("/")[-3]
        proc_short.append(os.path.join(split, spk, f"{utt}.wav"))
    return raw_short, proc_short


def _raw_noisy_dir(noise_type: str, snr: str) -> str:
    return os.path.join(
        "ntcd_timit/u/drspeech/data/TCDTIMIT/Noisy_TCDTIMIT", noise_type, snr, "volunteers"
    )


def noisy_speech_dict(input_speech_dir: str, dataset_type: str = "train",
                      dataset_size: str = "complete") -> dict[str, str]:
    """raw noisy wav -> processed noisy wav destination, over the noise grid."""
    raw_short, proc_short = _video_aligned_shortpaths(input_speech_dir, dataset_type)
    noise_types, snrs = _noise_grid(dataset_size)
    pairs: dict[str, str] = {}
    for noise_type in noise_types:
        for snr in snrs:
            src_dir = _raw_noisy_dir(noise_type, snr)
            dst_dir = os.path.join("ntcd_timit", "Noisy", noise_type, snr)
            pairs.update(
                (os.path.join(src_dir, r), os.path.join(dst_dir, p))
                for r, p in zip(raw_short, proc_short)
            )
    return pairs


def noisy_clean_pair_dict(input_speech_dir: str, dataset_type: str = "train",
                          dataset_size: str = "complete") -> dict[str, str]:
    """raw noisy wav -> processed clean wav, over the noise grid."""
    raw_short, _ = _video_aligned_shortpaths(input_speech_dir, dataset_type)
    clean_dir = f"ntcd_timit/Clean/{_split_dir(dataset_type)}/"
    noise_types, snrs = _noise_grid(dataset_size)
    pairs: dict[str, str] = {}
    for noise_type in noise_types:
        for snr in snrs:
            src_dir = _raw_noisy_dir(noise_type, snr)
            for r in raw_short:
                noisy = os.path.join(src_dir, r)
                spk = noisy.replace(os.sep, "/").split("/")[-3]
                pairs[noisy] = clean_dir + spk + "/" + os.path.basename(noisy)
    return pairs


def proc_noisy_clean_pair_dict(input_speech_dir: str, dataset_type: str = "train",
                               dataset_size: str = "complete", labels: str = "vad_labels",
                               upsampled: bool = False) -> dict[str, str]:
    """processed noisy wav -> processed clean label h5, over the noise grid.

    Enumerates the split's existing `*_{labels}[_upsampled].h5` files and
    pairs each with its noisy counterpart under Noisy/<noise>/<snr>/.
    """
    split = _split_dir(dataset_type)
    suffix = f"_{labels}_upsampled.h5" if upsampled else f"_{labels}.h5"
    label_files = _rel_sorted_glob(
        input_speech_dir, f"ntcd_timit/Clean/{split}/**/*{suffix}"
    )

    shortpaths = []
    for lf in label_files:
        parts = lf.replace(os.sep, "/").split("/")
        utt = parts[-1][: -len(suffix)]
        shortpaths.append(os.path.join(parts[-3], parts[-2], utt + ".wav"))

    noise_types, snrs = _noise_grid(dataset_size)
    pairs: dict[str, str] = {}
    for noise_type in noise_types:
        for snr in snrs:
            noisy_dir = os.path.join("ntcd_timit", "Noisy", noise_type, snr)
            pairs.update(
                (os.path.join(noisy_dir, sp), lf)
                for sp, lf in zip(shortpaths, label_files)
            )
    return pairs
