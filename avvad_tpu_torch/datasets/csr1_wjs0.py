"""CSR-1-WSJ-0 catalog: clean-speech file lists + pickle round-trip helpers.

Same capability surface as the reference's packages/dataset/csr1_wjs0.py
(speech_list, write_dataset, read_dataset). The corpus lives under
`CSR-1-WSJ-0/WAV/wsj0/{si_tr_s,si_dt_05,si_et_05}`.

A copy of avvad_tpu/datasets/csr1_wjs0.py.
"""

from __future__ import annotations

import os
import pickle
from glob import glob

_SPLIT_DIR = {"train": "si_tr_s", "validation": "si_dt_05", "test": "si_et_05"}


def _split_dir(dataset_type: str) -> str:
    try:
        return _SPLIT_DIR[dataset_type]
    except KeyError:
        raise ValueError(
            f"dataset_type must be one of {sorted(_SPLIT_DIR)}, got {dataset_type!r}"
        ) from None


def speech_list(input_speech_dir: str, dataset_type: str = "train") -> list[str]:
    """All wav files of a WSJ0 split, relative to `input_speech_dir`."""
    pattern = os.path.join(
        input_speech_dir, "CSR-1-WSJ-0/WAV/wsj0", _split_dir(dataset_type), "**/*.wav"
    )
    return [os.path.relpath(p, input_speech_dir) for p in sorted(glob(pattern, recursive=True))]


def _pickle_path(data_dir: str, dataset_type: str, suffix: str) -> str:
    return os.path.join(data_dir, "CSR-1-WSJ-0", f"{_split_dir(dataset_type)}_{suffix}.p")


def write_dataset(data, output_data_dir: str, dataset_type: str,
                  suffix: str = "unlabeled_frames") -> str:
    """Pickle `data` under <root>/CSR-1-WSJ-0/<split>_<suffix>.p."""
    path = _pickle_path(output_data_dir, dataset_type, suffix)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)
    return path


def read_dataset(data_dir: str, dataset_type: str, suffix: str = "unlabeled_frames"):
    with open(_pickle_path(data_dir, dataset_type, suffix), "rb") as f:
        return pickle.load(f)
