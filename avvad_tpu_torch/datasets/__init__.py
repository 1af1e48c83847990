"""Dataset catalogs: filesystem path resolution for the supported corpora.

Pure-Python, no I/O beyond globbing. Copies of avvad_tpu/datasets, held to
them by tests/test_torch_port_data.py.
"""

from .ntcd_timit import (
    NTCD_NOISE_TYPES,
    NTCD_SNRS,
    kaldi_list,
    noisy_clean_pair_dict,
    noisy_speech_dict,
    proc_noisy_clean_pair_dict,
    proc_video_audio_pair_dict,
    speech_list,
    video_list,
)
from . import csr1_wjs0
