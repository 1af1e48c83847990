"""Host-side (numpy) signal processing: copies of avvad_tpu/processing
(STFT, labels, WAV I/O, the lip-video decode and the frame-rate schedules).
The device frontend is ``avvad_tpu_torch.ops.stft``."""

from .audio_io import read_wav, write_wav
from .stft import hann_window, istft, log_power_spectrogram, pad_for_stft, stft
from .targets import (clean_speech_IBM, clean_speech_VAD, noise_aware_IBM,
                      noise_robust_clean_speech_IBM, threshold_IBM)
from .video import (decode_and_upsample, fps_block_schedule, fps_block_src_max,
                    fps_resample_indices, unique_frame_schedule)

__all__ = ["clean_speech_IBM", "clean_speech_VAD", "decode_and_upsample",
           "fps_block_schedule", "fps_block_src_max", "fps_resample_indices",
           "hann_window", "istft", "log_power_spectrogram", "noise_aware_IBM",
           "noise_robust_clean_speech_IBM", "pad_for_stft", "read_wav", "stft",
           "threshold_IBM", "unique_frame_schedule", "write_wav"]
