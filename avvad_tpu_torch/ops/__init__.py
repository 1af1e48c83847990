from .lstm_fused import lstm_layer_fused, lstm_layer_plain
from .qparams import weight_qparams
from .stft import log_power_frontend, stft_frames

__all__ = ["log_power_frontend", "lstm_layer_fused", "lstm_layer_plain",
           "stft_frames", "weight_qparams"]
