from .conv_fused import (basic_block_int8, basic_block_int8_plain, fold_block,
                         trunk_features_int8)
from .lstm_fused import (LSTMRecurrence, lstm_bwd, lstm_bwd_plain, lstm_fwd_train,
                         lstm_fwd_train_plain, lstm_layer_fused, lstm_layer_plain)
from .qparams import weight_qparams
from .stem_fused import fold_stem, stem_epilogue_plain, stem_epilogue_pool_quant
from .stft import frame_energy_vad, istft_frames, log_power_frontend, stft_frames
from .video import fps_resample, idct2_decode

__all__ = ["LSTMRecurrence", "basic_block_int8", "basic_block_int8_plain", "fold_block",
           "fold_stem", "fps_resample", "frame_energy_vad", "idct2_decode",
           "istft_frames", "log_power_frontend", "lstm_bwd", "lstm_bwd_plain",
           "lstm_fwd_train", "lstm_fwd_train_plain", "lstm_layer_fused",
           "lstm_layer_plain",
           "stem_epilogue_plain", "stem_epilogue_pool_quant", "stft_frames",
           "trunk_features_int8", "weight_qparams"]
