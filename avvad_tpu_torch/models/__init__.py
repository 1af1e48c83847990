from .lstm import LSTMCellFused, LSTMStack, select_last
from .mcb import CompactBilinearPooling, global_l2_normalize, signed_sqrt
from .resnet import BasicBlock, ResNet18
from .quantize import calibrate
from .vad_nets import AVVAD, AudioVAD, RawAudioVAD, VideoVAD
from .wavenet import WaveNetEncoder, adaptive_avg_pool1d

__all__ = ["AVVAD", "AudioVAD", "BasicBlock", "CompactBilinearPooling", "LSTMCellFused",
           "LSTMStack", "RawAudioVAD", "ResNet18", "VideoVAD", "WaveNetEncoder",
           "adaptive_avg_pool1d", "calibrate", "global_l2_normalize", "select_last",
           "signed_sqrt"]
