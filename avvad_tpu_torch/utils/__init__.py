"""Utilities (port of avvad_tpu/utils): profiling and tracing, the
reference's torch checkpoints in and out, a parameter count.

The JAX package's ``enable_compilation_cache`` (XLA's persistent cache)
has no PyTorch counterpart and is not ported.
"""

from .misc import count_parameters
from .profiling import PhaseTimer, trace
from .torch_export import export_resnet18_trunk, export_video_trunk_pt
from .torch_import import (import_reference_audio_vad, import_reference_avvad,
                           import_reference_video_vad, import_torch_linear,
                           import_torch_lstm, import_torch_resnet18,
                           load_torch_state_dict, random_reference_state,
                           sketch_matrix_from_hs)

__all__ = ["PhaseTimer", "count_parameters", "export_resnet18_trunk",
           "export_video_trunk_pt", "import_reference_audio_vad", "import_reference_avvad",
           "import_reference_video_vad", "import_torch_linear", "import_torch_lstm",
           "import_torch_resnet18", "load_torch_state_dict", "random_reference_state",
           "sketch_matrix_from_hs", "trace"]
