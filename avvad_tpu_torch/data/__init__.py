"""Input pipeline (port of avvad_tpu/data): utterance sources, padded and
bucketed batching, a thread-pooled loader and a device prefetcher.

Sources yield whole utterances as time-major numpy arrays; batches are
zero-padded to bucketed lengths with explicit length masks; the
``Prefetcher`` moves them to the card through pinned memory on a side
stream while the previous batch computes. The JAX package's
``data/prewarm.py`` (``planned_batch_shapes``, ``prewarm_step``) compiles
XLA programs ahead in parallel and has no PyTorch counterpart: eager
PyTorch compiles nothing per shape.
"""

from .augment import AugmentingSource, feature_stats, mix_at_snr, synth_noise
from .batching import Batch, bucket_length, pad_batch
from .pipeline import DataLoader, Prefetcher
from .records import load_audio_logspec, load_label, load_video, load_waveform
from .sources import (AudioSequenceSource, AudioVisualSource,
                      AudioVisualWaveformSource, AudioWaveformSource, FrameStore,
                      SpectrogramChunkSource, SpectrogramFrameSource,
                      SpectrogramWindowSource, VideoClipSource, VideoSequenceSource)
from .statistics import load_statistics, save_statistics, welford_merge

__all__ = ["AudioSequenceSource", "AudioVisualSource", "AudioVisualWaveformSource",
           "AudioWaveformSource", "AugmentingSource", "Batch", "DataLoader",
           "FrameStore", "Prefetcher", "SpectrogramChunkSource",
           "SpectrogramFrameSource", "SpectrogramWindowSource", "VideoClipSource",
           "VideoSequenceSource", "bucket_length", "feature_stats",
           "load_audio_logspec", "load_label", "load_statistics", "load_video",
           "load_waveform", "mix_at_snr", "pad_batch", "save_statistics",
           "synth_noise", "welford_merge"]
