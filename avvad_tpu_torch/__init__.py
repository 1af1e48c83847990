"""PyTorch / CUDA port of avvad_tpu for NVIDIA Hopper (H100).

It runs the audio-visual, audio-only and video-only waveform serving steps:
log-power STFT frontend, ResNet-18 lip tower (float, or the static-int8
trunk on the hand-written stem-epilogue and BasicBlock kernels), MCB
fusion, two LSTM layers whose recurrence runs in hand-written CUDA kernels
(``csrc/``), Dense, sigmoid. It trains ``AudioVAD``, ``VideoVAD`` (its
ResNet-18 trained from scratch, with ``remat`` if asked) and ``AVVAD``
with its ResNet trunk frozen or trained (``train/``), the LSTM's forward
and reverse-time backward in hand-written kernels too. ``serve`` holds the
streaming servers for ``AudioVAD``, ``AVVAD`` and ``VideoVAD`` (carried
LSTM state, one device step a tick for N streams), and ``tools.lstm_probe``
the probe that takes a recurrence step's cost apart on the card.

The corpus path: ``builders`` turns a raw NTCD-TIMIT tree into the
processed one (labels, upsampled lip video, statistics); ``datasets`` and
``data`` read it (catalog, sources, ``DataLoader``, and a ``Prefetcher``
that moves batches to the card through pinned memory on a side stream)
into ``train.Trainer``; ``evaluate`` calibrates the int8 tower, writes
each utterance's predictions over a split and scores them. ``config`` is
the typed configuration, ``processing`` the host numpy signal processing.

Scale-out: ``parallel`` holds (data, model) device meshes and
``torch.distributed`` process groups; ``train.Trainer(mesh=)`` and
``evaluate.evaluate_split(mesh=)`` run one rank a mesh position (data
parallel, the wide LSTM weights column-sharded over ``model``), and the
multi-stream servers shard their streams over a mesh's data devices.
Training options: dropout on the three VAD models and the auxiliary
losses of ``models.losses``.

The package imports torch, numpy, scipy and the standard library at module
level; ``h5py`` and ``yaml`` only inside the functions that read or write
HDF5 or YAML. The JAX package ``avvad_tpu`` is its reference and is never
imported here. Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
