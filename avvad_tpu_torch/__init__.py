"""PyTorch / CUDA port of avvad_tpu for NVIDIA Hopper (H100).

It runs the audio-visual, audio-only and video-only waveform serving steps:
log-power STFT frontend, ResNet-18 lip tower (float, or the static-int8
trunk on the hand-written stem-epilogue and BasicBlock kernels), MCB
fusion, two LSTM layers whose recurrence runs in hand-written CUDA kernels
(``csrc/``), Dense, sigmoid. It trains ``AudioVAD`` and ``AVVAD`` with
its ResNet trunk frozen (``train/``), the LSTM's forward and
reverse-time backward in hand-written kernels too. ``serve`` holds the
streaming servers for ``AudioVAD`` and ``AVVAD`` (carried LSTM state, one
device step a tick for N streams), and ``tools.lstm_probe`` the probe
that takes a recurrence step's cost apart on the card.
The package imports torch, numpy and the standard library only; the JAX
package ``avvad_tpu`` is its reference and is never imported here.
Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
