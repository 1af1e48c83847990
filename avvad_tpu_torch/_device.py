"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"`` (as the parity tests do). With no card and no explicit
request they raise: a serving step never drops silently to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); anything else
    is taken as given, and a CUDA request is also checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "avvad_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
