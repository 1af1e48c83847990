"""Small helpers (port of avvad_tpu/utils/misc.py)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
from torch import nn


def count_parameters(params) -> int:
    """Total parameter count of a module (its parameters, not its buffers)
    or of a state dict / nested mapping of arrays (every entry): the
    reference's count_parameters (the reference's packages/utils.py:5)."""
    if isinstance(params, nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(count_parameters(v) for v in params.values())
    return int(np.prod(np.shape(params)))
