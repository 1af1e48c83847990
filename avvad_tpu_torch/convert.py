"""JAX ``AVVAD`` / ``VideoVAD`` / ``AudioVAD`` / ``RawAudioVAD`` variables
-> the port's ``state_dict`` (trained ones too: ``batch_stats`` become the
BatchNorm running statistics).

The input is the Flax variables tree as nested dicts of numpy arrays
(``params``, ``batch_stats``, ``sketch`` and ``quant`` collections; the
sketches in plain (d_in, out) or folded (2, d_in, f) form). No Flax is imported: the
tree is walked as plain dicts. Rules, by leaf name:

- ``kernel`` 4-d (HWIO conv) -> ``weight`` OIHW; ``kernel`` 3-d (a Conv1D's
  (W, I, O), the WaveNet encoder's) -> ``Conv1d`` ``weight`` (O, I, W);
  ``kernel`` 2-d (Dense, (in, out)) -> ``weight`` (out, in);
- BatchNorm ``scale`` -> ``weight``, ``mean`` -> ``running_mean``, ``var`` ->
  ``running_var`` (plus ``num_batches_tracked``);
- LSTM ``w_ih`` / ``w_hh`` / ``bias``, Dense ``bias``, the sketches and the
  int8 tower's activation scales (``quant``: ``q_stem``, ``q1``, ``q_out``,
  and ``q_in`` of the int8 stem, 0-d buffers) keep their names and layouts.
The path through the tree becomes the dotted module path, which the port's
modules mirror.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
# Flax ``kernel`` by rank -> the torch ``weight`` layout
_KERNEL_LAYOUT = {
    4: lambda k: k.transpose(3, 2, 0, 1),  # conv HWIO -> OIHW
    3: lambda k: k.transpose(2, 1, 0),  # Conv1D (W, I, O) -> (O, I, W)
    2: lambda k: k.T,  # Dense (in, out) -> (out, in)
}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def from_flax_variables(tree: Mapping) -> dict[str, torch.Tensor]:
    """-> state_dict for ``avvad_tpu_torch.models.AVVAD``, ``VideoVAD``,
    ``AudioVAD`` or ``RawAudioVAD`` (strict load)."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats", "sketch", "quant"):
        for path, arr in _flatten(tree.get(collection, {})):
            *mods, leaf = path
            if leaf == "kernel":
                leaf = "weight"
                arr = _KERNEL_LAYOUT[arr.ndim](arr)
            else:
                leaf = _RENAME.get(leaf, leaf)
            key = ".".join([*mods, leaf])
            state[key] = torch.tensor(arr, dtype=torch.float32)
            if leaf == "running_mean":
                state[".".join([*mods, "num_batches_tracked"])] = \
                    torch.tensor(0, dtype=torch.long)
    return state
