"""Post-training int8 calibration for the video tower (port of
avvad_tpu/models/quantize.py).

The tower's int8 activation scales are 0-d float32 buffers (``q_stem``, and
``q_in`` with the int8 stem, on ``ResNet18``; ``q1`` and ``q_out`` on each
``BasicBlock``), the port's form
of the JAX ``quant`` collection. ``calibrate`` runs batches through the model
with every int8 tower in "calibrate" mode on the unfused path, so the buffers
keep the running max of |x| at each quantisation point, then restores each
tower's mode. The model is then served with ``quant_mode="static"``.

    model = AVVAD(..., tower_int8=True, tower_quant_mode="static",
                  tower_pallas=True)
    calibrate(model, [(audio_feats[:2], video[:2])],
              video_frame_indices=idx)
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from ..utils.profiling import setup_span
from .resnet import ResNet18


@setup_span("setup.calibrate")
def calibrate(model: nn.Module, batches: Iterable, **kw) -> nn.Module:
    """Run ``model(*batch, **kw)`` for each batch (a tuple of positional
    arguments, or one tensor) in eval mode with the int8 towers in
    "calibrate" mode -> the model, its scale buffers updated in place. The
    call is the ``setup.calibrate`` set-up span."""
    towers = [m for m in model.modules() if isinstance(m, ResNet18) and m.quant_int8]
    if not towers:
        raise ValueError("calibrate needs a model with an int8 tower "
                         "(tower_int8=True)")
    saved = [(t.quant_mode, t.stages_pallas) for t in towers]
    was_training = model.training
    model.eval()
    for t in towers:
        t.quant_mode, t.stages_pallas = "calibrate", False
    try:
        with torch.no_grad():
            for batch in batches:
                model(*(batch if isinstance(batch, (tuple, list)) else (batch,)), **kw)
    finally:
        model.train(was_training)
        for t, (mode, pallas) in zip(towers, saved):
            t.quant_mode, t.stages_pallas = mode, pallas
    return model
