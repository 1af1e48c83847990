"""Train, eval and predict steps, by modality (port of
avvad_tpu/train/steps.py).

A step takes a ``Batch`` (numpy, or tensors) and the dataset's
normalisation statistics, moves them to the state's device, and runs:
normalisation -> forward -> masked per-sequence BCE -> (train) backward
and Adam -> frame metrics. The train step runs the model in train mode,
as JAX's ``train=True``: BatchNorm on batch statistics, running
statistics updated; under autograd the LSTM runs its training kernels.
Eval and predict run in eval mode without autograd: the inference
kernel. The modalities are "audio" (``AudioVAD``), "video" (``VideoVAD``,
its ResNet-18 trained with the rest), "av" (``AVVAD``, the trunk frozen
or not) and "waveform" (``RawAudioVAD`` on ``Batch.waveform``, which is
not normalised).

``dropout=True`` (for models built with ``dropout_rate`` > 0) draws each
step's masks on the state's device, from a generator there seeded from
``(dropout_seed, state.step)``, the counterpart of JAX's
``fold_in(PRNGKey(dropout_seed), step)``.

With ``mesh=`` a step is the rank-local part of one data- (and tensor-)
parallel step over a process group of one rank a mesh position
(``parallel.mesh``): it takes this rank's rows of the global batch
(``parallel.shard_batch``), the layers that reduce over the batch take
global statistics (``parallel.sync``), the gradients are added over the
``data`` axis (a SUM: the loss is a sum over sequences), dropout masks are
drawn for the global batch and cut to the rank's rows, and the loss and
metrics are those of the global batch. It then equals the unmeshed step on
the global batch, as the JAX mesh step does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.losses import batch_f1_sums, masked_sequence_bce, mean_from_sums
from ..models.vad_nets import DropoutRNG, dropout_generator
from ..parallel.mesh import all_reduce_grads, batch_rows
from ..parallel.sync import all_reduce_sum, data_parallel

MODALITIES = ("audio", "video", "av", "waveform")


def _tensor(a, device) -> torch.Tensor | None:
    """A batch array (numpy, or a tensor already uploaded, as a prefetcher
    leaves it) -> float32 on ``device``."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def normalize(x: torch.Tensor, mean, std, eps: float = 1e-8) -> torch.Tensor:
    """(x - mean) / (std + eps), with (dim, 1)- or (dim,)-shaped statistics
    (numpy, or tensors) against (B, T, dim) features
    (train_AV_net.py:286-291)."""
    m, s = (_tensor(v, x.device) for v in (mean, std))
    m = m[..., 0] if m.ndim == 2 else m
    s = s[..., 0] if s.ndim == 2 else s
    return (x - m) / (s + eps)


def _forward_inputs(modality: str, batch, norm_stats, eps: float, device) -> tuple:
    """The model's positional inputs for a batch, on ``device``, normalised
    where the statistics are given."""
    if modality == "waveform":
        return (_tensor(batch.waveform, device),)
    audio, video = _tensor(batch.audio, device), _tensor(batch.video, device)
    stats = norm_stats or {}
    if audio is not None and stats.get("audio_mean") is not None:
        audio = normalize(audio, stats["audio_mean"], stats["audio_std"], eps)
    if video is not None and stats.get("video_mean") is not None:
        video = normalize(video, stats["video_mean"], stats["video_std"], eps)
    return {"audio": (audio,), "video": (video,), "av": (audio, video)}[modality]


class _Spmd:
    """A meshed step's view of its rank: the data group (gradients, batch
    statistics, metrics) and the rows of the global batch it holds."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.group("data")
        self.n_data = mesh.shape["data"]

    def rows(self, local_batch: int) -> slice:
        return batch_rows(self.mesh, local_batch * self.n_data)


def _spmd(mesh):
    return None if mesh is None else _Spmd(mesh)


def _metrics(logits, label, mask, loss, eps: float, spmd=None) -> dict:
    """Loss and per-sequence metrics of the (global) batch."""
    y_hat_hard = (torch.sigmoid(logits) > 0.5).float()
    sums = batch_f1_sums(y_hat_hard, label, mask, eps)
    if spmd is not None and spmd.group is not None:
        both = all_reduce_sum(torch.cat([loss.reshape(1), sums]), spmd.group)
        loss, sums = both[0], both[1:]
    acc, prec, rec, f1 = mean_from_sums(sums)
    return {"loss": loss, "accuracy": acc, "precision": prec, "recall": rec,
            "f1": f1}


def _make_forward(modality: str, eps: float, train: bool):
    """-> ``forward(state, batch, norm_stats, dropout_rng=None) -> (logits,
    label, mask)`` on the state's device, the model in train or eval mode."""
    if modality not in MODALITIES:
        raise ValueError(f"unknown modality {modality!r} (have {MODALITIES})")

    def forward(state, batch, norm_stats, dropout_rng=None):
        dev = state.device
        inputs = _forward_inputs(modality, batch, norm_stats, eps, dev)
        state.model.train(train)
        kw = {} if dropout_rng is None else {"dropout_rng": dropout_rng}
        return (state.model(*inputs, **kw), _tensor(batch.label, dev),
                _tensor(batch.mask, dev))

    return forward


def make_train_step(modality: str, eps: float = 1e-8, dropout: bool = False,
                    dropout_seed: int = 0, mesh=None):
    """-> ``step(state, batch, norm_stats) -> (state, metrics)``: one Adam
    step on the masked BCE; ``state`` is updated in place and returned.
    Metrics are 0-d tensors on the state's device. ``dropout``: thread a
    per-step dropout generator (module docstring). ``mesh``: the rank-local
    part of the meshed step (module docstring); the state's model and
    optimizer placed by ``parallel.shard_params`` / ``shard_opt_state``."""
    forward = _make_forward(modality, eps, train=True)
    spmd = _spmd(mesh)

    def train_step(state, batch, norm_stats=None):
        rng = None
        if dropout:
            gen = dropout_generator(dropout_seed, state.step, state.device)
            b = int(np.shape(batch.mask)[0])
            rng = (DropoutRNG(gen) if spmd is None else
                   DropoutRNG(gen, rows=spmd.rows(b), global_batch=b * spmd.n_data))
        with data_parallel(None if spmd is None else spmd.group):
            logits, label, mask = forward(state, batch, norm_stats, rng)
            loss = masked_sequence_bce(logits, label, mask, eps)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if spmd is not None:
            all_reduce_grads([p for g in state.optimizer.param_groups
                              for p in g["params"]], spmd.group)
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            return state, _metrics(logits.detach(), label, mask, loss.detach(), eps, spmd)

    return train_step


def make_eval_step(modality: str, eps: float = 1e-8, mesh=None):
    """-> ``step(state, batch, norm_stats) -> (metrics, y_hat_soft)``:
    BatchNorm on running statistics, no state change. ``mesh``: this
    rank's rows in, the global batch's metrics out, the rank's
    probabilities."""
    forward = _make_forward(modality, eps, train=False)
    spmd = _spmd(mesh)

    @torch.no_grad()
    def eval_step(state, batch, norm_stats=None):
        with data_parallel(None if spmd is None else spmd.group):
            logits, label, mask = forward(state, batch, norm_stats)
        loss = masked_sequence_bce(logits, label, mask, eps)
        return _metrics(logits, label, mask, loss, eps, spmd), torch.sigmoid(logits)

    return eval_step


def make_predict_step(modality: str, eps: float = 1e-8, mesh=None):
    """-> ``step(state, batch, norm_stats) -> y_hat_soft (B, T, y)``: pure
    inference, no labels needed. ``mesh``: this rank's rows in and out
    (the whole-tensor L2 norm of the MCB fusion over the global batch)."""
    forward = _make_forward(modality, eps, train=False)
    spmd = _spmd(mesh)

    @torch.no_grad()
    def predict_step(state, batch, norm_stats=None):
        with data_parallel(None if spmd is None else spmd.group):
            return torch.sigmoid(forward(state, batch, norm_stats)[0])

    return predict_step
