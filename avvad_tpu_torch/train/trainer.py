"""Epoch-loop trainer by modality (port of avvad_tpu/train/trainer.py).

Per epoch: a train pass with per-batch lines in ``output_batch.log``, an
eval pass, a summary in ``output_epoch.log`` (the reference's line
formats), a checkpoint named by epoch and validation loss, and pruning.
Batches come from a ``data.DataLoader``, or any re-iterable of host
``Batch`` with a length (a list); a ``source`` attribute, where present,
gives the number of utterances, and an ``epoch`` attribute is set to the
trainer's epoch before its pass, so that a resumed run does not replay
the shuffles of the epochs it has trained. With ``prefetch`` (the default,
as in JAX) each pass's batches go to the state's device through a
``data.Prefetcher``. The JAX trainer's ``prewarm=`` (XLA compiles ahead,
in parallel) has no PyTorch counterpart.

``mesh=``: data (and tensor) parallel training, one rank a mesh position
(``parallel``): every rank iterates the same batches (same loader, seed
and epoch), keeps the rows of its data coordinate on their way to the
device, and runs the meshed step of ``train.steps``; the state is placed
by ``parallel.shard_params`` / ``shard_opt_state`` and lives on the rank's
mesh device. Batch sizes must divide the data axis. Logs are written by
rank 0 only, and checkpoints hold the full state, written by rank 0.
"""

from __future__ import annotations

import os
import time

import torch

from ..data import Prefetcher
from ..data.batching import Batch
from ..parallel.mesh import shard_batch, shard_opt_state, shard_params
from .checkpoint import prune_checkpoints, save_checkpoint
from .steps import make_eval_step, make_train_step


def _to_float(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


class MetricAccumulator:
    def __init__(self):
        self.totals: dict = {}
        self.n = 0

    def add(self, metrics: dict):
        for k, v in metrics.items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v)
        self.n += 1

    def mean(self) -> dict:
        return {k: v / max(self.n, 1) for k, v in self.totals.items()}


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        return (torch.cuda.current_device() if d.type == "cuda" and d.index is None
                else d.index)
    return a.type == b.type and (a.type == "cpu" or index(a) == index(b))


class Trainer:
    def __init__(self, state, modality: str, model_dir: str,
                 norm_stats: dict | None = None, eps: float = 1e-8,
                 log_interval: int = 1, prefetch: bool = True, mesh=None):
        self.state = state
        self.modality = modality
        self.model_dir = model_dir
        self.norm_stats = norm_stats
        self.log_interval = log_interval
        self.prefetch = prefetch
        self.mesh = mesh
        self.n_data = 1
        if mesh is not None:
            mesh.check_world()
            if not _same_device(state.device, mesh.local_device):
                raise ValueError(f"the state is on {state.device}, this rank's mesh "
                                 f"device is {mesh.local_device}")
            self.n_data = mesh.shape["data"]
            shard_params(mesh, state.model)
            shard_opt_state(mesh, state.optimizer)
        self.writer = mesh is None or mesh.rank == 0
        self.train_step = make_train_step(modality, eps, mesh=mesh)
        self.eval_step = make_eval_step(modality, eps, mesh=mesh)
        os.makedirs(model_dir, exist_ok=True)
        self.batch_log = os.path.join(model_dir, "output_batch.log")
        self.epoch_log = os.path.join(model_dir, "output_epoch.log")

    def _log(self, path: str, line: str):
        if not self.writer:
            return
        with open(path, "a") as f:
            f.write(line + "\n")

    def _rows(self, batch: Batch) -> Batch:
        """A host batch -> this rank's rows (the whole batch unmeshed)."""
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def _iter(self, batches):
        if self.prefetch:
            return Prefetcher(batches, device=self.state.device,
                              put_fn=None if self.mesh is None else self._rows)
        return (self._rows(b) for b in batches)

    def train_epoch(self, batches, epoch: int) -> dict:
        if hasattr(batches, "epoch"):
            batches.epoch = epoch
        n_total = (len(batches.source) if hasattr(batches, "source")
                   else sum(b.batch_size for b in batches))
        n_batches = len(batches)
        acc = MetricAccumulator()
        seen = 0
        for batch_idx, batch in enumerate(self._iter(batches)):
            self.state, metrics = self.train_step(self.state, batch, self.norm_stats)
            m = _to_float(metrics)
            acc.add(m)
            seen += batch.batch_size * self.n_data
            if batch_idx % self.log_interval == 0:
                self._log(
                    self.batch_log,
                    "Train Epoch: {:2d}   [{:4d}/{:4d} ({:2d}%)]    "
                    "Loss: {:.2f}    Accuracy: {:.2f}    Precision: {:.2f}    "
                    "Recall: {:.2f}    F1-score.: {:.2f}".format(
                        epoch, seen, n_total,
                        int(100.0 * (batch_idx + 1) / n_batches),
                        m["loss"], m["accuracy"], m["precision"],
                        m["recall"], m["f1"],
                    ),
                )
        return acc.mean()

    def eval_epoch(self, batches) -> dict:
        acc = MetricAccumulator()
        for batch in self._iter(batches):
            metrics, _ = self.eval_step(self.state, batch, self.norm_stats)
            acc.add(_to_float(metrics))
        return acc.mean()

    def fit(self, train_batches, valid_batches, start_epoch: int = 1,
            end_epoch: int = 100, save_every: int = 1,
            keep_checkpoints: int = 3) -> dict:
        """Epochs start_epoch .. end_epoch - 1. keep_checkpoints: retain the
        best-vloss checkpoint plus this many newest epochs (0 = keep all)."""
        last = {}
        for epoch in range(start_epoch, end_epoch):
            t0 = time.perf_counter()
            train_m = self.train_epoch(train_batches, epoch)
            valid_m = self.eval_epoch(valid_batches)
            dt = time.perf_counter() - t0

            self._log(self.epoch_log, f"Epoch: {epoch}")
            for tag, m in [("Train", train_m), ("Validation", valid_m)]:
                self._log(
                    self.epoch_log,
                    "[{}]  Loss: {:.2f}    Accuracy: {:.2f}    "
                    "Precision: {:.2f}    Recall: {:.2f}    F1_score: {:.2f}".format(
                        tag, m.get("loss", 0), m.get("accuracy", 0),
                        m.get("precision", 0), m.get("recall", 0), m.get("f1", 0),
                    ),
                )
            self._log(self.epoch_log, f"[Time]  {dt:.2f}s")

            if epoch % save_every == 0:
                save_checkpoint(self.model_dir, self.state, self.norm_stats,
                                epoch=epoch, valid_loss=valid_m.get("loss", 0.0),
                                mesh=self.mesh)
                if keep_checkpoints and self.writer:
                    prune_checkpoints(self.model_dir, keep_latest=keep_checkpoints)
            last = {"train": train_m, "valid": valid_m, "epoch": epoch}
        return last
