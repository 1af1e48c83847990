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
in parallel) has no PyTorch counterpart, and its ``mesh=`` waits for the
port's ``torch.distributed`` scale-out.
"""

from __future__ import annotations

import os
import time

from ..data import Prefetcher
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


class Trainer:
    def __init__(self, state, modality: str, model_dir: str,
                 norm_stats: dict | None = None, eps: float = 1e-8,
                 log_interval: int = 1, prefetch: bool = True):
        self.state = state
        self.modality = modality
        self.model_dir = model_dir
        self.norm_stats = norm_stats
        self.log_interval = log_interval
        self.prefetch = prefetch
        self.train_step = make_train_step(modality, eps)
        self.eval_step = make_eval_step(modality, eps)
        os.makedirs(model_dir, exist_ok=True)
        self.batch_log = os.path.join(model_dir, "output_batch.log")
        self.epoch_log = os.path.join(model_dir, "output_epoch.log")

    def _log(self, path: str, line: str):
        with open(path, "a") as f:
            f.write(line + "\n")

    def _iter(self, batches):
        return (Prefetcher(batches, device=self.state.device) if self.prefetch
                else iter(batches))

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
            seen += batch.batch_size
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
                                epoch=epoch, valid_loss=valid_m.get("loss", 0.0))
                if keep_checkpoints:
                    prune_checkpoints(self.model_dir, keep_latest=keep_checkpoints)
            last = {"train": train_m, "valid": valid_m, "epoch": epoch}
        return last
