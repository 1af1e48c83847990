"""Loader + device prefetch (port of avvad_tpu/data/pipeline.py).

Replaces the reference's torch DataLoader(num_workers=16, pin_memory)
(the reference's scripts/train_AV_net.py:141-146) with a thread-pooled host
loader (file reads, the LZF decoder and numpy release the GIL) and an explicit
double-buffered device prefetcher, so host IO/DSP overlaps the card's
compute. ``DataLoader`` is the JAX package's, line for line (its numpy
shuffle too, so both packages plan the same batches); ``Prefetcher`` moves
batches through pinned memory on a side CUDA stream where JAX calls
``jax.device_put``.

Length-sorted batching ("pool shuffling") is available to shrink padding
waste: utterances are shuffled, grouped into a sort-pool, sorted by length
inside the pool, and cut into batches — randomness is preserved across
epochs while intra-batch length variance collapses.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from .batching import Batch, pad_batch


class DataLoader:
    """Iterates padded Batches from an indexable source."""

    def __init__(
        self,
        source,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        bucket: Optional[int] = None,
        bucket_ladder: bool = False,
        pad_batch_to_full: bool = False,
        sort_pool_factor: int = 0,
        num_workers: int = 8,
        drop_last: bool = False,
    ):
        self.source = source
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.bucket = bucket
        self.bucket_ladder = bucket_ladder
        self.pad_batch_to_full = pad_batch_to_full
        self.sort_pool_factor = sort_pool_factor
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.epoch = 0
        self._length_cache: dict = {}

    def __len__(self) -> int:
        n = len(self.source)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.source))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx

    def batch_plan(self) -> list[np.ndarray]:
        """The per-batch source indices this loader will emit (stable for a
        given (seed, epoch); used by writers that pair outputs back to
        utterances)."""
        return self._batch_indices()

    def _batch_indices(self) -> list[np.ndarray]:
        idx = self._order()
        bs = self.batch_size
        if self.sort_pool_factor and len(idx) > bs:
            pool = bs * self.sort_pool_factor
            chunks = []
            for s in range(0, len(idx), pool):
                block = idx[s : s + pool]
                # sort each pool by length descending (length probe is cheap
                # for catalog sources: metadata only, no feature load)
                lens = np.asarray([self._probe_length(i) for i in block])
                chunks.append(block[np.argsort(-lens, kind="stable")])
            idx = np.concatenate(chunks)
        batches = [idx[s : s + bs] for s in range(0, len(idx), bs)]
        if self.drop_last and batches and len(batches[-1]) < bs:
            batches.pop()
        return batches

    def _probe_length(self, i: int) -> int:
        if i not in self._length_cache:
            if hasattr(self.source, "probe_length"):
                # header-only probe (no feature computation)
                self._length_cache[i] = int(self.source.probe_length(i))
            else:
                self._length_cache[i] = int(self.source[i]["length"])
        return self._length_cache[i]

    def __iter__(self) -> Iterator[Batch]:
        pad_to = self.batch_size if self.pad_batch_to_full else None
        if hasattr(self.source, "set_epoch"):
            # augmenting sources re-seed their realizations per epoch
            self.source.set_epoch(self.epoch)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            batches = self._batch_indices()
            # pipeline item loading two batches ahead
            futures = [
                [pool.submit(self.source.__getitem__, int(i)) for i in b]
                for b in batches[:2]
            ]
            for bi, b in enumerate(batches):
                if bi + 2 < len(batches):
                    futures.append(
                        [pool.submit(self.source.__getitem__, int(i))
                         for i in batches[bi + 2]]
                    )
                items = [f.result() for f in futures[bi]]
                yield pad_batch(items, bucket=self.bucket,
                                bucket_ladder=self.bucket_ladder,
                                pad_batch_to=pad_to,
                                source_indices=[int(i) for i in b])
        self.epoch += 1


class Prefetcher:
    """Device prefetch: moves host batches to ``device`` ``depth`` batches
    ahead, from a thread of its own.

    ``device=None`` is the card (``resolve_device``: no card -> raises);
    ``device="cpu"`` wraps each array as a tensor without a copy. On the
    card each array is copied into pinned host memory and from there,
    ``non_blocking``, on a side CUDA stream; an event recorded after a
    batch's copies is waited on by the consumer's stream before the batch
    is handed out, and each tensor is marked with ``record_stream`` on that
    stream, so that its memory is not reused while the consumer's kernels
    may still read it. The pinned buffers come from PyTorch's caching host
    allocator, which hands one out again only once its copy has run. A
    loader exception is raised in the consumer, as in the JAX package.
    ``put_fn``: applied to each host batch before its upload (a data
    rank keeps its rows: ``parallel.shard_batch``).
    """

    def __init__(self, it: Iterable[Batch], depth: int = 2, device=None,
                 put_fn: Optional[Callable[[Batch], Batch]] = None):
        self.device = resolve_device(device)
        self._put_fn = put_fn
        self._side = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                      else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _put(self, a) -> torch.Tensor:
        """A host array, or a tensor (one already on the device stays)."""
        src = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        if self._side is None or src.device.type != "cpu":
            return src.to(self.device)
        staging = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        staging.copy_(src)
        return staging.to(self.device, non_blocking=True)

    def _fill(self, it):
        try:
            for batch in it:
                if self._put_fn is not None:
                    batch = self._put_fn(batch)
                if self._side is None:
                    self._q.put((Batch(*[None if a is None else self._put(a)
                                         for a in batch]), None))
                    continue
                with torch.cuda.stream(self._side):
                    dev = Batch(*[None if a is None else self._put(a) for a in batch])
                    ready = torch.cuda.Event()
                    ready.record(self._side)
                self._q.put((dev, ready))
        except BaseException as e:  # surface loader errors to the consumer
            self._q.put(e)
            return
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for a in batch:
                    if a is not None:
                        a.record_stream(stream)
            yield batch
