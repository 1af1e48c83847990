"""Profiling and tracing (port of avvad_tpu/utils/profiling.py).

``PhaseTimer``: accumulating wall-clock phase reports, the JAX package's
format. ``trace``: a ``torch.profiler`` trace of the host and, on the card,
of its kernels, written into a directory as a Chrome / Perfetto trace
(open it in ui.perfetto.dev or chrome://tracing), where the JAX package
writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``log_dir/trace_<pid>_<ns>.json``: CPU
    activity, and CUDA activity where a card is visible."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities, record_shapes=False)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """Accumulating named-phase wall-clock timer.

    with timer.phase("forward"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["{:<20} {:>10} {:>8} {:>12}".format(
            "PHASE", "TOTAL (s)", "CALLS", "MEAN (ms)")]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot, n = self.totals[name], self.counts[name]
            lines.append("{:<20} {:>10.3f} {:>8d} {:>12.2f}".format(
                name, tot, n, 1e3 * tot / n))
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
