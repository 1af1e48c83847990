"""Profiling and tracing (port of avvad_tpu/utils/profiling.py), and the
port's own spans and counters.

``trace``: a ``torch.profiler`` trace of the host and, on the card, of its
kernels, written into a directory as a Chrome / Perfetto trace (open it in
ui.perfetto.dev or chrome://tracing), where the JAX package writes a
``jax.profiler`` trace. ``PhaseTimer``: accumulating wall-clock phase
reports, the JAX package's format.

The recorder. ``span(name)`` marks a layer boundary where the work
happens: ``serve.step`` (``ServingStep``), ``serve.frontend``, ``tower``,
``tower.stem``, ``bn`` (each BatchNorm of the float ResNet trunk),
``fusion``, ``lstm``, ``head``, ``encoder`` (RawAudioVAD's WaveNet), and
the train step's ``train.step``, ``train.forward``, ``train.loss``,
``train.backward`` (``zero_grad`` and ``loss.backward``),
``train.optimizer`` and ``train.metrics``.

- Off (the default): a span is two flag reads and one shared null
  context: no allocation, no CUDA call.
- On after ``enable()`` (until ``disable()``), or while any torch profiler
  records (``trace``, ``--trace_dir``, a benchmark's profiled stretch).
  Each span keeps its name, its parent, its step (the id of the outermost
  span open on its thread, which every span of one step shares), host
  start and end (``time.perf_counter_ns``), the counters' growth over it,
  and on a card CUDA events at its start and end on the current stream,
  from a reused pool, resolved only when read. While a profiler records,
  a span is also a ``record_function`` range, on the trace's own clock
  beside the kernels it launched. Under ``torch.compile`` / ``torch.export``
  tracing and during CUDA-graph capture a span does nothing, so an
  exported or captured program is the same with the recorder on or off.
- Records sit in a buffer of fixed size; when it is full the oldest go
  and are counted (``dropped``). Nothing is written out: ``snapshot()``
  gives each span name's count and mean host, device and host-self ms
  (the duration less what its children cover) and its counters' growth a
  span, with the counters and the set-up spans; ``records()`` gives the
  spans one by one, device times in ms on one timeline a card. ``reset()``
  clears the records and the counters.

``count(name, n)`` is always on (a dict add): ``launch.<kernel>`` for
every launch of a hand-written kernel, ``build.nvcc`` for each build of
the kernel library. ``counters()`` and ``launches()`` read them.

``setup_span(name)`` times one-off set-up on the host clock whether the
recorder is on or off: ``setup.kernels`` (the kernel library's first
load, its nvcc build when it is missing), ``setup.calibrate``,
``setup.serving_fn`` and ``setup.train_state``.

To read it: ``profiling.enable()``, run, then ``profiling.snapshot()``;
or capture a ``trace(log_dir)`` (``scripts/train.py --trace_dir``), where
the spans appear in the Chrome trace over the kernels they launched.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 16      # span records kept; older ones are dropped
_NULL = contextlib.nullcontext()
_on = False             # set by enable() / disable()


class _Record:
    """One closed span. Device times are ms on its card's timeline, set
    when the recorder resolves the CUDA events."""

    __slots__ = ("id", "name", "parent", "step", "t0", "t1", "dev", "ev0", "ev1",
                 "d0", "d1", "counts")


class _Span:
    """An open span on the recorder (the on path of ``span``)."""

    __slots__ = ("rec", "r", "c0", "rf")

    def __init__(self, rec: "Recorder", name: str, dev):
        r = _Record()
        r.name, r.dev = name, dev
        r.ev0 = r.ev1 = r.d0 = r.d1 = None
        self.rec, self.r, self.rf = rec, r, None

    def __enter__(self):
        rec, r = self.rec, self.r
        stack = rec._stack()
        r.id = next(rec._ids)
        r.parent, r.step = (stack[-1].id, stack[-1].step) if stack else (None, r.id)
        stack.append(r)
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(r.name)
            self.rf.__enter__()
        self.c0 = dict(rec.counters)
        if r.dev is not None:
            r.ev0 = rec._event(r.dev)
        r.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec, r = self.rec, self.r
        r.t1 = time.perf_counter_ns()
        if r.dev is not None:
            r.ev1 = rec._event(r.dev)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        c0 = self.c0
        r.counts = {k: v - c0.get(k, 0) for k, v in rec.counters.items()
                    if v != c0.get(k, 0)} or None
        stack = rec._stack()
        if stack and stack[-1] is r:
            stack.pop()
        rec._keep(r)
        return False


class Recorder:
    """Span records, counters and set-up times (module docstring). The
    module's functions use one process-wide recorder."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.counters: dict[str, int] = {}
        self.setup: dict[str, list] = {}      # name -> [calls, seconds, self seconds]
        self.dropped = 0
        self._records: collections.deque = collections.deque()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._pool: list = []                 # free CUDA events
        self._epochs: dict = {}               # card index -> event at its timeline's 0
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str):
        """The on path of ``span``: a span, or the null context while
        compiling or capturing a CUDA graph."""
        if torch.compiler.is_compiling():
            return _NULL
        dev = None
        if torch.cuda.is_initialized():
            if torch.cuda.is_current_stream_capturing():
                return _NULL
            dev = torch.cuda.current_device()
        return _Span(self, name, dev)

    def _event(self, dev: int) -> torch.cuda.Event:
        if dev not in self._epochs:
            epoch = torch.cuda.Event(enable_timing=True)
            epoch.record()
            self._epochs[dev] = epoch
        try:
            ev = self._pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _release(self, r: _Record) -> None:
        if r.ev0 is not None:
            self._pool += [r.ev0, r.ev1]
            r.ev0 = r.ev1 = None

    def _keep(self, r: _Record) -> None:
        with self._lock:
            if len(self._records) >= self.capacity:
                self._release(self._records.popleft())
                self.dropped += 1
            self._records.append(r)

    def _resolve(self) -> list:
        """The records, their CUDA events read and returned to the pool."""
        with self._lock:
            recs = list(self._records)
            for r in recs:
                if r.ev0 is not None:
                    r.ev1.synchronize()
                    epoch = self._epochs[r.dev]
                    r.d0, r.d1 = epoch.elapsed_time(r.ev0), epoch.elapsed_time(r.ev1)
                    self._release(r)
        return recs

    def records(self) -> list[dict]:
        """The kept spans in the order they closed: name, id, parent,
        step, host start / end ns, device start / end ms (None off the
        card), counters' growth."""
        return [{"name": r.name, "id": r.id, "parent": r.parent, "step": r.step,
                 "host_start_ns": r.t0, "host_end_ns": r.t1,
                 "device_start_ms": r.d0, "device_end_ms": r.d1,
                 "counts": dict(r.counts or {})} for r in self._resolve()]

    def snapshot(self) -> dict:
        """{"spans": {name: {"count", "host_ms", "device_ms", "self_ms",
        "counts"}}, "counters", "setup": {name: {"calls", "s", "self_s"}},
        "dropped"}: means a span (``device_ms`` None without device times;
        ``self_ms`` the host time less its kept children's), ``counts`` the
        counters' mean growth a span."""
        recs = self._resolve()
        child_ns = defaultdict(int)
        for r in recs:
            if r.parent is not None:
                child_ns[r.parent] += r.t1 - r.t0
        by_name: dict = {}
        for r in recs:
            by_name.setdefault(r.name, []).append(r)
        spans = {}
        for name, rs in by_name.items():
            n = len(rs)
            dev = [r.d1 - r.d0 for r in rs if r.d0 is not None]
            counts: dict = defaultdict(int)
            for r in rs:
                for k, v in (r.counts or {}).items():
                    counts[k] += v
            spans[name] = {
                "count": n,
                "host_ms": sum(r.t1 - r.t0 for r in rs) / n / 1e6,
                "device_ms": sum(dev) / len(dev) if len(dev) == n else None,
                "self_ms": sum(r.t1 - r.t0 - child_ns[r.id] for r in rs) / n / 1e6,
                "counts": {k: v / n for k, v in counts.items()}}
        return {"spans": spans, "counters": dict(self.counters),
                "setup": {k: {"calls": c, "s": s, "self_s": own}
                          for k, (c, s, own) in self.setup.items()},
                "dropped": self.dropped}

    def reset(self) -> None:
        """Drop every record and zero the counters (the set-up times stay:
        they happen once a process)."""
        with self._lock:
            for r in self._records:
                self._release(r)
            self._records.clear()
            self.dropped = 0
        self.counters.clear()

    @contextlib.contextmanager
    def setup_span(self, name: str) -> Iterator[None]:
        stack = getattr(self._local, "setup", None)
        if stack is None:
            stack = self._local.setup = []
        stack.append(0.0)              # seconds of the set-up spans inside
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            inner = stack.pop()
            if stack:
                stack[-1] += dt
            entry = self.setup.setdefault(name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += dt
            entry[2] += dt - inner


_RECORDER = Recorder()


def span(name: str):
    """A span of the process's recorder, or the shared null context while
    the recorder is off (module docstring)."""
    if _on or _autograd_profiler._is_profiler_enabled:
        return _RECORDER.open(name)
    return _NULL


def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _on
    _on = True


def disable() -> None:
    """Record spans only while a torch profiler records."""
    global _on
    _on = False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    c = _RECORDER.counters
    c[name] = c.get(name, 0) + n


def counters(prefix: str = "") -> dict:
    """The counters whose names start with ``prefix``."""
    return {k: v for k, v in _RECORDER.counters.items() if k.startswith(prefix)}


def launches() -> dict:
    """{kernel name: launches} of the hand-written kernels since the last
    ``reset``, the kernels not launched left out."""
    return {k[len("launch."):]: v for k, v in _RECORDER.counters.items()
            if k.startswith("launch.") and v}


def setup_span(name: str):
    """Time one-off set-up on the host clock, recorder on or off."""
    return _RECORDER.setup_span(name)


def snapshot() -> dict:
    return _RECORDER.snapshot()


def records() -> list[dict]:
    return _RECORDER.records()


def reset() -> None:
    _RECORDER.reset()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block into ``log_dir/trace_<pid>_<ns>.json``: CPU
    activity, and CUDA activity where a card is visible; the program's
    spans are on while it records."""
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
    """Accumulating named-phase wall-clock timer; each phase is also a span
    of the same name.

    with timer.phase("forward"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with span(name):
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
