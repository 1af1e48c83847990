"""The traced run's records: CUDA-event stage marks, and a steady stretch of
steps under ``torch.profiler`` reduced to device busy time, the kernels by
name and the idle gaps by what the host was doing.

Every time here is in seconds. The profiled window runs from the start of
the first profiled step's host span to the end of the last one's, on the
trace's own clock; busy time is the union of the device operations'
intervals inside it, so overlapping kernels count once."""

from __future__ import annotations

import bisect
import sys
import time

import torch

STEP_SPAN = "bench.step"


def log_phase(ctx, name: str) -> None:
    """Seconds from the process's start to the end of a set-up phase, on
    standard error (the card synchronised first)."""
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize(ctx.device)
    print(f"setup {name} {time.perf_counter() - ctx.t0:.3f} s", file=sys.stderr, flush=True)


class Marks:
    """CUDA events recorded in order inside each step: ``mark(name)``
    between the step's ``begin()`` and ``end()``. ``stage_ms(a, b)`` is the
    mean over all steps of the device time from mark ``a`` to mark ``b``."""

    def __init__(self):
        self.steps, self._cur = [], None

    def begin(self) -> None:
        self._cur = {}
        self.mark("start")

    def mark(self, name: str) -> None:
        if self._cur is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._cur.setdefault(name, ev)

    def end(self) -> None:
        self.mark("end")
        self.steps.append(self._cur)
        self._cur = None

    def stage_ms(self, a: str, b: str) -> float | None:
        vals = [s[a].elapsed_time(s[b]) for s in self.steps if a in s and b in s]
        return sum(vals) / len(vals) if vals else None


def module_hooks(marks: Marks, module: torch.nn.Module, name: str) -> list:
    """Marks ``<name>_start`` / ``<name>_end`` around every forward of
    ``module`` -> hook handles."""
    return [module.register_forward_pre_hook(lambda *_: marks.mark(f"{name}_start")),
            module.register_forward_hook(lambda *_: marks.mark(f"{name}_end"))]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_profile(prof, top: int = 10) -> dict:
    """-> {"window_s", "busy_s", "steps", "kernels": [(name, start_s, end_s)],
    "device_ops": [[name, seconds]], "idle_gaps": [[host span, seconds]]}.
    An idle gap is named by what the host was doing at its middle: the
    harness's span (``bench.*``) and the innermost operation of the program
    open then ("python" where none is: the interpreter between operations)."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    steps = [e for e in events if e.name == STEP_SPAN and e.device_type == DeviceType.CPU]
    if not steps:
        return {}
    w0 = min(e.time_range.start for e in steps) * 1e-6
    w1 = max(e.time_range.end for e in steps) * 1e-6
    kernels = []
    for e in events:
        # the harness's own spans are mirrored on the device's timeline as
        # annotations: they are no device operation
        if e.device_type == DeviceType.CUDA and not _annotation(e):
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if b > w0 and a < w1:
                kernels.append((e.name, max(a, w0), min(b, w1)))
    busy = _union([[a, b] for _, a, b in kernels])
    busy_s = sum(b - a for a, b in busy)
    by_name = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    cpu = [e for e in events if e.device_type == DeviceType.CPU and e.name != STEP_SPAN]
    spans = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
                   for e in cpu if e.name.startswith("bench."))
    ops = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
                 for e in cpu if not e.name.startswith("bench."))
    gaps, at = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > at:
            t = 0.5 * (at + a)
            name = f"{_open_at(spans, t, 'between steps')}/{_open_at(ops, t, 'python')}"
            gaps.setdefault(name, []).append(a - at)
        at = max(at, b)
    return {"window_s": w1 - w0, "busy_s": busy_s, "steps": len(steps), "kernels": kernels,
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, sum(v)] for n, v in gaps.items()),
                                key=lambda x: -x[1])[:top]}


def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("bench.")


def _open_at(spans: list, t: float, none: str) -> str:
    """The innermost of the nested (start, end, name) spans, sorted by
    start, that is open at ``t``: the last to start before ``t`` that ends
    after it."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    for j in range(i, -1, -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return none
