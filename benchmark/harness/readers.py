"""What the per-layer metric readers (``metrics/<name>.py``) share: the
traced run's record is a dict with the cell's ``config`` and ``mix``, the
stage ``marks`` (``trace.Marks``, None off the card), ``window_peak_bytes``,
``dispatch_s`` (serving) and ``profile`` (``trace.reduce_profile``). Every
reader returns a number, or None where the record holds nothing to read."""

from __future__ import annotations

import importlib

from ..roofline import peaks


def stage_ms(rec: dict, a: str, b: str):
    marks = rec.get("marks")
    return marks.stage_ms(a, b) if marks is not None else None


def step_s(rec: dict):
    """The traced window's mean wall time a step."""
    prof = rec.get("profile") or {}
    return prof["window_s"] / prof["steps"] if prof.get("steps") else None


def idle_share(rec: dict):
    prof = rec.get("profile") or {}
    return 1.0 - prof["busy_s"] / prof["window_s"] if prof.get("window_s") else None


def kernel_time(rec: dict, pattern: str) -> tuple:
    """(launches, device seconds) of the profiled kernels whose name holds
    ``pattern``."""
    hits = [(b - a) for name, a, b in (rec.get("profile") or {}).get("kernels", [])
            if pattern in name]
    return len(hits), sum(hits)


def roofline_pct(rec: dict, pattern: str, bound_s_per_launch: float):
    """Sum of the launches' bounds over their device time, in percent."""
    n, dev_s = kernel_time(rec, pattern)
    return 100.0 * n * bound_s_per_launch / dev_s if n and dev_s > 0 else None


def mfu_pct(rec: dict):
    """The step's least time at the peaks of its parts' precisions over its
    measured wall time, in percent."""
    s = step_s(rec)
    if not s:
        return None
    cfg = rec["config"]
    model = importlib.import_module(f"benchmark.roofline.model_{cfg['name']}")
    ideal = sum(ops / peaks.PEAK[p] for _, ops, p in model.parts(cfg, rec["mix"]))
    return 100.0 * ideal / s


def peak_gib(rec: dict):
    b = rec.get("window_peak_bytes")
    return b / 2 ** 30 if b else None
