"""The comparison that decides ``correct``: the numbers read from the
program's outputs against the reference's, each held to its limit
(``limits/<cell>.json``; how each limit was set is in PERF.md)."""

from __future__ import annotations

import math

import torch


def serve_numbers(outputs: list, batch_ids: list, ref_probs: dict, limits: dict) -> tuple:
    """Every served answer against the reference's probabilities of its batch
    -> ({"prob_gap_p50": the largest median |p - p_ref| of a step,
    "prob_gap_row_mean": the largest mean |p - p_ref| over the frames of one
    utterance, "prob_gap_max": the widest |p - p_ref| of any frame}, the
    number of steps whose answers break a limit or are malformed). A number
    without a limit is reported, not judged."""
    numbers = {"prob_gap_p50": 0.0, "prob_gap_row_mean": 0.0, "prob_gap_max": 0.0}
    failed = 0
    for out, i in zip(outputs, batch_ids):
        ref = ref_probs[i]
        if out.shape != ref.shape or not torch.isfinite(out).all():
            step = dict.fromkeys(numbers, math.inf)
        else:
            gap = (out.float() - ref).abs()
            step = {"prob_gap_p50": float(gap.median()),
                    "prob_gap_row_mean": float(gap.flatten(1).mean(dim=1).max()),
                    "prob_gap_max": float(gap.max())}
        failed += any(not v <= limits.get(k, math.inf) for k, v in step.items())
        for k, v in step.items():
            numbers[k] = max(numbers[k], v)
    return numbers, failed


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gap(prog: dict, refr: dict, keep: list) -> float:
    """Worst leaf: | |prog| - |ref| | over max(|ref| of the leaf, the median
    leaf's |ref|), the norms taken per leaf over the leaves in ``keep``."""
    norms = {k: _norm(refr[k]) for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(_norm(prog[k]) - norms[k]) / max(norms[k], med) for k in keep)


def moving_leaves(grads1: dict, floor: float = 1e-3) -> list:
    """Leaves whose first reference gradient is above ``floor`` times the
    median leaf's norm: the rest move under Adam by round-off alone."""
    norms = {k: _norm(g) for k, g in grads1.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n > floor * med]


def train_numbers(prog: dict, refr: dict, w0: dict) -> dict:
    """``prog`` / ``refr``: {"losses", "grads1", "params"} of the first
    steps (``reference.train.run``'s form; the program's first gradient
    read back from Adam's first moment after one step) -> {"loss_gap":
    the widest relative loss gap of a step, "grad_norm_gap": the worst
    leaf's first-gradient norm gap, "update_norm_gap": the worst leaf's
    gap of the norm of its change over the steps}."""
    loss = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(prog["losses"], refr["losses"]))
    if len(prog["losses"]) != len(refr["losses"]) or not all(map(math.isfinite, prog["losses"])):
        loss = math.inf
    keep = moving_leaves(refr["grads1"])
    d_prog = {k: prog["params"][k].float() - w0[k].float() for k in keep}
    d_ref = {k: refr["params"][k].float() - w0[k].float() for k in keep}
    return {"loss_gap": loss,
            "grad_norm_gap": leaf_gap(prog["grads1"], refr["grads1"], keep),
            "update_norm_gap": leaf_gap(d_prog, d_ref, keep),
            "leaves_compared": len(keep), "leaves": len(refr["grads1"])}


def late_numbers(prog: dict, refr: dict, start: dict) -> dict:
    """One step after the window from the program's state there, ``start``
    ({leaf: value}); ``prog`` / ``refr`` as in ``train_numbers``, with the
    program's gradient read back from Adam's first moment -> {"late_loss_gap",
    "late_grad_norm_gap", "late_update_norm_gap"}, each as the first steps'
    number."""
    (lp,), (lr,) = prog["losses"], refr["losses"]
    loss = abs(lp - lr) / max(abs(lr), 1e-12) if math.isfinite(lp) else math.inf
    keep = moving_leaves(refr["grads1"])
    d_prog = {k: prog["params"][k].float() - start[k].float() for k in keep}
    d_ref = {k: refr["params"][k].float() - start[k].float() for k in keep}
    return {"late_loss_gap": loss,
            "late_grad_norm_gap": leaf_gap(prog["grads1"], refr["grads1"], keep),
            "late_update_norm_gap": leaf_gap(d_prog, d_ref, keep)}


def judge(numbers: dict, limits: dict) -> tuple:
    """-> (correct, [[name, value, limit], ...]): every number at or under
    its limit, and finite."""
    checks = [[k, numbers[k], limits[k]] for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks
