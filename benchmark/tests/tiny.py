"""Tiny CPU versions of the cells for the benchmark's own tests: the cell's
configuration, mix and limits read by name, the widths and sizes cut so that
a run takes seconds on the CPU (the program's plain kernels)."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from benchmark.harness.spec import Cell

TINY_CONFIG = {"lstm_hidden_size": 32, "mcb_output_size": 64}
TINY_MIX = {"batch": 2, "frames": 16, "pool": 4, "profile_from_step": 1, "profile_steps": 2}


def tiny_cell(name: str, **mix_over) -> SimpleNamespace:
    cell = Cell(name)
    return SimpleNamespace(name=name, config={**cell.config, **TINY_CONFIG},
                           mix={**cell.mix, **TINY_MIX, **mix_over}, limits=cell.limits,
                           chips=cell.chips, driver=cell.driver)


def run_tiny(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.3, trace: bool = False,
             **mix_over) -> dict:
    """One run of the cell's driver on the CPU, the look for a card skipped."""
    cell = tiny_cell(name, **mix_over)
    ctx = SimpleNamespace(cell=cell, seed=seed, seconds=seconds, trace=trace,
                          device=torch.device("cpu"), t0=time.perf_counter())
    return cell.driver().run(ctx)
