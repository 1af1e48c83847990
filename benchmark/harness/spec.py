"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration file, traffic mix and metrics;
``mixes/<traffic>.json``, ``limits/<cell>.json`` and ``metrics/<name>.py``
sit beside this package. The harness keeps no table of its own."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import a file by its path (metric readers carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Cell:
    """One entry of ``workloads`` with its configuration, mix and limits."""

    def __init__(self, name: str, bench: dict | None = None, root: Path = ROOT):
        bench = bench if bench is not None else benchmark(root)
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(root / configs[self.entry["config"]]["file"])
        self.mix = load_json(BENCH_DIR / "mixes" / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if m["moves"] in reported and applies(m, name)]

    def reader(self, metric: dict):
        """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
        path = BENCH_DIR / "metrics" / f"{metric['name']}.py"
        return load_module(path, f"bench_metric_{metric['name'].replace('.', '_')}").read

    def driver(self):
        """The mix's driver, ``drivers/<driver>.py``."""
        return importlib.import_module(f"benchmark.drivers.{self.mix['driver']}")
