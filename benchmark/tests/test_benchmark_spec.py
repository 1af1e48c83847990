"""BENCHMARK.json keeps to the benchmark's contract, and every file a cell
names is found by name: configuration, mix, driver, limits, metric readers."""

import json
import math
import re
from pathlib import Path

import pytest

from benchmark.harness.spec import BENCH_DIR, ROOT, Cell, applies, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
BENCH = benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_text_ok(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_text():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w["config"]) and NAME.match(w["traffic"]) for w in BENCH["workloads"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert _text_ok(c["source"]) and _text_ok(c["why"])
    assert all(_text_ok(w["why"]) for w in BENCH["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(_text_ok(m["layer"]) for m in BENCH["per_layer"])


def test_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    assert all(m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
               for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_chips_and_budget():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    # a full check of 24 cells has to fit: 2 + 14 * 24 runs, 180 s of compile a cell
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    """Every cell reports setup_s, another end-to-end metric and a per-layer
    metric; every per-layer metric's ``moves`` is reported in its cells."""
    c = Cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in BENCH["per_layer"]:
        if applies(m, cell) and "workloads" in m:
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = Cell(cell)
    cfg_entry = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert Path(ROOT / cfg_entry["file"]).is_file()
    assert cfg_entry["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert c.config["name"] == cfg_entry["name"] and c.config["reduced"] == cfg_entry["reduced"]
    assert (BENCH_DIR / "drivers" / f"{c.mix['driver']}.py").is_file()
    assert callable(c.driver().run)
    assert c.limits and all(v > 0 and math.isfinite(v) for v in c.limits.values())
    for m in c.per_layer:
        assert callable(c.reader(m))
    assert (BENCH_DIR / "roofline" / f"model_{c.config['name']}.py").is_file()


def test_config_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        json.loads((ROOT / f).read_text())
