"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module name (``avvad_tpu_torch`` is not ``avvad_tpu``), and
the plain reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.spec import BENCH_DIR, ROOT
from benchmark.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "avvad_tpu_torch" not in top_level_imports(path)
    assert not any(n.module and "drivers" in n.module or n.level > 1
                   for n in ast.walk(ast.parse(path.read_text()))
                   if isinstance(n, ast.ImportFrom))


def test_forbidden_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "avvad_tpu_torch_probe", sys)
    assert "avvad_tpu_torch_probe" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "avvad_tpu.models", sys)
    assert "avvad_tpu.models" in forbidden_modules()


def test_a_run_loads_no_jax():
    """What a run imports, the program's entries included, loads neither JAX
    nor the JAX package."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.drivers.serve, benchmark.drivers.train\n"
            "import benchmark.harness.readings\n"
            "import avvad_tpu_torch.export, avvad_tpu_torch.models, avvad_tpu_torch.train\n"
            "from avvad_tpu_torch.data import Batch\n"
            "from benchmark.run import forbidden_modules\n"
            "print(forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
