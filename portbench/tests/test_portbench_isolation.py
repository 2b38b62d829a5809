"""What the benchmark may import and read.

Nothing under ``portbench/`` imports JAX, flax, the JAX package ``repro``
or its old ``benchmarks``: top-level names are compared whole, since the
port's ``repro_torch`` begins with ``repro``.  The reference imports
nothing of the program.  No file names a path under ``benchmarks/`` or
the JAX package's ``BENCH_simulator.json``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_sources_found():
    assert PB / "run.py" in SOURCES and len(SOURCES) > 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.relative_to(PB).parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "math", "os", "heapq", "types", "concurrent",
               "numpy"}
    assert _imports(path) <= allowed


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.name != Path(__file__).name],
    ids=lambda p: str(p.relative_to(PB)))
def test_no_path_into_the_jax_benchmark(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks/" not in node.value
            assert "BENCH_simulator" not in node.value


def test_cells_load_with_jax_and_repro_blocked():
    """Every cell's harness, driver, readers and the port's study path
    import in a process where importing a banned name raises."""
    code = f"""
import sys
BANNED = {sorted(BANNED)!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]
import json, pathlib
from portbench import harness
root = pathlib.Path({str(REPO)!r})
for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]:
    harness.load_cell(root, w["name"])
import repro_torch.experiments, repro_torch.core.traces
from portbench.reference import control, judge
print(harness.banned_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
