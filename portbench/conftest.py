"""pytest settings of the benchmark's own tests (``python -m pytest -q
portbench/tests`` from the repo root)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and nvcc; skips without them")
