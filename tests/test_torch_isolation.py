"""The port stands alone: no jax, nothing of ``repro``, no CPU fallback.

* An AST scan of every file under ``src/repro_torch/`` and of
  ``chip_smoke.py`` finds no import of ``jax`` and none of ``repro`` /
  ``repro.*``.
* A subprocess in which ``jax`` and ``repro`` cannot be imported at all
  imports ``repro_torch`` and runs a tiny CPU grid; afterwards
  ``sys.modules`` holds neither.
* Without CUDA, an entry point called without ``device=`` raises instead
  of running on the CPU.
* The constants the port re-declares equal the reference's.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"batch_torch.py", "event_step.py", "chip_smoke.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_NO_JAX = r"""
import importlib.abc
import sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import repro_torch
from repro_torch.core.simulator import ThresholdTrust
from repro_torch.core.traces import Exponential, make_event_trace
from repro_torch.core.waste import Platform

traces = [make_event_trace(Exponential(1.0), 2500.0, 0.7, 0.6, 40000.0,
                           np.random.default_rng(s)) for s in (1, 2)]
res = repro_torch.simulate_batch(
    traces, Platform(mu=2500.0, c=60.0, d=10.0, r=30.0), 10000.0,
    [1200.0, 2000.0], cp=30.0, trust=ThresholdTrust(100.0),
    inexact_window=300.0, trace_seeds=[3, 4], device="cpu")
assert res.makespan.shape == (2, 2) and (res.makespan > 10000.0).all()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("ISOLATED-OK")
"""


def test_runs_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ISOLATED-OK" in proc.stdout


def _entry_points():
    import numpy as np

    from repro_torch.core.batch import simulate_batch, simulate_lanes
    from repro_torch.core.batch_torch import run_lanes_torch
    from repro_torch.core.policies import Strategy
    from repro_torch.core.simulator import NeverTrust
    from repro_torch.core.traces import EventTrace
    from repro_torch.core.waste import Platform
    from repro_torch.experiments import evaluate_strategies

    plat = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    trace = EventTrace(np.array([500.0]), np.zeros(1, dtype=np.int8), 1e5)
    return {
        "simulate_batch": lambda: simulate_batch([trace], plat, 1000.0,
                                                 [600.0]),
        "simulate_lanes": lambda: simulate_lanes(
            [trace], plat, 1000.0, cp=30.0, trace_indices=[0],
            periods=[600.0], trusts=[NeverTrust()], windows=[0.0],
            seeds=[0]),
        "evaluate_strategies": lambda: evaluate_strategies(
            [trace], plat, 1000.0, 30.0,
            [Strategy("s", 600.0, NeverTrust())]),
        "run_lanes_torch": lambda: run_lanes_torch(
            None, plat, 1000.0, np.zeros(1, np.int64), np.full(1, 600.0),
            np.zeros(1, np.int8), np.zeros(1), np.zeros(1),
            np.zeros(1, np.int64), 30.0),
    }


@pytest.mark.parametrize("entry", ["simulate_batch", "simulate_lanes",
                                   "evaluate_strategies", "run_lanes_torch"])
def test_no_silent_cpu_fallback(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[entry]()


def test_default_device_is_cuda(monkeypatch):
    from repro_torch import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device().type == "cuda"
    assert resolve_device("cpu").type == "cpu"


def test_redeclared_constants_match_reference():
    pytest.importorskip("jax")
    import repro.core.batch as ref_batch
    import repro.core.batch_jax as ref_bj
    import repro.core.simulator as ref_sim
    import repro.core.traces as ref_traces
    import repro.kernels.event_step as ref_es

    import repro_torch.core.batch as batch
    import repro_torch.core.batch_torch as bt
    import repro_torch.core.simulator as sim
    import repro_torch.core.traces as traces
    import repro_torch.kernels.event_step as es

    assert es.F_FIELDS == ref_es.F_FIELDS and es.I_FIELDS == ref_es.I_FIELDS
    assert (es.N_F, es.N_I) == (ref_es.N_F, ref_es.N_I) == (23, 12)
    for name in [n for n in dir(ref_es) if n[:2] in ("F_", "I_")
                 and n not in ("F_FIELDS", "I_FIELDS")]:
        assert getattr(es, name) == getattr(ref_es, name), name
    phases = ("_WORK", "_CKPT", "_PROCKPT", "_DOWN", "_RECOVER", "_VERIFY")
    for name in phases:
        assert getattr(sim, name) == getattr(ref_sim, name) \
            == getattr(es, name) == getattr(ref_es, name), name
    for name in ("FAULT_UNPRED", "FAULT_PRED", "FALSE_PRED", "SILENT"):
        assert getattr(traces, name) == getattr(ref_traces, name), name
    assert sim.WINDOW_MODES == ref_sim.WINDOW_MODES
    codes = ("_TRUST_NEVER", "_TRUST_ALWAYS", "_TRUST_THRESHOLD",
             "_TRUST_FIXED_Q", "_WMODE_INSTANT", "_WMODE_WITHIN")
    for name in codes:
        assert getattr(batch, name) == getattr(ref_batch, name) \
            == getattr(bt, name) == getattr(ref_bj, name), name
    for name in ("_PC_POP", "_PC_FAULT", "_PC_PRED", "_PC_FINAL",
                 "_PC_SILENT", "_DEF_SLOTS", "_ADV_PASSES", "_BIG_SEQ"):
        assert getattr(bt, name) == getattr(ref_bj, name), name
