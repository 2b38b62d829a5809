"""The port's training examples and the predictor study's adaptive demo,
run small on the CPU (moved from ``tests/test_torch_examples.py`` so that
``--dist loadfile`` runs the two halves on two workers).

* ``predictor_study_torch.py``: the adaptive demo at one trace holds its
  own asserts (re-plans, the estimator sees the drift).
* ``fault_tolerant_training_torch.py``: ``flagship_cfg`` is the
  reference's config; phase 1 (the xLSTM-100M variant at its width, a few
  steps) and phase 2 hold their own asserts.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name: str):
    """An example script as a module (``examples/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _serial_oracle(monkeypatch):
    # The scalar oracle runs in this process (no spawn pool) in both
    # packages.
    monkeypatch.setenv("REPRO_EXPERIMENT_WORKERS", "0")


def test_predictor_study_adaptive_demo():
    ps = _load("predictor_study_torch")
    got = ps.adaptive_demo(device="cpu", n_traces=1)   # asserts inside
    batch = got["batch"]
    assert batch.makespan.shape == (1, 1)
    assert int(batch.n_replans[0, 0]) >= 1
    assert all(m > 0 for m in got["makespans"])


def test_flagship_cfg_matches_reference():
    spec = importlib.util.spec_from_file_location(
        "_example_ft_ref", EXAMPLES / "fault_tolerant_training.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    ft = _load("fault_tolerant_training_torch")
    mine, theirs = ft.flagship_cfg(), ref.flagship_cfg()
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (mine.head_dim, mine.remat, mine.d_model, mine.n_layers) \
        == (224, False, 896, 10)
    assert mine.param_count() == theirs.param_count()


def test_fault_tolerant_training_phase1():
    ft = _load("fault_tolerant_training_torch")
    got = ft.phase1(4, device="cpu")                # loss assert inside
    assert got["stats"].n_steps == 4
    assert got["stats"].final_loss < got["first_loss"]


def test_fault_tolerant_training_phase2():
    ft = _load("fault_tolerant_training_torch")
    got = ft.phase2(40, device="cpu")               # waste assert inside
    assert list(got) == ["Young", "RFO", "OptimalPrediction"]
    assert all(s.n_faults > 0 and s.n_rollbacks > 0 for s in got.values())
    # the predictor's path: proactive (delta-quantized) saves
    assert got["OptimalPrediction"].n_proactive > 0
    assert got["RFO"].n_proactive == got["Young"].n_proactive == 0
    assert got["OptimalPrediction"].waste <= got["RFO"].waste + 0.02
