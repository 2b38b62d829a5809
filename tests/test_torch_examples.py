"""The port's copies of the five examples, run small on the CPU.

* ``quickstart_torch.py``: the analytic numbers of section 1 ``==`` the
  JAX package's functions on the same scenario; the experiment of section
  2 (through the scalar oracle, ``REPRO_ENGINE=scalar``) ``==`` the
  reference's ``run_experiment`` on the same spec, row for row; section 3
  trains its 60 steps.
* ``predictor_study_torch.py``: the analytic plane and both sensitivities
  ``==`` the reference's functions; the adaptive demo at one trace holds
  its own asserts (re-plans, the estimator sees the drift).
* ``trace_timeline_torch.py``: its Perfetto JSON is byte for byte the
  reference example's.
* ``serving_torch.py``: greedy decoding is deterministic and a sampled
  run differs from it, for all three families.
* ``fault_tolerant_training_torch.py``: ``flagship_cfg`` is the
  reference's config; phase 1 (the xLSTM-100M variant at its width, a few
  steps) and phase 2 hold their own asserts.

Tolerance: none where numbers are compared (the port's host functions are
bitwise the reference's).
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


def _ref_scenario(sc):
    from repro.experiments import ScenarioSpec as RefScenario
    return RefScenario.from_dict(sc.to_dict())


def test_quickstart_matches_reference(capsys, monkeypatch):
    from repro.core.exact import optimal_period_exact as ref_exact
    from repro.core.prediction import beta_lim as ref_beta_lim
    from repro.core.prediction import \
        optimal_period_with_prediction as ref_opt
    from repro.core.waste import t_rfo as ref_t_rfo
    from repro.core.waste import waste as ref_waste
    from repro.experiments import ExperimentSpec as RefExperiment
    from repro.experiments import build_strategy as ref_build
    from repro.experiments import run_experiment as ref_run

    qs = _load("quickstart_torch")
    monkeypatch.setenv("REPRO_ENGINE", "scalar")
    out = qs.main(device="cpu", steps=60, n_traces=2)
    assert "spec round-trips through JSON: True" in capsys.readouterr().out

    sc = _ref_scenario(qs.scenario(2))
    a = out["analytic"]
    assert a["mu"] == sc.platform.mu
    assert a["periods"] == {ref_build(n, sc).name: ref_build(n, sc).period
                            for n in ("young", "daly", "rfo")}
    assert a["rfo_waste"] == ref_waste(ref_t_rfo(sc.platform), sc.platform)
    assert (a["t_star"], a["w_star"], a["use_predictions"]) == ref_opt(sc.pp)
    assert a["beta_lim"] == ref_beta_lim(sc.pp)
    exact = ref_exact(sc.pp)
    assert (a["exact"].period, a["exact"].threshold, a["exact"].waste) \
        == (exact.period, exact.threshold, exact.waste)

    ref_exp = RefExperiment.from_dict(out["experiment"].to_dict())
    assert out["table"].rows == ref_run(ref_exp, engine="scalar").rows
    assert len(out["table"].rows) == 3

    stats = out["stats"]
    assert stats.n_steps == 60 and stats.total_time > 0
    assert stats.n_periodic > 0 and 0.0 < stats.waste < 1.0


def test_predictor_study_analytic_plane_matches_reference(capsys):
    from repro.core.prediction import \
        optimal_period_with_prediction as ref_opt
    from repro.core.waste import t_rfo as ref_t_rfo
    from repro.core.waste import waste as ref_waste
    from repro.experiments import ScenarioSpec as RefScenario
    from repro.experiments import SweepSpec as RefSweep

    ps = _load("predictor_study_torch")
    got = ps.analytic_plane()
    assert "invest in recall" in capsys.readouterr().out

    base = RefScenario(n=2 ** 16, c=600.0, d=60.0, r=600.0)
    assert got["w_nopred"] == ref_waste(ref_t_rfo(base.platform),
                                        base.platform)
    sweep = RefSweep(axes={"recall": ps.GRID, "precision": ps.GRID})
    want = {}
    for c, cell in sweep.cells(base):
        _, w, used = ref_opt(cell.pp)
        want[(c["recall"], c["precision"])] = (w, used)
    assert got["plane"] == want

    def w_at(r, p):
        return ref_opt(base.replace(recall=r, precision=p).pp)[1]
    r0, p0, eps = 0.7, 0.7, 0.05
    assert got["dr"] == (w_at(r0 + eps, p0) - w_at(r0 - eps, p0)) / (2 * eps)
    assert got["dp"] == (w_at(r0, p0 + eps) - w_at(r0, p0 - eps)) / (2 * eps)


def test_predictor_study_adaptive_demo():
    ps = _load("predictor_study_torch")
    got = ps.adaptive_demo(device="cpu", n_traces=1)   # asserts inside
    batch = got["batch"]
    assert batch.makespan.shape == (1, 1)
    assert int(batch.n_replans[0, 0]) >= 1
    assert all(m > 0 for m in got["makespans"])


def test_trace_timeline_bytes_match_reference(tmp_path, capsys):
    port = _load("trace_timeline_torch")
    ref = _load("trace_timeline")
    got = port.main(str(tmp_path / "port.json"))
    ref.main(str(tmp_path / "ref.json"))
    out = capsys.readouterr().out
    assert out.count("wrote ") == 2
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "ref.json").read_bytes()
    assert len(got["attributions"]) == port.N_JOBS


def test_serving_is_deterministic():
    sv = _load("serving_torch")
    out = sv.main(device="cpu", batch=2, prompt_len=16, n_new=8)
    assert list(out) == sv.ARCHS
    for arch, res in out.items():
        assert res["tokens"].shape == (2, 8), arch
        assert bool((res["logprobs"] <= 0).all()), arch
        assert res["sampled_differs"], arch


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
