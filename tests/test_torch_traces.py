"""The port's host-side models against the JAX package's, bitwise.

* ``ScenarioSpec(...).make_trace(i)``: times, kinds and windows equal the
  reference's for Exponential and Weibull faults, per-processor and
  platform-level streams, prediction windows and the silent stream (the
  other distributions and the predictor models:
  ``tests/test_torch_predictors.py``).
* ``t_rfo``, ``beta_lim`` and ``optimal_period_with_prediction`` (both
  cadences) return the same floats.
* ``evaluate_strategies`` on the CPU returns the reference's mean
  makespans (and so its waste) for rfo, optimal_prediction and the
  BestPeriod search over rfo; its steps compose, and a pass over a subset
  of the bank's traces gives those columns of the whole pass.

Tolerance: none.  The port copies the host code operation for
operation, and the lane engine is bitwise the numpy engine.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# repro.core re-exports functions named like its modules (``waste``), so
# the modules are taken by name.
ref_policies = importlib.import_module("repro.core.policies")
ref_prediction = importlib.import_module("repro.core.prediction")
ref_waste = importlib.import_module("repro.core.waste")

from repro.experiments import ScenarioSpec as RefScenario  # noqa: E402
from repro.experiments.runner import best_period_search as ref_bps  # noqa: E402
from repro.experiments.runner import evaluate_strategies as ref_eval  # noqa: E402

from repro_torch.core import policies, prediction, waste  # noqa: E402
from repro_torch.core.traces import traces_from_numpy  # noqa: E402
from repro_torch.experiments import (BestPeriodSearch, ScenarioSpec,  # noqa: E402
                                     best_means, candidate_makespans,
                                     evaluate_strategies, expand_candidates)

SCENARIOS = {
    "exponential": dict(n=4096, time_base_years_total=100.0),
    "weibull": dict(n=4096, time_base_years_total=100.0,
                    dist={"name": "weibull", "params": {"shape": 0.7}}),
    "platform_stream": dict(n=4096, time_base_years_total=100.0,
                            per_processor=False),
    "window": dict(n=4096, time_base_years_total=100.0, window=900.0),
    "silent": dict(n=4096, time_base_years_total=100.0,
                   silent_mu_ind=2.0e8, verify_cost=120.0, keep_ckpts=2),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("index", [0, 3])
def test_make_trace_matches_reference(name, index):
    kw = SCENARIOS[name]
    ref = RefScenario(**kw).make_trace(index)
    got = ScenarioSpec(**kw).make_trace(index)
    assert got.horizon == ref.horizon
    assert got.times.dtype == np.float64 and got.kinds.dtype == np.int8
    assert (got.times == ref.times).all() and (got.kinds == ref.kinds).all()
    if ref.windows is None:
        assert got.windows is None
    else:
        assert (got.windows == ref.windows).all()
    assert ref.times.size > 10
    if name == "silent":
        assert ref.n_silent > 0


def test_scenario_defaults_match_reference():
    ref, got = RefScenario(), ScenarioSpec()
    for f in dataclasses.fields(got):
        want = getattr(ref, f.name)
        have = getattr(got, f.name)
        if f.name in ("dist", "false_pred_dist") and want is not None:
            assert (have.name, dict(have.params)) == \
                (want.name, dict(want.params))
        else:
            assert have == want, f.name
    for prop in ("mu", "cp", "time_base", "horizon"):
        assert getattr(got, prop) == getattr(ref, prop), prop


def test_unported_scenarios_raise():
    """What is still unported raises: the strategies of ROADMAP A4 by
    name; an unknown name or model order is refused as the reference
    refuses it."""
    from repro_torch.experiments import build_strategy
    for name in ("young", "nopred", "prediction", "window_proactive",
                 "silent_verify", "dynamic_rfo"):
        with pytest.raises(NotImplementedError, match="A4"):
            build_strategy(name, ScenarioSpec())
    with pytest.raises(KeyError):
        build_strategy("no_such_strategy", ScenarioSpec())
    with pytest.raises(ValueError):
        ScenarioSpec(model_order="second")
    with pytest.raises(KeyError):
        ScenarioSpec(dist={"name": "no_such_dist"}).make_trace(0)


PLATFORMS = [(60150.0, 600.0, 60.0, 600.0), (2500.0, 60.0, 10.0, 30.0),
             (800.0, 600.0, 60.0, 600.0)]
PREDICTORS = [(0.85, 0.82, 600.0), (0.5, 0.3, 60.0), (0.99, 0.999, 30.0),
              (1.0, 0.9, 600.0)]


@pytest.mark.parametrize("plat", PLATFORMS)
def test_first_order_periods_match(plat):
    mu, c, d, r = plat
    got = waste.Platform(mu=mu, c=c, d=d, r=r)
    ref = ref_waste.Platform(mu=mu, c=c, d=d, r=r)
    assert waste.t_rfo(got) == ref_waste.t_rfo(ref)
    assert waste.t_young(got) == ref_waste.t_young(ref)
    assert waste.t_daly(got) == ref_waste.t_daly(ref)
    assert waste.waste(2 * c, got) == ref_waste.waste(2 * c, ref)


@pytest.mark.parametrize("plat", PLATFORMS)
@pytest.mark.parametrize("pred", PREDICTORS)
@pytest.mark.parametrize("cadence", ["restart", "continue"])
def test_prediction_plans_match(plat, pred, cadence):
    mu, c, d, r = plat
    recall, precision, cp = pred
    got = prediction.PredictedPlatform(
        waste.Platform(mu=mu, c=c, d=d, r=r),
        prediction.Predictor(recall, precision), cp)
    ref = ref_prediction.PredictedPlatform(
        ref_waste.Platform(mu=mu, c=c, d=d, r=r),
        ref_prediction.Predictor(recall, precision), cp)
    assert prediction.beta_lim(got) == ref_prediction.beta_lim(ref)
    assert prediction.optimal_period_with_prediction(got, cadence=cadence) \
        == ref_prediction.optimal_period_with_prediction(ref,
                                                         cadence=cadence)
    s, s_ref = policies.optimal_prediction(got), \
        ref_policies.optimal_prediction(ref)
    assert (s.period, type(s.trust).__name__) == \
        (s_ref.period, type(s_ref.trust).__name__)


def test_evaluate_strategies_matches_reference():
    """rfo, optimal_prediction and BestPeriod(rfo) on a small scenario:
    the same means, hence the same waste, from one lane pass."""
    # mu = mu_ind / n is the paper's 2^16-processor platform MTBF, so each
    # trace carries faults and predictions for the strategies to differ on.
    kw = dict(n=4096, mu_ind=3.942e9 / 16, time_base_years_total=100.0,
              n_traces=3, seed=2)
    ref_sc, sc = RefScenario(**kw), ScenarioSpec(**kw)
    ref_traces = ref_sc.make_traces()
    traces = traces_from_numpy([t.times for t in ref_traces],
                               [t.kinds for t in ref_traces],
                               [t.horizon for t in ref_traces])
    ref_rfo = ref_policies.rfo(ref_sc.platform)
    ref_opt = ref_policies.optimal_prediction(ref_sc.pp)
    want = ref_eval(ref_traces, ref_sc.platform, ref_sc.time_base,
                    ref_sc.cp, [ref_rfo, ref_opt], seed=sc.seed,
                    engine="batch")
    _, want_best = ref_bps(ref_rfo, ref_traces, ref_sc.platform,
                           ref_sc.time_base, ref_sc.cp, seed=sc.seed,
                           engine="batch")
    got = evaluate_strategies(
        traces, sc.platform, sc.time_base, sc.cp,
        [policies.rfo(sc.platform), policies.optimal_prediction(sc.pp),
         BestPeriodSearch(policies.rfo(sc.platform))],
        seed=sc.seed, device="cpu")
    assert got == want + [want_best]
    assert got[2] <= got[0]     # BestPeriod never loses to its base
    assert got[1] != got[0]     # the predictor changed the outcome
    waste_got = [1.0 - sc.time_base / m for m in got]
    waste_ref = [1.0 - ref_sc.time_base / m for m in want + [want_best]]
    assert waste_got == waste_ref


def test_trace_subset_is_those_columns_of_the_whole():
    """``candidate_makespans`` over some of the bank's traces returns those
    columns of the pass over all of them, bit for bit; rfo and the grid of
    BestPeriod(rfo) share the rfo lane; the three steps are
    ``evaluate_strategies``."""
    sc = ScenarioSpec(n=4096, mu_ind=3.942e9 / 16,
                      time_base_years_total=100.0, n_traces=3, seed=2)
    traces = sc.make_traces()
    base = policies.rfo(sc.platform)
    strategies = [base, policies.optimal_prediction(sc.pp),
                  BestPeriodSearch(base, n_points=4)]
    unique, rows = expand_candidates(strategies, sc.platform)
    assert rows[:2] == [[0], [1]]
    assert 0 in rows[2] and len(unique) == len(rows[2]) + 1
    args = (traces, sc.platform, sc.time_base, sc.cp, unique)
    whole = candidate_makespans(*args, seed=sc.seed, device="cpu")
    part = candidate_makespans(*args, seed=sc.seed, trace_indices=[2, 0],
                               device="cpu")
    assert whole.shape == (len(unique), 3) and part.shape == (len(unique), 2)
    assert (part == whole[:, [2, 0]]).all()
    assert best_means(whole, rows) == evaluate_strategies(
        traces, sc.platform, sc.time_base, sc.cp, strategies, seed=sc.seed,
        device="cpu")
