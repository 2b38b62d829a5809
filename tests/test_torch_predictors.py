"""The port's predictor study against the JAX package's, bitwise.

* Each generative predictor model (oracle, lead_time, drifting, bursty)
  and each trace distribution (exponential, weibull, uniform, lognormal,
  empirical, lanl) gives the reference's traces at two seeds, through
  ``make_event_trace`` and through ``ScenarioSpec``.
* ``ScenarioSpec(predictor=...)`` and ``ScenarioSpec(model_order="exact")``
  give the reference's banks and plans; ``build_strategy`` builds the
  reference's rfo, optimal_prediction, adaptive, fixed_period and
  best_period.
* The study as a whole, small: ``benchmarks/predictor_sweep.py``'s five
  predictor cells x rfo, optimal_prediction and adaptive through
  ``evaluate_strategies`` on the CPU, the reference's means; and its
  convergence cell (stale prior) at the reference's quick size, every
  ``BatchResult`` field the numpy lanes', with the script's own claims.

Tolerance: none (``==``), except the convergence claims, which are the
reference script's own bounds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.predictor_sweep import STALE_PRIOR, predictor_axis  # noqa: E402
from repro.core import traces as ref_traces  # noqa: E402
from repro.core.batch import simulate_batch as ref_simulate_batch  # noqa: E402
from repro.experiments import PredictorSpec as RefPredictorSpec  # noqa: E402
from repro.experiments import ScenarioSpec as RefScenario  # noqa: E402
from repro.experiments import build_strategy as ref_build  # noqa: E402
from repro.experiments import evaluate_strategies as ref_eval  # noqa: E402
from repro.predictors import build_predictor as ref_build_predictor  # noqa: E402

from repro_torch.core import traces  # noqa: E402
from repro_torch.core.batch import simulate_batch  # noqa: E402
from repro_torch.core.prediction import (beta_lim,  # noqa: E402
                                         optimal_period_with_prediction)
from repro_torch.experiments import (BestPeriodSearch, PredictorSpec,  # noqa: E402
                                     ScenarioSpec, build_strategy,
                                     evaluate_strategies, list_strategies)
from repro_torch.predictors import build_predictor, list_predictors  # noqa: E402

MODELS = {
    "oracle": {},
    "lead_time": dict(lead_mean=3600.0, min_lead=600.0),
    "lead_time_weibull": dict(lead_mean=1800.0, min_lead=60.0,
                              lead_dist={"name": "weibull",
                                         "params": {"shape": 0.7}}),
    "drifting": dict(recall_end=0.6, precision_end=0.25,
                     drift_start=5e4, drift_span=2e5),
    "drifting_default_span": dict(precision_end=0.5),
    "bursty": dict(burst_size=4.0, burst_gap=900.0),
}


def _same_trace(got, want) -> None:
    assert got.horizon == want.horizon
    assert got.times.dtype == np.float64 and got.kinds.dtype == np.int8
    assert (got.times == want.times).all() and (got.kinds == want.kinds).all()
    if want.windows is None:
        assert got.windows is None
    else:
        assert (got.windows == want.windows).all()


def test_registered_models():
    assert list_predictors() == ["bursty", "drifting", "lead_time", "oracle"]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_predictor_model_traces_match_reference(name, seed):
    kind = name.split("_weibull")[0].split("_default")[0]
    params = MODELS[name]
    mu, horizon = 2500.0, 4e5
    want = ref_traces.make_event_trace(
        ref_traces.Exponential(1.0), mu, 0.7, 0.6, horizon,
        np.random.default_rng(seed),
        predictor_model=ref_build_predictor(kind, 0.7, 0.6, **params))
    got = traces.make_event_trace(
        traces.Exponential(1.0), mu, 0.7, 0.6, horizon,
        np.random.default_rng(seed),
        predictor_model=build_predictor(kind, 0.7, 0.6, **params))
    _same_trace(got, want)
    assert (want.kinds == traces.FALSE_PRED).sum() > 10


DISTS = {
    "exponential": {},
    "weibull": {"shape": 0.7},
    "uniform": {},
    "lognormal": {"sigma": 1.2},
    "empirical": {"samples": [1.0, 2.0, 5.0, 13.0]},
    "lanl": {"n_intervals": 500, "seed": 7},
}


@pytest.mark.parametrize("index", [0, 3])
@pytest.mark.parametrize("per_processor", [True, False],
                         ids=["per_processor", "platform"])
@pytest.mark.parametrize("dist", sorted(DISTS))
def test_distribution_traces_match_reference(dist, per_processor, index):
    kw = dict(n=1024, time_base_years_total=20.0,
              per_processor=per_processor, start=0.0,
              dist={"name": dist, "params": DISTS[dist]},
              false_pred_dist={"name": "uniform"})
    want = RefScenario(**kw).make_trace(index)
    got = ScenarioSpec(**kw).make_trace(index)
    _same_trace(got, want)
    assert want.times.size > 5


def test_lanl_log_matches_reference():
    want = ref_traces.lanl_like_log(np.random.default_rng(3), 200)
    got = traces.lanl_like_log(np.random.default_rng(3), 200)
    assert got.samples == want.samples and got.mean == want.mean
    assert got.rescaled(50.0).samples == want.rescaled(50.0).samples


def _sweep_scenario(**kw) -> dict:
    # mu = mu_ind / n is the paper's 2^16-processor platform MTBF, so a
    # short job sees enough faults and predictions to re-plan on.
    return dict(n=4096, mu_ind=3.942e9 / 16, time_base_years_total=100.0,
                n_traces=2, seed=2, **kw)


@pytest.mark.parametrize("cell", range(5), ids=["oracle", "lead_time",
                                                "bursty", "drift_slow",
                                                "drift_fast"])
def test_predictor_axis_banks_match_reference(cell):
    """The sweep's predictor cells: PredictorSpec through ScenarioSpec."""
    ref_sc = RefScenario(**_sweep_scenario())
    spec = predictor_axis(ref_sc)[cell]
    ref_sc = dataclasses.replace(ref_sc, predictor=spec)
    sc = ScenarioSpec(**_sweep_scenario(), predictor=spec.to_dict())
    assert isinstance(sc.predictor, PredictorSpec)
    assert sc.predictor.to_dict() == RefPredictorSpec.from_dict(
        spec.to_dict()).to_dict()
    for i in range(2):
        _same_trace(sc.make_trace(i), ref_sc.make_trace(i))


@pytest.mark.parametrize("order", ["first", "exact"])
def test_registered_strategies_match_reference(order):
    kw = _sweep_scenario(model_order=order)
    ref_sc, sc = RefScenario(**kw), ScenarioSpec(**kw)
    assert sc.model_order == order
    assert list_strategies() == ["adaptive", "best_period", "fixed_period",
                                 "optimal_prediction", "rfo"]
    cases = [("rfo", {}), ("optimal_prediction", {}), ("adaptive", {}),
             ("adaptive", dict(STALE_PRIOR)),
             ("adaptive", dict(halflife=48.0, min_preds=8, min_faults=4,
                               model_order="exact")),
             ("fixed_period", dict(period=5000.0)),
             ("fixed_period", dict(period=5000.0, trust_threshold=700.0))]
    for name, params in cases:
        want, got = ref_build(name, ref_sc, **params), \
            build_strategy(name, sc, **params)
        assert (got.name, got.period, type(got.trust).__name__,
                vars(got.trust)) == (want.name, want.period,
                                     type(want.trust).__name__,
                                     vars(want.trust)), name
        assert (None if got.adaptive is None else got.adaptive.key()) == \
            (None if want.adaptive is None else want.adaptive.key())
    want = ref_build("best_period", ref_sc, base="adaptive", n_points=6)
    got = build_strategy("best_period", sc, base="adaptive", n_points=6)
    assert isinstance(got, BestPeriodSearch)
    assert (got.n_points, got.span, got.base.period,
            got.base.adaptive.key()) == (want.n_points, want.span,
                                         want.base.period,
                                         want.base.adaptive.key())


def test_predictor_sweep_cells_match_reference():
    """Five predictor cells x (rfo, optimal_prediction, adaptive): the
    port's evaluate_strategies on the CPU gives the reference's means."""
    kw = dict(_sweep_scenario(), time_base_years_total=400.0)
    base = RefScenario(**kw)
    replans = 0
    for spec in predictor_axis(base):
        ref_sc = dataclasses.replace(base, predictor=spec)
        sc = ScenarioSpec(**kw, predictor=spec.to_dict())
        ref_bank = ref_sc.make_traces()
        bank = sc.make_traces()
        names = ("rfo", "optimal_prediction", "adaptive")
        want = ref_eval(ref_bank, ref_sc.platform, ref_sc.time_base,
                        ref_sc.cp, [ref_build(n, ref_sc) for n in names],
                        seed=sc.seed, engine="batch")
        strategies = [build_strategy(n, sc) for n in names]
        got = evaluate_strategies(bank, sc.platform, sc.time_base, sc.cp,
                                  strategies, seed=sc.seed, device="cpu")
        assert got == want, spec.name
        ad = strategies[2]
        res = simulate_batch(bank, sc.platform, sc.time_base, [ad.period],
                             cp=sc.cp, trust=ad.trust, adaptive=ad.adaptive,
                             trace_seeds=[sc.seed + 7919 * i
                                          for i in range(len(bank))],
                             device="cpu")
        replans += int(res.n_replans.sum())
    assert replans > 0


def test_convergence_cell_matches_reference():
    """predictor_sweep.py's convergence cell at its quick size: the port's
    adaptive lanes are the numpy lanes' on every field, and pass the
    script's claims (predictor_sweep.py:91-140)."""
    kw = dict(n_traces=6, time_base_years_total=40000.0)
    ref_sc, sc = RefScenario(**kw), ScenarioSpec(**kw)
    ref_bank, bank = ref_sc.make_traces(), sc.make_traces()
    for a, b in zip(ref_bank, bank):
        _same_trace(b, a)
    seeds = [sc.seed + 7919 * i for i in range(len(bank))]
    ref_ad = ref_build("adaptive", ref_sc, **STALE_PRIOR)
    ad = build_strategy("adaptive", sc, **STALE_PRIOR)
    want = ref_simulate_batch(ref_bank, ref_sc.platform, ref_sc.time_base,
                              [ref_ad.period], cp=ref_sc.cp,
                              trust=ref_ad.trust, adaptive=ref_ad.adaptive,
                              trace_seeds=seeds)
    got = simulate_batch(bank, sc.platform, sc.time_base, [ad.period],
                         cp=sc.cp, trust=ad.trust, adaptive=ad.adaptive,
                         trace_seeds=seeds, device="cpu")
    for f in dataclasses.fields(want):
        va, vb = getattr(want, f.name), getattr(got, f.name)
        if isinstance(va, np.ndarray):
            assert (va == vb).all(), f.name
    t_true, _, use_true = optimal_period_with_prediction(sc.pp)
    thr_true = beta_lim(sc.pp)
    rel_t = np.abs(got.final_period[0] - t_true) / t_true
    rel_thr = np.abs(got.final_threshold[0] - thr_true) / thr_true
    assert use_true
    assert (got.n_replans[0] >= 1).all()
    assert np.isfinite(got.final_threshold[0]).all()
    assert float(rel_thr.max()) < 0.15
    assert float(rel_t.mean()) < 0.20 and float(rel_t.max()) < 0.35
    assert abs(float(got.est_recall[0].mean()) - sc.recall) < 0.1
    assert abs(float(got.est_precision[0].mean()) - sc.precision) < 0.1
    stale = build_strategy("fixed_period", sc, period=ad.period,
                           trust_threshold=ad.trust.threshold)
    m_stale, m_ad = evaluate_strategies(bank, sc.platform, sc.time_base,
                                        sc.cp, [stale, ad], seed=sc.seed,
                                        device="cpu")
    assert m_ad < m_stale
