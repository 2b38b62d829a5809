"""The port's experiment layer against the JAX package's, bitwise.

* Every strategy the reference registers builds in the port with the same
  name, period bits, trust class and parameter, window fields,
  ``n_verify``, ``verify_cost`` and ``keep_ckpts`` (the dynamic ones: the
  same ``HazardPeriod`` and the same period at every probed date).
* Specs: ``to_dict`` and ``key()`` equal the reference's, ``from_dict``
  round-trips, ``SweepSpec.cells`` gives the same axis columns and
  scenarios, ``with_overrides`` the same spec.
* ``run_experiment`` rows ``==`` the reference's on small experiments: the
  lanes on the CPU, ``engine="scalar"``, BestPeriod searches, dynamic
  strategies (through the oracle), batched banks, ``n_traces=0``.
* ``workers=2`` (a spawn pool) ``==`` ``workers=0``; an ``EvalCache``
  round trip on disk with the torch engine tag in its key.

Tolerance: none (the engines' bit-for-bit contract).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.experiments as ref  # noqa: E402
from repro.experiments import runner as ref_runner  # noqa: E402

import repro_torch.experiments as port  # noqa: E402
from repro_torch.experiments import runner  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry, set_registry  # noqa: E402

SMALL = dict(n=4096, time_base_years_total=100.0, n_traces=2)
SCENARIOS = {
    "default": {},
    "weibull": dict(dist={"name": "weibull", "params": {"shape": 0.5}}),
    "window": dict(window=1800.0, recall=0.7, precision=0.4),
    "silent": dict(silent_mu_ind=2e9, verify_cost=120.0, keep_ckpts=2),
    "exact": dict(model_order="exact", n=2 ** 19, c=1800.0),
}
PARAMS = {"inexact_prediction": [{}, {"window": 900.0}],
          "simple_policy": [{}, {"q": 0.5}, {"q": 1.0}],
          "window_proactive": [{}, {"window_period": 1500.0}],
          "silent_verify": [{}, {"keep_ckpts": 3, "k_max": 4}],
          "fixed_period": [{"period": 5000.0},
                           {"period": 5000.0, "trust_threshold": 700.0}],
          "best_period": [{}, {"base": "optimal_prediction",
                               "n_points": 6}],
          "dynamic_rfo": [{"shape": 0.7}],
          "dynamic_prediction": [{"shape": 0.7, "floor_mult": 2.0}]}


def _strategy_fields(s):
    if hasattr(s, "base"):                       # a BestPeriodSearch
        return ("search", s.name, s.n_points, s.span,
                _strategy_fields(s.base))
    period = s.period
    if callable(period):
        period = (type(period).__name__, dataclasses.astuple(period),
                  [period(t) for t in (0.0, 3600.0, 86400.0, 3.0e7)])
    return (s.name, period, type(s.trust).__name__, vars(s.trust),
            s.inexact_window, s.window_mode, s.window_period,
            None if s.adaptive is None else s.adaptive.key(), s.n_verify,
            s.verify_cost, s.keep_ckpts)


def test_registries_match_reference():
    assert port.list_strategies() == ref.list_strategies()
    assert port.list_distributions() == ref.list_distributions()
    assert port.PREDICTORS == ref.PREDICTORS
    assert port.list_experiments() == {}
    with pytest.raises(KeyError):
        port.build_experiment("exec_times")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_every_strategy_builds_like_reference(scenario):
    kw = dict(SMALL, **SCENARIOS[scenario])
    sc, ref_sc = port.ScenarioSpec(**kw), ref.ScenarioSpec(**kw)
    for name in ref.list_strategies():
        for params in PARAMS.get(name, [{}]):
            try:
                want = ref.build_strategy(name, ref_sc, **params)
            except ValueError:
                with pytest.raises(ValueError):
                    port.build_strategy(name, sc, **params)
                continue
            got = port.build_strategy(name, sc, **params)
            assert _strategy_fields(got) == _strategy_fields(want), \
                (scenario, name, params)


@pytest.mark.parametrize("name", ["exponential", "weibull", "uniform",
                                  "lognormal", "empirical", "lanl"])
def test_distributions_build_like_reference(name):
    params = {"empirical": {"samples": [1.0, 3.0, 8.0]},
              "weibull": {"shape": 0.6}}.get(name, {})
    got = port.build_distribution(name, **params).rescaled(5000.0)
    want = ref.build_distribution(name, **params).rescaled(5000.0)
    assert type(got).__name__ == type(want).__name__
    assert (got.sample(np.random.default_rng(3), 64)
            == want.sample(np.random.default_rng(3), 64)).all()


def _exp_dict():
    return {
        "name": "demo", "description": "a small sweep",
        "scenario": dict(SMALL, dist={"name": "weibull",
                                      "params": {"shape": 0.7}}),
        "strategies": [{"name": "rfo"}, {"name": "young", "label": "Y"},
                       {"name": "best_period",
                        "params": {"base": "optimal_prediction",
                                   "n_points": 5}}],
        "sweep": {"axes": {"recall,precision": [[0.85, 0.82], [0.7, 0.4]],
                           "dist.params.shape": [0.5, 0.7],
                           "predictor": [None, {"name": "bursty"}]},
                  "labels": {"recall,precision": ["good", "fair"]},
                  "names": {"recall,precision": "predictor_q"},
                  "mode": "cartesian"},
        "metrics": ["makespan", "waste"]}


def test_specs_round_trip_like_reference():
    d = _exp_dict()
    got, want = port.ExperimentSpec.from_dict(d), ref.ExperimentSpec.from_dict(d)
    assert got.to_dict() == want.to_dict()
    assert got.to_json(sort_keys=True) == want.to_json(sort_keys=True)
    assert port.ExperimentSpec.from_json(got.to_json()) == got
    cells, ref_cells = list(got.cells()), list(want.cells())
    assert len(cells) == len(ref_cells) == 8
    for (cols, sc), (ref_cols, ref_sc) in zip(cells, ref_cells):
        assert cols == ref_cols
        assert sc.to_dict() == ref_sc.to_dict() and sc.key() == ref_sc.key()
    over = {"recall,precision": [[0.9, 0.9]], "n": 2048}
    assert got.with_overrides(over).to_dict() == \
        want.with_overrides(over).to_dict()
    for spec in (got, want):
        with pytest.raises(ValueError, match="sweep axis"):
            spec.with_overrides({"recall": 0.3})
    zipped = {"axes": {"n": [1024, 2048], "window": [0.0, 60.0]},
              "mode": "zip"}
    assert [c for c, _ in port.SweepSpec.from_dict(zipped).cells(
        port.ScenarioSpec())] == [c for c, _ in ref.SweepSpec.from_dict(
            zipped).cells(ref.ScenarioSpec())]
    sc = port.ScenarioSpec().replace(**{"dist.params.shape": 0.5,
                                        "predictor.params.lead_mean": 60.0})
    ref_sc = ref.ScenarioSpec().replace(**{"dist.params.shape": 0.5,
                                           "predictor.params.lead_mean": 60.0})
    assert sc.key() == ref_sc.key()


def test_baseline_specs_round_trip_like_reference():
    """The specs stored in suites/baselines/quick.json mean the same cell
    in both packages."""
    from pathlib import Path
    path = Path(__file__).parent.parent / "suites" / "baselines" / "quick.json"
    records = json.loads(path.read_text())["records"].values()
    specs = [r["identity"]["spec"] for r in records
             if "spec" in r["identity"]]
    assert len(specs) == 5
    for d in specs:
        got, want = port.ExperimentSpec.from_dict(d), \
            ref.ExperimentSpec.from_dict(d)
        assert got.to_dict() == want.to_dict() == d
        for (cols, sc), (ref_cols, ref_sc) in zip(got.cells(), want.cells()):
            assert cols == ref_cols and sc.key() == ref_sc.key()


def _run_both(d, **kw):
    ref_kw = {k: v for k, v in kw.items() if k != "device"}
    got = port.run_experiment(port.ExperimentSpec.from_dict(d),
                              device="cpu", workers=0, **kw)
    want = ref.run_experiment(ref.ExperimentSpec.from_dict(d), workers=0,
                              **ref_kw)
    assert got.rows == want.rows
    return got


EXPERIMENTS = {
    "paper": {"scenario": SMALL,
              "strategies": ["young", "daly", "rfo", "optimal_prediction",
                             "inexact_prediction", "exact_exponential"],
              "sweep": {"axes": {"n": [2048, 4096]}}},
    "best_period": {"scenario": SMALL,
                    "strategies": [{"name": "best_period",
                                    "params": {"n_points": 6}},
                                   "rfo", {"name": "best_period",
                                           "params": {"base": "adaptive",
                                                      "n_points": 4}}]},
    "window_silent": {"scenario": dict(SMALL, window=900.0,
                                       silent_mu_ind=4e8, verify_cost=60.0),
                      "strategies": ["window_start", "window_proactive",
                                     "window_ignore", "silent_verify",
                                     "silent_verify_pred", "simple_policy"]},
    "dynamic": {"scenario": dict(SMALL, dist={"name": "weibull",
                                              "params": {"shape": 0.5}}),
                "strategies": ["rfo", "dynamic_rfo", "dynamic_prediction",
                               {"name": "simple_policy",
                                "params": {"q": 0.5}}]},
    "order": {"scenario": dict(SMALL, n=2 ** 16),
              "strategies": ["nopred", "prediction", "exact_nopred",
                             "exact_prediction"],
              "sweep": {"axes": {"model_order": ["first", "exact"]}},
              "metrics": ["waste", "makespan_days"]},
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_run_experiment_matches_reference(name):
    d = dict(EXPERIMENTS[name], name=name)
    table = _run_both(d)
    assert all(r["makespan_days" if "makespan_days" in r else "makespan"]
               > 0 for r in table.rows)


@pytest.mark.parametrize("name", ["paper", "dynamic", "window_silent"])
def test_scalar_engine_matches_reference(name):
    d = dict(EXPERIMENTS[name], name=name)
    table = _run_both(d, engine="scalar")
    lanes = port.run_experiment(port.ExperimentSpec.from_dict(d),
                                device="cpu", workers=0)
    assert table.rows == lanes.rows


def test_batched_banks_and_analytic_runs_match_reference():
    d = dict(EXPERIMENTS["paper"], name="paper")
    _run_both(d, batched_traces=True)
    table = _run_both(d, n_traces=0)
    assert all(r["makespan"] is None for r in table.rows)
    _run_both(d, n_traces=3, seed=11)


def test_engine_choices():
    d = dict(EXPERIMENTS["dynamic"], name="dynamic")
    exp = port.ExperimentSpec.from_dict(d)
    with pytest.raises(ValueError, match="auto, batch or scalar"):
        port.run_experiment(exp, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="engine='batch'"):
        port.run_experiment(exp, engine="batch", device="cpu")


def test_spawn_pool_matches_serial(monkeypatch):
    """16 oracle runs (8 strategies x 2 traces): a spawn pool of 2
    workers gives the serial bits."""
    pools = []
    real_pool = runner.ProcessPoolExecutor

    def pool(*args, **kw):
        pools.append(kw["mp_context"].get_start_method())
        return real_pool(*args, **kw)
    monkeypatch.setattr(runner, "ProcessPoolExecutor", pool)
    d = {"name": "pool", "scenario": dict(SMALL, dist={
        "name": "weibull", "params": {"shape": 0.6}}),
        "strategies": ["young", "daly", "rfo", "optimal_prediction",
                       "dynamic_rfo", "dynamic_prediction",
                       "inexact_prediction", "exact_exponential"]}
    exp = port.ExperimentSpec.from_dict(d)
    serial = port.run_experiment(exp, engine="scalar", workers=0)
    pooled = port.run_experiment(exp, engine="scalar", workers=2)
    assert pooled.rows == serial.rows and pools == ["spawn"]
    want = ref.run_experiment(ref.ExperimentSpec.from_dict(d),
                              engine="scalar", workers=0)
    assert serial.rows == want.rows


def test_eval_cache_persists_with_the_torch_tag(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    d = dict(EXPERIMENTS["best_period"], name="cached")
    exp = port.ExperimentSpec.from_dict(d)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        first = port.run_experiment(exp, device="cpu", persist=True)
        misses = reg.counters["runner.cache_misses"]
        files = sorted(tmp_path.glob("eval-*.json"))
        assert len(files) == 1 and misses > 0
        reg.clear()
        again = port.run_experiment(exp, device="cpu", persist=True)
        assert reg.counters["runner.cache_misses"] == 0
        assert reg.counters["runner.cache_hits"] == misses
    finally:
        set_registry(prev)
    assert again.rows == first.rows
    cell = next(exp.cells())[1]
    tag = runner._engine_fingerprint("cpu")
    assert tag == f"torch-{torch.__version__}-cpu-cpu|"
    key = runner._cell_persist_key(cell, False, "cpu")
    assert files[0].name == f"{key}.json"
    ref_cell = next(ref.ExperimentSpec.from_dict(d).cells())[1]
    assert ref_cell.key() == cell.key()
    assert key != ref_runner._cell_persist_key(ref_cell, False, "auto")
    cache = port.EvalCache(persist_key=key)
    assert len(cache) == misses


def test_result_table_matches_reference():
    d = dict(EXPERIMENTS["paper"], name="paper")
    got = port.run_experiment(port.ExperimentSpec.from_dict(d),
                              device="cpu")
    want = ref_runner.ResultTable(got.rows)
    assert got.format() == want.format()
    assert got.to_json() == want.to_json()
    assert got.columns == want.columns
    assert got.strategy_dict("makespan", n=2048) == \
        want.strategy_dict("makespan", n=2048)
    assert got.value("period", n=4096, strategy="RFO") == \
        want.value("period", n=4096, strategy="RFO")
    assert got.mean("waste") == want.mean("waste")


def test_policy_wrappers_match_reference():
    from repro.core import policies as ref_policies
    from repro_torch.core import policies
    sc, ref_sc = port.ScenarioSpec(**SMALL), ref.ScenarioSpec(**SMALL)
    traces, ref_traces = sc.make_traces(), ref_sc.make_traces()
    strat = policies.optimal_prediction(sc.pp)
    ref_strat = ref_policies.optimal_prediction(ref_sc.pp)
    assert policies.evaluate(strat, traces, sc.platform, sc.time_base,
                             sc.cp, seed=3, device="cpu") == \
        ref_policies.evaluate(
        ref_strat, ref_traces, ref_sc.platform, ref_sc.time_base, ref_sc.cp,
        seed=3)
    got, got_m = policies.best_period(strat, traces, sc.platform,
                                      sc.time_base, sc.cp, n_points=6,
                                      device="cpu")
    want, want_m = ref_policies.best_period(ref_strat, ref_traces,
                                            ref_sc.platform, ref_sc.time_base,
                                            ref_sc.cp, n_points=6)
    assert (got.name, got.period, got_m) == (want.name, want.period, want_m)
