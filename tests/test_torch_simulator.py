"""The port's scalar oracle against the JAX package's, bitwise.

* ``simulate``: every ``SimResult`` field ``==`` the reference's, over the
  cases of ``tests/test_simulator.py``, the 9 golden cells' first traces
  (each cell's strategy built by both registries, including a dynamic
  period), and random traces with windows, silent errors, verification
  and adaptive re-planning.
* A recording sink gets the reference's sequence of ``emit`` calls.
* ``average_makespan`` ``==`` the reference's.
* The port's oracle ``==`` the port's lanes on the CPU, every field.

Tolerance: none.  The oracle is a copy of the reference's host code, and
the lanes replay its draws.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.traces import EventTrace as RefTrace  # noqa: E402
from repro.core.traces import Exponential as RefExponential  # noqa: E402
from repro.core.traces import make_event_trace as ref_make_trace  # noqa: E402
from repro.core.waste import Platform as RefPlatform  # noqa: E402
from repro.experiments import ScenarioSpec as RefScenario  # noqa: E402
from repro.experiments import StrategySpec as RefStrategySpec  # noqa: E402
from repro.predictors import AdaptiveConfig as RefAdaptive  # noqa: E402

from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.batch import simulate_batch  # noqa: E402
from repro_torch.core.traces import EventTrace, Exponential  # noqa: E402
from repro_torch.core.traces import make_event_trace  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402
from repro_torch.experiments import ScenarioSpec, StrategySpec  # noqa: E402
from repro_torch.predictors import AdaptiveConfig  # noqa: E402

GOLDEN = json.loads((Path(__file__).parent / "golden" / "parity_v1.json")
                    .read_text())["cells"]

_TRUSTS = {"never": lambda: (sim.NeverTrust(), ref_sim.NeverTrust()),
           "always": lambda: (sim.AlwaysTrust(), ref_sim.AlwaysTrust()),
           "thr30": lambda: (sim.ThresholdTrust(30.0),
                             ref_sim.ThresholdTrust(30.0)),
           "q": lambda: (sim.FixedProbabilityTrust(0.5),
                         ref_sim.FixedProbabilityTrust(0.5))}


def _fields(res) -> dict:
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _same(got, want, what=""):
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys()
    for name in w:
        assert type(g[name]) is type(w[name]) and g[name] == w[name], \
            (what, name, g[name], w[name])


def _both(times, kinds, horizon=1e9, windows=None):
    t = np.asarray(times, float)
    k = np.asarray(kinds, np.int8)
    w = None if windows is None else np.asarray(windows, float)
    return (EventTrace(t, k, horizon, windows=w),
            RefTrace(t.copy(), k.copy(), horizon,
                     windows=None if w is None else w.copy()))


# (times, kinds, platform (mu, c, d, r), time_base, period, kw): the
# mechanics cases of tests/test_simulator.py, and the same machinery with
# windows, verification and silent strikes.
MECHANICS = {
    "fault_free": ([], [], (1e12, 10.0, 1.0, 2.0), 360.0, 100.0, {}),
    "single_fault": ([150.0], [0], (1e12, 10.0, 5.0, 20.0), 360.0, 100.0, {}),
    "fault_in_ckpt": ([95.0], [0], (1e12, 10.0, 0.0, 0.0), 180.0, 100.0, {}),
    "trusted_true": ([50.0], [1], (1e12, 10.0, 2.0, 3.0), 360.0, 100.0,
                     dict(cp=4.0, trust="always")),
    "untrusted_true": ([50.0], [1], (1e12, 10.0, 2.0, 3.0), 360.0, 100.0,
                       dict(cp=4.0, trust="never")),
    "false_pred": ([50.0], [2], (1e12, 10.0, 2.0, 3.0), 360.0, 100.0,
                   dict(cp=4.0, trust="always")),
    "threshold_early": ([20.0], [2], (1e12, 10.0, 0.0, 0.0), 180.0, 100.0,
                        dict(cp=4.0, trust="thr30")),
    "threshold_late": ([40.0], [2], (1e12, 10.0, 0.0, 0.0), 180.0, 100.0,
                       dict(cp=4.0, trust="thr30")),
    "unhonourable": ([2.0], [2], (1e12, 10.0, 0.0, 0.0), 90.0, 100.0,
                     dict(cp=4.0, trust="always")),
    "past_completion": ([500.0], [1], (1e12, 10.0, 2.0, 3.0), 360.0, 100.0,
                        dict(cp=4.0, trust="always")),
    "mixed": ([50.0, 120.0, 260.0], [1, 0, 2], (1e12, 10.0, 2.0, 3.0),
              600.0, 100.0, dict(cp=4.0, trust="always")),
    "inexact": ([50.0], [1], (1e12, 10.0, 0.0, 0.0), 360.0, 100.0,
                dict(cp=4.0, trust="always", inexact_window=20.0)),
    "fixed_q": ([50.0, 130.0, 170.0, 240.0], [1, 2, 1, 2],
                (1e12, 10.0, 2.0, 3.0), 600.0, 100.0,
                dict(cp=4.0, trust="q")),
    "within": ([50.0, 300.0], [1, 2], (1e12, 10.0, 2.0, 3.0), 900.0, 100.0,
               dict(cp=4.0, trust="always", inexact_window=120.0,
                    window_mode="within", window_period=30.0)),
    "event_windows": ([50.0, 140.0, 300.0], [1, 0, 2],
                      (1e12, 10.0, 2.0, 3.0), 900.0, 100.0,
                      dict(cp=4.0, trust="always", windows=[60.0, 0.0, 40.0],
                           window_mode="within", window_period=25.0)),
    "silent_verify": ([40.0, 130.0, 260.0, 420.0], [3, 3, 0, 3],
                      (1e12, 10.0, 2.0, 3.0), 800.0, 100.0,
                      dict(n_verify=2, verify_cost=3.0, keep_ckpts=2)),
    "silent_blind": ([40.0, 95.0, 260.0], [3, 3, 3],
                     (1e12, 10.0, 2.0, 3.0), 400.0, 100.0, {}),
    "silent_deep": ([85.0, 140.0, 185.0, 330.0], [3, 3, 0, 0],
                    (1e12, 10.0, 2.0, 3.0), 600.0, 100.0,
                    dict(n_verify=1, verify_cost=2.0, keep_ckpts=3)),
}


def _run_case(case, sink_pair=(None, None)):
    times, kinds, (mu, c, d, r), tb, period, kw = case
    kw = dict(kw)
    windows = kw.pop("windows", None)
    trust = kw.pop("trust", None)
    got_tr, ref_tr = _both(times, kinds, windows=windows)
    pk, rk = dict(kw), dict(kw)
    if trust is not None:
        pk["trust"], rk["trust"] = _TRUSTS[trust]()
    got = sim.simulate(got_tr, Platform(mu=mu, c=c, d=d, r=r), tb, period,
                       rng=np.random.default_rng(7), sink=sink_pair[0], **pk)
    want = ref_sim.simulate(ref_tr, RefPlatform(mu=mu, c=c, d=d, r=r), tb,
                            period, rng=np.random.default_rng(7),
                            sink=sink_pair[1], **rk)
    return got, want


@pytest.mark.parametrize("name", sorted(MECHANICS))
def test_mechanics_match_reference(name):
    got, want = _run_case(MECHANICS[name])
    _same(got, want, name)


class _Recorder:
    def __init__(self) -> None:
        self.calls = []

    def emit(self, t, kind, **fields):
        self.calls.append((t, kind, sorted(fields.items())))


@pytest.mark.parametrize("name", ["mixed", "within", "silent_verify",
                                  "silent_deep", "fixed_q"])
def test_sink_sees_reference_emits(name):
    a, b = _Recorder(), _Recorder()
    got, want = _run_case(MECHANICS[name], (a, b))
    _same(got, want, name)
    assert a.calls and a.calls == b.calls


def _golden_pair(name):
    want = GOLDEN[name]
    sc = ScenarioSpec.from_dict(want["scenario"])
    ref_sc = RefScenario.from_dict(want["scenario"])
    spec = want["strategy"]
    return (sc, StrategySpec.from_dict(spec).build(sc), ref_sc,
            RefStrategySpec.from_dict(spec).build(ref_sc))


def _sim_strategy(module, trace, sc, strat, seed):
    return module.simulate(
        trace, sc.platform, sc.time_base, strat.period, cp=sc.cp,
        trust=strat.trust, inexact_window=strat.inexact_window,
        window_mode=strat.window_mode, window_period=strat.window_period,
        adaptive=strat.adaptive, n_verify=strat.n_verify,
        verify_cost=strat.verify_cost, keep_ckpts=strat.keep_ckpts,
        rng=np.random.default_rng(seed))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_first_trace_matches_reference(name):
    """The cell's first trace, both oracles: every field ``==``, and the
    makespan is the pinned one."""
    sc, strat, ref_sc, ref_strat = _golden_pair(name)
    got = _sim_strategy(sim, sc.make_trace(0), sc, strat, sc.seed)
    want = _sim_strategy(ref_sim, ref_sc.make_trace(0), ref_sc, ref_strat,
                         ref_sc.seed)
    _same(got, want, name)
    assert got.makespan == GOLDEN[name]["makespans"][0]


def test_dynamic_period_matches_reference():
    """A callable period (the registry's HazardPeriod) through both oracles
    on a Weibull scenario."""
    kw = dict(n=2 ** 14, dist={"name": "weibull", "params": {"shape": 0.5}},
              time_base_years_total=200.0, n_traces=2)
    sc, ref_sc = ScenarioSpec(**kw), RefScenario(**kw)
    for name in ("dynamic_rfo", "dynamic_prediction"):
        strat = StrategySpec(name).build(sc)
        ref_strat = RefStrategySpec(name).build(ref_sc)
        assert callable(strat.period)
        for i in range(2):
            got = _sim_strategy(sim, sc.make_trace(i), sc, strat, 11 + i)
            want = _sim_strategy(ref_sim, ref_sc.make_trace(i), ref_sc,
                                 ref_strat, 11 + i)
            _same(got, want, (name, i))


RANDOM_STRATS = {
    "rfo_like": dict(period=3000.0, trust="never"),
    "threshold": dict(period=2500.0, trust="thr30", inexact_window=400.0),
    "within": dict(period=2500.0, trust="always", inexact_window=900.0,
                   window_mode="within", window_period=300.0),
    "q": dict(period=2000.0, trust="q"),
    "verify": dict(period=2600.0, trust="thr30", n_verify=3,
                   verify_cost=25.0, keep_ckpts=2),
    "adaptive": dict(period=2400.0, trust="thr30", adaptive=dict(
        prior_recall=0.5, prior_precision=0.5, min_preds=8, min_faults=4)),
    "adaptive_mu": dict(period=2400.0, trust="thr30", adaptive=dict(
        prior_recall=0.5, prior_precision=0.5, min_preds=8, min_faults=4,
        halflife=24.0, estimate_mu=True)),
}


def _random_bank(module_make, dist, seed):
    return module_make(dist(1.0), 2500.0, 0.7, 0.6, 200000.0,
                       np.random.default_rng(seed), silent_mu=9000.0)


def _strategy_kw(spec, adaptive_cls, trusts_index):
    kw = dict(spec)
    kw["trust"] = _TRUSTS[kw["trust"]]()[trusts_index]
    if "adaptive" in kw:
        kw["adaptive"] = adaptive_cls(**kw["adaptive"])
    return kw


@pytest.mark.parametrize("name", sorted(RANDOM_STRATS))
def test_random_traces_match_reference(name):
    plat = dict(mu=2500.0, c=60.0, d=10.0, r=30.0)
    for seed in (3, 4, 5):
        got_tr = _random_bank(make_event_trace, Exponential, seed)
        ref_tr = _random_bank(ref_make_trace, RefExponential, seed)
        pk = _strategy_kw(RANDOM_STRATS[name], AdaptiveConfig, 0)
        rk = _strategy_kw(RANDOM_STRATS[name], RefAdaptive, 1)
        period = pk.pop("period")
        rk.pop("period")
        got = sim.simulate(got_tr, Platform(**plat), 40000.0, period,
                           cp=30.0, rng=np.random.default_rng(seed), **pk)
        want = ref_sim.simulate(ref_tr, RefPlatform(**plat), 40000.0, period,
                                cp=30.0, rng=np.random.default_rng(seed),
                                **rk)
        _same(got, want, (name, seed))


def test_average_makespan_matches_reference():
    plat = dict(mu=2500.0, c=60.0, d=10.0, r=30.0)
    got = sim.average_makespan(
        lambda rng: make_event_trace(Exponential(1.0), 2500.0, 0.8, 0.7,
                                     200000.0, rng),
        Platform(**plat), 30000.0, 1500.0, n_runs=6, seed=3, cp=30.0,
        trust=sim.ThresholdTrust(50.0))
    want = ref_sim.average_makespan(
        lambda rng: ref_make_trace(RefExponential(1.0), 2500.0, 0.8, 0.7,
                                   200000.0, rng),
        RefPlatform(**plat), 30000.0, 1500.0, n_runs=6, seed=3, cp=30.0,
        trust=ref_sim.ThresholdTrust(50.0))
    assert got == want


def test_simulate_refuses_like_reference():
    tr, _ = _both([], [])
    plat = Platform(mu=1e12, c=10.0, d=1.0, r=2.0)
    with pytest.raises(ValueError, match="window_mode"):
        sim.simulate(tr, plat, 100.0, 50.0, window_mode="bad")
    with pytest.raises(ValueError, match="window_period"):
        sim.simulate(tr, plat, 100.0, 50.0, window_mode="within",
                     window_period=5.0)
    with pytest.raises(ValueError, match="period"):
        sim.simulate(tr, plat, 100.0, 5.0)
    with pytest.raises(ValueError, match="keep_ckpts"):
        sim.simulate(tr, plat, 100.0, 50.0, keep_ckpts=0)


@pytest.mark.parametrize("name", sorted(RANDOM_STRATS))
def test_oracle_matches_lanes_on_cpu(name):
    """The port's two engines on the same bank: ``simulate`` per (trace,
    seed) ``==`` the lane engine on the CPU, every SimResult field."""
    plat = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    traces = [_random_bank(make_event_trace, Exponential, s)
              for s in (3, 4)]
    kw = _strategy_kw(RANDOM_STRATS[name], AdaptiveConfig, 0)
    period = kw.pop("period")
    seeds = [101, 202]
    batch = simulate_batch(
        traces, plat, 40000.0, [period], cp=30.0, trust=[kw["trust"]],
        inexact_window=kw.get("inexact_window", 0.0),
        window_mode=kw.get("window_mode", "instant"),
        window_period=kw.get("window_period", 0.0),
        adaptive=[kw.get("adaptive")], n_verify=kw.get("n_verify", 0),
        verify_cost=kw.get("verify_cost", 0.0),
        keep_ckpts=kw.get("keep_ckpts", 1), trace_seeds=seeds,
        device="cpu")
    for ti, tr in enumerate(traces):
        want = sim.simulate(tr, plat, 40000.0, period, cp=30.0,
                            rng=np.random.default_rng(seeds[ti]), **kw)
        _same(batch.result(0, ti), want, (name, ti))
