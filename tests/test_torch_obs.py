"""The port's observability layer against the JAX package's (mirrors
``tests/test_obs.py``, all but the store's CLI view).

Each test runs the port and the reference on the same cells (the golden
parity scenario, traces and seeds from the same recipe) and holds the
port's value ``==`` the reference's, then asserts the reference test's
own claims on the port's values:

* tracing is inert, and the recorded events (time, kind, duration,
  fields) are the reference's, event for event;
* attribution buckets ``==`` bit for bit, from the oracle's ``SimResult``
  and from the port's CPU ``BatchResult`` (the plain lane loop) against
  the reference's numpy lanes; where the closure cannot reach a lane's
  makespan both raise, and ``attribute_lanes`` marks exactly those lanes;
* ``expected_fractions`` ``==``, and the reference's reconciliation bounds;
* fleets: per-job attribution, sinks, metrics counters, and the Perfetto
  JSON byte for byte;
* ``obs_metrics`` (``chip_smoke.py``'s port of
  ``benchmarks/obs_metrics.py``) ``==`` its record in
  ``suites/baselines/quick.json`` and the live reference.
"""

import dataclasses
import functools
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.batch import simulate_batch as ref_simulate_batch  # noqa: E402
from repro.core.simulator import simulate as ref_simulate  # noqa: E402
from repro.experiments import ScenarioSpec as RefScenario  # noqa: E402
from repro.experiments import StrategySpec as RefStrategy  # noqa: E402
from repro.obs import attribution as ref_att  # noqa: E402
from repro.obs import metrics as ref_metrics  # noqa: E402
from repro.obs import perfetto as ref_perfetto  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402

from repro_torch.core.batch import simulate_batch  # noqa: E402
from repro_torch.core.simulator import simulate  # noqa: E402
from repro_torch.core.waste import waste  # noqa: E402
from repro_torch.experiments import ScenarioSpec, StrategySpec  # noqa: E402
from repro_torch.obs import (BUCKETS, MetricsRegistry, NullSink,  # noqa: E402
                             RecordingSink, TraceEvent, attribute_batch,
                             attribute_fleet_job, attribute_lanes,
                             attribute_result, events_to_trace_events,
                             expected_fractions, fleet_to_perfetto,
                             get_registry, record_run, set_registry,
                             write_trace)

ROOT = Path(__file__).resolve().parents[1]

# tests/test_obs.py's cells: the golden parity scenario, ~110 periods a
# trace, the paper's full mechanics.
_BASE = dict(n=2 ** 16, c=600.0, d=60.0, r=600.0, n_traces=2,
             time_base_years_total=2000.0, seed=5)
_CELLS = {
    "baseline_rfo": ({}, "rfo", {}),
    "prediction_optimal": ({}, "optimal_prediction", {}),
    "window_within": ({"window": 9000.0}, "window_proactive", {}),
    "adaptive_stale_prior": ({}, "adaptive", {
        "prior_recall": 0.4, "prior_precision": 0.95, "min_preds": 8,
        "min_faults": 4, "tol": 0.03}),
    "stochastic_trust_q": ({}, "simple_policy", {"q": 0.5}),
}


@functools.lru_cache(maxsize=None)
def _cell(name, side):
    """(scenario, strategy, traces) of a cell on one side."""
    extra, sname, params = _CELLS[name]
    spec, strat = ((ScenarioSpec, StrategySpec) if side == "port"
                   else (RefScenario, RefStrategy))
    scenario = spec(**_BASE, **extra)
    return scenario, strat(sname, dict(params)).build(scenario), \
        scenario.make_traces()


def _run_cell(name, trace_index=0, sink=None, side="port", seed=None):
    scenario, strat, traces = _cell(name, side)
    i = trace_index
    run = simulate if side == "port" else ref_simulate
    seed = scenario.seed + 7919 * i if seed is None else seed
    return run(traces[i], scenario.platform, scenario.time_base,
               strat.period, cp=scenario.cp, trust=strat.trust,
               inexact_window=strat.inexact_window,
               window_mode=strat.window_mode,
               window_period=strat.window_period, adaptive=strat.adaptive,
               rng=np.random.default_rng(seed), sink=sink)


def _events(sink):
    return [(e.t, e.kind, e.dur, e.args) for e in sink]


def _both(name, trace_index=0, seed=None):
    """The cell traced on both sides: (port result, port sink, reference
    result, reference sink), the results and events held ``==``."""
    sink, ref_sink = RecordingSink(), ref_trace.RecordingSink()
    got = _run_cell(name, trace_index, sink, seed=seed)
    want = _run_cell(name, trace_index, ref_sink, side="ref", seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _events(sink) == _events(ref_sink)
    return got, sink, want, ref_sink


# -- tracing is inert ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_CELLS))
@pytest.mark.parametrize("trace_index", [0, 1])
def test_tracing_never_changes_results(name, trace_index):
    bare = _run_cell(name, trace_index, sink=None)
    null = _run_cell(name, trace_index, sink=NullSink())
    rec, sink, _, _ = _both(name, trace_index)
    assert bare == null == rec
    assert len(sink) > 0


def test_tracing_inert_over_seeds():
    """tests/test_obs.py's property test on a seeded draw of (rng seed,
    cell): traced == untraced, and both sides' events ``==``."""
    rng = np.random.default_rng(19)
    names = sorted(_CELLS)
    for _ in range(10):
        seed = int(rng.integers(0, 10 ** 6))
        name = names[int(rng.integers(len(names)))]
        bare = _run_cell(name, 0, seed=seed)
        traced, _, _, _ = _both(name, 0, seed=seed)
        assert bare == traced


# -- bucket closure and counters (the oracle) ---------------------------------

@pytest.mark.parametrize("name", sorted(_CELLS))
def test_buckets_sum_to_makespan_exactly(name):
    res, _, ref_res, _ = _both(name)
    att = attribute_result(res)
    assert dataclasses.asdict(att) == dataclasses.asdict(
        ref_att.attribute_result(ref_res))
    assert att.total() == res.makespan
    assert att.makespan == res.makespan
    assert all(getattr(att, b) >= 0.0 for b in BUCKETS)
    assert math.isclose(att.downtime + att.recovery, res.time_down,
                        rel_tol=1e-12, abs_tol=1e-6)
    fr = att.fractions()
    assert math.isclose(sum(fr.values()), 1.0, rel_tol=1e-12)
    assert att.waste_fraction() == 1.0 - fr["work"]


@pytest.mark.parametrize("name", sorted(_CELLS))
def test_trace_counts_match_engine_counters(name):
    res, sink, _, ref_sink = _both(name)
    counts = sink.counts()
    assert counts == ref_sink.counts()
    assert counts.get("fault", 0) == res.n_faults_hit
    assert counts.get("rollback", 0) == res.n_rollbacks
    assert counts.get("prockpt_end", 0) == res.n_proactive_ckpts
    assert counts.get("ckpt_end", 0) == res.n_periodic_ckpts
    assert counts.get("prediction", 0) == res.n_predictions
    assert counts.get("rollback", 0) == counts.get("re_exec", 0)
    assert counts.get("replan", 0) == res.n_replans
    for ev in sink:
        assert isinstance(ev, TraceEvent)
        assert ev.t >= 0.0 and ev.dur >= 0.0
    assert [e.kind for e in sink.by_kind("fault")] \
        == ["fault"] * counts.get("fault", 0)


def test_record_run_convenience():
    out = []
    for side, run in (("port", record_run), ("ref", ref_trace.record_run)):
        scenario, strat, traces = _cell("prediction_optimal", side)
        out.append(run(traces[0], scenario.platform, scenario.time_base,
                       strat.period, cp=scenario.cp, trust=strat.trust,
                       rng=np.random.default_rng(scenario.seed)))
    (res, sink), (ref_res, ref_sink) = out
    assert isinstance(sink, RecordingSink) and len(sink) > 0
    assert dataclasses.asdict(res) == dataclasses.asdict(ref_res)
    assert _events(sink) == _events(ref_sink)
    assert attribute_result(res).total() == res.makespan


# -- bucket closure on the lanes ----------------------------------------------

def _bits(buckets):
    return {k: np.asarray(v, dtype=np.float64).view(np.int64).tolist()
            for k, v in buckets.items()}


@pytest.mark.parametrize("name", sorted(_CELLS))
def test_batch_buckets_and_counters_match_scalar(name):
    """The port's CPU lanes (the lane loop's plain version), attributed:
    the buckets are the reference's numpy lanes' bit for bit, close on
    every lane, and each lane's result equals the oracle's."""
    results = []
    for side, run in (("port", simulate_batch), ("ref", ref_simulate_batch)):
        scenario, strat, traces = _cell(name, side)
        kw = {"device": "cpu"} if side == "port" else {}
        results.append(run(
            traces, scenario.platform, scenario.time_base,
            [float(strat.period)], cp=scenario.cp, trust=strat.trust,
            inexact_window=strat.inexact_window,
            window_mode=strat.window_mode, window_period=strat.window_period,
            adaptive=strat.adaptive,
            trace_seeds=[scenario.seed + 7919 * i
                         for i in range(len(traces))], **kw))
    batch, ref_batch = results
    buckets = attribute_batch(batch)
    assert _bits(buckets) == _bits(ref_att.attribute_batch(ref_batch))
    tot = buckets["work"].copy()
    for b in BUCKETS[1:]:
        tot = tot + buckets[b]
    assert (tot == np.asarray(batch.makespan)).all()
    lanes, closed = attribute_lanes(batch)
    assert closed.all() and _bits(lanes) == _bits(buckets)
    for i in range(batch.makespan.shape[1]):
        want = _run_cell(name, i)
        got = batch.result(0, i)
        assert got.makespan == want.makespan
        assert got.n_proactive_ckpts == want.n_proactive_ckpts
        assert got.n_rollbacks == want.n_rollbacks
        assert got.time_downtime == want.time_downtime
        assert got.time_recovery == want.time_recovery
        assert attribute_result(got).total() == got.makespan


def test_attribute_batch_requires_split_fields():
    class _Legacy:
        makespan = np.ones(2)
        time_ckpt = np.zeros(2)
        time_prockpt = np.zeros(2)
        time_lost = np.zeros(2)
        time_downtime = None
        time_recovery = None

    for fn in (attribute_batch, attribute_lanes, ref_att.attribute_batch):
        with pytest.raises(ValueError):
            fn(_Legacy())


def test_attribute_lanes_marks_the_lanes_the_reference_cannot_close():
    """The paper study (26 candidates x 200 traces, the reference's numpy
    lanes): on some lanes no ``work`` makes the closure's fold land on the
    makespan, and the JAX package's attribute_batch raises for the batch
    (ROADMAP Queue C).  The port's raises alike; attribute_lanes marks
    exactly the lanes whose scalar attribution raises in the reference,
    gives the reference's buckets on the others and sums within one ulp
    of the makespan on all."""
    from repro.core import simulator as ref_sim
    from repro_torch.core import simulator as port_sim
    from repro_torch.core.policies import optimal_prediction, rfo
    from repro_torch.experiments import BestPeriodSearch, expand_candidates

    sc = ScenarioSpec(n_traces=200)
    base = rfo(sc.platform)
    unique, _ = expand_candidates(
        [base, optimal_prediction(sc.pp), BestPeriodSearch(base)],
        sc.platform)
    trusts = [ref_sim.NeverTrust() if isinstance(s.trust,
                                                 port_sim.NeverTrust)
              else ref_sim.ThresholdTrust(s.trust.threshold)
              for s in unique]
    ref = RefScenario(n_traces=200)
    batch = ref_simulate_batch(
        ref.make_traces(), ref.platform, ref.time_base,
        [float(s.period) for s in unique], cp=ref.cp, trust=trusts,
        inexact_window=[s.inexact_window for s in unique],
        trace_seeds=[ref.seed + 7919 * i for i in range(200)])
    with pytest.raises(ArithmeticError):
        ref_att.attribute_batch(batch)
    with pytest.raises(ArithmeticError):
        attribute_batch(batch)
    buckets, closed = attribute_lanes(batch)
    assert 0 < int((~closed).sum()) < closed.size // 10
    tot = buckets["work"].copy()
    for b in BUCKETS[1:]:
        tot = tot + buckets[b]
    mk = batch.makespan
    assert (tot[closed] == mk[closed]).all()
    assert (np.abs(tot - mk) <= np.spacing(mk)).all()
    for ci, ti in np.ndindex(mk.shape):
        lane = batch.result(ci, ti)
        if closed[ci, ti]:
            want = ref_att.attribute_result(lane).buckets()
            assert all(want[k] == float(v[ci, ti])
                       for k, v in buckets.items())
        else:
            with pytest.raises(ArithmeticError):
                ref_att.attribute_result(lane)
            with pytest.raises(ArithmeticError):
                attribute_result(lane)


# -- reconciliation against the paper's analytic terms ------------------------

def _mean_fractions(name, bucket):
    atts = [attribute_result(_run_cell(name, i)) for i in (0, 1)]
    return sum(a.fractions()[bucket] for a in atts) / len(atts)


def test_fractions_reconcile_with_first_order_waste():
    scenario, strat, _ = _cell("baseline_rfo", "port")
    ref_scenario, _, _ = _cell("baseline_rfo", "ref")
    t = float(strat.period)
    exp = expected_fractions(t, scenario.platform)
    assert exp == ref_att.expected_fractions(t, ref_scenario.platform)
    assert math.isclose(sum(exp.values()), 1.0, rel_tol=1e-12)
    assert exp["ckpt"] == scenario.platform.c / t
    assert exp["proactive_ckpt"] == 0.0
    assert math.isclose(1.0 - exp["work"], waste(t, scenario.platform),
                        rel_tol=0.05)
    for b in ("ckpt", "downtime", "recovery", "re_exec"):
        got = _mean_fractions("baseline_rfo", b)
        assert abs(got - exp[b]) < max(0.02, 1.5 * exp[b]), b
    assert abs(_mean_fractions("baseline_rfo", "work") - exp["work"]) < 0.05


def test_fractions_reconcile_with_prediction_terms():
    scenario, strat, _ = _cell("prediction_optimal", "port")
    ref_scenario, _, _ = _cell("prediction_optimal", "ref")
    t = float(strat.period)
    exp = expected_fractions(t, scenario.platform, scenario.pp)
    assert exp == ref_att.expected_fractions(t, ref_scenario.platform,
                                             ref_scenario.pp)
    assert expected_fractions(t, scenario.platform, scenario.pp,
                              n_verify=2, verify_cost=30.0) \
        == ref_att.expected_fractions(t, ref_scenario.platform,
                                      ref_scenario.pp, n_verify=2,
                                      verify_cost=30.0)
    assert exp["proactive_ckpt"] > 0.0
    assert math.isclose(sum(exp.values()), 1.0, rel_tol=1e-12)
    assert exp["re_exec"] < expected_fractions(t, scenario.platform)[
        "re_exec"]
    for b in ("ckpt", "downtime", "recovery", "proactive_ckpt", "re_exec"):
        got = _mean_fractions("prediction_optimal", b)
        assert abs(got - exp[b]) < max(0.02, 1.5 * exp[b]), b
    assert abs(_mean_fractions("prediction_optimal", "work")
               - exp["work"]) < 0.05


# -- fleets: sinks, the wait bucket, Perfetto ---------------------------------

def _fleet_run(side="port"):
    if side == "port":
        from repro_torch.fleet.sim import FleetJobInput, simulate_fleet
        sink_cls = RecordingSink
    else:
        from repro.fleet.sim import FleetJobInput, simulate_fleet
        sink_cls = ref_trace.RecordingSink
    scenario, strat, traces = _cell("prediction_optimal", side)
    sinks = [sink_cls() for _ in traces]
    fleet = simulate_fleet(
        [FleetJobInput(trace=tr, platform=scenario.platform,
                       time_base=scenario.time_base, period=strat.period,
                       cp=scenario.cp, trust=strat.trust,
                       rng=np.random.default_rng(scenario.seed + 7919 * i),
                       name=f"job{i}", sink=sinks[i])
         for i, tr in enumerate(traces)],
        storage_streams=1, repair_slots=1)
    return fleet, sinks


def test_fleet_attribution_and_sinks():
    fleet, sinks = _fleet_run()
    ref_fleet, ref_sinks = _fleet_run("ref")
    waits = 0.0
    for job, sink, ref_job, ref_sink in zip(fleet.jobs, sinks,
                                            ref_fleet.jobs, ref_sinks):
        att = attribute_fleet_job(job)
        assert dataclasses.asdict(att) == dataclasses.asdict(
            ref_att.attribute_fleet_job(ref_job))
        assert _events(sink) == _events(ref_sink) and len(sink) > 0
        assert att.total() == job.sim.makespan
        assert att.wait == (job.time_contention_ckpt
                            + job.time_contention_prockpt
                            + job.time_repair_wait)
        waits += att.wait
        counts = sink.counts()
        assert counts.get("ckpt_start", 0) >= counts.get("ckpt_end", 0)
        assert counts.get("prockpt_end", 0) == job.sim.n_proactive_ckpts
    assert waits > 0.0


def test_fleet_perfetto_export(tmp_path):
    fleet, sinks = _fleet_run()
    ref_fleet, ref_sinks = _fleet_run("ref")
    streams = [(j.name, s.events) for j, s in zip(fleet.jobs, sinks)]
    ref_streams = [(j.name, s.events)
                   for j, s in zip(ref_fleet.jobs, ref_sinks)]
    trace = fleet_to_perfetto(streams)
    assert trace == ref_perfetto.fleet_to_perfetto(ref_streams)
    evs = trace["traceEvents"]
    phs = {e["ph"] for e in evs}
    assert "X" in phs and "M" in phs
    for e in evs:
        assert "ph" in e and "pid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0.0 and "name" in e and "ts" in e
        if e["ph"] == "i":
            assert "s" in e
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] in ("process_name",
                                                 "thread_name")}
    assert {j.name for j in fleet.jobs} <= names
    out, ref_out = tmp_path / "trace.json", tmp_path / "ref_trace.json"
    write_trace(str(out), streams, title="fleet")
    ref_perfetto.write_trace(str(ref_out), ref_streams, title="fleet")
    assert out.read_bytes() == ref_out.read_bytes()
    loaded = json.loads(out.read_text())
    assert len(loaded["traceEvents"]) == len(evs)
    assert _chip_smoke().check_perfetto(loaded, ["job0", "job1"]) > 0


def test_events_to_trace_events_pairing():
    raw = [(0.0, "ckpt_start", 0.0, {}), (600.0, "ckpt_end", 600.0, {}),
           (700.0, "fault", 0.0, {"phase": 0}),
           (700.0, "down_start", 60.0, {}),
           (760.0, "recover_start", 600.0, {}),
           (1360.0, "recover_end", 600.0, {}),
           (1400.0, "prockpt_start", 0.0, {})]
    out = events_to_trace_events([TraceEvent(*e) for e in raw])
    assert out == ref_perfetto.events_to_trace_events(
        [ref_trace.TraceEvent(*e) for e in raw])
    slices = [e for e in out if e["ph"] == "X"]
    instants = [e for e in out if e["ph"] == "i"]
    assert {s["name"] for s in slices} == {"ckpt", "downtime", "recovery",
                                           "proactive_ckpt"}
    assert [i["name"] for i in instants] == ["fault"]
    ck = next(s for s in slices if s["name"] == "ckpt")
    assert ck["ts"] == 0.0 and ck["dur"] == 600.0


# -- metrics registry ---------------------------------------------------------

def test_metrics_registry_basics():
    for reg in (MetricsRegistry(), ref_metrics.MetricsRegistry()):
        reg.count("a")
        reg.count("a", 4)
        reg.gauge("g", 2.5)
        reg.add_time("t", 0.25)
        with reg.timer("t"):
            pass
        snap = reg.snapshot()
        assert snap["counters"]["a"] == 5
        assert snap["gauges"]["g"] == 2.5
        assert snap["timers"]["t"] >= 0.25
        flat = reg.flat_timings()
        assert flat["g"] == 2.5 and flat["t"] >= 0.25
        other = type(reg)()
        other.count("a", 2)
        other.gauge("g2", 1.0)
        reg.merge(other)
        assert reg.counters["a"] == 7 and reg.gauges["g2"] == 1.0
        reg.clear()
        assert not reg.counters and not reg.gauges and not reg.timers


def test_set_registry_scoping():
    fresh = MetricsRegistry()
    prev = set_registry(fresh)
    try:
        get_registry().count("x")
        assert fresh.counters["x"] == 1
    finally:
        set_registry(prev)
    assert get_registry() is prev


def _counted(side, fn):
    mod = sys.modules["repro_torch.obs.metrics"] if side == "port" \
        else ref_metrics
    fresh = mod.MetricsRegistry()
    prev = mod.set_registry(fresh)
    try:
        fn()
    finally:
        mod.set_registry(prev)
    return fresh.counters


def test_fleet_feeds_metrics_registry():
    got = _counted("port", _fleet_run)
    assert got == _counted("ref", lambda: _fleet_run("ref"))
    assert got.get("fleet.faults", 0) > 0
    assert got.get("fleet.repair_waits", 0) >= 0


def test_ft_runtime_feeds_metrics_registry():
    from repro.core.traces import Exponential as RefExp
    from repro.core.traces import make_event_trace as ref_make
    from repro.ft.runtime import FaultInjector as RefInjector
    from repro.ft.runtime import PredictorRuntime as RefPredictor
    from repro_torch.core.traces import Exponential, make_event_trace
    from repro_torch.ft.runtime import FaultInjector, PredictorRuntime

    def drive(make, exp, injector, predictor):
        trace = make(exp(1.0), 1000.0, 0.8, 0.8, 50_000.0,
                     np.random.default_rng(0))
        assert injector(trace).next_fault_in(0.0, 50_000.0) is not None
        assert predictor(trace, lead_time=100.0).announced_in(0.0, 50_000.0)

    got = _counted("port", lambda: drive(make_event_trace, Exponential,
                                         FaultInjector, PredictorRuntime))
    assert got == _counted("ref", lambda: drive(ref_make, RefExp,
                                                RefInjector, RefPredictor))
    assert got.get("ft.faults_injected", 0) > 0
    assert got.get("ft.predictions", 0) > 0


# -- obs_metrics: the record and the live reference ---------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obs_metrics_payload_equals_record_and_reference():
    cs = _chip_smoke()
    payload, trace = cs.obs_metrics_payload()
    record = cs._quick_record(cs.OBS_RECORD)["payload"]
    without = lambda d: {k: v for k, v in d.items() if k != "wall_s"}
    assert without(payload) == without(record)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import obs_metrics
    ref_payload = {}
    ref_payload["counters"] = _counted(
        "ref", lambda: ref_payload.update(obs_metrics.run()))
    assert payload["metrics"] == ref_payload.pop("counters")
    assert without(payload) == dict(without(ref_payload),
                                    metrics=payload["metrics"])
    assert cs.check_perfetto(trace, ["job0", "job1"]) > 0
