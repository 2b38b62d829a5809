"""The port's fleet, availability model and availability scheduler against
the JAX package's (mirrors ``tests/test_fleet.py``).

Each test builds the same fleet on both sides and holds the port's
results ``==`` the reference's (every ``SimResult`` field, the couplings'
seconds, plans, specs, rows), then asserts the reference test's own
claims on the port's values.  Beyond the mirror:

* 1-job fleets ``==`` the golden cells (``tests/golden/parity_v1.json``)
  and ``==`` the port's CPU lanes on the same inputs;
* ``fleet_sweep`` (``chip_smoke.py``'s port of
  ``benchmarks/fleet_sweep.py``) at its quick size ``==`` its record in
  ``suites/baselines/quick.json``, and at its full size ``==`` the live
  reference, the 1B tenant's measured outage pair and the twins'
  contention that break the script's own claims included;
* ``job_from_model`` ``==`` on every architecture of the zoo;
* ``CheckpointScheduler(objective="availability")`` decides as the
  reference's does (period, trust answers, beta_A, objective value).
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro import fleet as ref_fleet  # noqa: E402
from repro.configs.base import PlatformConfig as RefPlatformConfig  # noqa: E402
from repro.core.prediction import PredictedPlatform as RefPP  # noqa: E402
from repro.core.prediction import Predictor as RefPredictor  # noqa: E402
from repro.core.simulator import NeverTrust as RefNever  # noqa: E402
from repro.core.waste import Platform as RefPlatform  # noqa: E402
from repro.experiments import ScenarioSpec as RefScenario  # noqa: E402
from repro.experiments import StrategySpec as RefStrategy  # noqa: E402
from repro.ft import CheckpointScheduler as RefScheduler  # noqa: E402

from repro_torch.configs.base import PlatformConfig  # noqa: E402
from repro_torch.core.batch import simulate_batch  # noqa: E402
from repro_torch.core.prediction import (PredictedPlatform,  # noqa: E402
                                         Predictor, beta_lim)
from repro_torch.core.simulator import (NeverTrust, SimResult,  # noqa: E402
                                        simulate)
from repro_torch.core.waste import Platform, t_rfo, waste  # noqa: E402
from repro_torch.experiments import ScenarioSpec, StrategySpec  # noqa: E402
from repro_torch.fleet import (FleetJobInput, FleetJobSpec,  # noqa: E402
                               FleetSpec, OutageWeights, beta_avail,
                               evaluate_fleet, job_from_model,
                               measured_unavailability,
                               optimal_period_availability, plan_fleet,
                               plan_job, simulate_fleet, staggered_period,
                               t_avail_nopred, t_avail_pred, unavailability,
                               unavailability_nopred, unavailability_pred)
from repro_torch.ft import CheckpointScheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_PATH = ROOT / "tests" / "golden" / "parity_v1.json"
_FLEET_CELLS = ("baseline_rfo", "prediction_optimal",
                "prediction_exact_model", "predictor_lead_time",
                "stochastic_trust_q")


def _golden_cell(name, side="port"):
    want = json.loads(GOLDEN_PATH.read_text())["cells"][name]
    spec, strat = ((ScenarioSpec, StrategySpec) if side == "port"
                   else (RefScenario, RefStrategy))
    scenario = spec.from_dict(want["scenario"])
    return scenario, strat.from_dict(want["strategy"]).build(scenario), \
        want["makespans"]


def _inputs_for(scenario, strat, i, period=None, side="port"):
    cls = FleetJobInput if side == "port" else ref_fleet.FleetJobInput
    return cls(trace=scenario.make_trace(i), platform=scenario.platform,
               time_base=scenario.time_base,
               period=float(strat.period) if period is None else period,
               cp=scenario.cp, trust=strat.trust,
               inexact_window=strat.inexact_window,
               rng=np.random.default_rng(scenario.seed + 7919 * i))


def _jobs_equal(got, want):
    """Every job of two fleet results ``==``: SimResult fields and the
    couplings' seconds."""
    assert len(got.jobs) == len(want.jobs)
    for g, w in zip(got.jobs, want.jobs):
        assert g.name == w.name
        assert dataclasses.asdict(g.sim) == dataclasses.asdict(w.sim)
        assert (g.time_contention_ckpt, g.time_contention_prockpt,
                g.time_repair_wait) == (w.time_contention_ckpt,
                                        w.time_contention_prockpt,
                                        w.time_repair_wait)


# -- degeneracy: 1 job, no contention == the scalar engine --------------------

@pytest.mark.parametrize("name", _FLEET_CELLS)
def test_one_job_fleet_matches_golden_bit_for_bit(name):
    scenario, strat, makespans = _golden_cell(name)
    got = [simulate_fleet([_inputs_for(scenario, strat, i)]).jobs[0]
           .sim.makespan for i in range(scenario.n_traces)]
    assert got == makespans


def test_one_job_fleet_full_simresult_equality():
    scenario, strat, _ = _golden_cell("prediction_optimal")
    ref_sc, ref_strat, _ = _golden_cell("prediction_optimal", "ref")
    for i in range(scenario.n_traces):
        want = simulate(scenario.make_trace(i), scenario.platform,
                        scenario.time_base, float(strat.period),
                        cp=scenario.cp, trust=strat.trust,
                        inexact_window=strat.inexact_window,
                        rng=np.random.default_rng(scenario.seed + 7919 * i))
        fleet = simulate_fleet([_inputs_for(scenario, strat, i)])
        _jobs_equal(fleet, ref_fleet.simulate_fleet(
            [_inputs_for(ref_sc, ref_strat, i, side="ref")]))
        job = fleet.jobs[0]
        for f in dataclasses.fields(SimResult):
            assert getattr(job.sim, f.name) == getattr(want, f.name), f.name
        assert job.time_contention_ckpt == 0.0
        assert job.time_contention_prockpt == 0.0
        assert job.time_repair_wait == 0.0


def test_one_job_fleet_equals_the_cpu_lanes():
    """The fleet's degeneracy path against the port's lane engine on the
    CPU (the lane loop's plain version), every SimResult field."""
    scenario, strat, makespans = _golden_cell("prediction_optimal")
    n = scenario.n_traces
    lanes = simulate_batch(
        [scenario.make_trace(i) for i in range(n)], scenario.platform,
        scenario.time_base, [float(strat.period)], cp=scenario.cp,
        trust=strat.trust, inexact_window=strat.inexact_window,
        trace_seeds=[scenario.seed + 7919 * i for i in range(n)],
        device="cpu")
    assert lanes.makespan[0].tolist() == makespans
    for i in range(n):
        job = simulate_fleet([_inputs_for(scenario, strat, i)]).jobs[0]
        lane = lanes.result(0, i)
        assert dataclasses.asdict(job.sim) == dataclasses.asdict(lane)


def test_multi_job_uncontended_matches_scalar():
    scenario, strat, makespans = _golden_cell("prediction_optimal")
    ref_sc, ref_strat, _ = _golden_cell("prediction_optimal", "ref")
    fleet = simulate_fleet([_inputs_for(scenario, strat, i)
                            for i in range(scenario.n_traces)])
    _jobs_equal(fleet, ref_fleet.simulate_fleet(
        [_inputs_for(ref_sc, ref_strat, i, side="ref")
         for i in range(ref_sc.n_traces)]))
    assert [j.sim.makespan for j in fleet.jobs] == makespans
    assert fleet.makespan == max(makespans)


# -- storage contention and staggering ----------------------------------------

_FAULT_FREE = dict(n=4, c=600.0, d=60.0, r=600.0, mu_ind=4e12,
                   time_base_years_total=4 * 2.0 / 365.0, n_traces=1,
                   seed=2)


class _Strat:
    period = 7200.0
    trust = NeverTrust()
    inexact_window = 0.0


class _RefStrat(_Strat):
    trust = RefNever()


def _sync_pair(streams, stagger_offsets=(0.0, 0.0), side="port"):
    port = side == "port"
    sc = (ScenarioSpec if port else RefScenario)(**_FAULT_FREE)
    stagger = staggered_period if port else ref_fleet.staggered_period
    inputs = []
    for k, off in enumerate(stagger_offsets):
        period = 7200.0 if off <= 0.0 else stagger(7200.0, off)
        inp = _inputs_for(sc, _Strat() if port else _RefStrat(), 0,
                          period=period, side=side)
        inp.name = f"tenant{k}"
        inputs.append(inp)
    sim = simulate_fleet if port else ref_fleet.simulate_fleet
    return sim(inputs, storage_streams=streams)


def _pair_both(streams, offsets=(0.0, 0.0)):
    got = _sync_pair(streams, offsets)
    _jobs_equal(got, _sync_pair(streams, offsets, side="ref"))
    return got


def test_synchronized_saves_stretch_each_other():
    solo = _pair_both(None)
    shared = _pair_both(1)
    for j in solo.jobs:
        assert j.time_contention_ckpt == 0.0
    c = _FAULT_FREE["c"]
    n_ckpts = round(solo.jobs[0].sim.time_ckpt / c)
    assert n_ckpts > 20
    for j in shared.jobs:
        assert j.time_contention_ckpt == pytest.approx(n_ckpts * c, rel=1e-9)
        assert j.sim.makespan == pytest.approx(
            solo.jobs[0].sim.makespan + n_ckpts * c, rel=1e-9)


def test_staggering_removes_contention():
    staggered = _pair_both(1, (0.0, 3600.0))
    solo = _pair_both(None)
    assert staggered.jobs[0].time_contention_ckpt == 0.0
    assert staggered.jobs[1].time_contention_ckpt == 0.0
    assert staggered.jobs[0].sim.makespan == solo.jobs[0].sim.makespan
    c = _FAULT_FREE["c"]
    assert staggered.jobs[1].sim.time_ckpt == \
        solo.jobs[1].sim.time_ckpt - c
    assert staggered.jobs[1].sim.makespan == solo.jobs[1].sim.makespan - c


def _plan_tuple(p):
    return (p.period, type(p.trust).__name__,
            getattr(p.trust, "threshold", None), p.use_predictions,
            p.expected, p.inexact_window, p.stagger_offset)


def test_plan_fleet_staggers_offsets():
    job = FleetJobSpec(scenario=ScenarioSpec(**_FAULT_FREE))
    plans = plan_fleet(FleetSpec(jobs=(job, job, job), stagger=True))
    ref_job = ref_fleet.FleetJobSpec(scenario=RefScenario(**_FAULT_FREE))
    ref_plans = ref_fleet.plan_fleet(ref_fleet.FleetSpec(
        jobs=(ref_job, ref_job, ref_job), stagger=True))
    assert [_plan_tuple(p) for p in plans] \
        == [_plan_tuple(p) for p in ref_plans]
    offs = [p.stagger_offset for p in plans]
    assert offs[0] == 0.0 and offs[1] > 0.0 and offs[2] > offs[1]
    assert offs[1] == pytest.approx(plans[1].period / 3.0)
    assert isinstance(plans[0].period_arg, float)
    fn, ref_fn = plans[1].period_arg, ref_plans[1].period_arg
    for t in (0.0, 1.0, -1.0, 5e3):
        assert fn(t) == ref_fn(t)
    assert fn(0.0) == pytest.approx(plans[1].period + offs[1])
    assert fn(1.0) == plans[1].period


# -- repair slots --------------------------------------------------------------

_FAULTY = dict(n=64, c=300.0, d=600.0, r=1800.0, mu_ind=64 * 2e5,
               time_base_years_total=64 * 4.0 / 365.0, n_traces=3, seed=9)
_REPAIR_HEAVY = dict(_FAULTY, mu_ind=64 * 1e4)


def test_repair_slots_queue_and_unbounded_is_free():
    sc, ref_sc = ScenarioSpec(**_REPAIR_HEAVY), RefScenario(**_REPAIR_HEAVY)
    strat = StrategySpec("rfo").build(sc)
    ref_strat = RefStrategy("rfo").build(ref_sc)

    def both(**kw):
        got = simulate_fleet([_inputs_for(sc, strat, i) for i in range(3)],
                             **kw)
        _jobs_equal(got, ref_fleet.simulate_fleet(
            [_inputs_for(ref_sc, ref_strat, i, side="ref")
             for i in range(3)], **kw))
        return got

    free = both()
    assert all(j.time_repair_wait == 0.0 for j in free.jobs)
    queued = both(repair_slots=1)
    assert sum(j.time_repair_wait for j in queued.jobs) > 0.0
    for jq, jf in zip(queued.jobs, free.jobs):
        assert jq.sim.makespan >= jf.sim.makespan
        assert jq.sim.n_faults >= jf.sim.n_faults
    both(storage_streams=1, repair_slots=2)
    with pytest.raises(ValueError):
        simulate_fleet([_inputs_for(sc, strat, 0)], repair_slots=0)
    assert simulate_fleet([]).jobs == []


# -- the availability model ----------------------------------------------------

PLAT_KW = dict(mu=5e4, c=600.0, d=60.0, r=600.0)
PLAT, REF_PLAT = Platform(**PLAT_KW), RefPlatform(**PLAT_KW)
PP = PredictedPlatform(PLAT, Predictor(0.85, 0.82), 180.0)
REF_PP = RefPP(REF_PLAT, RefPredictor(0.85, 0.82), 180.0)
WEIGHTS = [(1.0, 1.0, 1.0), (0.25, 0.25, 1.0), (0.5, 1.0, 0.5),
           (0.3, 0.6, 0.9), (1.0, 0.1, 0.2)]


@pytest.mark.parametrize("w", WEIGHTS)
def test_availability_model_equals_reference(w):
    ow, rw = OutageWeights(*w), ref_fleet.OutageWeights(*w)
    for cp in (180.0, 900.0, 5000.0):
        pp = PredictedPlatform(PLAT, Predictor(0.85, 0.82), cp)
        rpp = RefPP(REF_PLAT, RefPredictor(0.85, 0.82), cp)
        assert beta_avail(pp, ow) == ref_fleet.beta_avail(rpp, rw)
        assert t_avail_pred(pp, ow) == ref_fleet.t_avail_pred(rpp, rw)
        assert optimal_period_availability(pp, ow) \
            == ref_fleet.optimal_period_availability(rpp, rw)
        for t in (600.0, 900.0, 3000.0, 9000.0, 40000.0):
            assert unavailability(t, pp, ow) \
                == ref_fleet.unavailability(t, rpp, rw)
            assert unavailability_pred(t, pp, ow) \
                == ref_fleet.unavailability_pred(t, rpp, rw)
            assert unavailability_nopred(t, PLAT, ow) \
                == ref_fleet.unavailability_nopred(t, REF_PLAT, rw)
    assert t_avail_nopred(PLAT, ow) == ref_fleet.t_avail_nopred(REF_PLAT, rw)
    full = Predictor(1.0, 0.9)
    assert t_avail_pred(PredictedPlatform(PLAT, full, 180.0), ow) \
        == ref_fleet.t_avail_pred(RefPP(REF_PLAT, RefPredictor(1.0, 0.9),
                                        180.0), rw)


def test_unit_weights_degenerate_to_waste_model():
    w1 = OutageWeights()
    assert t_avail_nopred(PLAT, w1) == pytest.approx(t_rfo(PLAT))
    assert beta_avail(PP, w1) == pytest.approx(beta_lim(PP))
    t = 9000.0
    wff = PLAT.c / t
    wfault = (PLAT.d + PLAT.r + t / 2.0) / PLAT.mu
    assert unavailability_nopred(t, PLAT, w1) == pytest.approx(wff + wfault)
    assert waste(t, PLAT) == pytest.approx(wff + wfault - wff * wfault)


def test_weighted_optimum_scales_by_sqrt_ratio():
    w = OutageWeights(ckpt=0.25, prockpt=0.25, replay=1.0)
    assert t_avail_nopred(PLAT, w) == \
        pytest.approx(0.5 * t_rfo(PLAT), rel=1e-12)
    assert beta_avail(PP, w) == pytest.approx(0.25 * beta_lim(PP))
    t_a, t_w = t_avail_nopred(PLAT, w), t_rfo(PLAT)
    assert unavailability_nopred(t_a, PLAT, w) < \
        unavailability_nopred(t_w, PLAT, w)


def test_outage_weights_validation_and_round_trip():
    with pytest.raises(ValueError):
        OutageWeights(ckpt=0.0)
    with pytest.raises(ValueError):
        OutageWeights(replay=1.5)
    w = OutageWeights(ckpt=0.3, prockpt=0.6, replay=0.9)
    assert OutageWeights.from_dict(w.to_dict()) == w
    assert w.to_dict() == ref_fleet.OutageWeights(0.3, 0.6, 0.9).to_dict()


def test_unavailability_two_branch_continuity():
    pp = PredictedPlatform(PLAT, Predictor(0.85, 0.82), 900.0)
    w = OutageWeights(ckpt=0.5, prockpt=1.0, replay=0.5)
    beta = beta_avail(pp, w)
    assert beta > PLAT.c
    lo, hi = unavailability(beta, pp, w), unavailability(beta * 1.0001, pp, w)
    assert lo == pytest.approx(hi, rel=1e-3)
    with pytest.raises(ValueError):
        unavailability_nopred(PLAT.c / 2.0, PLAT, w)


def test_measured_unavailability_unit_weights_equals_waste():
    scenario, strat, _ = _golden_cell("prediction_optimal")
    job = simulate_fleet([_inputs_for(scenario, strat, 0)]).jobs[0]
    kw = dict(makespan=job.sim.makespan, time_ckpt=job.sim.time_ckpt,
              time_prockpt=job.sim.time_prockpt, time_down=job.sim.time_down,
              time_lost=job.sim.time_lost)
    u = measured_unavailability(w=OutageWeights(), **kw)
    assert u == ref_fleet.measured_unavailability(
        w=ref_fleet.OutageWeights(), **kw)
    assert u == pytest.approx(job.sim.waste, abs=1e-12)
    w = (0.25, 0.5, 0.75)
    extra = dict(time_contention_ckpt=3.0, time_contention_prockpt=2.0,
                 time_repair_wait=7.0)
    assert measured_unavailability(w=OutageWeights(*w), **kw, **extra) \
        == ref_fleet.measured_unavailability(
            w=ref_fleet.OutageWeights(*w), **kw, **extra)
    assert measured_unavailability(w=OutageWeights(), **dict(
        kw, makespan=0.0)) == 0.0


# -- specs, planning, evaluate_fleet -------------------------------------------

def _round_trip_spec(side):
    port = side == "port"
    fl = None if port else ref_fleet
    mk_job = job_from_model if port else fl.job_from_model
    Job = FleetJobSpec if port else fl.FleetJobSpec
    Spec = FleetSpec if port else fl.FleetSpec
    W = OutageWeights if port else fl.OutageWeights
    return Spec(
        jobs=(mk_job("llama3.2-1b", n_devices=16, n_traces=2, slo=0.99),
              Job(scenario=(ScenarioSpec if port else RefScenario)(
                  **_FAULTY),
                  strategy=(StrategySpec if port else RefStrategy)("rfo"),
                  name="legacy")),
        objective="availability", outage=W(ckpt=0.25, prockpt=0.25,
                                           replay=1.0),
        storage_streams=1, repair_slots=2, stagger=True, name="rt")


def test_fleet_spec_round_trip():
    spec = _round_trip_spec("port")
    assert spec.to_dict() == _round_trip_spec("ref").to_dict()
    assert spec.key() == _round_trip_spec("ref").key()
    back = FleetSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert back == spec
    assert back.key() == spec.key()
    assert back.n_runs == 2
    assert back.job_name(1) == "legacy"
    assert FleetSpec().n_runs == 0
    with pytest.raises(ValueError):
        FleetSpec(objective="throughput")
    with pytest.raises(ValueError):
        FleetJobSpec(scenario=ScenarioSpec(**_FAULTY), slo=1.5)


@pytest.mark.parametrize("arch", sorted(ref_configs.REGISTRY)
                         + sorted(ref_configs.EXTRAS))
def test_job_from_model_equals_reference(arch):
    for kw in (dict(n_devices=256, n_traces=2),
               dict(n_devices=8192, n_traces=3, seed=4, mu_ind=3.15e8,
                    delta_ratio=0.4, r=120.0, time_base_days=20.0,
                    slo=0.999, name="t")):
        got = job_from_model(arch, **kw)
        want = ref_fleet.job_from_model(arch, **kw)
        assert got.to_dict() == want.to_dict()


def test_job_from_model_sizes_from_zoo():
    small = job_from_model("llama3.2-1b", n_devices=16, n_traces=2)
    big = job_from_model("llama3-405b", n_devices=8192, n_traces=2)
    for j in (small, big):
        sc = j.scenario
        assert sc.c > 0.0 and 0.0 < sc.cp < sc.c
        assert sc.r == sc.c
    assert big.scenario.c < 400 * small.scenario.c
    assert big.scenario.platform.mu < small.scenario.platform.mu


def test_plan_job_objectives_diverge():
    job = FleetJobSpec(scenario=ScenarioSpec(**_FAULTY))
    ref_job = ref_fleet.FleetJobSpec(scenario=RefScenario(**_FAULTY))
    w = OutageWeights(ckpt=0.25, prockpt=0.25, replay=1.0)
    rw = ref_fleet.OutageWeights(ckpt=0.25, prockpt=0.25, replay=1.0)
    pw = plan_job(job, "waste")
    pa = plan_job(job, "availability", w)
    assert _plan_tuple(pw) == _plan_tuple(ref_fleet.plan_job(ref_job,
                                                             "waste"))
    assert _plan_tuple(pa) == _plan_tuple(
        ref_fleet.plan_job(ref_job, "availability", rw))
    strat_job = FleetJobSpec(scenario=ScenarioSpec(**_FAULTY),
                             strategy=StrategySpec("optimal_prediction"))
    assert _plan_tuple(plan_job(strat_job)) == _plan_tuple(
        ref_fleet.plan_job(ref_fleet.FleetJobSpec(
            scenario=RefScenario(**_FAULTY),
            strategy=RefStrategy("optimal_prediction"))))
    assert pa.period < pw.period
    if pa.use_predictions == pw.use_predictions:
        assert pa.expected < pw.expected
    if pa.use_predictions and pw.use_predictions:
        assert pa.trust.threshold < pw.trust.threshold


def test_plan_job_rejects_single_job_engine_features():
    job = FleetJobSpec(scenario=ScenarioSpec(**dict(_FAULTY, window=9000.0)),
                       strategy=StrategySpec("window_proactive"))
    with pytest.raises(ValueError, match="window_mode"):
        plan_job(job)
    job = FleetJobSpec(scenario=ScenarioSpec(**_FAULTY),
                       strategy=StrategySpec("adaptive", {"min_preds": 4,
                                                          "min_faults": 2}))
    with pytest.raises(ValueError, match="adaptive"):
        plan_job(job)
    job = FleetJobSpec(scenario=ScenarioSpec(**_FAULTY),
                       strategy=StrategySpec("dynamic_rfo",
                                             {"shape": 0.7}))
    with pytest.raises(ValueError, match="constant"):
        plan_job(job)


def _slo_fleet(side):
    port = side == "port"
    Job = FleetJobSpec if port else ref_fleet.FleetJobSpec
    Spec = FleetSpec if port else ref_fleet.FleetSpec
    W = OutageWeights if port else ref_fleet.OutageWeights
    Sc = ScenarioSpec if port else RefScenario
    return Spec(jobs=(Job(scenario=Sc(**_FAULTY), name="a", slo=0.97),
                      Job(scenario=Sc(**dict(_FAULTY, seed=17)), name="b",
                          slo=0.5)),
                objective="availability",
                outage=W(ckpt=0.5, prockpt=0.5, replay=1.0),
                storage_streams=1, repair_slots=1, n_traces=2,
                name="slo-fleet")


def test_evaluate_fleet_reports_per_tenant_slos():
    table = evaluate_fleet(_slo_fleet("port"))
    assert table.rows == ref_fleet.evaluate_fleet(_slo_fleet("ref")).rows
    assert [r["job"] for r in table.rows] == ["a", "b"]
    for row in table.rows:
        assert row["fleet"] == "slo-fleet"
        assert row["objective"] == "availability"
        assert 0.0 < row["availability"] < 1.0
        assert row["availability"] == pytest.approx(
            1.0 - row["unavailability"])
        assert 0.0 <= row["slo_met"] <= 1.0
        assert row["expected_objective"] > 0.0
        assert row["n_faults"] > 0
    assert table.rows[1]["slo_met"] >= table.rows[0]["slo_met"]
    assert sum(r["contention_ckpt_s"] + r["repair_wait_s"]
               for r in table.rows) >= 0.0


def test_evaluate_fleet_availability_objective_beats_waste_plan():
    w = OutageWeights(ckpt=0.25, prockpt=0.25, replay=1.0)
    rw = ref_fleet.OutageWeights(ckpt=0.25, prockpt=0.25, replay=1.0)
    jobs = (FleetJobSpec(scenario=ScenarioSpec(**_FAULTY), name="t"),)
    ref_jobs = (ref_fleet.FleetJobSpec(scenario=RefScenario(**_FAULTY),
                                       name="t"),)
    by_obj = {}
    for obj in ("waste", "availability"):
        rows = evaluate_fleet(FleetSpec(jobs=jobs, objective=obj,
                                        outage=w)).rows
        assert rows == ref_fleet.evaluate_fleet(ref_fleet.FleetSpec(
            jobs=ref_jobs, objective=obj, outage=rw)).rows
        by_obj[obj] = rows[0]
    assert by_obj["availability"]["period"] < by_obj["waste"]["period"]
    assert by_obj["availability"]["unavailability"] < \
        by_obj["waste"]["unavailability"]


# -- fleet_sweep: the record and the live reference ----------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_sweep(n_traces):
    """benchmarks/fleet_sweep.py's tables through the JAX package, without
    the script's asserts (it stops at its first failed claim)."""
    import sys
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import fleet_sweep as fs
    rows = {obj: ref_fleet.evaluate_fleet(ref_fleet.FleetSpec(
        jobs=fs._jobs(n_traces), objective=obj, outage=fs.WEIGHTS,
        name=f"hetero-{obj}")).rows for obj in ("waste", "availability")}
    cont = {}
    for stagger in (False, True):
        t = ref_fleet.evaluate_fleet(ref_fleet.FleetSpec(
            jobs=fs._twins(n_traces), objective="availability",
            outage=fs.WEIGHTS, storage_streams=1, stagger=stagger,
            name=f"twins-stagger={stagger}"))
        cont[stagger] = sum(r["contention_ckpt_s"] + r["contention_prockpt_s"]
                            for r in t.rows)
    return rows, {"synchronized": cont[False], "staggered": cont[True]}


def test_fleet_sweep_quick_equals_record_and_reference():
    cs = _chip_smoke()
    payload, _ = cs.fleet_sweep_payload(cs.FLEET_QUICK)
    record = cs._quick_record(cs.FLEET_RECORD)["payload"]
    for key in ("rows", "contention_s", "model_vs_sim", "metrics"):
        assert payload[key] == record[key], key
    rows, cont = _ref_sweep(cs.FLEET_QUICK)
    assert payload["rows"] == rows and payload["contention_s"] == cont
    assert len(cs.fleet_sweep_claims(payload, all_claims=True)) == 4


def test_fleet_sweep_full_equals_reference():
    """At 25 traces the port gives the reference's rows, including the
    1B tenant's measured outage pair (8.0026e-05 under the waste plan
    against 8.0702e-05 under the availability plan) that breaks
    fleet_sweep.py:87, and the twins' contention whose cut (9.76x) misses
    the script's 10x; the suite's own claim holds."""
    cs = _chip_smoke()
    payload, _ = cs.fleet_sweep_payload(cs.FLEET_FULL)
    rows, cont = _ref_sweep(cs.FLEET_FULL)
    assert payload["rows"] == rows and payload["contention_s"] == cont
    by = {obj: {r["job"]: r for r in rs} for obj, rs in rows.items()}
    small = ("llama3.2-1b", "unavailability")
    assert by["waste"][small[0]][small[1]] < \
        by["availability"][small[0]][small[1]]
    assert not cont["staggered"] < 0.1 * cont["synchronized"]
    with pytest.raises(AssertionError):
        cs.fleet_sweep_claims(payload, all_claims=True)
    cs.fleet_sweep_claims(payload, all_claims=False)
    assert 0.9 <= payload["model_vs_sim"]["llama3-405b"] <= 1.1


# -- the availability objective of the scheduler -------------------------------

_SCHED_PLATFORMS = {
    "ft": (dict(mu_ind=300.0, c=30.0, cp=10.0, d=5.0, r=15.0), 1),
    "mesh512": (dict(mu_ind=125 * 365 * 86400.0, c=600.0, cp=600.0,
                     d=60.0, r=600.0), 512),
    "cheap_cp": (dict(mu_ind=125 * 365 * 86400.0, c=600.0, cp=60.0,
                      d=60.0, r=600.0), 4096),
    "no_recall": (dict(recall=0.0), 64),
}


@pytest.mark.parametrize("name", sorted(_SCHED_PLATFORMS))
@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("use_predictor", [True, False])
def test_availability_scheduler_equals_reference(name, w, use_predictor):
    over, n = _SCHED_PLATFORMS[name]
    kw = dict(over, ckpt_outage=w[0], prockpt_outage=w[1],
              replay_outage=w[2])
    port = CheckpointScheduler(PlatformConfig(**kw), n,
                               use_predictor=use_predictor,
                               objective="availability")
    ref = RefScheduler(RefPlatformConfig(**kw), n,
                       use_predictor=use_predictor, objective="availability")
    assert dataclasses.astuple(port.decision) \
        == dataclasses.astuple(ref.decision)
    assert (port.objective, port.mu, port.c, port.cp, port.use_predictor) \
        == (ref.objective, ref.mu, ref.c, ref.cp, ref.use_predictor)
    for s in (ref, port):
        s.notify_save_completed(50.0)
    for t in np.linspace(0.0, 3 * ref.period, 61):
        assert port.due(t) == ref.due(t)
        assert port.trust(t) == ref.trust(t)
    assert port.steps_per_checkpoint(10.0) == ref.steps_per_checkpoint(10.0)
    if w == (1.0, 1.0, 1.0) and use_predictor and name != "no_recall":
        waste_plan = CheckpointScheduler(PlatformConfig(**kw), n)
        assert port.decision.beta_lim == pytest.approx(
            waste_plan.decision.beta_lim)
