"""Adaptive re-planning lanes and unbounded deferred faults, against the
JAX package, bitwise.

* Adaptive lanes: ``simulate_batch(..., adaptive=cfg, device="cpu")`` ``==``
  the reference's numpy lanes on every ``BatchResult`` field (makespans,
  counters, ``n_replans``, ``final_period``, ``final_threshold``,
  ``est_*``) over the five configurations of
  ``tests/test_jax_engine.py:103-134`` (plain, halflife, estimate_mu, the
  exact model, and mu + halflife + "within" windows) under host-loop caps
  1, 7, 16 and the engine's own, every case re-planning; the Never-trust
  prior and adaptive lanes beside static ones
  (``tests/test_predictors.py:415-486``).
* The estimator: ``maybe_replan``, ``AdaptiveConfig`` (validation, key,
  plans at both model orders), ``OnlineRPEstimator`` and the exact model's
  functions return the reference's floats.
* Deferred faults past the 8 register slots: the overflowed lanes rerun
  from their start with 16, 32, ... slots, and only they do; the result is
  the numpy lanes' (whose slots grow), adaptive lanes included.

Tolerance: none (``==``).  The ``gpu``-marked cases hold the kernel's
adaptive instantiation and its wide route to the plain loop on the card
and skip here.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.batch import simulate_batch as ref_simulate_batch  # noqa: E402
from repro.core.traces import (FAULT_PRED, EventTrace, Exponential,  # noqa: E402
                               make_event_trace)
from repro.core.waste import Platform as RefPlatform  # noqa: E402
from repro.predictors import estimator as ref_est  # noqa: E402

import repro_torch.core.batch_torch as batch_torch  # noqa: E402
import repro_torch.kernels.lane_loop as ll  # noqa: E402
from repro_torch.core import exact, simulator as sim, waste  # noqa: E402
from repro_torch.core.batch import simulate_batch  # noqa: E402
from repro_torch.core.prediction import PredictedPlatform, Predictor  # noqa: E402
from repro_torch.core.traces import traces_from_numpy  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry, set_registry  # noqa: E402
from repro_torch.predictors import estimator as est  # noqa: E402

ref_exact = importlib.import_module("repro.core.exact")
ref_waste = importlib.import_module("repro.core.waste")
ref_prediction = importlib.import_module("repro.core.prediction")

REF_PLAT = RefPlatform(mu=2500.0, c=60.0, d=10.0, r=30.0)
PLAT = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
TIME_BASE = 30000.0
PERIODS = [1200.0, 2500.0]
SEEDS = [5, 6, 7]
NO_CAP = 2 ** 31 - 1

# tests/test_jax_engine.py:103-134: four configurations and the heaviest
# combination (online mu, EW decay and "within" windows).
_BASE = dict(prior_recall=0.5, prior_precision=0.5, min_preds=8,
             min_faults=4, tol=0.02)
CONFIGS = {
    "plain": ({}, {}),
    "halflife": (dict(halflife=64.0), {}),
    "estimate_mu": (dict(estimate_mu=True), {}),
    "exact_model": (dict(model_order="exact"), {}),
    "mu_halflife_within": (dict(halflife=64.0, estimate_mu=True),
                           dict(window_mode="within", window_period=100.0)),
}
CAPS = [1, 7, 16, batch_torch._LAUNCH_CAP]
CAP_IDS = ["cap1", "cap7", "cap16", "engine_cap"]


def _carry(traces):
    return traces_from_numpy([t.times for t in traces],
                             [t.kinds for t in traces],
                             [t.horizon for t in traces],
                             [t.windows for t in traces])


def _traces(seeds=(20, 21, 22)):
    return [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6,
                             100000.0, np.random.default_rng(s))
            for s in seeds]


def _port_trust(t):
    if isinstance(t, ref_sim.NeverTrust):
        return sim.NeverTrust()
    if isinstance(t, ref_sim.AlwaysTrust):
        return sim.AlwaysTrust()
    if isinstance(t, ref_sim.ThresholdTrust):
        return sim.ThresholdTrust(t.threshold)
    return sim.FixedProbabilityTrust(t.q)


def _port_cfg(cfg):
    return None if cfg is None else est.AdaptiveConfig(
        **dataclasses.asdict(cfg))


def _assert_bitwise(a, b, tag: str) -> None:
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.shape == vb.shape and (va == vb).all(), \
                f"{tag}: field {f.name} diverged"
        else:
            assert va == vb, f"{tag}: {f.name}"


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


def _both(traces, platform, time_base, periods, *, trust, adaptive,
          **kw):
    """The reference's numpy lanes and the port on the CPU."""
    ref = ref_simulate_batch(traces, platform[0], time_base, periods,
                             trust=trust, adaptive=adaptive, **kw)
    port_ad = ([_port_cfg(a) for a in adaptive]
               if isinstance(adaptive, list) else _port_cfg(adaptive))
    port_trust = ([_port_trust(t) for t in trust]
                  if isinstance(trust, list) else _port_trust(trust))
    port = simulate_batch(_carry(traces), platform[1], time_base, periods,
                          trust=port_trust, adaptive=port_ad,
                          device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("cap", CAPS, ids=CAP_IDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_adaptive_lanes_match_numpy(name, cap, monkeypatch, registry):
    """Every field ``==`` the numpy lanes under every cap; every case
    re-plans, and the host's re-plan count is the lanes' own."""
    monkeypatch.setattr(batch_torch, "_LAUNCH_CAP", cap)
    extra, kw = CONFIGS[name]
    cfg = ref_est.AdaptiveConfig(**_BASE, **extra)
    ref, port = _both(_traces(), (REF_PLAT, PLAT), TIME_BASE, PERIODS,
                      trust=ref_sim.ThresholdTrust(100.0), adaptive=cfg,
                      cp=30.0, inexact_window=300.0, trace_seeds=SEEDS, **kw)
    _assert_bitwise(ref, port, f"{name} cap={cap}")
    assert (ref.n_replans > 0).any(), "no lane re-planned: inert case"
    c = registry.counters
    assert c["engine.replans"] == int(ref.n_replans.sum())
    iters, rounds = c["torch.iterations"], c["torch.replan_rounds"]
    assert 0 < rounds <= c["engine.replans"]
    assert c["torch.loop_calls"] <= math.ceil(iters / cap) + rounds
    assert registry.timers["torch.replan_s"] > 0.0
    if extra.get("estimate_mu"):
        assert (ref.est_mu > 0).any()


def _parity_case():
    """tests/test_predictors.py:415-424."""
    p = RefPlatform(mu=5e4, c=600.0, d=60.0, r=600.0)
    tb, cp = 3e5, 600.0
    cfg = ref_est.AdaptiveConfig(prior_recall=0.3, prior_precision=0.95,
                                 min_preds=8, min_faults=4, tol=0.03)
    t0, thr0 = cfg.plan(p, cp, cfg.prior_recall, cfg.prior_precision)
    traces = [make_event_trace(Exponential(1.0), p.mu, 0.85, 0.8, 40 * tb,
                               np.random.default_rng(i)) for i in range(4)]
    return (p, Platform(mu=p.mu, c=p.c, d=p.d, r=p.r)), tb, cp, cfg, t0, \
        ref_sim.ThresholdTrust(thr0), traces


@pytest.mark.parametrize("window", [0.0, 1200.0])
def test_adaptive_beside_static_candidates(window):
    """An adaptive and a static candidate in one grid (and with an inexact
    window): the static lanes keep their plan and the -1 sentinels."""
    plat, tb, cp, cfg, t0, trust, traces = _parity_case()
    ref, port = _both(traces, plat, tb, [t0, 9000.0], cp=cp,
                      trust=[trust, ref_sim.NeverTrust()],
                      adaptive=[cfg, None], inexact_window=window,
                      trace_seeds=7)
    _assert_bitwise(ref, port, "mixed candidates")
    assert (port.n_replans[0] >= 1).any() and (port.n_replans[1] == 0).all()
    assert (port.final_period[1] == 9000.0).all()
    assert (port.final_threshold[1] == -1.0).all()
    assert (port.est_recall[1] == -1.0).all()


def test_adaptive_never_trust_prior_matches_numpy():
    """A prior whose plan says 'never trust' (threshold +inf) runs as
    Threshold(+inf) and re-plans into trusting."""
    plat, tb, cp, _, _, _, traces = _parity_case()
    cfg = ref_est.AdaptiveConfig(prior_recall=0.05, prior_precision=0.05,
                                 min_preds=8, min_faults=4, tol=0.03)
    t0, thr0 = cfg.plan(plat[0], cp, cfg.prior_recall, cfg.prior_precision)
    assert math.isinf(thr0)
    ref, port = _both(traces, plat, tb, [t0], cp=cp,
                      trust=ref_sim.NeverTrust(), adaptive=cfg,
                      trace_seeds=5)
    _assert_bitwise(ref, port, "never-trust prior")
    assert np.isfinite(port.final_threshold).any()
    assert (port.n_trusted > 0).any()


# -- the estimator and the exact model ------------------------------------------

_COUNTS = [(0, 0, 0), (7, 0, 3), (8, 0, 4), (20, 5, 4), (30, 30, 1),
           (0, 40, 16), (12.5, 3.25, 8.75), (100, 3, 2), (40, 0, 0)]


@pytest.mark.parametrize("extra", [{}, dict(model_order="exact"),
                                   dict(estimate_mu=True, halflife=32.0)],
                         ids=["first", "exact", "mu_halflife"])
def test_maybe_replan_matches_reference(extra):
    rp = RefPlatform(mu=5e4, c=600.0, d=60.0, r=600.0)
    pp = Platform(mu=5e4, c=600.0, d=60.0, r=600.0)
    kw = dict(prior_recall=0.3, prior_precision=0.95, min_preds=8,
              min_faults=4, tol=0.03, **extra)
    ref_cfg, cfg = ref_est.AdaptiveConfig(**kw), est.AdaptiveConfig(**kw)
    fired = 0
    for ntp, nfp, nuf in _COUNTS:
        for planned in ((0.3, 0.95), (0.85, 0.82)):
            for mu in ((None, None), (4e4, 5e4), (5.1e4, 5e4)):
                args = (float(ntp), float(nfp), float(nuf)) + planned
                want = ref_est.maybe_replan(ref_cfg, rp, 600.0, *args,
                                            mu_hat=mu[0], planned_mu=mu[1])
                got = est.maybe_replan(cfg, pp, 600.0, *args, mu_hat=mu[0],
                                       planned_mu=mu[1])
                assert got == want, (ntp, nfp, nuf, planned, mu)
                fired += want is not None
    assert fired > 0


@pytest.mark.parametrize("kw", [
    dict(min_preds=0), dict(min_faults=0), dict(tol=0.0),
    dict(model_order="second"), dict(halflife=-1.0),
    dict(halflife=2.0, min_preds=32)])
def test_adaptive_config_validation_matches_reference(kw):
    base = dict(prior_recall=0.5, prior_precision=0.5)
    with pytest.raises(ValueError):
        ref_est.AdaptiveConfig(**base, **kw)
    with pytest.raises(ValueError):
        est.AdaptiveConfig(**base, **kw)


@pytest.mark.parametrize("order", ["first", "exact"])
def test_adaptive_config_plans_match_reference(order):
    kw = dict(prior_recall=0.7, prior_precision=0.4, halflife=64.0,
              model_order=order, estimate_mu=True)
    ref_cfg, cfg = ref_est.AdaptiveConfig(**kw), est.AdaptiveConfig(**kw)
    assert cfg.key() == ref_cfg.key() and cfg.decay == ref_cfg.decay
    for mu, c, d, r, cp in [(60150.0, 600.0, 60.0, 600.0, 600.0),
                            (2500.0, 60.0, 10.0, 30.0, 30.0),
                            (800.0, 600.0, 60.0, 600.0, 300.0)]:
        for rec, prec, mu_hat in [(0.85, 0.82, None), (0.05, 0.2, None),
                                  (0.5, 0.999, 0.8 * mu), (1.0, 0.3, None)]:
            want = ref_cfg.plan(RefPlatform(mu=mu, c=c, d=d, r=r), cp, rec,
                                prec, mu=mu_hat)
            got = cfg.plan(Platform(mu=mu, c=c, d=d, r=r), cp, rec, prec,
                           mu=mu_hat)
            assert got == want
    assert est.decay_factor(None) == ref_est.decay_factor(None) == 1.0


@pytest.mark.parametrize("halflife", [None, 16.0])
def test_online_estimator_matches_reference(halflife):
    rng = np.random.default_rng(4)
    ref_e = ref_est.OnlineRPEstimator(min_preds=8, min_faults=4,
                                      halflife=halflife)
    e = est.OnlineRPEstimator(min_preds=8, min_faults=4, halflife=halflife)
    assert (e.recall, e.precision) == (ref_e.recall, ref_e.precision)
    for _ in range(300):
        if rng.random() < 0.6:
            ok = bool(rng.random() < 0.8)
            ref_e.observe_prediction(ok)
            e.observe_prediction(ok)
        else:
            pred = bool(rng.random() < 0.5)
            ref_e.observe_fault(pred)
            e.observe_fault(pred)
        for attr in ("n_true_pred", "n_false_pred", "n_unpred_faults",
                     "ready", "recall", "precision", "n_predictions",
                     "n_faults"):
            assert getattr(e, attr) == getattr(ref_e, attr), attr
    assert e.ready
    assert est.estimate_precision(0.0, 5.0) == \
        ref_est.estimate_precision(0.0, 5.0) == est.P_HAT_MIN


PLATFORMS = [(60150.0, 600.0, 60.0, 600.0), (2500.0, 60.0, 10.0, 30.0),
             (800.0, 600.0, 60.0, 600.0)]
PREDICTORS = [(0.85, 0.82, 600.0), (0.5, 0.3, 60.0), (0.99, 0.999, 30.0),
              (0.0, 0.5, 600.0)]


@pytest.mark.parametrize("plat", PLATFORMS)
@pytest.mark.parametrize("pred", PREDICTORS)
def test_exact_model_matches_reference(plat, pred):
    """Every function of core/exact.py, and the Lambert-W pieces of
    core/waste.py, return the reference's floats."""
    mu, c, d, r = plat
    recall, precision, cp = pred
    p, rp = Platform(mu=mu, c=c, d=d, r=r), RefPlatform(mu=mu, c=c, d=d, r=r)
    pp = PredictedPlatform(p, Predictor(recall, precision), cp)
    rpp = ref_prediction.PredictedPlatform(
        rp, ref_prediction.Predictor(recall, precision), cp)
    t = 3.0 * c
    assert exact.repair_time_exact(p) == ref_exact.repair_time_exact(rp)
    assert exact.expected_cycle_nopred(t, p) == \
        ref_exact.expected_cycle_nopred(t, rp)
    assert exact.waste_exact_nopred(t, p) == ref_exact.waste_exact_nopred(t, rp)
    assert exact.expected_makespan_exact_nopred(t, 1e6, p) == \
        ref_exact.expected_makespan_exact_nopred(t, 1e6, rp)
    assert exact.t_exact_nopred(p) == ref_exact.t_exact_nopred(rp)
    for beta in (0.0, cp, 2.5 * cp, 1e9):
        assert exact.exact_cycle_prediction(t, pp, beta) == \
            ref_exact.exact_cycle_prediction(t, rpp, beta)
        assert exact.waste_exact_prediction(t, pp, beta) == \
            ref_exact.waste_exact_prediction(t, rpp, beta)
        assert exact.expected_makespan_exact_prediction(t, 1e6, pp, beta) \
            == ref_exact.expected_makespan_exact_prediction(t, 1e6, rpp,
                                                            beta)
    if recall > 0.0:
        assert exact.beta_lim_exact(pp) == ref_exact.beta_lim_exact(rpp)
    for refine in (True, False):
        assert dataclasses.astuple(exact.optimal_period_exact(pp, refine)) \
            == dataclasses.astuple(ref_exact.optimal_period_exact(rpp,
                                                                  refine))
    assert dataclasses.astuple(exact.optimal_period_exact_nopred(p)) == \
        dataclasses.astuple(ref_exact.optimal_period_exact_nopred(rp))
    assert exact.minimize_scalar(lambda x: (x - 3.0) ** 2, 0.5, 10.0) == \
        ref_exact.minimize_scalar(lambda x: (x - 3.0) ** 2, 0.5, 10.0)
    assert waste.t_exact_exponential(p) == ref_waste.t_exact_exponential(rp)
    assert waste.expected_makespan_exponential(t, 1e6, p) == \
        ref_waste.expected_makespan_exponential(t, 1e6, rp)
    assert waste.expected_makespan_first_order(t, 1e6, p) == \
        ref_waste.expected_makespan_first_order(t, 1e6, rp)
    for z, branch in ((0.5, 0), (-0.2, 0), (-0.2, -1), (5.0, 0)):
        assert waste.lambert_w(z, branch) == ref_waste.lambert_w(z, branch)


# -- deferred faults past the register slots -------------------------------------

def _stack_trace(n: int) -> EventTrace:
    """``n`` true predictions a few seconds apart, each with a window wide
    enough that all their faults are in flight at once."""
    times = 1000.0 + 10.0 * np.arange(n)
    return EventTrace(times, np.full(n, FAULT_PRED, dtype=np.int8), 1e7,
                      np.full(n, 1e6))


def _capture_slots(monkeypatch) -> list:
    """(slots, lane count) of every chunk the engine runs."""
    seen = []
    real = batch_torch._run_chunk

    def recording(loop, lanes, g, cap, replan=None):
        seen.append((lanes.slots, lanes.f.shape[1]))
        return real(loop, lanes, g, cap, replan)

    monkeypatch.setattr(batch_torch, "_run_chunk", recording)
    return seen


@pytest.mark.parametrize("n_faults,slots", [
    (9, [8, 16]), (12, [8, 16]), (20, [8, 16, 32]), (40, [8, 16, 32, 64])])
def test_slots_double_until_no_lane_overflows(n_faults, slots, monkeypatch,
                                              registry):
    """Only the overflowed lanes rerun, with twice the slots each time,
    and all lanes end with the numpy lanes' bits."""
    seen = _capture_slots(monkeypatch)
    traces = [_stack_trace(n_faults)] + _traces(seeds=(3, 4))
    ref, port = _both(traces, (REF_PLAT, PLAT), TIME_BASE, PERIODS,
                      trust=ref_sim.AlwaysTrust(), adaptive=None, cp=30.0,
                      trace_seeds=[3, 4, 5])
    _assert_bitwise(ref, port, f"{n_faults} faults in flight")
    # The first chunk holds every lane; the reruns, the two lanes (one per
    # period) of the stacked trace.
    assert seen == [(8, 6)] + [(k, 2) for k in slots[1:]]
    assert registry.counters["engine.deferred_overflows"] == 1


def test_adaptive_lanes_rerun_past_the_slots(monkeypatch, registry):
    """An adaptive lane that overflows reruns as an adaptive lane: its
    re-plans and estimates are the numpy lanes'."""
    seen = _capture_slots(monkeypatch)
    cfg = ref_est.AdaptiveConfig(**_BASE)
    traces = [_stack_trace(12)] + _traces(seeds=(3,))
    ref, port = _both(traces, (REF_PLAT, PLAT), TIME_BASE, PERIODS,
                      trust=ref_sim.ThresholdTrust(100.0), adaptive=cfg,
                      cp=30.0, trace_seeds=[3, 4])
    _assert_bitwise(ref, port, "adaptive overflow")
    assert seen[0] == (8, 4) and seen[1][0] == 16
    assert (ref.n_replans[:, 1] > 0).all()


# -- on the card ---------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode "
                    "(chip_smoke.py runs these checks on the GPU)")


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return bool(torch.equal(a, b))


def _record_chunks(monkeypatch) -> list:
    """(chunk state at its start, bank, re-plan callback) of every chunk."""
    seen = []
    real = batch_torch._run_chunk

    def recording(loop, lanes, g, cap, replan=None):
        seen.append((lanes.clone(), g, replan))
        return real(loop, lanes, g, cap, replan)

    monkeypatch.setattr(batch_torch, "_run_chunk", recording)
    return seen


def _port_run(name, device):
    extra, kw = CONFIGS[name]
    return simulate_batch(
        _carry(_traces()), PLAT, TIME_BASE, PERIODS, cp=30.0,
        trust=sim.ThresholdTrust(100.0), inexact_window=300.0,
        adaptive=est.AdaptiveConfig(**_BASE, **extra), trace_seeds=SEEDS,
        device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cuda_adaptive_kernel_matches_plain(name, monkeypatch):
    """lane_loop_kernel<adaptive> == the plain loop on the same CUDA
    chunk, call for call (each re-plan round between), at the engine's cap
    and at a cap of 1; the CUDA engine == the CPU on every field."""
    _need_cuda()
    seen = _record_chunks(monkeypatch)
    on_cpu = _port_run(name, "cpu")
    lanes, g, replan = seen[0]
    lanes, g = lanes.to("cuda"), g.to("cuda")
    assert lanes.adaptive
    plain = lanes.clone()
    batch_torch._run_chunk(ll.lane_loop_ref, plain, g, NO_CAP, replan)
    for cap in (batch_torch._LAUNCH_CAP, 1):
        kern = lanes.clone()
        before = ll.lane_loop.launches
        calls = batch_torch._run_chunk(ll.lane_loop, kern, g, cap, replan)
        assert ll.lane_loop.launches - before == calls
        for part in ("f", "i", "q"):
            assert _bits_equal(getattr(kern, part), getattr(plain, part)), \
                f"{name} cap={cap}: {part}"
    monkeypatch.undo()
    _assert_bitwise(on_cpu, _port_run(name, "cuda"), f"{name} cuda")


@pytest.mark.gpu
def test_cuda_wide_rerun_matches_cpu(monkeypatch):
    """The wide route on the card: CUDA == CPU, through the kernel, and
    the rerun chunk holds only the overflowed lanes."""
    _need_cuda()
    traces = _carry([_stack_trace(40)] + _traces(seeds=(3, 4)))
    kw = dict(cp=30.0, trust=sim.AlwaysTrust(), trace_seeds=[3, 4, 5])
    on_cpu = simulate_batch(traces, PLAT, TIME_BASE, PERIODS, device="cpu",
                            **kw)
    seen = _capture_slots(monkeypatch)
    before = ll.lane_loop.launches
    on_gpu = simulate_batch(traces, PLAT, TIME_BASE, PERIODS, **kw)
    _assert_bitwise(on_cpu, on_gpu, "wide route")
    assert seen == [(8, 6), (16, 2), (32, 2), (64, 2)]
    assert ll.lane_loop.launches - before == 4
