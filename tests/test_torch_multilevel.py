"""The port's two-level model and online estimator against the JAX
package's (mirrors ``tests/test_extensions.py``).

Each test runs the port and the reference on the same inputs, drawn from
a seed with numpy, and holds the port's value ``==`` the reference's:
two-level waste and its (T1*, k*) optimum, the fault stream of
``two_level_stream`` (built on the port's own ``core/traces.py``), every
field of ``simulate_two_level``'s result, the estimator's state and the
adaptive scheduler's re-plans.  The reference test's own claims are then
asserted on the port's values.  In the degenerate single-level limits
(phi = 0 with k = 1, phi = 1 with C1 = C2) the two-level engine is
``==`` the port's scalar oracle.
"""

import dataclasses
import math

import numpy as np
import pytest

from repro.configs.base import PlatformConfig as RefPlatformConfig
from repro.core import multilevel as ref_ml
from repro.core.simulator import NeverTrust as RefNever
from repro.core.simulator import simulate as ref_simulate
from repro.core.traces import EventTrace as RefTrace
from repro.core.traces import Weibull as RefWeibull
from repro.core.waste import Platform as RefPlatform
from repro.ft.estimator import AdaptiveScheduler as RefAdaptive
from repro.ft.estimator import OnlineEstimator as RefEstimator

from repro_torch.configs.base import PlatformConfig
from repro_torch.core import (TwoLevelPlatform, optimal_two_level,
                              simulate_two_level, two_level_stream,
                              waste_two_level)
from repro_torch.core.simulator import NeverTrust, simulate
from repro_torch.core.traces import EventTrace, Weibull
from repro_torch.core.waste import Platform, t_rfo, waste
from repro_torch.ft import AdaptiveScheduler, OnlineEstimator


def _pair(**kw):
    return TwoLevelPlatform(**kw), ref_ml.TwoLevelPlatform(**kw)


def _streams(kw, horizon, seed, dist=None, ref_dist=None):
    p, rp = _pair(**kw)
    got = two_level_stream(p, horizon, np.random.default_rng(seed),
                           dist=dist)
    want = ref_ml.two_level_stream(rp, horizon, np.random.default_rng(seed),
                                   dist=ref_dist)
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    return got


def _simulate_both(kw, faults, soft, time_base, t1, k):
    p, rp = _pair(**kw)
    got = simulate_two_level(faults, soft, p, time_base, t1, k)
    want = ref_ml.simulate_two_level(faults, soft, rp, time_base, t1, k)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.waste == want.waste
    return got


def test_two_level_reduces_to_single_level_at_k1():
    kw = dict(mu=10_000.0, phi=0.0, c1=10.0, c2=100.0, r1=10.0, r2=100.0,
              d=5.0)
    p2, rp2 = _pair(**kw)
    p1 = Platform(mu=10_000.0, c=100.0, d=5.0, r=100.0)
    for t in (500.0, 1000.0, 2000.0):
        assert waste_two_level(t, 1, p2) == ref_ml.waste_two_level(t, 1,
                                                                   rp2)
        assert waste_two_level(t, 1, p2) == pytest.approx(waste(t, p1))
    with pytest.raises(ValueError):
        waste_two_level(0.0, 1, p2)
    with pytest.raises(ValueError):
        TwoLevelPlatform(mu=1.0, phi=1.5, c1=1.0, c2=1.0, r1=1.0, r2=1.0)


def test_two_level_t1_star_is_argmin():
    kw = dict(mu=20_000.0, phi=0.7, c1=5.0, c2=120.0, r1=5.0, r2=120.0,
              d=2.0)
    p, rp = _pair(**kw)
    t1, k, w = optimal_two_level(p)
    assert (t1, k, w) == ref_ml.optimal_two_level(rp)
    assert optimal_two_level(p, k_max=3) == ref_ml.optimal_two_level(
        rp, k_max=3)
    assert k >= 2
    for f in (0.7, 0.9, 1.1, 1.4):
        assert waste_two_level(t1 * f, k, p) >= w - 1e-12
    for kk in (max(1, k - 1), k + 1):
        t1k = max(p.c1, math.sqrt(
            2 * p.mu * ((kk - 1) * p.c1 + p.c2)
            / (kk * (p.phi + (1 - p.phi) * kk))))
        assert waste_two_level(t1k, kk, p) >= w - 1e-12


def test_two_level_beats_single_level_with_soft_faults():
    mu, phi = 5_000.0, 0.8
    kw = dict(mu=mu, phi=phi, c1=5.0, c2=150.0, r1=5.0, r2=150.0, d=2.0)
    p2, _ = _pair(**kw)
    p1 = Platform(mu=mu, c=150.0, d=2.0, r=150.0)
    rp1 = RefPlatform(mu=mu, c=150.0, d=2.0, r=150.0)
    t1, k, w2 = optimal_two_level(p2)
    assert w2 < waste(t_rfo(p1), p1)
    time_base = 200_000.0
    m2 = m1 = 0.0
    for seed in range(8):
        faults, soft = _streams(kw, 10.0 * time_base, seed)
        m2 += _simulate_both(kw, faults, soft, time_base, t1, k).makespan
        kinds = np.zeros(len(faults), np.int8)
        got = simulate(EventTrace(faults, kinds, 1e12), p1, time_base,
                       t_rfo(p1), trust=NeverTrust())
        want = ref_simulate(RefTrace(faults, kinds, 1e12), rp1, time_base,
                            t_rfo(p1), trust=RefNever())
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        m1 += got.makespan
    assert m2 < m1


def test_two_level_simulation_matches_analytic():
    kw = dict(mu=8_000.0, phi=0.7, c1=10.0, c2=100.0, r1=10.0, r2=100.0,
              d=5.0)
    t1, k, w_analytic = optimal_two_level(TwoLevelPlatform(**kw))
    time_base = 500_000.0
    wastes = []
    for seed in range(10):
        faults, soft = _streams(kw, 10.0 * time_base, seed)
        wastes.append(_simulate_both(kw, faults, soft, time_base, t1,
                                     k).waste)
    assert np.mean(wastes) == pytest.approx(w_analytic, abs=0.03)


def test_two_level_waste_bounded():
    """The reference's property test over (phi, mu) on a seeded grid
    (the two ends of phi included): the port's optimum ``==`` the
    reference's, positive waste, T1 >= C1 and k >= 1."""
    rng = np.random.default_rng(11)
    grid = [(0.0, 2_000.0), (1.0, 1e6)] + [
        (float(phi), float(mu))
        for phi, mu in zip(rng.uniform(0.0, 1.0, 28),
                           rng.uniform(2_000.0, 1e6, 28))]
    for phi, mu in grid:
        kw = dict(mu=mu, phi=phi, c1=5.0, c2=100.0, r1=5.0, r2=100.0, d=1.0)
        p, rp = _pair(**kw)
        t1, k, w = optimal_two_level(p)
        assert (t1, k, w) == ref_ml.optimal_two_level(rp)
        assert 0.0 < w
        assert t1 >= p.c1 and k >= 1


@pytest.mark.parametrize("phi", [0.0, 0.35, 1.0])
def test_two_level_stream_and_runs_equal_reference(phi):
    """Every branch of the stream (phi = 0 and 1 are single streams) under
    the default Exponential law and a Weibull renewal law, and the
    engine's runs on them, ``==`` the reference's."""
    kw = dict(mu=3_000.0, phi=phi, c1=8.0, c2=90.0, r1=8.0, r2=90.0, d=3.0)
    t1, k, _ = optimal_two_level(TwoLevelPlatform(**kw))
    for seed in range(3):
        for dist, ref_dist in ((None, None),
                               (Weibull(0.7, 1.0), RefWeibull(0.7, 1.0))):
            faults, soft = _streams(kw, 4e5, seed, dist, ref_dist)
            for tt, kk in ((t1, k), (t1 * 1.3, 1), (t1, k + 2)):
                _simulate_both(kw, faults, soft, 1e5, tt, kk)


@pytest.mark.parametrize("phi, k", [(0.0, 1), (1.0, 1), (1.0, 4)])
def test_two_level_degenerate_limit_equals_oracle(phi, k):
    """All-hard faults with every checkpoint durable, or all-soft faults
    with C1 = C2, is the paper's single-level model: the two-level engine
    gives the port's scalar oracle's makespan, bit for bit."""
    kw = dict(mu=5_000.0, phi=phi, c1=100.0, c2=100.0, r1=100.0, r2=100.0,
              d=5.0)
    plat = Platform(mu=5_000.0, c=100.0, d=5.0, r=100.0)
    for seed in range(4):
        faults, soft = _streams(kw, 2e6, seed)
        got = _simulate_both(kw, faults, soft, 200_000.0, 1_000.0, k)
        trace = EventTrace(faults, np.zeros(len(faults), np.int8), 1e12)
        oracle = simulate(trace, plat, 200_000.0, 1_000.0,
                          trust=NeverTrust())
        assert got.makespan == oracle.makespan


def _estimator_state(est):
    return dataclasses.astuple(est.state), list(est._open_predictions)


def test_estimator_converges_to_true_mtbf():
    est, ref = OnlineEstimator(halflife=30.0), RefEstimator(halflife=30.0)
    rng = np.random.default_rng(0)
    t = 0.0
    for _ in range(400):
        t += rng.exponential(500.0)
        est.observe_fault(t, was_predicted=False)
        ref.observe_fault(t, was_predicted=False)
        assert _estimator_state(est) == _estimator_state(ref)
    assert est.state.mu == pytest.approx(500.0, rel=0.25)


def test_estimator_recall_precision():
    est = OnlineEstimator(halflife=50.0, match_window=5.0)
    ref = RefEstimator(halflife=50.0, match_window=5.0)
    rng = np.random.default_rng(1)
    t = 0.0
    r_true, p_true = 0.8, 0.6
    for _ in range(600):
        t += rng.exponential(100.0)
        predicted = rng.random() < r_true
        for e in (est, ref):
            if predicted:
                e.observe_prediction(t)
            e.observe_fault(t, was_predicted=predicted)
        if rng.random() < r_true * (1 - p_true) / p_true:
            for e in (est, ref):
                e.observe_prediction(t + 20.0)
                e.expire_predictions(t + 40.0)
        assert _estimator_state(est) == _estimator_state(ref)
    # A fault matched against open predictions (was_predicted=None).
    for e in (est, ref):
        e.observe_prediction(t + 100.0)
        e.observe_fault(t + 102.0)
    assert _estimator_state(est) == _estimator_state(ref)
    st_ = est.state
    assert st_.recall == pytest.approx(r_true, abs=0.1)
    assert st_.precision == pytest.approx(p_true, abs=0.15)


PRIOR = dict(mu_ind=10_000.0, c=60.0, cp=20.0, d=5.0, r=30.0, recall=0.85,
             precision=0.82)


def _adaptive_pair(**kw):
    return (AdaptiveScheduler(PlatformConfig(**PRIOR), n_devices=1, c=60.0,
                              cp=20.0, **kw),
            RefAdaptive(RefPlatformConfig(**PRIOR), n_devices=1, c=60.0,
                        cp=20.0, **kw))


def _same_plan(ada, ref):
    assert dataclasses.astuple(ada.scheduler.decision) \
        == dataclasses.astuple(ref.scheduler.decision)
    assert ada.n_replans == ref.n_replans
    assert ada.scheduler._last_save_end == ref.scheduler._last_save_end


def test_adaptive_scheduler_replans_on_drift():
    ada, ref = _adaptive_pair(halflife=10.0)
    t0 = ada.scheduler.period
    _same_plan(ada, ref)
    rng = np.random.default_rng(2)
    t = 0.0
    for _ in range(60):
        t += rng.exponential(1_000.0)
        hit = rng.random() < 0.85
        ada.estimator.observe_fault(t, was_predicted=hit)
        ref.estimator.observe_fault(t, was_predicted=hit)
    for s in (ada, ref):
        s.scheduler.notify_save_completed(t)
    assert dataclasses.asdict(ada._current_config()) \
        == dataclasses.asdict(ref._current_config())
    assert ada.maybe_replan() and ref.maybe_replan()
    _same_plan(ada, ref)
    assert ada.scheduler.period < t0
    assert ada.n_replans == 1
    assert not ada.maybe_replan() and not ref.maybe_replan()
    _same_plan(ada, ref)


def test_adaptive_scheduler_hysteresis():
    ada, ref = _adaptive_pair(replan_threshold=0.5)
    t = 0.0
    rng = np.random.default_rng(3)
    for _ in range(50):
        t += rng.exponential(9_000.0)
        hit = rng.random() < 0.85
        ada.estimator.observe_fault(t, was_predicted=hit)
        ref.estimator.observe_fault(t, was_predicted=hit)
    assert not ada.maybe_replan() and not ref.maybe_replan()
    _same_plan(ada, ref)
