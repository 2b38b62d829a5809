"""The frozen reference against the port, on the CPU (and on the card).

The reference's trace generator, candidates, event loop and means must be
the port's bit for bit: what decides ``correct`` is a bitwise comparison.
A float32 control run through the same comparison must fail it.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from portbench.reference import judge, policies, simulate
from portbench.reference import traces as ref_traces
from portbench_tiny import TINY_CFG, TINY_TRAFFIC

REPO = Path(__file__).resolve().parents[2]
CONFIGS = ("paper-exp-2e16", "paper-w05-2e19")


def _config(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" /
                       f"{name}.json").read_text())


def _driver():
    from portbench.harness import load_module
    return load_module(REPO / "portbench" / "drivers" / "study.py",
                       "portbench_driver_study")


@pytest.mark.parametrize("name", CONFIGS)
def test_generator_is_the_ports(name):
    cfg = _config(name)
    sc = _driver()._scenario(cfg)
    for i in (0, 3):
        times, kinds, horizon = ref_traces.make_trace(
            cfg, np.random.default_rng(sc.seed + 1009 * i))
        port = sc.make_trace(i)
        assert times.tobytes() == port.times.tobytes()
        assert kinds.tobytes() == port.kinds.tobytes()
        assert horizon == port.horizon and port.windows is None


def test_pool_does_not_depend_on_threads():
    pool = ref_traces.make_pool(TINY_CFG, 2 ** 31 + 7, 6)
    for i, (times, kinds, _) in enumerate(pool):
        alone = ref_traces.make_trace(TINY_CFG, ref_traces.trace_rng(
            2 ** 31 + 7, i))
        assert times.tobytes() == alone[0].tobytes()
        assert kinds.tobytes() == alone[1].tobytes()


@pytest.mark.parametrize("name", CONFIGS)
def test_candidates_are_the_ports(name):
    cfg = _config(name)
    drv = _driver()
    traffic = json.loads((REPO / "portbench" / "workloads" /
                          f"study-{name[6:]}.json").read_text())["traffic"]
    strategies = drv._reference_strategies(traffic)
    unique, rows = drv._port_candidates(drv._scenario(cfg), strategies)
    ref, ref_rows = policies.candidates(judge.platform(cfg), strategies)
    assert len(unique) == len(ref) == 26 and rows == ref_rows
    for s, (period, thr) in zip(unique, ref):
        assert s.period == period
        assert getattr(s.trust, "threshold", None) == thr


def _tiny_grid(device: str):
    """The tiny deployment's candidates on 3 traces through the port's
    ``candidate_results`` and ``best_means`` on ``device``."""
    from repro_torch.core.traces import traces_from_numpy
    from repro_torch.experiments import best_means, candidate_results
    drv = _driver()
    pool = ref_traces.make_pool(TINY_CFG, 11, 3)
    sc = drv._scenario(TINY_CFG)
    strategies = drv._reference_strategies(TINY_TRAFFIC)
    unique, rows = drv._port_candidates(sc, strategies)
    port = traces_from_numpy(*zip(*pool))
    res = candidate_results(port, sc.platform, sc.time_base, sc.cp, unique,
                            seed=5, device=device)
    return pool, strategies, res, best_means(res.makespan, rows)


def _assert_reference_is(pool, strategies, res, means, F=float):
    cands, rows = policies.candidates(judge.platform(TINY_CFG), strategies)
    off = 0
    for c, cand in enumerate(cands):
        for t, trace in enumerate(pool):
            lane = judge.reference_lane(TINY_CFG, trace, cand, F=F)
            off += sum(not judge.same(f, getattr(res, f)[c, t], lane[f])
                       for f in simulate.FIELDS)
    ref_means = [m for m, _ in policies.best(res.makespan, rows)]
    return off, [judge.same("mean", a, b) for a, b in zip(means, ref_means)]


def test_reference_lanes_are_the_ports_cpu():
    pool, strategies, res, means = _tiny_grid("cpu")
    off, means_same = _assert_reference_is(pool, strategies, res, means)
    assert off == 0 and all(means_same)
    assert res.makespan.shape == (6, 3)
    assert (res.n_periodic_ckpts > 0).all() and res.n_faults_hit.sum() > 0
    assert res.n_proactive_ckpts.sum() > 0


def test_float32_control_fails_the_comparison():
    pool, strategies, res, means = _tiny_grid("cpu")
    off, _ = _assert_reference_is(pool, strategies, res, means,
                                  F=np.float32)
    assert off > 0
    # The issue's control: inputs rounded through float32, loop in float64.
    rounded = [(t.astype(np.float32).astype(np.float64), k, h)
               for t, k, h in pool]
    off, _ = _assert_reference_is(rounded, strategies, res, means)
    assert off > 0


def test_reference_lane_fields_have_the_ports_types():
    lane = judge.reference_lane(TINY_CFG, ref_traces.make_pool(
        TINY_CFG, 3, 1)[0], (2000.0, None))
    for field, value in lane.items():
        assert isinstance(value, int if field.startswith("n_") else float)
    assert math.isfinite(lane["makespan"])


@pytest.mark.gpu
def test_reference_lanes_are_the_ports_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the lane-loop kernel runs only there")
    pool, strategies, res, means = _tiny_grid("cuda:0")
    off, means_same = _assert_reference_is(pool, strategies, res, means)
    assert off == 0 and all(means_same)
