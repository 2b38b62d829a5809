"""``correct`` comes out false when the timed path is broken underneath,
and for the lower-precision control in the program's place.

A whole run of the harness (everything but its look for a card) on the
tiny cell on the CPU, with one fault planted in the port each time: a
step that returns its state unchanged, half of the batch left out with
the means taken over the rest, and an answer altered where it is
produced.  The cell runs on one chip, so there is no exchange between
chips to leave out.
"""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import control, judge
from portbench_tiny import tiny_checkout


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return harness.load_cell(tiny_checkout(tmp_path_factory.mktemp("pb")),
                             "tiny-study")


def _run(cell, seed=2 ** 31 + 101):
    return harness.run(cell, seed=seed, seconds=0.5, trace=False,
                       device="cpu", t_start=0.0)


def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def _state_unchanged(monkeypatch):
    import repro_torch.core.batch_torch as bt

    def idle(lanes, g, *, cap):
        return torch.zeros((), dtype=torch.int32)
    idle.launches = 0       # the engine reads the wrapper's launch count
    monkeypatch.setattr(bt, "lane_loop", idle)


def _half_batch(monkeypatch):
    import repro_torch.experiments as ex
    whole = ex.candidate_results

    def half(traces, *args, **kw):
        return whole(traces[:len(traces) // 2], *args, **kw)
    monkeypatch.setattr(ex, "candidate_results", half)


def _makespan_ulp(monkeypatch):
    from repro_torch.core.batch import BatchResult
    made = BatchResult.from_lanes.__func__

    def altered(cls, out, time_base, shape):
        res = made(cls, out, time_base, shape)
        res.makespan = np.nextafter(res.makespan, np.inf)
        return res
    monkeypatch.setattr(BatchResult, "from_lanes", classmethod(altered))


def _one_rollback_more(monkeypatch):
    from repro_torch.core.batch import BatchResult
    made = BatchResult.from_lanes.__func__

    def altered(cls, out, time_base, shape):
        res = made(cls, out, time_base, shape)
        res.n_rollbacks = res.n_rollbacks + 1
        return res
    monkeypatch.setattr(BatchResult, "from_lanes", classmethod(altered))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _makespan_ulp, _one_rollback_more],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(cell, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(cell)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("seed", [5, 6, 2 ** 31 + 9])
def test_float32_control_is_not_correct(cell, seed):
    drv, traffic = cell.driver, cell.spec["traffic"]
    state = drv.setup(cell.cfg, traffic, seed, "cpu")
    outs = [drv.run_pass(state, drv.request(state, i)) for i in range(2)]
    picks = judge.sample(outs, (len(state.candidates),
                                traffic["traces_per_pass"]), seed,
                         traffic["check_lanes"])
    prog, _ = judge.judge(cell.cfg, state.strategies, state.pool,
                          drv.candidates(state), outs, picks)
    assert judge.correct(prog)
    cands, passes = control.view(cell.cfg, state.strategies, state.pool,
                                 outs, picks)
    ctl, _ = judge.judge(cell.cfg, state.strategies, state.pool, cands,
                         passes, picks)
    assert not judge.correct(ctl)
    assert all(ctl[k][0] > 0 for k in ("cands_off", "lanes_off", "ms_gap",
                                       "means_off"))
