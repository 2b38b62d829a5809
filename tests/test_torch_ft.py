"""The port's fault-tolerance runtime, scheduler and trainer against the
JAX package's.

* The scheduler's decision is the reference's floats (``==``) on the
  platforms of ``tests/test_ft.py:70-124``; the clock, injector and
  predictor runtime answer the same queries the same way.
* Trainer parity: reduced llama3.2-1b at float32, 30 steps on the trace of
  ``tests/test_ft.py:173-176``.  The port's trainer starts from the
  reference trainer's initial state (carried across through numpy) and is
  fed the reference's batches (a test-side replacement of
  ``data.batch_at``).  Every ``TrainerStats`` counter and virtual time is
  ``==``; ``final_loss`` agrees within 1e-3 (float32 rounding differs
  between XLA and eager torch, and AdamW normalises it).  A fault before
  the first save would restart both from their seed-0 init: the port is
  handed the reference's ``PRNGKey(0)`` init for that case, and the test
  shows that this trace has no such fault.
* Port-only mirrors of ``tests/test_ft.py:180-239`` at a tiny size.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.configs.base import InputShape as RefShape  # noqa: E402
from repro.configs.base import PlatformConfig as RefPlatform  # noqa: E402
from repro.core.traces import EventTrace as RefTrace  # noqa: E402
from repro.ft import CheckpointScheduler as RefScheduler  # noqa: E402
from repro.ft import FaultInjector as RefInjector  # noqa: E402
from repro.ft import PredictorRuntime as RefPredictor  # noqa: E402
from repro.models.transformer import init_params as ref_init  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.train import FaultTolerantTrainer as RefTrainer  # noqa: E402

from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.base import InputShape, PlatformConfig  # noqa: E402
from repro_torch.core.traces import (EventTrace, Exponential,  # noqa: E402
                                     make_event_trace)
from repro_torch.ft import (CheckpointScheduler, FaultInjector,  # noqa: E402
                            PredictorRuntime, VirtualClock)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train import FaultTolerantTrainer, TrainerStats  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

PLAT_KW = dict(mu_ind=300.0, c=30.0, cp=10.0, d=5.0, r=15.0, recall=0.85,
               precision=0.82)
PLAT = PlatformConfig(**PLAT_KW)
REF_PLAT = RefPlatform(**PLAT_KW)
CFG = REGISTRY["llama3.2-1b"].reduced()
SHAPE = InputShape("t", 64, 4, "train")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The trainers here are tiny: one intra-op thread is as fast alone
    and avoids oversubscribing the cores when test files run in
    parallel processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def trace_of(times, kinds, cls=EventTrace):
    return cls(np.asarray(times, float), np.asarray(kinds, np.int8),
               horizon=1e9)


# -- runtime pieces -----------------------------------------------------------

def test_virtual_clock():
    c = VirtualClock()
    assert c.advance(5.0) == 5.0
    with pytest.raises(ValueError):
        c.advance(-1.0)


def test_injector_and_predictor_answer_like_reference():
    g = np.random.default_rng(0)
    times = np.sort(g.uniform(0.0, 1000.0, 60))
    kinds = g.integers(0, 3, 60).astype(np.int8)
    inj, ref_inj = FaultInjector(trace_of(times, kinds)), \
        RefInjector(trace_of(times, kinds, RefTrace))
    pr, ref_pr = PredictorRuntime(trace_of(times, kinds), 30.0), \
        RefPredictor(trace_of(times, kinds, RefTrace), 30.0)
    for t0 in np.linspace(-50.0, 1050.0, 111):
        for dt in (5.0, 10.0, 40.0):
            assert inj.next_fault_in(t0, t0 + dt) \
                == ref_inj.next_fault_in(t0, t0 + dt)
            got = pr.announced_in(t0, t0 + dt)
            want = ref_pr.announced_in(t0, t0 + dt)
            assert [dataclasses.astuple(p) for p in got] \
                == [dataclasses.astuple(p) for p in want]


def test_predictor_runtime_lead_time():
    pr = PredictorRuntime(trace_of([100.0, 200.0], [1, 2]), lead_time=30.0)
    anns = pr.announced_in(60.0, 80.0)
    assert len(anns) == 1 and anns[0].announce_time == 70.0
    assert anns[0].date == 100.0 and anns[0].is_true
    assert PredictorRuntime(trace_of([100.0], [0]), 30.0).announced_in(
        0.0, 1000.0) == []


# -- scheduler ----------------------------------------------------------------

_BIG = dict(mu_ind=125 * 365 * 86400.0, c=600.0, cp=600.0, d=60.0, r=600.0)
PLATFORMS = {
    "ft": ({}, 1),
    "mesh512": (_BIG, 512),
    "mesh64": (_BIG, 64),
    "roomy": ({"mu_ind": 3e5}, 1),
    "no_recall": ({"recall": 0.0}, 1),
}


@pytest.mark.parametrize("name", sorted(PLATFORMS))
@pytest.mark.parametrize("use_predictor", [True, False])
def test_scheduler_decision_equals_reference(name, use_predictor):
    over, n = PLATFORMS[name]
    port = CheckpointScheduler(dataclasses.replace(PLAT, **over), n,
                               use_predictor=use_predictor)
    ref = RefScheduler(dataclasses.replace(REF_PLAT, **over), n,
                       use_predictor=use_predictor)
    assert dataclasses.astuple(port.decision) \
        == dataclasses.astuple(ref.decision)
    assert (port.mu, port.c, port.cp, port.use_predictor) \
        == (ref.mu, ref.c, ref.cp, ref.use_predictor)
    for s in (ref, port):
        s.notify_save_completed(100.0)
    for t in np.linspace(0.0, 3 * ref.period, 97):
        assert port.due(t) == ref.due(t)
        assert port.trust(t) == ref.trust(t)
    assert port.next_checkpoint_start() == ref.next_checkpoint_start()
    assert port.steps_per_checkpoint(10.0) == ref.steps_per_checkpoint(10.0)


def test_scheduler_requires_positive_costs():
    with pytest.raises(ValueError):
        CheckpointScheduler(dataclasses.replace(PLAT, c=0.0), n_devices=1)


def test_scheduler_availability_objective_is_not_ported():
    """The availability objective is ported now (the name is kept): its
    decision is the reference's floats, with and without a predictor, and
    an unknown objective still raises."""
    for w in ((1.0, 1.0, 1.0), (0.25, 0.25, 1.0)):
        out = dict(ckpt_outage=w[0], prockpt_outage=w[1],
                   replay_outage=w[2])
        for use in (True, False):
            port = CheckpointScheduler(dataclasses.replace(PLAT, **out), 1,
                                       objective="availability",
                                       use_predictor=use)
            ref = RefScheduler(dataclasses.replace(REF_PLAT, **out), 1,
                               objective="availability", use_predictor=use)
            assert dataclasses.astuple(port.decision) \
                == dataclasses.astuple(ref.decision)
    with pytest.raises(ValueError, match="objective"):
        CheckpointScheduler(PLAT, 1, objective="throughput")


# -- trainer parity with the reference ----------------------------------------

def fault_trace(cls=None):
    """The trace of tests/test_ft.py:173-176 (seed 3, mu 300)."""
    tr = make_event_trace(Exponential(1.0), 300.0, 0.85, 0.82, horizon=1e5,
                          rng=np.random.default_rng(3))
    return tr if cls is None else trace_of(tr.times, tr.kinds, cls)


def test_trace_matches_reference():
    from repro.core.traces import Exponential as RefExp
    from repro.core.traces import make_event_trace as ref_make
    ref = ref_make(RefExp(1.0), 300.0, 0.85, 0.82, horizon=1e5,
                   rng=np.random.default_rng(3))
    port = fault_trace()
    np.testing.assert_array_equal(port.times, ref.times)
    np.testing.assert_array_equal(port.kinds, ref.kinds)


def test_trainer_parity_with_reference(tmp_path):
    cfg32 = dataclasses.replace(CFG, dtype="float32")
    ref_cfg = dataclasses.replace(REF_REGISTRY["llama3.2-1b"].reduced(),
                                  dtype="float32")
    ref_shape = RefShape("t", 64, 4, "train")
    ref_tr = RefTrainer(ref_cfg, ref_shape, REF_PLAT,
                        workdir=str(tmp_path / "ref"), step_time=10.0,
                        trace=fault_trace(RefTrace), seed=0)
    port_tr = FaultTolerantTrainer(cfg32, SHAPE, PLAT,
                                   workdir=str(tmp_path / "port"),
                                   step_time=10.0, trace=fault_trace(),
                                   seed=0, device="cpu")
    port_tr.state = params_from_numpy(jax.tree.map(np.asarray, ref_tr.state),
                                      "cpu")

    def ref_batch(step):
        return {"tokens": torch.from_numpy(np.array(
            ref_tr.data.batch_at(step)["tokens"]))}

    fresh = []

    def ref_fresh_state(seed):
        fresh.append(seed)
        params, _ = ref_init(ref_cfg, jax.random.PRNGKey(seed))
        return params_from_numpy(jax.tree.map(np.asarray, {
            "params": params, "opt": ref_adamw_init(params, ref_tr.opt_cfg),
            "data_step": jnp.zeros((), jnp.int32)}), "cpu")

    port_tr.data.batch_at = ref_batch
    port_tr.init_state = ref_fresh_state
    restarts = []
    ref_restore = ref_tr.manager.restore

    def counting_restore(**kw):
        try:
            return ref_restore(**kw)
        except FileNotFoundError:
            restarts.append(ref_tr.clock.now)
            raise

    ref_tr.manager.restore = counting_restore
    ref_stats = ref_tr.run(30)
    port_stats = port_tr.run(30)

    for f in dataclasses.fields(TrainerStats):
        if f.name != "final_loss":
            assert getattr(port_stats, f.name) == getattr(ref_stats, f.name), \
                f.name
    assert port_stats.n_faults > 0 and port_stats.n_proactive > 0
    assert abs(port_stats.final_loss - ref_stats.final_loss) <= 1e-3
    assert port_tr.manager.checkpoints() == ref_tr.manager.checkpoints()
    assert int(port_tr.state["data_step"]) == int(ref_tr.state["data_step"])
    # Both restarted from a fresh init exactly when the reference did; on
    # this trace the first fault comes after the first (fallback-full)
    # proactive save, so neither restarts.
    assert fresh == [0] * len(restarts) and restarts == []


# -- port-only mirrors of tests/test_ft.py:180-239 ----------------------------

TINY = dataclasses.replace(CFG, n_layers=1, d_model=64, n_heads=2,
                           n_kv_heads=1, head_dim=32, d_ff=128,
                           vocab_size=128)
TINY_SHAPE = InputShape("t", 16, 2, "train")


def tiny_trainer(tmp_path, sub, trace=None, **kw):
    return FaultTolerantTrainer(TINY, TINY_SHAPE, PLAT,
                                workdir=str(tmp_path / sub), step_time=10.0,
                                trace=trace, seed=0, device="cpu", **kw)


def test_trainer_faultfree_baseline(tmp_path):
    stats = tiny_trainer(tmp_path, "a").run(30)
    assert stats.n_steps == 30 and stats.n_faults == 0
    assert stats.useful_time == pytest.approx(300.0)
    assert np.isfinite(stats.final_loss)


def test_trainer_with_faults_recovers(tmp_path):
    tr = tiny_trainer(tmp_path, "a", fault_trace())
    stats = tr.run(60)
    assert stats.n_faults > 0
    assert int(tr.state["data_step"]) >= 60
    attributed = (stats.useful_time + stats.lost_time + stats.ckpt_time +
                  stats.prockpt_time + stats.down_time)
    assert attributed <= stats.total_time + 1e-6
    assert np.isfinite(stats.final_loss)


def test_rollback_replay_is_deterministic(tmp_path):
    tr_faulty = tiny_trainer(tmp_path, "a", fault_trace())
    s_faulty = tr_faulty.run(40)
    tr_clean = tiny_trainer(tmp_path, "b")
    s_clean = tr_clean.run(40)
    assert s_faulty.n_rollbacks > 0
    a = flatten(tr_faulty.state["params"])[0].float().numpy()
    b = flatten(tr_clean.state["params"])[0].float().numpy()
    np.testing.assert_allclose(a, b, atol=5e-2)
    assert s_faulty.final_loss == pytest.approx(s_clean.final_loss, abs=0.5)


def test_predictor_reduces_measured_waste(tmp_path):
    with_pred = tiny_trainer(tmp_path, "p", fault_trace()).run(60)
    without = tiny_trainer(tmp_path, "n", fault_trace(),
                           use_predictor=False).run(60)
    assert with_pred.waste < without.waste


def test_trainer_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FaultTolerantTrainer(TINY, TINY_SHAPE, PLAT,
                             workdir=str(tmp_path), step_time=10.0)
