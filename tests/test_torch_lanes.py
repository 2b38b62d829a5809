"""The port's lane engine against the JAX package's lane engines, bitwise.

``repro_torch.core.batch.simulate_batch(..., device="cpu")`` must equal
the reference's ``simulate_batch(backend="numpy")`` on every
:class:`BatchResult` field, over the matrix of
``tests/test_jax_engine.py:44-110`` (four trust policies x instant/within
windows, per-event windows) plus the silent-error axis (``n_verify``,
``verify_cost``, ``keep_ckpts``).  Both engines get the identical bank,
carried across with ``traces_from_numpy``.  Tolerance: none (``==``),
the engines' bit-for-bit contract.

Also: chunked equals unchunked, a stop test every iteration equals the
engine's stop cadence, deferred-fault overflow raises, adaptive lanes
raise, and one small case against the reference's ``backend="jax"`` (in
an x64 subprocess).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.batch import simulate_batch as ref_simulate_batch  # noqa: E402
from repro.core.batch import simulate_lanes as ref_simulate_lanes  # noqa: E402
from repro.core.traces import (FALSE_PRED, FAULT_PRED, FAULT_UNPRED,  # noqa: E402
                               EventTrace, Exponential, make_event_trace)
from repro.core.waste import Platform as RefPlatform  # noqa: E402

import repro_torch.core.batch_torch as batch_torch  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.batch import simulate_batch, simulate_lanes  # noqa: E402
from repro_torch.core.traces import traces_from_numpy  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402
from repro_torch.obs.metrics import get_registry  # noqa: E402

REF_PLAT = RefPlatform(mu=2500.0, c=60.0, d=10.0, r=30.0)
PLAT = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
TIME_BASE = 30000.0
PERIODS = [1200.0, 2500.0]
SEEDS = [5, 6, 7]
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _port_trust(t):
    """The port's trust policy equal to a reference policy."""
    if isinstance(t, ref_sim.NeverTrust):
        return sim.NeverTrust()
    if isinstance(t, ref_sim.AlwaysTrust):
        return sim.AlwaysTrust()
    if isinstance(t, ref_sim.ThresholdTrust):
        return sim.ThresholdTrust(t.threshold)
    return sim.FixedProbabilityTrust(t.q)


def _carry(traces):
    return traces_from_numpy([t.times for t in traces],
                             [t.kinds for t in traces],
                             [t.horizon for t in traces],
                             [t.windows for t in traces])


def _traces(seeds=(20, 21, 22), horizon=100000.0, silent_mu=None):
    return [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6, horizon,
                             np.random.default_rng(s), silent_mu=silent_mu)
            for s in seeds]


def _both(traces, trust, **kw):
    kw.setdefault("cp", 30.0)
    kw.setdefault("trace_seeds", SEEDS[:len(traces)])
    ref = ref_simulate_batch(traces, REF_PLAT, TIME_BASE, PERIODS,
                             trust=trust, **kw)
    port = simulate_batch(_carry(traces), PLAT, TIME_BASE, PERIODS,
                          trust=_port_trust(trust), device="cpu", **kw)
    return ref, port


def _assert_bitwise(a, b, tag: str) -> None:
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        va, vb = getattr(a, name), getattr(b, name)
        if not isinstance(va, np.ndarray):
            assert va == vb, f"{tag}: {name}"
            continue
        assert va.shape == vb.shape, f"{tag}: {name} shape"
        assert (va == vb).all(), \
            f"{tag}: field {name} diverged (bitwise contract broken)"


TRUSTS = [ref_sim.NeverTrust(), ref_sim.AlwaysTrust(),
          ref_sim.ThresholdTrust(100.0), ref_sim.FixedProbabilityTrust(0.6)]
TRUST_IDS = ["never", "always", "threshold", "fixed_q"]


@pytest.mark.parametrize("trust", TRUSTS, ids=TRUST_IDS)
@pytest.mark.parametrize("wmode", ["instant", "within"])
def test_trust_matrix_matches_numpy(trust, wmode):
    kw = dict(inexact_window=300.0, window_mode=wmode)
    if wmode == "within":
        kw["window_period"] = 100.0
    ref, port = _both(_traces(), trust, **kw)
    _assert_bitwise(ref, port, f"{type(trust).__name__}/{wmode}")
    assert (ref.n_predictions > 0).all()


def _win_trace(seed):
    r = np.random.default_rng(seed)
    n = 80
    times = np.sort(r.uniform(0, 75000.0, n))
    kinds = r.choice([FAULT_UNPRED, FAULT_PRED, FALSE_PRED], n,
                     p=[0.3, 0.4, 0.3]).astype(np.int8)
    wins = r.choice([-1.0, 0.0, 250.0, 600.0], n).astype(np.float64)
    return EventTrace(times, kinds, 100000.0, wins)


@pytest.mark.parametrize("kw", [
    dict(trust=ref_sim.AlwaysTrust(), inexact_window=300.0),
    dict(trust=ref_sim.ThresholdTrust(100.0), inexact_window=300.0,
         window_mode="within", window_period=100.0),
], ids=["always", "threshold_within"])
def test_per_event_windows_match_numpy(kw):
    """Per-event window lengths, mixed with -1 fallback sentinels and
    zero-width exact dates, drive the same window arming."""
    kw = dict(kw)
    ref, port = _both([_win_trace(s) for s in (10, 11, 12)],
                      kw.pop("trust"), **kw)
    _assert_bitwise(ref, port, "per-event windows")


@pytest.mark.parametrize("n_verify,verify_cost,keep", [
    (0, 0.0, 1), (1, 40.0, 2), (3, 20.0, 3)])
@pytest.mark.parametrize("trust", [ref_sim.NeverTrust(),
                                   ref_sim.ThresholdTrust(100.0)],
                         ids=["never", "threshold"])
def test_silent_errors_match_numpy(n_verify, verify_cost, keep, trust):
    """Silent strikes, the verification cadence, dirty-ring rollbacks and
    the end-of-job acceptance check, field for field."""
    traces = _traces(silent_mu=4000.0)
    ref, port = _both(traces, trust, inexact_window=300.0,
                      n_verify=n_verify, verify_cost=verify_cost,
                      keep_ckpts=keep)
    _assert_bitwise(ref, port, f"silent k={n_verify} keep={keep}")
    assert (ref.n_silent > 0).any()
    if n_verify:
        assert (ref.n_verifications > 0).all()
        assert (ref.n_deep_rollbacks > 0).any() or keep == 1


def _lane_args():
    return dict(cp=30.0, trace_indices=[0, 1, 2, 0],
                periods=[1200.0, 1500.0, 2500.0, 1200.0],
                windows=[0.0, 300.0, 300.0, 300.0],
                window_modes=["instant", "instant", "within", "instant"],
                window_periods=[0.0, 0.0, 100.0, 0.0],
                seeds=[5, 6, 7, 8])


REF_LANE_TRUSTS = [ref_sim.NeverTrust(), ref_sim.AlwaysTrust(),
                   ref_sim.ThresholdTrust(100.0),
                   ref_sim.FixedProbabilityTrust(0.6)]


def test_simulate_lanes_matches_numpy():
    traces = _traces()
    ms_ref = ref_simulate_lanes(traces, REF_PLAT, TIME_BASE,
                                trusts=REF_LANE_TRUSTS, **_lane_args())
    ms = simulate_lanes(_carry(traces), PLAT, TIME_BASE,
                        trusts=[_port_trust(t) for t in REF_LANE_TRUSTS],
                        device="cpu", **_lane_args())
    assert list(ms) == list(ms_ref)


def _port_run(**kw):
    return simulate_batch(_carry(_traces()), PLAT, TIME_BASE, PERIODS,
                          cp=30.0, trust=sim.ThresholdTrust(100.0),
                          inexact_window=300.0, trace_seeds=SEEDS,
                          device="cpu", **kw)


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunked_matches_unchunked(chunk):
    reg = get_registry()
    before = reg.counters.get("torch.chunks", 0)
    _assert_bitwise(_port_run(), _port_run(chunk=chunk), f"chunk={chunk}")
    n_lanes = len(PERIODS) * len(SEEDS)
    assert reg.counters["torch.chunks"] - before == 1 + -(-n_lanes // chunk)


def test_stop_test_cadence_changes_no_bit(monkeypatch):
    """Testing for the end every iteration (the JAX loop's cadence) and
    every ``_STOP_EVERY`` iterations give the same bits."""
    assert batch_torch._STOP_EVERY > 1
    ref = _port_run()
    monkeypatch.setattr(batch_torch, "_STOP_EVERY", 1)
    _assert_bitwise(ref, _port_run(), "stop test every iteration")


def test_deferred_overflow_raises():
    """More in-flight deferred fault dates than the fixed slot capacity
    fail loudly (the numpy engine handles the same trace)."""
    n = 12  # > _DEF_SLOTS overlapping armed windows
    times = 1000.0 + 10.0 * np.arange(n)
    trace = EventTrace(times, np.full(n, FAULT_PRED, dtype=np.int8), 1e7,
                       np.full(n, 1e6))
    kw = dict(cp=30.0, trace_seeds=[3])
    ref_simulate_batch([trace], REF_PLAT, TIME_BASE, [1200.0],
                       trust=ref_sim.AlwaysTrust(), **kw)
    reg = get_registry()
    before = reg.counters.get("engine.deferred_overflows", 0)
    with pytest.raises(RuntimeError, match="deferred-fault capacity"):
        simulate_batch(_carry([trace]), PLAT, TIME_BASE, [1200.0],
                       trust=sim.AlwaysTrust(), device="cpu", **kw)
    assert reg.counters["engine.deferred_overflows"] == before + 1


def test_adaptive_lanes_raise():
    with pytest.raises(NotImplementedError, match="Queue A"):
        simulate_batch(_carry(_traces(seeds=(1,))), PLAT, TIME_BASE,
                       [1200.0], trust=sim.ThresholdTrust(100.0),
                       adaptive=object(), device="cpu")


def test_period_below_checkpoint_raises():
    with pytest.raises(ValueError, match="below checkpoint"):
        simulate_batch(_carry(_traces(seeds=(1,))), PLAT, TIME_BASE,
                       [30.0], device="cpu")


_JAX_LANES = """
import json, sys
import numpy as np
from repro.core.batch import simulate_lanes
from repro.core.simulator import (AlwaysTrust, FixedProbabilityTrust,
                                  NeverTrust, ThresholdTrust)
from repro.core.traces import Exponential, make_event_trace
from repro.core.waste import Platform

args = json.loads(sys.argv[1])
traces = [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6, 100000.0,
                           np.random.default_rng(s)) for s in (20, 21, 22)]
trusts = [NeverTrust(), AlwaysTrust(), ThresholdTrust(100.0),
          FixedProbabilityTrust(0.6)]
ms = simulate_lanes(traces, Platform(mu=2500.0, c=60.0, d=10.0, r=30.0),
                    30000.0, trusts=trusts, backend="jax", **args)
print(json.dumps([repr(float(m)) for m in ms]))
"""


def test_matches_jax_backend_subprocess():
    pytest.importorskip("jax")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + sys.path))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_LANES, json.dumps(_lane_args())],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ms_jax = [float(v) for v in json.loads(proc.stdout.splitlines()[-1])]
    ms = simulate_lanes(_carry(_traces()), PLAT, TIME_BASE,
                        trusts=[_port_trust(t) for t in REF_LANE_TRUSTS],
                        device="cpu", **_lane_args())
    assert list(ms) == ms_jax
