"""The lane engine split over a list of devices, against the reference.

``device=[...]`` cuts each chunk into contiguous shards of
``ceil(n / len(devices))`` lanes, one per entry (repeats allowed), the
port's counterpart of the JAX engine's ``shard_map`` over ``jax.devices()``
(``REPRO_JAX_SHARD=1``).  On the CPU the shards run over a repeated
``"cpu"``: every :class:`BatchResult` field must be ``==`` the unsplit
port and the reference's ``simulate_batch(backend="numpy")``, and the
makespans ``==`` the reference's jax engine sharded four ways over forced
host devices (in an x64 subprocess).  Tolerance: none (``==``), the
engines' bit-for-bit contract.

Also: a lane that overflows the 8 deferred-fault slots inside one shard,
an adaptive grid (never split: one shard), no padded lane, the device
list's rules and the engine fingerprint of a list.
"""

import dataclasses
import functools
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
from repro.core.traces import (FAULT_PRED, EventTrace, Exponential,  # noqa: E402
                               make_event_trace)
from repro.core.waste import Platform as RefPlatform  # noqa: E402
from repro.predictors import estimator as ref_est  # noqa: E402

import repro_torch.core.batch_torch as batch_torch  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.batch import simulate_batch  # noqa: E402
from repro_torch.core.traces import traces_from_numpy  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402
from repro_torch.device import resolve_device, resolve_devices  # noqa: E402
from repro_torch.experiments.runner import _engine_fingerprint  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry, set_registry  # noqa: E402
from repro_torch.predictors import estimator as est  # noqa: E402

REF_PLAT = RefPlatform(mu=2500.0, c=60.0, d=10.0, r=30.0)
PLAT = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
# A shorter job than tests/test_torch_lanes.py's 30,000 s: the plain loop
# runs shard by shard on the CPU, so each case costs its shards' runs.
TIME_BASE = 6000.0
TRACE_SEEDS = (20,)
SEEDS = [5]
SRC = str(Path(__file__).resolve().parents[1] / "src")

# tests/test_torch_lanes.py's trust x window grid as one grid of
# candidates: the four trust policies, each with instant and "within"
# windows, at two periods.
REF_TRUSTS = [t for t in (ref_sim.NeverTrust(), ref_sim.AlwaysTrust(),
                          ref_sim.ThresholdTrust(100.0),
                          ref_sim.FixedProbabilityTrust(0.6))
              for _ in range(2)]
GRID = dict(periods=[1200.0, 2500.0] * 4, window_mode=["instant",
                                                       "within"] * 4,
            inexact_window=300.0, window_period=100.0, cp=30.0,
            trace_seeds=SEEDS)
N_LANES = len(GRID["periods"]) * len(TRACE_SEEDS)


def _port_trust(t):
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


def _traces(seeds=TRACE_SEEDS):
    return [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6,
                             100000.0, np.random.default_rng(s))
            for s in seeds]


def _port_grid(**kw):
    g = dict(GRID)
    periods = g.pop("periods")
    return simulate_batch(_carry(_traces()), PLAT, TIME_BASE, periods,
                          trust=[_port_trust(t) for t in REF_TRUSTS],
                          **g, **kw)


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


@pytest.fixture
def registry():
    reg = MetricsRegistry()
    prev = set_registry(reg)
    yield reg
    set_registry(prev)


@pytest.fixture(scope="module")
def grid_refs():
    """The reference's numpy lanes and the unsplit port on the grid."""
    g = dict(GRID)
    periods = g.pop("periods")
    ref = ref_simulate_batch(_traces(), REF_PLAT, TIME_BASE, periods,
                             trust=REF_TRUSTS, **g)
    assert (ref.n_predictions > 0).all() and (ref.n_faults > 0).any()
    return ref, _port_grid(device="cpu")


@functools.lru_cache(maxsize=None)
def _split_run(n_shards: int, chunk: int | None) -> tuple:
    """The grid over ``["cpu"] * n_shards``: its result, its counters and
    the lanes of each shard of each chunk, as ``_run_shards`` was handed
    them."""
    seen = []
    real = batch_torch._run_shards

    def recording(loop, shards, cap):
        seen.append([lanes.f.shape[1] for lanes, _, _ in shards])
        return real(loop, shards, cap)

    reg = MetricsRegistry()
    prev = set_registry(reg)
    batch_torch._run_shards = recording
    try:
        got = _port_grid(device=["cpu"] * n_shards, chunk=chunk)
    finally:
        batch_torch._run_shards = real
        set_registry(prev)
    return got, dict(reg.counters), seen


@pytest.mark.parametrize("chunk", [None, 4, 5], ids=["whole", "chunk4",
                                                      "chunk5"])
@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_split_matches_unsplit_and_numpy(n_shards, chunk, grid_refs):
    """Each chunk cut over ``["cpu"] * n_shards`` gives the unsplit port's
    and the reference's numpy lanes' bits on every field.  Its shards hold
    its lanes once each, in shards of ``ceil(n / n_shards)``: no padded
    lane runs (the reference pads a 5-lane chunk to 8 for four shards)."""
    ref, unsplit = grid_refs
    got, counters, seen = _split_run(n_shards, chunk)
    tag = f"{n_shards} shards, chunk {chunk}"
    _assert_bitwise(unsplit, got, tag + " vs unsplit")
    _assert_bitwise(ref, got, tag + " vs numpy")
    size = N_LANES if chunk is None else chunk
    sizes = [min(size, N_LANES - lo) for lo in range(0, N_LANES, size)]
    assert counters["torch.chunks"] == len(sizes)
    want = []
    for n in sizes:
        part = -(-n // n_shards)
        want.append([min(part, n - lo) for lo in range(0, n, part)])
    assert seen == want
    assert counters["torch.shards"] == sum(map(len, want))
    if (n_shards, chunk) == (4, 5):
        assert want == [[2, 2, 1], [1, 1, 1]]


def _stack_trace(n: int) -> EventTrace:
    """``n`` true predictions 10 s apart, each window wide enough that all
    their faults are in flight at once (test_deferred_overflow_raises)."""
    times = 1000.0 + 10.0 * np.arange(n)
    return EventTrace(times, np.full(n, FAULT_PRED, dtype=np.int8), 1e7,
                      np.full(n, 1e6))


def test_overflow_inside_one_shard(registry):
    """A trace with 12 faults in flight (more than the 8 slots) on a lane
    that shares its shard with another: it reruns with 16 slots, and
    every lane gives the unsplit port's and the numpy lanes' bits."""
    base = _traces(seeds=(20, 21))
    traces = [base[0], _stack_trace(12), base[1]]
    kw = dict(cp=30.0, inexact_window=300.0, trace_seeds=[3, 4, 5])
    ref = ref_simulate_batch(traces, REF_PLAT, TIME_BASE, [1200.0],
                             trust=ref_sim.AlwaysTrust(), **kw)
    for device in ("cpu", ["cpu"] * 2):
        before = registry.counters.get("engine.deferred_overflows", 0)
        port = simulate_batch(_carry(traces), PLAT, TIME_BASE, [1200.0],
                              trust=sim.AlwaysTrust(), device=device, **kw)
        _assert_bitwise(ref, port, f"overflow on {device}")
        assert registry.counters["engine.deferred_overflows"] == before + 1
    # Shards of two lanes: the overflowed lane 1 beside lane 0, lane 2
    # alone.
    assert registry.counters["torch.shards"] == 1 + 2


def test_adaptive_grid_stays_unsplit(registry):
    """An adaptive grid given a device list runs unsplit on its first
    device (one shard, counted) and gives the numpy lanes' bits."""
    kw = dict(prior_recall=0.5, prior_precision=0.5, min_preds=8,
              min_faults=4, tol=0.02)
    ref = ref_simulate_batch(_traces(), REF_PLAT, TIME_BASE,
                             [1200.0, 2500.0],
                             trust=ref_sim.ThresholdTrust(100.0),
                             inexact_window=300.0,
                             adaptive=ref_est.AdaptiveConfig(**kw), cp=30.0,
                             trace_seeds=SEEDS)
    port = simulate_batch(_carry(_traces()), PLAT, TIME_BASE,
                          [1200.0, 2500.0],
                          trust=sim.ThresholdTrust(100.0),
                          inexact_window=300.0,
                          adaptive=est.AdaptiveConfig(**kw), cp=30.0,
                          trace_seeds=SEEDS, device=["cpu"] * 4)
    assert registry.counters["torch.shards"] == 1
    assert registry.counters["torch.chunks"] == 1
    _assert_bitwise(ref, port, "adaptive with a device list")


def test_device_list_rules(monkeypatch):
    """Repeats resolve entry by entry; an empty list, a list that mixes
    device types or holds a meta device, a CUDA index beyond the visible
    cards and a CUDA list without a card raise; ``None`` splits over
    every card only when more than one is visible."""
    assert resolve_devices(["cpu"] * 3) == (torch.device("cpu"),) * 3
    assert resolve_devices(("cpu",)) == (torch.device("cpu"),)
    assert resolve_devices("cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="at least one"):
        resolve_devices([])
    with pytest.raises(ValueError, match="mixes device types"):
        resolve_devices(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        resolve_devices(["meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_devices(["cuda:0"] * 4)
    with pytest.raises(RuntimeError, match="no CUDA"):
        _port_grid(device=["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert resolve_devices(["cuda:1", "cuda:0"]) == (
        torch.device("cuda", 1), torch.device("cuda", 0))
    assert resolve_devices(None) == (torch.device("cuda", 0),
                                     torch.device("cuda", 1))
    with pytest.raises(ValueError, match="beyond the 2 visible"):
        resolve_devices(["cuda:0", "cuda:2"])
    with pytest.raises(ValueError, match="beyond the 2 visible"):
        resolve_device("cuda:2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_devices(None) == (torch.device("cuda"),)
    assert resolve_devices("cuda") == (torch.device("cuda"),)


def test_fingerprint_of_a_list_is_its_first_device():
    """A split run has one device's bits: it shares the unsplit run's
    cache entries and suite records."""
    assert _engine_fingerprint(["cpu"] * 4) == _engine_fingerprint("cpu")
    assert _engine_fingerprint(("cpu",)) == _engine_fingerprint("cpu")


@pytest.mark.gpu
def test_cuda_split_matches_unsplit():
    """On the card: one shard and four shards on ``cuda:0`` give the
    unsplit CUDA run's bits (chip_smoke.py phase 5a runs this at the
    study's size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU "
                    "mode (chip_smoke.py phase 5a runs the split there)")
    unsplit = _port_grid(device="cuda")
    for device in (["cuda:0"], ["cuda:0"] * 4):
        _assert_bitwise(unsplit, _port_grid(device=device, chunk=5),
                        f"{len(device)} shards on cuda:0")


_JAX_SHARDED = """
import json, sys
import jax
import numpy as np
from repro.core.batch import simulate_batch
from repro.core.simulator import (AlwaysTrust, FixedProbabilityTrust,
                                  NeverTrust, ThresholdTrust)
from repro.core.traces import Exponential, make_event_trace
from repro.core.waste import Platform

assert len(jax.devices()) == 4, jax.devices()
args = json.loads(sys.argv[1])
traces = [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6, 100000.0,
                           np.random.default_rng(s))
          for s in args.pop("trace_seeds_bank")]
trusts = [t for t in (NeverTrust(), AlwaysTrust(), ThresholdTrust(100.0),
                      FixedProbabilityTrust(0.6)) for _ in range(2)]
periods = args.pop("periods")
time_base = args.pop("time_base")
res = simulate_batch(traces, Platform(mu=2500.0, c=60.0, d=10.0, r=30.0),
                     time_base, periods, trust=trusts, backend="jax",
                     **args)
print(json.dumps([repr(float(m)) for m in res.makespan.reshape(-1)]))
"""


def test_matches_jax_sharded_four_ways_subprocess():
    """The reference's jax engine under ``shard_map`` over four forced
    host devices, chunks of 5 (padded to 8 there), ``==`` the port over
    ``["cpu"] * 4`` with ``chunk=5`` on every makespan."""
    pytest.importorskip("jax")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               REPRO_JAX_SHARD="1", REPRO_JAX_CHUNK="5",
               PYTHONPATH=os.pathsep.join([SRC] + sys.path))
    args = dict(GRID, trace_seeds_bank=list(TRACE_SEEDS),
                time_base=TIME_BASE)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, json.dumps(args)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    ms_jax = [float(v) for v in json.loads(proc.stdout.splitlines()[-1])]
    got, _, _ = _split_run(4, 5)
    assert list(got.makespan.reshape(-1)) == ms_jax
