"""The lane engine's host loop and its lane-loop kernel.

``run_lanes_torch`` drives a chunk through ``lane_loop`` calls of at most
``batch_torch._LAUNCH_CAP`` iterations each, reading one stop flag back
after each call.  On the CPU the calls run the plain eager loop
(``lane_loop_ref``); on the card, the CUDA kernel ``lane_loop_kernel``.
Each lane runs until it finished, overflowed or reached the cap, so the
cap changes no bit: under caps 1, 7, ``_STOP_EVERY`` and none, the port
must equal the JAX package's numpy lanes on every ``BatchResult`` field
(tolerance: none, ``==``), on the fixtures of ``tests/test_torch_lanes.py``
(trust x window matrix, per-event windows, silent errors).

Also: the largest per-lane iteration count is what a lockstep loop with a
stop test every iteration needs; a chunk takes ``ceil(iterations / cap)``
calls; a trace that overflows the 8 deferred-fault slots gives the numpy
lanes' bits under every cap (its lanes rerun with more slots); the CUDA
source's row, flag and code numbers are the Python module's.  The
``gpu``-marked cases hold the kernel to the plain loop on the card and
skip here.
"""

import dataclasses
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as ref_sim  # noqa: E402
from repro.core.batch import simulate_batch as ref_simulate_batch  # noqa: E402
from repro.core.traces import (FALSE_PRED, FAULT_PRED, FAULT_UNPRED,  # noqa: E402
                               EventTrace, Exponential, make_event_trace)
from repro.core.waste import Platform as RefPlatform  # noqa: E402

import repro_torch.core.batch_torch as batch_torch  # noqa: E402
import repro_torch.kernels.event_step as es  # noqa: E402
import repro_torch.kernels.lane_loop as ll  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.batch import simulate_batch, simulate_lanes  # noqa: E402
from repro_torch.core.traces import traces_from_numpy  # noqa: E402
from repro_torch.core.waste import Platform  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry, set_registry  # noqa: E402

REF_PLAT = RefPlatform(mu=2500.0, c=60.0, d=10.0, r=30.0)
PLAT = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
TIME_BASE = 30000.0
PERIODS = [1200.0, 2500.0]
SEEDS = [5, 6, 7]
NO_CAP = 2 ** 31 - 1
CAPS = [1, 7, ll._STOP_EVERY, NO_CAP]
CAP_IDS = ["cap1", "cap7", "cap_stop_every", "no_cap"]
CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "event_step.cu")
GOLDEN = json.loads((Path(__file__).parent / "golden" / "parity_v1.json")
                    .read_text())["cells"]


def _traces(seeds=(20, 21, 22), silent_mu=None):
    return [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6,
                             100000.0, np.random.default_rng(s),
                             silent_mu=silent_mu) for s in seeds]


def _win_trace(seed):
    r = np.random.default_rng(seed)
    n = 80
    times = np.sort(r.uniform(0, 75000.0, n))
    kinds = r.choice([FAULT_UNPRED, FAULT_PRED, FALSE_PRED], n,
                     p=[0.3, 0.4, 0.3]).astype(np.int8)
    wins = r.choice([-1.0, 0.0, 250.0, 600.0], n).astype(np.float64)
    return EventTrace(times, kinds, 100000.0, wins)


def _fixtures():
    """(id, function making the traces, reference trust, simulate_batch
    keywords)."""
    out = []
    trusts = [("never", ref_sim.NeverTrust()),
              ("always", ref_sim.AlwaysTrust()),
              ("threshold", ref_sim.ThresholdTrust(100.0)),
              ("fixed_q", ref_sim.FixedProbabilityTrust(0.6))]
    for tid, trust in trusts:
        out.append((f"{tid}-instant", _traces, trust,
                    dict(inexact_window=300.0, window_mode="instant")))
        out.append((f"{tid}-within", _traces, trust,
                    dict(inexact_window=300.0, window_mode="within",
                         window_period=100.0)))
    wins = lambda: [_win_trace(s) for s in (10, 11, 12)]  # noqa: E731
    out.append(("windows-always", wins, ref_sim.AlwaysTrust(),
                dict(inexact_window=300.0)))
    out.append(("windows-threshold-within", wins,
                ref_sim.ThresholdTrust(100.0),
                dict(inexact_window=300.0, window_mode="within",
                     window_period=100.0)))
    silent = lambda: _traces(silent_mu=4000.0)  # noqa: E731
    for nv, vc, keep in [(0, 0.0, 1), (1, 40.0, 2), (3, 20.0, 3)]:
        for tid, trust in trusts[0], trusts[2]:
            out.append((f"silent-k{nv}-keep{keep}-{tid}", silent, trust,
                        dict(inexact_window=300.0, n_verify=nv,
                             verify_cost=vc, keep_ckpts=keep)))
    return out


FIXTURES = {fid: (build, trust, kw) for fid, build, trust, kw in _fixtures()}


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


_REF_CACHE: dict = {}


def _reference(fid):
    """The JAX package's numpy lanes on one fixture (computed once)."""
    if fid not in _REF_CACHE:
        build, trust, kw = FIXTURES[fid]
        traces = build()
        _REF_CACHE[fid] = ref_simulate_batch(
            traces, REF_PLAT, TIME_BASE, PERIODS, trust=trust, cp=30.0,
            trace_seeds=SEEDS[:len(traces)], **kw)
    return _REF_CACHE[fid]


def _port(fid, device="cpu"):
    build, trust, kw = FIXTURES[fid]
    traces = build()
    return simulate_batch(_carry(traces), PLAT, TIME_BASE, PERIODS,
                          trust=_port_trust(trust), cp=30.0,
                          trace_seeds=SEEDS[:len(traces)], device=device,
                          **kw)


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


@pytest.mark.parametrize("cap", CAPS, ids=CAP_IDS)
@pytest.mark.parametrize("fid", sorted(FIXTURES))
def test_host_loop_caps_match_numpy(fid, cap, monkeypatch, registry):
    """Every cap gives the numpy lanes' bits, in ceil(iterations / cap)
    host-loop calls."""
    monkeypatch.setattr(batch_torch, "_LAUNCH_CAP", cap)
    _assert_bitwise(_reference(fid), _port(fid), f"{fid} cap={cap}")
    iters = registry.counters["torch.iterations"]
    assert iters > 0
    assert registry.counters["torch.loop_calls"] == math.ceil(iters / cap)
    assert registry.counters["kernels.lane_loop.launches"] == 0  # the CPU


def _lockstep_iterations(lanes: "ll.Lanes", g: "ll.LaneBank") -> int:
    """Iterations of the lockstep loop with a stop test every iteration
    (the JAX package's while_loop): the body over all lanes until every
    lane finished."""
    s, k = ll._unpack(lanes)
    fs, is_ = lanes.f[:es.N_F].clone(), lanes.i[:es.N_I].clone()
    n = 0
    while not bool((is_[es.I_FIN] != 0).all() | s["overflow"].any()):
        fs, is_, s = ll._body(fs, is_, s, k, g)
        n += 1
    return n


def _capture(monkeypatch) -> list:
    """Record a clone of every chunk's state at its first lane_loop call."""
    seen = []
    real = batch_torch.lane_loop

    def recording(lanes, g, *, cap):
        if int(lanes.q[ll.LQ_ITERS].max()) == 0:
            seen.append((lanes.clone(), g))
        return real(lanes, g, cap=cap)

    recording.launches = 0
    monkeypatch.setattr(batch_torch, "lane_loop", recording)
    return seen


@pytest.mark.parametrize("fid", ["threshold-within", "windows-always",
                                 "silent-k3-keep3-threshold"])
def test_largest_lane_count_is_lockstep_need(fid, monkeypatch, registry):
    """``torch.iterations``, the largest per-lane iteration count, is the
    number of iterations a stop-test-every-1 lockstep run needs."""
    seen = _capture(monkeypatch)
    _port(fid)
    (lanes, g), = seen
    assert registry.counters["torch.iterations"] == \
        _lockstep_iterations(lanes, g)


def _overflow_trace():
    n = 12  # > _DEF_SLOTS overlapping armed windows
    times = 1000.0 + 10.0 * np.arange(n)
    return EventTrace(times, np.full(n, FAULT_PRED, dtype=np.int8), 1e7,
                      np.full(n, 1e6))


_OVERFLOW_KW = dict(cp=30.0, trace_indices=[0, 1, 1, 0],
                    periods=[1200.0] * 4, windows=[0.0] * 4,
                    seeds=[3, 4, 5, 6])


def _overflow_lanes(device="cpu"):
    return simulate_lanes(
        _carry([_overflow_trace()] + _traces(seeds=(3,))), PLAT, TIME_BASE,
        trusts=[sim.AlwaysTrust()] * 4, device=device, **_OVERFLOW_KW)


@pytest.mark.parametrize("cap", CAPS, ids=CAP_IDS)
def test_overflow_raises_under_caps(cap, monkeypatch, registry):
    """Under every cap, the overflowed lanes' rerun with more slots gives
    the numpy lanes' bits; the overflow is counted once for the chunk."""
    from repro.core.batch import simulate_lanes as ref_simulate_lanes
    monkeypatch.setattr(batch_torch, "_LAUNCH_CAP", cap)
    want = ref_simulate_lanes([_overflow_trace()] + _traces(seeds=(3,)),
                              REF_PLAT, TIME_BASE,
                              trusts=[ref_sim.AlwaysTrust()] * 4,
                              **_OVERFLOW_KW)
    assert list(_overflow_lanes()) == list(want)
    assert registry.counters["engine.deferred_overflows"] == 1


def test_overflowed_lane_stops_others_run_on(monkeypatch):
    """The plain loop holds an overflowed lane where it overflowed and
    runs the others to their end, as the kernel does lane by lane."""
    seen = _capture(monkeypatch)
    _overflow_lanes()
    lanes, g = seen[0]
    assert lanes.slots == ll._DEF_SLOTS
    whole = lanes.clone()
    flag = int(ll.lane_loop_ref(whole, g, cap=NO_CAP))
    # The overflowed lanes stop unfinished; none can run on.
    assert flag == ll.FLAG_OVERFLOW
    over = whole.i[ll.LI_OVERFLOW] != 0
    assert over.any() and not over.all()
    assert (whole.i[es.I_FIN][~over] == 1).all()
    assert (whole.i[es.I_FIN][over] == 0).all()
    # One iteration a call, as many calls as the longest lane ran: the
    # same bits (a stopped lane is left as it is).
    step = lanes.clone()
    for _ in range(int(whole.q[ll.LQ_ITERS].max())):
        ll.lane_loop_ref(step, g, cap=1)
    for name in ("f", "i", "q"):
        assert torch.equal(getattr(step, name), getattr(whole, name))


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    seen = _capture(monkeypatch)
    _port("fixed_q-within")
    lanes, g = seen[0]
    a, b = lanes.clone(), lanes.clone()
    before = ll.lane_loop.launches
    fa = ll.lane_loop(a, g, cap=50)
    fb = ll.lane_loop_ref(b, g, cap=50)
    assert ll.lane_loop.launches == before       # no kernel ran
    assert int(fa) == int(fb) == 1               # unfinished after 50
    for name in ("f", "i", "q"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert int(a.q[ll.LQ_ITERS].max()) == 50


@pytest.mark.parametrize("bad", ["dtype", "rows", "lanes", "layout",
                                 "cap0", "cap_big"])
def test_wrapper_rejects_bad_chunk(bad, monkeypatch):
    seen = _capture(monkeypatch)
    _port("always-instant")
    lanes, g = seen[0]
    cap = 5
    if bad == "dtype":
        lanes = dataclasses.replace(lanes, f=lanes.f.float())
    elif bad == "rows":
        lanes = dataclasses.replace(lanes, i=lanes.i[:-1])
    elif bad == "lanes":
        lanes = dataclasses.replace(lanes, q=lanes.q[:, :-1])
    elif bad == "layout":
        lanes = dataclasses.replace(lanes, tab=lanes.tab.T.contiguous().T)
    elif bad == "cap0":
        cap = 0
    else:
        cap = 2 ** 31
    with pytest.raises(ValueError):
        ll.lane_loop(lanes, g, cap=cap)


def _enums(src: str) -> dict:
    """name -> value of every enumerator and int constexpr of a source."""
    out = {}
    for body in re.findall(r"enum\s+\w+\s*\{([^}]*)\}", src):
        value = -1
        for item in body.split(","):
            item = re.sub(r"//.*", "", item).strip()
            if not item:
                continue
            name, _, expr = item.partition("=")
            value = int(expr) if expr.strip() else value + 1
            out[name.strip()] = value
    for name, value in re.findall(r"constexpr int (\w+) = (\d+);", src):
        out[name] = int(value)
    return out


def test_kernel_rows_and_codes_match_module():
    """The CUDA source numbers its rows and codes as the Python modules
    do (the kernel cannot run here; this keeps the two in step)."""
    from repro_torch.core import traces
    c = _enums(CSRC.read_text())
    py = {**{n: getattr(es, n) for n in dir(es) if n[:2] in ("F_", "I_")
             and isinstance(getattr(es, n), int)},
          "N_F": es.N_F, "N_I": es.N_I,
          **{n: getattr(ll, n) for n in dir(ll)
             if n[:3] in ("LF_", "LI_", "LQ_") or n == "N_LQ"},
          **{n[1:]: getattr(ll, n) for n in dir(ll)
             if n.startswith(("_PC_", "_TRUST_"))},
          **{n: getattr(ll, n) for n in dir(ll) if n.startswith("FLAG_")},
          "DEF_SLOTS": ll._DEF_SLOTS, "BIG_SEQ": ll._BIG_SEQ,
          "ADV_PASSES": ll._ADV_PASSES, "N_COUNTS": len(ll.COUNTS),
          **{n: getattr(traces, n) for n in ("FAULT_UNPRED", "FAULT_PRED",
                                             "FALSE_PRED", "SILENT")},
          **{n: getattr(sim, "_" + n) for n in ("WORK", "CKPT", "PROCKPT",
                                                "DOWN", "RECOVER",
                                                "VERIFY")}}
    for name, value in py.items():
        assert c.get(name) == value, name
    counts = ["C_FAULTS", "C_FAULTS_HIT", "C_PREDICTIONS", "C_TRUSTED",
              "C_TRUSTED_TRUE", "C_IGNORED", "C_SILENT"]
    assert [c[n] for n in counts] == list(range(len(ll.COUNTS)))
    assert len(counts) == len(ll.COUNTS)
    from repro_torch.predictors.estimator import P_HAT_MIN
    hat, = re.findall(r"constexpr double P_HAT_MIN = ([0-9.e+-]+);",
                      CSRC.read_text())
    assert float(hat) == P_HAT_MIN == ll.P_HAT_MIN
    for name in ("LF_NTP", "LF_TOL", "LF_DEF", "LI_ACT", "LI_RESUME",
                 "LI_DEFSEQ", "FLAG_REPLAN"):
        assert c[name] == getattr(ll, name), name


# -- on the card ---------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; the kernel has no CPU mode "
                    "(chip_smoke.py runs these checks on the GPU)")


def _to_cuda(lanes, g):
    return lanes.to("cuda"), g.to("cuda")


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return bool(torch.equal(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("fid", sorted(FIXTURES))
def test_cuda_kernel_matches_plain(fid, monkeypatch):
    """On the card: the kernel == the plain loop on the same CUDA chunk,
    in one launch and under a cap of 1, and the CUDA engine == the CPU."""
    _need_cuda()
    seen = _capture(monkeypatch)
    on_cpu = _port(fid)
    lanes, g = _to_cuda(*seen[0])
    plain = lanes.clone()
    batch_torch._run_chunk(ll.lane_loop_ref, plain, g, NO_CAP)
    iters = int(plain.q[ll.LQ_ITERS].max())
    for cap in (batch_torch._LAUNCH_CAP, 1):
        kern = lanes.clone()
        before = ll.lane_loop.launches
        calls = batch_torch._run_chunk(ll.lane_loop, kern, g, cap)
        assert ll.lane_loop.launches - before == calls
        assert calls <= math.ceil(iters / cap)
        for name in ("f", "i", "q"):
            assert _bits_equal(getattr(kern, name), getattr(plain, name)), \
                f"{fid} cap={cap}: {name}"
    monkeypatch.undo()
    _assert_bitwise(on_cpu, _port(fid, device="cuda"), f"{fid} cuda")


@pytest.mark.gpu
def test_cuda_chunk_launches_no_event_step(registry):
    """A CUDA chunk runs through lane_loop_kernel alone: ceil(iterations /
    cap) launches or fewer, and no event_step_kernel."""
    _need_cuda()
    before = es.event_step.launches
    _port("silent-k1-keep2-threshold", device="cuda")
    iters = registry.counters["torch.iterations"]
    launches = registry.counters["kernels.lane_loop.launches"]
    assert 0 < launches <= math.ceil(iters / batch_torch._LAUNCH_CAP)
    assert registry.counters["kernels.event_step.launches"] == 0
    assert es.event_step.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_cuda_golden_cell(name):
    """The golden parity net on the card, through the kernel, ``==``."""
    _need_cuda()
    from test_torch_golden import golden_makespans
    ms = golden_makespans(name, "cuda")
    assert [float(m) for m in ms] == GOLDEN[name]["makespans"], name
