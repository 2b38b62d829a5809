"""Drive the PyTorch/CUDA port on one GPU and hold it to its plain versions.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result):

1. device    - require CUDA; print the card's name and power limit.
2. build     - build the CUDA kernel from the checkout's source with
               nvcc; the PTX has no fma.
3. kernel    - each kernel against its plain torch version on the same
               CUDA tensors, ``==`` on the bits, at 300, 4,800, the main
               path's 5,200 and 65,536 lanes with 1 and 4 passes.
4. main path - the paper's study at the scale ``BENCH_simulator.json``
               records (n = 65,536 processors, 200 traces): rfo,
               optimal_prediction and BestPeriod(rfo) through the three
               steps of ``evaluate_strategies`` on CUDA, with the kernel
               launch counts set to 0 just before and read just after;
               the timed pass's first 8 traces of every candidate rerun on
               the CPU over the same bank, ``==``; then a 24-period x
               8-trace sub-grid on CUDA and on the CPU, ``==`` on every
               BatchResult field.
5. scale     - 65,536 lanes as one chunk (the ``engine_perf.py`` big-lane
               setup), lanes/s, 64 lanes checked against the CPU, and a
               profiler window for the device's busy share.
6. timing    - each kernel at the main path's shape against its plain
               version, by CUDA events, beside its bytes bound; the timed
               state is checked ``==`` too.

The last two lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  Run from a checkout: it imports the
port from ``src/`` beside it and builds into ``build/repro_torch/``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate for the bytes
# bound, float64 outside the tensor cores for the operations bound.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
# The kernel-check platform of the random states (event_step.random_state).
KW = dict(c=60.0, cp=30.0, d=10.0, r=30.0, time_base=4000.0)
N_TRACES = 200          # BENCH_simulator.json's bank
SUB_TRACES = 8          # the CPU cross-check's sub-grid
BIG_LANES = 65536


def log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bitwise_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return bool(torch.equal(a, b))


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    name = "event_step"
    info = _build.build(name)
    log(f"[build] {name} built in {time.perf_counter() - t0:.2f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {name}: {line.strip()}")
    if "fma.rn.f64" in _build.ptx(name):
        raise RuntimeError(f"{name}: PTX contains fma.rn.f64")
    log(f"[build] {name}: PTX has no fma.rn.f64")


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over entries that differ (equal infinities: 0)."""
    import torch
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def _check_step(fs, is_, n: int) -> float:
    """event_step (kernel) == event_step_ref on one CUDA state, passes 1
    and 4; returns the largest absolute difference seen."""
    import torch
    from repro_torch.kernels.event_step import event_step, event_step_ref
    max_err = 0.0
    for passes in (1, 4):
        fk, ik = event_step(fs, is_, passes=passes, **KW)
        fr, ir = event_step_ref(fs, is_, passes=passes, **KW)
        torch.cuda.synchronize()
        max_err = max(max_err, _max_abs_err(fk, fr),
                      _max_abs_err(ik.double(), ir.double()))
        if not (_bitwise_equal(fk, fr) and _bitwise_equal(ik, ir)):
            bad = int(((fk != fr).any(0) | (ik != ir).any(0)).sum())
            raise AssertionError(f"event_step kernel != plain at {n} "
                                 f"lanes, passes={passes}: {bad} lanes "
                                 f"differ")
    return max_err


def phase_kernel(sizes: tuple[int, ...]) -> float:
    """event_step kernel == event_step_ref on the card at each lane count;
    returns the largest absolute difference seen."""
    import torch
    from repro_torch.kernels.event_step import event_step, random_state
    max_err = 0.0
    for n in sizes:
        fs_np, is_np = random_state(n, seed=n)
        fs = torch.from_numpy(fs_np).cuda()
        is_ = torch.from_numpy(is_np).cuda()
        max_err = max(max_err, _check_step(fs, is_, n))
        moved = float((event_step(fs, is_, **KW)[0] != fs).any(0)
                      .double().mean())
        log(f"[kernel] event_step {n} lanes: kernel == plain, passes 1 "
            f"and 4 ({moved:.2f} of lanes moved)")
    return max_err


def _assert_same(a, b, tag: str) -> None:
    import numpy as np
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            if va.shape != vb.shape or not (va == vb).all():
                raise AssertionError(f"{tag}: field {f.name} differs")
        elif va != vb:
            raise AssertionError(f"{tag}: field {f.name} differs")


def study_setup() -> dict:
    """The paper scenario, its trace bank and the study's lane candidates:
    rfo, optimal_prediction and BestPeriod(rfo)."""
    import numpy as np
    from repro_torch.core.policies import optimal_prediction, rfo
    from repro_torch.experiments import (BestPeriodSearch, ScenarioSpec,
                                         expand_candidates)
    sc = ScenarioSpec(n_traces=N_TRACES)
    t0 = time.perf_counter()
    traces = sc.make_traces()
    events = np.mean([t.times.size for t in traces])
    log(f"[main] scenario n={sc.n} mu={sc.mu:.1f} s C={sc.c} R={sc.r} "
        f"D={sc.d} r={sc.recall} p={sc.precision}: {len(traces)} traces, "
        f"{events:.1f} events/trace, made in "
        f"{time.perf_counter() - t0:.2f} s")
    base = rfo(sc.platform)
    opt = optimal_prediction(sc.pp)
    unique, rows = expand_candidates([base, opt, BestPeriodSearch(base)],
                                     sc.platform)
    return {"sc": sc, "traces": traces, "opt": opt, "unique": unique,
            "rows": rows, "n_lanes": len(unique) * len(traces)}


def phase_main(study: dict) -> dict:
    """The paper's study on the card; returns what the later phases need."""
    import numpy as np
    import torch
    from repro_torch.core.batch import simulate_batch
    from repro_torch.experiments import best_means, candidate_makespans
    from repro_torch.kernels.event_step import event_step
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    sc, traces, unique = study["sc"], study["traces"], study["unique"]
    plat, n_lanes = sc.platform, study["n_lanes"]
    reg = MetricsRegistry()
    prev = set_registry(reg)
    event_step.launches = 0
    t0 = time.perf_counter()
    ms = candidate_makespans(traces, plat, sc.time_base, sc.cp, unique,
                             seed=sc.seed)
    means = best_means(ms, study["rows"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = event_step.launches
    set_registry(prev)
    if launches <= 0:
        raise AssertionError("the main path launched no event_step kernel")
    iters = reg.counters["torch.iterations"]
    for name, m in zip(("RFO", "OptimalPrediction", "BestPeriod(RFO)"),
                       means):
        if not (np.isfinite(m) and m > sc.time_base):
            raise AssertionError(f"{name}: mean makespan {m} is not a "
                                 f"finite value above time_base")
        log(f"[main] {name}: mean makespan {m!r} s, waste "
            f"{1.0 - sc.time_base / m!r}")
    if not means[2] <= means[0]:
        raise AssertionError("BestPeriod lost to its base period")
    log(f"[main] {n_lanes} lanes ({len(unique)} candidates x {len(traces)} "
        f"traces) in {wall:.3f} s: {n_lanes / wall:.1f} lanes/s, {iters} "
        f"loop iterations ({wall / iters * 1e3:.4f} ms each), event_step "
        f"launches {launches}")

    # The timed pass itself against the CPU: its first SUB_TRACES traces
    # of every candidate, rerun over the same 200-trace bank.
    t0 = time.perf_counter()
    on_cpu = candidate_makespans(traces, plat, sc.time_base, sc.cp, unique,
                                 seed=sc.seed,
                                 trace_indices=range(SUB_TRACES),
                                 device="cpu")
    t_cpu = time.perf_counter() - t0
    if not (ms[:, :SUB_TRACES].view(np.int64)
            == on_cpu.view(np.int64)).all():
        raise AssertionError("timed study pass: CUDA != CPU on its first "
                             f"{SUB_TRACES} traces")
    log(f"[main] timed pass, {len(unique)} candidates x first {SUB_TRACES} "
        f"traces: CUDA == CPU on every makespan (cpu {t_cpu:.2f} s)")

    # CUDA == CPU on a 24-period x 8-trace sub-grid, every field: the
    # grid's periods other than rfo's own, under optimal_prediction's trust.
    sub = traces[:SUB_TRACES]
    periods = np.array([s.period for s in unique[-24:]])
    kw = dict(cp=sc.cp, trust=study["opt"].trust,
              trace_seeds=[sc.seed + 7919 * i for i in range(len(sub))])
    t0 = time.perf_counter()
    on_gpu = simulate_batch(sub, plat, sc.time_base, periods, **kw)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = simulate_batch(sub, plat, sc.time_base, periods, device="cpu",
                            **kw)
    t_cpu = time.perf_counter() - t0
    _assert_same(on_gpu, on_cpu, "CUDA vs CPU sub-grid")
    log(f"[main] sub-grid {len(periods)} x {len(sub)}: CUDA == CPU on every "
        f"BatchResult field (cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s)")
    return {"launches": launches, "wall_s": wall, "iterations": iters}


def phase_scale() -> None:
    """65,536 lanes as one chunk on the engine_perf.py big-lane setup."""
    import numpy as np
    import torch
    from repro_torch.core.batch import simulate_lanes
    from repro_torch.core.simulator import ThresholdTrust
    from repro_torch.core.traces import Exponential, make_event_trace
    from repro_torch.core.waste import Platform

    lp = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    bank = [make_event_trace(Exponential(1.0), lp.mu, 0.7, 0.6, 200000.0,
                             np.random.default_rng(s)) for s in range(64)]
    idx = np.arange(BIG_LANES) % len(bank)

    def run(lanes: np.ndarray, device=None) -> np.ndarray:
        return simulate_lanes(
            bank, lp, 50000.0, cp=30.0, trace_indices=idx[lanes],
            periods=np.full(lanes.size, 1200.0),
            trusts=[ThresholdTrust(100.0)] * lanes.size,
            windows=np.full(lanes.size, 300.0), seeds=lanes + 7,
            device=device)

    everything = np.arange(BIG_LANES)
    run(everything[:256])                      # warm up allocator, kernel
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = run(everything)
    wall = time.perf_counter() - t0
    if not (np.isfinite(ms).all() and (ms > 50000.0).all()):
        raise AssertionError("scale run: makespans not finite above "
                             "time_base")
    cpu = run(everything[:64], device="cpu")
    if not (cpu == ms[:64]).all():
        raise AssertionError("scale run: CUDA != CPU on the first 64 lanes")
    log(f"[scale] {BIG_LANES} lanes in one chunk: {wall:.3f} s, "
        f"{BIG_LANES / wall:.1f} lanes/s; first 64 lanes == CPU")

    # Device busy share and kernels per iteration over a profiled run.
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    lanes = everything[:8192]
    reg = MetricsRegistry()
    prev = set_registry(reg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(lanes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    set_registry(prev)
    iters = reg.counters["torch.iterations"]
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] {lanes.size} lanes, {iters} iterations: wall "
        f"{wall:.3f} s, device busy {busy:.3f} s ({busy / wall:.3f} of "
        f"wall); device events: {sum(r[2] for r in rows)} "
        f"({sum(r[2] for r in rows) / max(iters, 1):.1f} per iteration)")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"[profile]   {dev_us / 1e3:10.3f} ms  {count:7d}x  {key[:70]}")


def _device_rows(prof) -> list[tuple[float, str, int]]:
    """(device us, name, count) of each device-side event of a profile
    (kernels, copies): the CPU-side op events carry the same device time
    as their children, so they are left out."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "cuda_time_total", 0.0)
        rows.append((dev_us, evt.key, evt.count))
    return rows


def phase_timing(n_lanes: int) -> dict:
    """event_step (4 passes, as the engine calls it) at the main path's
    lane count: kernel and plain version by CUDA events, and the bound."""
    import torch
    from repro_torch.kernels.event_step import (BYTES_PER_LANE,
                                                FLOPS_PER_LANE_PASS,
                                                event_step, event_step_ref,
                                                random_state)
    fs_np, is_np = random_state(n_lanes, seed=1)
    fs = torch.from_numpy(fs_np).cuda()
    is_ = torch.from_numpy(is_np).cuda()
    launches = event_step.launches
    max_err = _check_step(fs, is_, n_lanes)
    log(f"[kernel] event_step {n_lanes} lanes, the timed state: kernel == "
        f"plain, passes 1 and 4")
    ms = _time_ms(lambda: event_step(fs, is_, passes=4, **KW), 500)
    plain_ms = _time_ms(lambda: event_step_ref(fs, is_, passes=4, **KW), 50)
    # The kernel's own device time, without the host's enqueue cost that
    # back-to-back CUDA-event timing includes when the host is the slower.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            event_step(fs, is_, passes=4, **KW)
        torch.cuda.synchronize()
    kern = [(us, n) for us, key, n in _device_rows(prof)
            if "event_step_kernel" in key]
    device_ms = (sum(us for us, _ in kern) / sum(n for _, n in kern) / 1e3
                 if kern else None)
    event_step.launches = launches          # timing launches do not count
    bytes_ms = BYTES_PER_LANE * n_lanes / HBM_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_LANE_PASS * 4 * n_lanes / FP64_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    dev = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
    log(f"[timing] event_step {n_lanes} lanes, 4 passes: kernel {ms:.5f} "
        f"ms per call (device time {dev}, profiler), plain {plain_ms:.5f} "
        f"ms, bound {bound_ms:.6f} ms by {bound_by} (bytes {bytes_ms:.6f} "
        f"ms, operations {ops_ms:.6f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": max_err}


def main() -> int:
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    study = study_setup()
    max_err = phase_kernel((300, 4800, study["n_lanes"], BIG_LANES))
    main_run = phase_main(study)
    phase_scale()
    timing = phase_timing(study["n_lanes"])
    max_err = max(max_err, timing["max_abs_err"])
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "event_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step.cu",
        "replaces": "src/repro/kernels/event_step.py:275",
        "launches": main_run["launches"], "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
