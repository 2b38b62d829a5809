"""Drive the PyTorch/CUDA port on one GPU and hold it to its plain versions.

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result):

1. device    - require CUDA; print the card's name and power limit.
2. build     - build every CUDA source (event_step.cu, ckpt_delta.cu,
               flash_attention.cu, decode_attention.cu) from the checkout
               with nvcc, one process each, started together, and print
               each kernel's registers and spills; the event_step PTX
               (event_step_kernel and each of lane_loop_kernel's four
               instantiations: the 8 register slots or the wide route,
               static or adaptive lanes) has no fma and multiplies with
               mul.rn.f64, the ckpt_delta PTX
               divides with div.rn.f32, rounds with cvt.rni and has no fma;
               the attention
               PTX divides with div.rn.f32 (no fast-math division), and
               flash_attention's multiplies on the tensor cores
               (wgmma.mma_async, its bf16 route).
3. kernel    - event_step against its plain torch version on the same
               CUDA tensors, ``==`` on the bits, at 300, 4,800, the main
               path's 5,200 and 65,536 lanes with 1 and 4 passes.  Then
               lane_loop_kernel against the plain eager loop on the same
               CUDA chunk, ``==`` on every row of every state matrix and
               every count: the study's 5,200-lane chunk as the main path
               hands it over, and a 384-lane grid the study does not reach
               (verification 0-3 with keep_ckpts 1-3 and silent errors,
               "within" windows, per-event windows, all four trust
               policies, FixedProbability's draws), each at the engine's
               per-launch cap and at a cap of 1; the grid also CUDA ==
               CPU on every makespan.
3a. adaptive - lane_loop_kernel's adaptive instantiation: the five adaptive
               configurations of ``tests/test_jax_engine.py:103-134``
               (plain, halflife, estimate_mu, the exact model, mu +
               halflife + "within") x 40 traces of the study's bank, each
               started on its prior's plan, through the engine on CUDA
               and on the CPU, ``==`` on every BatchResult field; the
               chunk's kernel ``==`` the plain loop call for call (the
               host's re-plan rounds between) at the engine's cap and at
               a cap of 1; launches, re-plan rounds, re-plans, the host's
               re-plan seconds, and the chunk's device time (profiler)
               beside its bound.
4. main path - the paper's study at the scale ``BENCH_simulator.json``
               records (n = 65,536 processors, 200 traces): rfo,
               optimal_prediction and BestPeriod(rfo) through the three
               steps of ``evaluate_strategies`` on CUDA, with the kernel
               launch counts set to 0 just before and read just after:
               lane_loop launches > 0, event_step launches 0; launches per
               chunk, the largest per-lane iteration count, lanes/s and
               how the host splits the pass's wall time.  The timed
               pass's first 8 traces of every candidate rerun on
               the CPU over the same bank, ``==``; then a 24-period x
               8-trace sub-grid on CUDA and on the CPU, ``==`` on every
               BatchResult field.
5. scale     - 65,536 lanes as one chunk (the ``engine_perf.py`` big-lane
               setup), lanes/s, 64 lanes checked against the CPU, and a
               profiler window for the device's busy share and device
               events per iteration.
6. timing    - event_step at the main path's shape against its plain
               version, by CUDA events, beside its bytes bound; the timed
               state is checked ``==`` too.  lane_loop_kernel on the
               study's chunk by CUDA events and profiler device time,
               beside its bound, the plain loop's time on the same chunk
               (phase 3's run) and the longest lane's ns per iteration.
6a. predictor study - ``benchmarks/predictor_sweep.py``'s five predictor
               cells (oracle, lead_time, bursty, two drifting ramps) at its
               non-quick size (25 traces, n = 65,536, the paper's
               platform) through the port's own ``ScenarioSpec``,
               ``PredictorSpec`` and ``build_strategy``: rfo,
               optimal_prediction and adaptive through the three steps of
               ``evaluate_strategies`` on CUDA, the launch counts set to 0
               just before and read just after (lane_loop > 0, event_step
               0); lanes/s, launches per chunk, re-plan rounds and the host
               split of each cell; then the first 4 traces of every cell
               and strategy on the CPU in one run, ``==``.
6b. convergence - the sweep's convergence cell (stale prior r = 0.3,
               p = 0.99; 20 traces, 40,000 years) on CUDA, held to the
               script's own claims (``predictor_sweep.py:91-140``).
6c. overflow - 64 lanes of a trace with 12 faults in flight (more than
               the kernel's 8 register slots) beside 192 other lanes: the
               chunk through the 8-slot kernel, only the 64 overflowed
               lanes rerun through the wide route (16 slots), CUDA == CPU.
7. ckpt kernels - quantize_delta / dequantize_delta kernels ``==`` their
               plain versions (q, scales, restored bits) at 123, 256,
               1000 x 37 and 4096 x 16 elements in fp32 and bf16, with a
               random and a zero delta.
8. trainer   - the slice's main path: FaultTolerantTrainer on
               tinyllama-1.1b at full width (1.1e9 bf16 params + fp32
               AdamW moments, 11.0 GB; seq 128, batch 8, the CLI's
               platform) over a fixed trace with one periodic save, one
               trusted true prediction and its proactive save, and the
               fault it predicted, which rolls back to the delta; the
               ckpt_delta launch counts set to 0 just before and read just
               after.  Before the run: timed train steps and where a step
               goes (forward + backward, AdamW, device busy share).  At
               the proactive save, through the manager's hooks: both
               kernels ``==`` plain on every one of the 24 quantized leaves
               and on one bf16 parameter leaf, and timed over those 24
               leaves (CUDA events) beside the plain versions and the
               bytes bound.  At the restore: quantized leaves within their
               block's scale/2 of the saved state, raw leaves ``==``.
               Bytes and seconds of each save and restore, C and C_p.
9. cuda vs cpu - the reduced llama3.2-1b trainer of ``tests/test_ft.py``
               (30 steps, its trace) on CUDA and on the CPU from one
               initial state: every TrainerStats counter and virtual time
               and the (step, kind) of every restore ``==`` (one of them is
               from a delta), final loss within 1e-3 relative (bf16).
10. attention kernels - flash_attention and decode_attention against their
               plain versions on the card, on the reference's cases
               (``tests/test_kernels.py``: FLASH_CASES and seq 96,
               DECODE_CASES and per-batch lengths 1/64/128) and one case
               each at the main path's heads (g = 8) and lengths (flash at
               seq 2,048; decode over a cache of 2,176 with ragged
               lengths), and cases that cut the bf16 flash kernel's
               64-row and 64-key tiles unevenly and decode prefixes that
               end inside a cluster's last block, float32 at 2e-6 and
               bfloat16 to one bf16 ulp.
11. serving   - the slice's main path: ServingEngine on tinyllama-1.1b at
               full width (bf16, attn_impl="pallas", cache_len 2176),
               batch 8, prompt 2,048, 128 new tokens, greedy; prefill s,
               decode ms per step, tokens/s, peak memory and a profiled
               window of decode steps, which must hold one decode kernel
               per layer per step (one launch a call, no merge pass);
               decode_attention launches set to 0 before the generate and
               read after (22 x 128).  A second,
               checked generate: hooks hold the kernel to its plain version
               on every layer's inputs at the first and last step (one
               bf16 ulp; the last step's inputs also cast to float32, at
               2e-6), and the generated tokens, teacher-forced through
               attn_impl="ref", give each step's logits within 2e-2 of the
               largest.  The kernel timed on the last step's inputs of all
               22 layers in turn (L2 cold, as in a step) beside its plain
               version, scaled_dot_product_attention and its bytes bound.
               Then forward_train over the prompts with attn_impl="pallas":
               22 flash_attention launches, logits within 2e-2 of the
               largest of attn_impl="ref"; on layer 0's inputs the kernel
               held to plain with repeat_kv and with the grouped layout
               (g = 8, the same bits), in bf16 (one ulp) and cast to
               float32 (2e-6), and timed beside its plain version,
               scaled_dot_product_attention and its bound.
12. serving f32 - phase 11's checks at full width in float32, where
               rounding leaves room for a limit that a faulty kernel would
               cross: the checked generate (decode kernel within 2e-6 of
               plain) with the ref route teacher-forced over its tokens,
               and forward_train through the flash kernel (22 launches),
               both within 1e-4 of the ref route's largest logit.
13. serving cuda vs cpu - reduced llama3.2-1b in float32 (batch 3, prompt
               24, 8 new tokens, cache_len 48, as ``tests/test_serve.py``)
               with attn_impl="pallas" on CUDA (the kernel) and on the CPU
               (its plain version): greedy tokens ``==``, logprobs within
               1e-4.

The last two lines are the ``kernels`` JSON line (all five TPU kernels;
the event_step entry reports lane_loop_kernel, which carries the advance
on the main path, with its adaptive instantiation's check, time, launches
and bound from phase 3a and the predictor study's launches) and
``{"ok": true, "device": {...}}``.  Run from a checkout: it imports the
port from ``src/`` beside it and builds into ``build/repro_torch/``.  The
checkpoint phases write about 27 GB into a temporary directory (under
``$TMPDIR``), which is removed at the end; the script raises if the disk
has less free space than it needs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, 700 W): memory rate for the bytes
# bound, float64 outside the tensor cores for the operations bound of the
# float64 lane step; bf16 dense tensor cores for attention on bf16 inputs
# (the input type's peak), float32 outside the tensor cores beside it.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
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


def _bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaNs and signed zeros included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point() and a.numel():
        a = a.reshape(-1).view(torch.uint8)
        b = b.reshape(-1).view(torch.uint8)
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


# PTX each source must (and must not) contain: the bitwise contracts.
PTX_RULES = {
    "event_step": (("mul.rn.f64",), ("fma.rn.f64",)),
    "ckpt_delta": (("div.rn.f32", "cvt.rni.f32.f32"),
                   ("fma.rn.f32", "div.approx", "div.full")),
    "flash_attention": (("div.rn.f32", "wgmma.mma_async"),
                        ("div.approx", "div.full")),
    "decode_attention": (("div.rn.f32",), ("div.approx", "div.full")),
}


def _ptx_entries(ptx: str) -> dict[str, str]:
    """Each kernel entry's PTX by its (mangled) name."""
    out = {}
    for part in re.split(r"\.entry\s+", ptx)[1:]:
        out[part.split("(")[0].strip()] = part
    return out


def _entry_label(mangled: str) -> str:
    """A readable name for a kernel entry: lane_loop_kernel's template
    flags spelled out (WIDE, ADAPTIVE)."""
    m = re.search(r"lane_loop_kernelILb([01])ELb([01])E", mangled)
    if m:
        wide, adaptive = (("true" if v == "1" else "false")
                          for v in m.groups())
        return f"lane_loop_kernel<wide={wide}, adaptive={adaptive}>"
    m = re.search(r"[a-z][a-z_]*_kernel", mangled)
    return m.group(0) if m else mangled


def phase_build() -> None:
    """Build every source with its own nvcc, all started together, and
    read each one's PTX; print each kernel's registers and spills."""
    from repro_torch.kernels import _build
    names = sorted(PTX_RULES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2 * len(names)) as pool:
        builds = [pool.submit(_build.build, n) for n in names]
        ptxs = [pool.submit(_build.ptx, n) for n in names]
        infos = [f.result() for f in builds]
        ptxs = [f.result() for f in ptxs]
    log(f"[build] {', '.join(names)} built and their PTX read in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in "
        f"parallel)")
    for name, info, ptx in zip(names, infos, ptxs):
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s")
        entry = "?"
        for line in info["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = _entry_label(m.group(1))
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")
        need, banned = PTX_RULES[name]
        missing = [w for w in need if w not in ptx]
        found = [w for w in banned if w in ptx]
        if missing or found:
            raise RuntimeError(f"{name}: PTX lacks {missing} or contains "
                               f"{found}")
        log(f"[build] {name}: PTX has {list(need)} and none of "
            f"{list(banned)}")
        if name == "event_step":
            # Each lane-loop instantiation on its own: the bitwise
            # contract holds in every one.
            loops = {_entry_label(k): v
                     for k, v in _ptx_entries(ptx).items()
                     if "lane_loop_kernel" in k}
            if len(loops) != 4:
                raise RuntimeError(f"event_step: {len(loops)} lane-loop "
                                   f"instantiations in the PTX, not 4")
            for label, body in sorted(loops.items()):
                if "mul.rn.f64" not in body or "fma.rn.f64" in body:
                    raise RuntimeError(f"{label}: PTX lacks mul.rn.f64 or "
                                       f"holds fma.rn.f64")
                log(f"[build] {label}: PTX has mul.rn.f64, no fma.rn.f64")


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
        if not (_bits_equal(fk, fr) and _bits_equal(ik, ir)):
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


def _record_chunks() -> tuple[list, object]:
    """Wrap the lane engine's ``lane_loop`` so that each chunk's state is
    cloned at its first call, as the engine hands it over.  Returns the
    records and a function that removes the wrapper."""
    import repro_torch.core.batch_torch as bt
    from repro_torch.kernels.lane_loop import LQ_ITERS
    real = bt.lane_loop
    seen = []

    def recording(lanes, g, *, cap):
        if int(lanes.q[LQ_ITERS].max()) == 0:
            seen.append((lanes.clone(), g))
        return real(lanes, g, cap=cap)

    recording.launches = 0
    bt.lane_loop = recording

    def restore() -> None:
        bt.lane_loop = real
    return seen, restore


def _check_lane_loop(lanes, g, what: str, replan=None) -> dict:
    """lane_loop_kernel == the plain loop on one CUDA chunk, at the
    engine's cap and at a cap of 1: every row of F, I and Q on the bits
    (for adaptive lanes, call for call, the host's re-plan rounds
    between).  Returns the plain run's milliseconds (CUDA events), the
    largest per-lane iteration count and the largest difference seen."""
    import math

    import torch
    from repro_torch.core.batch_torch import _LAUNCH_CAP, _run_chunk
    from repro_torch.kernels import event_step as es
    from repro_torch.kernels.lane_loop import LQ_ITERS, lane_loop, lane_loop_ref
    counts = lane_loop.launches, es.event_step.launches
    rounds = [0]

    def counted(chunk):
        rounds[0] += 1
        return replan(chunk)

    plain = lanes.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    _run_chunk(lane_loop_ref, plain, g, _LAUNCH_CAP, counted)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    iters = int(plain.q[LQ_ITERS].max())
    max_err = 0.0
    for cap in (_LAUNCH_CAP, 1):
        kern = lanes.clone()
        before = lane_loop.launches
        rounds[0] = 0
        calls = _run_chunk(lane_loop, kern, g, cap, counted)
        torch.cuda.synchronize()
        if lane_loop.launches - before != calls or \
                calls > math.ceil(iters / cap) + rounds[0]:
            raise AssertionError(f"lane_loop {what}, cap {cap}: {calls} "
                                 f"calls, {lane_loop.launches - before} "
                                 f"launches for {iters} iterations and "
                                 f"{rounds[0]} re-plan rounds")
        for name in ("f", "i", "q"):
            a, b = getattr(kern, name), getattr(plain, name)
            max_err = max(max_err, _max_abs_err(a.double(), b.double()))
            if not _bits_equal(a, b):
                rows = (a != b).any(1).nonzero().flatten().tolist()
                bad = int((a != b).any(0).sum())
                raise AssertionError(f"lane_loop kernel != plain on {what}, "
                                     f"cap {cap}: matrix {name} rows {rows}, "
                                     f"{bad} lanes")
        log(f"[kernel] lane_loop {what}, {lanes.f.shape[1]} lanes, cap "
            f"{cap}: kernel == plain on every row ({calls} launches, "
            f"{rounds[0]} re-plan rounds, longest lane {iters} iterations)")
    lane_loop.launches, es.event_step.launches = counts
    return {"plain_ms": plain_ms, "iterations": iters, "max_abs_err": max_err}


def _check_grid() -> dict:
    """384 lanes the study does not reach, run by the engine on CUDA (the
    chunk recorded) and on the CPU: verification 0-3 with keep_ckpts 1-3
    on traces with silent errors, instant and "within" windows, per-event
    windows and all four trust policies."""
    import numpy as np
    from repro_torch.core.batch import simulate_lanes
    from repro_torch.core.simulator import (AlwaysTrust,
                                            FixedProbabilityTrust,
                                            NeverTrust, ThresholdTrust)
    from repro_torch.core.traces import (FALSE_PRED, FAULT_PRED,
                                         FAULT_UNPRED, EventTrace,
                                         Exponential, make_event_trace)
    from repro_torch.core.waste import Platform
    plat = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    traces = [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6,
                               100000.0, np.random.default_rng(s),
                               silent_mu=4000.0) for s in (20, 21, 22)]
    g = np.random.default_rng(10)
    times = np.sort(g.uniform(0, 75000.0, 80))
    kinds = g.choice([FAULT_UNPRED, FAULT_PRED, FALSE_PRED], 80,
                     p=[0.3, 0.4, 0.3]).astype(np.int8)
    traces.append(EventTrace(times, kinds, 100000.0,
                             g.choice([-1.0, 0.0, 250.0, 600.0], 80)))
    trusts = [NeverTrust(), AlwaysTrust(), ThresholdTrust(100.0),
              FixedProbabilityTrust(0.6)]
    verify = [(0, 0.0, 1), (1, 40.0, 2), (2, 30.0, 1), (3, 20.0, 3)]
    lanes = [(tr, t, wm, v, p) for tr in range(len(traces))
             for t in trusts for wm in ("instant", "within")
             for v in verify for p in (800.0, 1200.0, 2500.0)]
    kw = dict(cp=30.0, trace_indices=[ln[0] for ln in lanes],
              periods=[ln[4] for ln in lanes],
              trusts=[ln[1] for ln in lanes],
              windows=[300.0] * len(lanes),
              window_modes=[ln[2] for ln in lanes],
              window_periods=[100.0] * len(lanes),
              n_verifies=[ln[3][0] for ln in lanes],
              verify_costs=[ln[3][1] for ln in lanes],
              keep_ckpts=[ln[3][2] for ln in lanes],
              seeds=list(range(5, 5 + len(lanes))))
    seen, restore = _record_chunks()
    try:
        on_gpu = simulate_lanes(traces, plat, 30000.0, **kw)
    finally:
        restore()
    on_cpu = simulate_lanes(traces, plat, 30000.0, device="cpu", **kw)
    if not (on_gpu.view(np.int64) == on_cpu.view(np.int64)).all():
        raise AssertionError("lane_loop grid: CUDA != CPU")
    log(f"[kernel] lane_loop grid, {len(lanes)} lanes: CUDA == CPU on every "
        f"makespan")
    (chunk, bank), = seen
    return _check_lane_loop(chunk, bank, "grid")


def phase_lane_loop(study: dict) -> dict:
    """lane_loop_kernel == the plain loop on the study's chunk (recorded
    from one pass of the study on CUDA) and on the grid; returns the study
    chunk and the check's numbers for the timing phase."""
    from repro_torch.experiments import candidate_makespans
    sc = study["sc"]
    seen, restore = _record_chunks()
    try:
        candidate_makespans(study["traces"], sc.platform, sc.time_base,
                            sc.cp, study["unique"], seed=sc.seed)
    finally:
        restore()
    (chunk, bank), = seen
    out = _check_lane_loop(chunk, bank, "study chunk")
    grid = _check_grid()
    return dict(out, chunk=chunk, bank=bank,
                max_abs_err=max(out["max_abs_err"], grid["max_abs_err"]))


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
    make_s = time.perf_counter() - t0
    events = np.mean([t.times.size for t in traces])
    log(f"[main] scenario n={sc.n} mu={sc.mu:.1f} s C={sc.c} R={sc.r} "
        f"D={sc.d} r={sc.recall} p={sc.precision}: {len(traces)} traces, "
        f"{events:.1f} events/trace, made in {make_s:.4f} s")
    base = rfo(sc.platform)
    opt = optimal_prediction(sc.pp)
    unique, rows = expand_candidates([base, opt, BestPeriodSearch(base)],
                                     sc.platform)
    return {"sc": sc, "traces": traces, "opt": opt, "unique": unique,
            "rows": rows, "n_lanes": len(unique) * len(traces),
            "make_s": make_s}


def phase_main(study: dict) -> dict:
    """The paper's study on the card; returns what the later phases need."""
    import numpy as np
    import torch
    from repro_torch.core.batch import simulate_batch
    from repro_torch.experiments import best_means, candidate_makespans
    from repro_torch.kernels.event_step import event_step
    from repro_torch.kernels.lane_loop import lane_loop
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    sc, traces, unique = study["sc"], study["traces"], study["unique"]
    plat, n_lanes = sc.platform, study["n_lanes"]
    reg = MetricsRegistry()
    prev = set_registry(reg)
    lane_loop.launches = 0
    event_step.launches = 0
    t0 = time.perf_counter()
    ms = candidate_makespans(traces, plat, sc.time_base, sc.cp, unique,
                             seed=sc.seed)
    means = best_means(ms, study["rows"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, step_launches = lane_loop.launches, event_step.launches
    set_registry(prev)
    if launches <= 0:
        raise AssertionError("the main path launched no lane_loop kernel")
    if step_launches != 0:
        raise AssertionError(f"the main path launched event_step_kernel "
                             f"{step_launches} times")
    iters = reg.counters["torch.iterations"]
    chunks = reg.counters["torch.chunks"]
    for name, m in zip(("RFO", "OptimalPrediction", "BestPeriod(RFO)"),
                       means):
        if not (np.isfinite(m) and m > sc.time_base):
            raise AssertionError(f"{name}: mean makespan {m} is not a "
                                 f"finite value above time_base")
        log(f"[main] {name}: mean makespan {m!r} s, waste "
            f"{1.0 - sc.time_base / m!r}")
    if not means[2] <= means[0]:
        raise AssertionError("BestPeriod lost to its base period")
    split = {key: reg.timers.get(f"torch.{key}_s", 0.0)
             for key in ("tables", "upload", "run", "readback")}
    rest = wall - sum(split.values())
    log(f"[main] {n_lanes} lanes ({len(unique)} candidates x {len(traces)} "
        f"traces) in {wall:.4f} s: {n_lanes / wall:.1f} lanes/s; {chunks} "
        f"chunk(s), {launches} lane_loop launches ({launches / chunks:.1f} "
        f"per chunk), event_step launches {step_launches}, longest lane "
        f"{iters} iterations")
    log(f"[main] the pass's wall time on the host: draw tables "
        f"{split['tables']:.4f} s, uploads {split['upload']:.4f} s, host "
        f"loop (kernel + flag read-backs) {split['run']:.4f} s, read-backs "
        f"{split['readback']:.4f} s, the rest (candidates, bank packing, "
        f"means) {rest:.4f} s; the traces were made in "
        f"{study['make_s']:.4f} s before it")

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

    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    everything = np.arange(BIG_LANES)
    run(everything[:256])                      # warm up allocator, kernel
    torch.cuda.synchronize()
    reg = MetricsRegistry()
    prev = set_registry(reg)
    t0 = time.perf_counter()
    ms = run(everything)
    wall = time.perf_counter() - t0
    set_registry(prev)
    if not (np.isfinite(ms).all() and (ms > 50000.0).all()):
        raise AssertionError("scale run: makespans not finite above "
                             "time_base")
    cpu = run(everything[:64], device="cpu")
    if not (cpu == ms[:64]).all():
        raise AssertionError("scale run: CUDA != CPU on the first 64 lanes")
    log(f"[scale] {BIG_LANES} lanes in one chunk: {wall:.4f} s, "
        f"{BIG_LANES / wall:.1f} lanes/s, "
        f"{reg.counters['kernels.lane_loop.launches']} lane_loop launches, "
        f"longest lane {reg.counters['torch.iterations']} iterations, host "
        f"loop {reg.timers['torch.run_s']:.4f} s, draw tables "
        f"{reg.timers['torch.tables_s']:.4f} s; first 64 lanes == CPU")

    # Device busy share and kernels per iteration over a profiled run.
    from torch.profiler import ProfilerActivity, profile
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


def phase_loop_timing(check: dict) -> dict:
    """lane_loop_kernel on the study's chunk (as phase 3 recorded it) by
    CUDA events and profiler device time, beside its bound, the plain
    loop's time on the same chunk (phase 3's run) and the longest lane's
    ns per iteration."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.batch_torch import _LAUNCH_CAP
    from repro_torch.kernels.lane_loop import (FLOPS_PER_LANE_ITER, LQ_ITERS,
                                               bytes_per_lane, lane_loop)
    chunk, g = check["chunk"], check["bank"]
    n = chunk.f.shape[1]
    launches = lane_loop.launches
    reps = 10
    fresh = [chunk.clone() for _ in range(reps + 1)]
    lane_loop(fresh[-1], g, cap=_LAUNCH_CAP)        # warm up
    iters = fresh[-1].q[LQ_ITERS]
    if int(iters.max()) != check["iterations"]:
        raise AssertionError("the timed launch ran another iteration count")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for lanes in fresh[:reps]:
        lane_loop(lanes, g, cap=_LAUNCH_CAP)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    fresh = [chunk.clone() for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for lanes in fresh:
            lane_loop(lanes, g, cap=_LAUNCH_CAP)
        torch.cuda.synchronize()
    kern = [(us, c) for us, key, c in _device_rows(prof)
            if "lane_loop_kernel" in key]
    device_ms = (sum(us for us, _ in kern) / sum(c for _, c in kern) / 1e3
                 if kern else None)
    lane_loop.launches = launches           # timing launches do not count
    bank_bytes = g.times.numel() * (8 + 4 + 8)
    const_bytes, state_bytes = bytes_per_lane()
    nbytes = (n * (2 * state_bytes + const_bytes)
              + chunk.tab.numel() * 8 + bank_bytes)
    total_iters = int(iters.sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = FLOPS_PER_LANE_ITER * total_iters / FP64_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    longest = check["iterations"]
    dev = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
    ns_iter = (device_ms if device_ms is not None else ms) / longest * 1e6
    log(f"[timing] lane_loop {n} lanes (the study's chunk), one launch: "
        f"kernel {ms:.5f} ms by CUDA events, device time {dev} "
        f"(profiler); plain loop {check['plain_ms']:.3f} ms; bound "
        f"{bound_ms:.6f} ms by {bound_by} (bytes {nbytes}: {bytes_ms:.6f} "
        f"ms; operations {FLOPS_PER_LANE_ITER} x {total_iters} lane "
        f"iterations: {ops_ms:.6f} ms); longest lane {longest} iterations, "
        f"{ns_iter:.2f} ns per iteration; mean lane "
        f"{total_iters / n:.1f} iterations")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": check["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "ns_per_iteration": ns_iter}


# -- the predictor study (adaptive lanes, generative predictors) -------------

# The adaptive configurations of tests/test_jax_engine.py:103-134 (plain,
# halflife, estimate_mu, the exact model) and the heaviest combination
# (online mu, EW decay and "within" windows), each started on its prior's
# plan.  The paper scenario's traces carry exact dates, so the lanes take
# an inexact window; "within" lanes checkpoint every 1,200 s in it
# (> C_p = 600 s).
ADAPTIVE_BASE = dict(prior_recall=0.5, prior_precision=0.5, min_preds=8,
                     min_faults=4, tol=0.02)
ADAPTIVE_CONFIGS = (("plain", {}, "instant"),
                    ("halflife", dict(halflife=64.0), "instant"),
                    ("estimate_mu", dict(estimate_mu=True), "instant"),
                    ("exact_model", dict(model_order="exact"), "instant"),
                    ("mu_halflife_within",
                     dict(halflife=64.0, estimate_mu=True), "within"))
ADAPTIVE_TRACES = 40        # of the study's bank, per configuration
ADAPTIVE_WINDOW = 1800.0
ADAPTIVE_WPERIOD = 1200.0
STUDY_TRACES = 25           # benchmarks/predictor_sweep.py, non-quick
STUDY_CPU_TRACES = 4        # the CPU cross-check, per cell
# predictor_sweep.py:69: the convergence cell's stale prior.
STALE_PRIOR = {"prior_recall": 0.3, "prior_precision": 0.99, "tol": 0.02}


def _predictor_axis(sc) -> list:
    """predictor_sweep.py:48-66: the swept predictor families, the
    drifting ramps placed inside the job window."""
    from repro_torch.experiments import PredictorSpec
    drift = {"drift_start": sc.start, "drift_span": 2.0 * sc.time_base}
    return [
        ("oracle", PredictorSpec("oracle")),
        ("lead_time", PredictorSpec("lead_time", {"lead_mean": 3600.0,
                                                  "min_lead": 600.0})),
        ("bursty", PredictorSpec("bursty", {"burst_size": 4.0,
                                            "burst_gap": 900.0})),
        ("drift_slow", PredictorSpec("drifting", {"precision_end": 0.6,
                                                  **drift})),
        ("drift_fast", PredictorSpec("drifting", {"precision_end": 0.25,
                                                  "recall_end": 0.6,
                                                  **drift})),
    ]


def _record_runs() -> tuple[list, object]:
    """Wrap the engine's host loop so that each chunk's state is cloned at
    its start, with its bank and re-plan callback.  Returns the records
    and a function that removes the wrapper."""
    import repro_torch.core.batch_torch as bt
    real = bt._run_chunk
    seen = []

    def recording(loop, lanes, g, cap, replan=None):
        seen.append((lanes.clone(), g, replan))
        return real(loop, lanes, g, cap, replan)

    bt._run_chunk = recording

    def restore() -> None:
        bt._run_chunk = real
    return seen, restore


def _host_split(reg, wall: float) -> str:
    split = {key: reg.timers.get(f"torch.{key}_s", 0.0)
             for key in ("tables", "upload", "run", "replan", "readback")}
    rest = wall - sum(v for k, v in split.items() if k != "replan")
    return (f"draw tables {split['tables']:.4f} s, uploads "
            f"{split['upload']:.4f} s, host loop {split['run']:.4f} s (of "
            f"it re-plans on the host {split['replan']:.4f} s), read-backs "
            f"{split['readback']:.4f} s, the rest {rest:.4f} s")


def phase_adaptive(study: dict) -> dict:
    """lane_loop_kernel<adaptive> on the five adaptive configurations over
    the paper scenario's traces: the engine on CUDA and on the CPU, ==
    on every BatchResult field; the recorded chunk's kernel == the plain
    loop at the engine's cap and at a cap of 1; its device time, bound
    and re-plan rounds."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.batch import simulate_batch
    from repro_torch.core.batch_torch import _LAUNCH_CAP, _run_chunk
    from repro_torch.core.simulator import NeverTrust, ThresholdTrust
    from repro_torch.kernels.lane_loop import (FLOPS_PER_ADAPTIVE_LANE_ITER,
                                               LQ_ITERS, bytes_per_lane,
                                               lane_loop)
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    from repro_torch.predictors import AdaptiveConfig

    sc = study["sc"]
    plat, traces = sc.platform, study["traces"][:ADAPTIVE_TRACES]
    cfgs, periods, trusts, modes = [], [], [], []
    for _, extra, mode in ADAPTIVE_CONFIGS:
        cfg = AdaptiveConfig(**ADAPTIVE_BASE, **extra)
        t0, thr = cfg.plan(plat, sc.cp, cfg.prior_recall,
                           cfg.prior_precision)
        cfgs.append(cfg)
        periods.append(t0)
        trusts.append(NeverTrust() if math.isinf(thr) else
                      ThresholdTrust(thr))
        modes.append(mode)
    kw = dict(cp=sc.cp, trust=trusts, adaptive=cfgs,
              inexact_window=ADAPTIVE_WINDOW, window_mode=modes,
              window_period=ADAPTIVE_WPERIOD,
              trace_seeds=[sc.seed + 7919 * i for i in range(len(traces))])
    reg = MetricsRegistry()
    prev = set_registry(reg)
    seen, restore = _record_runs()
    launches = lane_loop.launches
    try:
        t0 = time.perf_counter()
        on_gpu = simulate_batch(traces, plat, sc.time_base, periods, **kw)
        wall = time.perf_counter() - t0
    finally:
        restore()
        set_registry(prev)
    n_launch = lane_loop.launches - launches
    lane_loop.launches = launches
    c = reg.counters
    if not (on_gpu.n_replans.sum(axis=1) > 0).all():
        raise AssertionError(f"adaptive chunk: a configuration never "
                             f"re-planned ({on_gpu.n_replans.sum(axis=1)})")
    n_lanes = len(cfgs) * len(traces)
    log(f"[adaptive] {len(cfgs)} configurations x {len(traces)} traces "
        f"({n_lanes} lanes) on CUDA in {wall:.4f} s: {n_launch} lane_loop "
        f"launches, {c['torch.replan_rounds']} re-plan rounds, "
        f"{c['engine.replans']} re-plans (per configuration "
        f"{on_gpu.n_replans.sum(axis=1).tolist()}), longest lane "
        f"{c['torch.iterations']} iterations; {_host_split(reg, wall)}")
    t0 = time.perf_counter()
    on_cpu = simulate_batch(traces, plat, sc.time_base, periods,
                            device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    _assert_same(on_gpu, on_cpu, "adaptive chunk, CUDA vs CPU")
    log(f"[adaptive] CUDA == CPU on every BatchResult field (n_replans, "
        f"final_period, final_threshold and est_* included; cpu "
        f"{t_cpu:.2f} s)")
    chunk, g, replan = seen[0]
    if not chunk.adaptive or chunk.slots != 8:
        raise AssertionError("the adaptive chunk did not take the 8-slot "
                             "adaptive route")
    check = _check_lane_loop(chunk, g, "adaptive chunk", replan)

    # The chunk's device time: every launch of one run of the host loop
    # (the re-plans between them on the host), by the profiler.
    lanes = chunk.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = _run_chunk(lane_loop, lanes, g, _LAUNCH_CAP, replan)
        torch.cuda.synchronize()
        chunk_wall = time.perf_counter() - t0
    lane_loop.launches = launches
    kern = [(us, n) for us, key, n in _device_rows(prof)
            if "lane_loop_kernel" in key]
    device_ms = sum(us for us, _ in kern) / 1e3 if kern else None
    iters = lanes.q[LQ_ITERS]
    const_bytes, state_bytes = bytes_per_lane(adaptive=True)
    nbytes = (lanes.f.shape[1] * (2 * state_bytes + const_bytes)
              + lanes.tab.numel() * 8 + g.times.numel() * (8 + 4 + 8))
    total_iters = int(iters.sum())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (FLOPS_PER_ADAPTIVE_LANE_ITER * total_iters / FP64_FLOP_PER_S
              * 1e3)
    bound_ms = max(bytes_ms, ops_ms)
    dev = "not measured" if device_ms is None else f"{device_ms:.5f} ms"
    log(f"[timing] lane_loop_kernel<adaptive> on the adaptive chunk "
        f"({lanes.f.shape[1]} lanes): {calls} launches, device time {dev} "
        f"in all (profiler), host loop {chunk_wall * 1e3:.3f} ms with its "
        f"re-plans; plain loop {check['plain_ms']:.3f} ms; bound "
        f"{bound_ms:.6f} ms by "
        f"{'bytes' if bytes_ms >= ops_ms else 'operations'} (bytes "
        f"{nbytes}: {bytes_ms:.6f} ms; operations "
        f"{FLOPS_PER_ADAPTIVE_LANE_ITER} x {total_iters} lane iterations: "
        f"{ops_ms:.6f} ms)")
    return {"max_abs_err": check["max_abs_err"], "launches": calls,
            "ms": device_ms, "plain_ms": check["plain_ms"],
            "bound_ms": bound_ms, "wall_ms": chunk_wall * 1e3}


def phase_predictor_study() -> dict:
    """benchmarks/predictor_sweep.py's five predictor cells at its
    non-quick size (25 traces, n = 65,536), rfo, optimal_prediction and
    adaptive through the three steps of evaluate_strategies on CUDA, the
    launch counts set to 0 just before and read just after; then the first
    4 traces of every cell and strategy on the CPU, ==."""
    import numpy as np
    import torch
    from repro_torch.core.batch import simulate_lanes
    from repro_torch.experiments import (ScenarioSpec, best_means,
                                         build_strategy,
                                         candidate_makespans,
                                         expand_candidates)
    from repro_torch.kernels.event_step import event_step
    from repro_torch.kernels.lane_loop import lane_loop
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    base = ScenarioSpec(n_traces=STUDY_TRACES)
    names = ("rfo", "optimal_prediction", "adaptive")
    cells = []
    lane_loop.launches = 0
    event_step.launches = 0
    for label, spec in _predictor_axis(base):
        sc = dataclasses.replace(base, predictor=spec)
        t0 = time.perf_counter()
        traces = sc.make_traces()
        make_s = time.perf_counter() - t0
        unique, rows = expand_candidates(
            [build_strategy(n, sc) for n in names], sc.platform)
        reg = MetricsRegistry()
        prev = set_registry(reg)
        launches = lane_loop.launches
        t0 = time.perf_counter()
        ms = candidate_makespans(traces, sc.platform, sc.time_base, sc.cp,
                                 unique, seed=sc.seed)
        means = best_means(ms, rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        set_registry(prev)
        launches = lane_loop.launches - launches
        for name, m in zip(names, means):
            if not (np.isfinite(m) and m > sc.time_base):
                raise AssertionError(f"{label}/{name}: mean makespan {m}")
        c = reg.counters
        n_lanes = ms.size
        log(f"[study] {label}: {n_lanes} lanes ({len(unique)} candidates x "
            f"{len(traces)} traces) in {wall:.4f} s, {n_lanes / wall:.1f} "
            f"lanes/s; {c['torch.chunks']} chunk(s), {launches} lane_loop "
            f"launches ({launches / c['torch.chunks']:.1f} per chunk), "
            f"{c.get('torch.replan_rounds', 0)} re-plan rounds, "
            f"{c.get('engine.replans', 0)} re-plans, longest lane "
            f"{c['torch.iterations']} iterations; {_host_split(reg, wall)}; "
            f"traces made in {make_s:.4f} s")
        log(f"[study] {label}: mean makespan (waste) "
            + ", ".join(f"{n} {m!r} s ({1.0 - sc.time_base / m:.6f})"
                        for n, m in zip(names, means)))
        cells.append({"label": label, "sc": sc, "traces": traces,
                      "unique": unique, "ms": ms, "means": means,
                      "wall": wall, "launches": launches})
    total = lane_loop.launches
    if total <= 0:
        raise AssertionError("the predictor study launched no lane_loop "
                             "kernel")
    if event_step.launches != 0:
        raise AssertionError(f"the predictor study launched event_step "
                             f"{event_step.launches} times")

    # The device's busy share over one more pass of the oracle cell.
    from torch.profiler import ProfilerActivity, profile
    cell = cells[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        candidate_makespans(cell["traces"], cell["sc"].platform,
                            cell["sc"].time_base, cell["sc"].cp,
                            cell["unique"], seed=cell["sc"].seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    lane_loop.launches = total              # the profiled pass does not count
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] predictor study, the oracle cell once more: wall "
        f"{wall:.4f} s, device busy {busy:.4f} s ({busy / wall:.3f} of "
        f"wall), {sum(r[2] for r in rows)} device events")
    oracle = dict(zip(names, cells[0]["means"]))
    log(f"[study] the sweep's claims at this size: oracle optimal < rfo "
        f"{oracle['optimal_prediction'] < oracle['rfo']}, adaptive within "
        f"3% of optimal {oracle['adaptive'] < 1.03 * oracle['optimal_prediction']}, "
        f"lead_time optimal > oracle optimal "
        f"{cells[1]['means'][1] > oracle['optimal_prediction']}, drift_fast "
        f"optimal > oracle optimal "
        f"{cells[4]['means'][1] > oracle['optimal_prediction']}")

    # The CPU cross-check: the first traces of every cell and candidate,
    # all in one plain run over the cells' banks side by side.
    bank, lanes = [], []
    for k, cell in enumerate(cells):
        off = len(bank)
        bank += cell["traces"][:STUDY_CPU_TRACES]
        lanes += [(k, ci, t, off + t) for ci in range(len(cell["unique"]))
                  for t in range(STUDY_CPU_TRACES)]
    sc = cells[0]["sc"]
    strat = [cells[k]["unique"][ci] for k, ci, _, _ in lanes]
    t0 = time.perf_counter()
    on_cpu = simulate_lanes(
        bank, sc.platform, sc.time_base, cp=sc.cp,
        trace_indices=[ln[3] for ln in lanes],
        periods=[float(s.period) for s in strat],
        trusts=[s.trust for s in strat],
        windows=[s.inexact_window for s in strat],
        window_modes=[s.window_mode for s in strat],
        window_periods=[s.window_period for s in strat],
        adaptives=[s.adaptive for s in strat],
        seeds=[sc.seed + 7919 * ln[2] for ln in lanes], device="cpu")
    t_cpu = time.perf_counter() - t0
    want = np.array([cells[k]["ms"][ci, t] for k, ci, t, _ in lanes])
    if not (want.view(np.int64) == on_cpu.view(np.int64)).all():
        raise AssertionError("predictor study: CUDA != CPU on the first "
                             f"{STUDY_CPU_TRACES} traces")
    log(f"[study] {len(lanes)} lanes (5 cells x 3 strategies x first "
        f"{STUDY_CPU_TRACES} traces): CUDA == CPU on every makespan (cpu "
        f"{t_cpu:.2f} s)")
    return {"launches": total, "cells": [
        {k: cell[k] for k in ("label", "wall", "launches")} | {
            "lanes": int(cell["ms"].size)} for cell in cells]}


def phase_convergence() -> None:
    """predictor_sweep.py's convergence cell (stale prior, 20 traces,
    40,000 years) on CUDA, held to the script's own claims
    (predictor_sweep.py:91-140)."""
    import numpy as np
    from repro_torch.core.batch import simulate_batch
    from repro_torch.core.prediction import (beta_lim,
                                             optimal_period_with_prediction)
    from repro_torch.experiments import (ScenarioSpec, build_strategy,
                                         evaluate_strategies)
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    sc = ScenarioSpec(n_traces=20, time_base_years_total=40000.0)
    traces = sc.make_traces()
    plat, tb, cp = sc.platform, sc.time_base, sc.cp
    ad = build_strategy("adaptive", sc, **STALE_PRIOR)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    t0 = time.perf_counter()
    batch = simulate_batch(
        traces, plat, tb, [ad.period], cp=cp, trust=ad.trust,
        adaptive=ad.adaptive,
        trace_seeds=[sc.seed + 7919 * i for i in range(len(traces))])
    wall = time.perf_counter() - t0
    set_registry(prev)
    t_true, _, use_true = optimal_period_with_prediction(sc.pp)
    thr_true = beta_lim(sc.pp)
    periods = batch.final_period[0]
    thresholds = batch.final_threshold[0]
    replans = batch.n_replans[0]
    r_hat, p_hat = batch.est_recall[0], batch.est_precision[0]
    rel_t = np.abs(periods - t_true) / t_true
    rel_thr = np.abs(thresholds - thr_true) / thr_true
    claims = [
        ("predictions analytically worth it", use_true),
        ("every lane re-planned", bool((replans >= 1).all())),
        ("thresholds finite", bool(np.isfinite(thresholds).all())),
        ("thresholds within 0.15 of beta_lim", float(rel_thr.max()) < 0.15),
        ("periods within 0.20 of T* (mean), 0.35 (max)",
         float(rel_t.mean()) < 0.20 and float(rel_t.max()) < 0.35),
        ("r-hat within 0.1", abs(float(r_hat.mean()) - sc.recall) < 0.1),
        ("p-hat within 0.1", abs(float(p_hat.mean()) - sc.precision) < 0.1),
    ]
    stale = build_strategy("fixed_period", sc, period=ad.period,
                           trust_threshold=ad.trust.threshold)
    m_stale, m_ad = evaluate_strategies(traces, plat, tb, cp, [stale, ad],
                                        seed=sc.seed)
    claims.append(("adaptive beats the stale static plan", m_ad < m_stale))
    c = reg.counters
    log(f"[convergence] {len(traces)} lanes in {wall:.4f} s: "
        f"{c['kernels.lane_loop.launches']} launches, "
        f"{c['torch.replan_rounds']} re-plan rounds, {c['engine.replans']} "
        f"re-plans (per lane {replans.tolist()}), longest lane "
        f"{c['torch.iterations']} iterations; {_host_split(reg, wall)}")
    log(f"[convergence] T* {t_true:.1f} s <- periods mean rel err "
        f"{float(rel_t.mean()):.4f} (max {float(rel_t.max()):.4f}); "
        f"beta_lim {thr_true:.1f} s <- thresholds max rel err "
        f"{float(rel_thr.max()):.4f}; r-hat {float(r_hat.mean()):.4f}, "
        f"p-hat {float(p_hat.mean()):.4f}; adaptive {m_ad / 86400.0:.4f} d "
        f"vs stale static {m_stale / 86400.0:.4f} d")
    failed = [name for name, ok in claims if not ok]
    if failed:
        raise AssertionError(f"convergence cell: {failed}")
    log(f"[convergence] every claim of predictor_sweep.py:91-140 holds")


def phase_overflow() -> None:
    """A trace whose true predictions put 12 faults in flight at once
    (tests/test_torch_lanes.py:207-222): 64 lanes of it beside 192 other
    lanes.  The chunk runs through the 8-slot kernel; only the 64
    overflowed lanes rerun, through the wide route; CUDA == CPU."""
    import numpy as np
    from repro_torch.core.batch import simulate_lanes
    from repro_torch.core.simulator import AlwaysTrust, ThresholdTrust
    from repro_torch.core.traces import (FAULT_PRED, EventTrace, Exponential,
                                         make_event_trace)
    from repro_torch.core.waste import Platform
    from repro_torch.kernels.lane_loop import lane_loop
    from repro_torch.obs.metrics import MetricsRegistry, set_registry

    plat = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    n = 12
    over = EventTrace(1000.0 + 10.0 * np.arange(n),
                      np.full(n, FAULT_PRED, dtype=np.int8), 1e7,
                      np.full(n, 1e6))
    bank = [over] + [make_event_trace(Exponential(2500.0), 2500.0, 0.7, 0.6,
                                      100000.0, np.random.default_rng(s))
                     for s in (20, 21, 22)]
    tr = np.concatenate([np.zeros(64, np.int64),
                         1 + np.arange(192) % 3]).astype(np.int64)
    L = tr.size
    kw = dict(cp=30.0, trace_indices=tr,
              periods=np.where(np.arange(L) % 2, 1200.0, 2500.0),
              trusts=[AlwaysTrust() if j < 64 or j % 2 else
                      ThresholdTrust(100.0) for j in range(L)],
              windows=np.full(L, 300.0), seeds=np.arange(L) + 11)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    seen, restore = _record_runs()
    launches = lane_loop.launches
    try:
        on_gpu = simulate_lanes(bank, plat, 30000.0, **kw)
    finally:
        restore()
        set_registry(prev)
    runs = [(lanes.slots, lanes.f.shape[1]) for lanes, _, _ in seen]
    if runs != [(8, L), (16, 64)]:
        raise AssertionError(f"overflow: the runs were {runs}, not the "
                             f"8-slot chunk and a 16-slot rerun of the 64 "
                             f"overflowed lanes")
    if reg.counters["engine.deferred_overflows"] != 1:
        raise AssertionError("overflow: engine.deferred_overflows not 1")
    n_launch = lane_loop.launches - launches
    lane_loop.launches = launches
    on_cpu = simulate_lanes(bank, plat, 30000.0, device="cpu", **kw)
    if not (on_gpu.view(np.int64) == on_cpu.view(np.int64)).all():
        raise AssertionError("overflow: CUDA != CPU")
    log(f"[overflow] {L} lanes, 64 of them 12 faults in flight: the chunk "
        f"through lane_loop_kernel<wide=false> ({L} lanes, 8 slots), the 64 "
        f"overflowed lanes alone rerun through lane_loop_kernel<wide=true> "
        f"(16 slots), {n_launch} launches; engine.deferred_overflows 1; "
        f"CUDA == CPU on every makespan")


# -- the fault-tolerant trainer's path (ckpt_delta kernels) -------------------

ARCH = "tinyllama-1.1b"      # launch/train.py's default --arch, full width
SEQ, BATCH = 128, 8          # launch/train.py's default shape
STEP_TIME, MTBF = 10.0, 600.0  # launch/train.py's default platform
CKPT_SIZES = ((123,), (256,), (1000, 37), (4096, 16))
N_WARM_STEPS = 3
TIMING_REPS = 5
# CUDA vs CPU final loss of the reduced bf16 trainer: the measured gap was
# 3.35e-5 relative (H100 SXM, 700 W), so about 30 times the reading.
LOSS_RTOL_BF16 = 1e-3
# The bf16 parameter leaf held to plain beside the 24 quantized ones.
BF16_LEAF = "['params']['layers'][0]['ffn']['w_gate']"


def _check_ckpt_leaf(cur, base, what: str, errs: dict):
    """Both kernels == their plain versions on one (cur, base) pair; folds
    each kernel's largest absolute difference into ``errs`` and returns
    the kernel's scales."""
    import torch
    from repro_torch.kernels import ckpt_delta as cd
    q_k, s_k = cd.quantize_delta(cur, base)
    q_r, s_r = cd.quantize_delta_ref(cur, base)
    torch.cuda.synchronize()
    if not (_bits_equal(q_k, q_r) and _bits_equal(s_k, s_r)):
        bad = int((q_k != q_r).sum())
        raise AssertionError(f"quantize_delta kernel != plain on {what}: "
                             f"{bad} q differ, scales equal "
                             f"{_bits_equal(s_k, s_r)}")
    out_k = cd.dequantize_delta(q_k, s_k, base)
    out_r = cd.dequantize_delta_ref(q_r, s_r, base)
    torch.cuda.synchronize()
    if not _bits_equal(out_k, out_r):
        raise AssertionError(f"dequantize_delta kernel != plain on {what}")
    errs["quantize_delta"] = max(errs["quantize_delta"],
                                 _max_abs_err(q_k.float(), q_r.float()),
                                 _max_abs_err(s_k, s_r))
    errs["dequantize_delta"] = max(errs["dequantize_delta"],
                                   _max_abs_err(out_k.float(),
                                                out_r.float()))
    return s_k


def phase_ckpt_kernels(errs: dict) -> None:
    """Both ckpt_delta kernels == plain at the reference test's sizes."""
    import numpy as np
    import torch
    for shape in CKPT_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            g = np.random.default_rng(sum(shape))
            base = torch.from_numpy(g.standard_normal(shape)).to(dtype)
            cur = (base.float() + 0.01 * torch.from_numpy(
                g.standard_normal(shape)).float()).to(dtype)
            base, cur = base.cuda(), cur.cuda()
            _check_ckpt_leaf(cur, base, f"{shape} {dtype}", errs)
            s = _check_ckpt_leaf(base, base, f"{shape} {dtype}, zero delta",
                                 errs)
            if not bool((s == 1.0).all()):
                raise AssertionError("zero delta: scales are not 1")
    log(f"[ckpt-kernels] quantize/dequantize kernel == plain at "
        f"{[tuple(s) for s in CKPT_SIZES]}, fp32 and bf16, random and "
        f"zero delta")


def _disk_check(root: str, need: int) -> None:
    free = shutil.disk_usage(root).free
    log(f"[disk] {root}: {free / 1e9:.2f} GB free, the checkpoint phases "
        f"need about {need / 1e9:.2f} GB")
    if free < need:
        raise RuntimeError(f"{root} has {free} bytes free; the full-width "
                           f"checkpoint phases need about {need} bytes")


def _full_width_trainer(workdir: str, trace=None):
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.train import cli_platform
    from repro_torch.train import FaultTolerantTrainer
    return FaultTolerantTrainer(
        get(ARCH), InputShape("cli", SEQ, BATCH, "train"),
        cli_platform(STEP_TIME, MTBF), workdir=workdir,
        step_time=STEP_TIME, trace=trace)


def _free_cuda() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _step_ms(tr) -> float:
    """Steady milliseconds of one full-width train step: the trainer's own
    step on its state and first batch, nothing committed."""
    import torch
    batch = tr.data.batch_at(0)
    step_s = []
    for _ in range(N_WARM_STEPS):
        t0 = time.perf_counter()
        out = tr._train_step(tr.state["params"], tr.state["opt"], batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        del out
    steady = min(step_s[1:])
    log(f"[step] train steps (s): {step_s}; steady {steady * 1e3:.3f} ms "
        f"per step, {SEQ * BATCH / steady:.1f} tokens/s")
    return steady * 1e3


def _check_proactive(tr, state, bf16_base, errs: dict) -> dict:
    """At the run's proactive save, before it is written: both kernels ==
    plain on the 24 leaves it quantizes (against the device base of the
    last full save) and on one bf16 parameter leaf (against that leaf at
    the last full save), then both timed over those 24 leaves.  The launch
    counts are left as they were.  Returns what the restore check needs."""
    from repro_torch.ckpt.manager import is_quantized
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.tree import flatten, leaf_names

    launches = cd.quantize_delta.launches, cd.dequantize_delta.launches
    leaves, names = flatten(state), leaf_names(state)
    base = tr.manager._last_full_state
    quantized = [i for i, t in enumerate(leaves) if is_quantized(t)]
    if len(quantized) != 24:
        raise AssertionError(f"{len(quantized)} quantized leaves, not 24")
    scales = {i: _check_ckpt_leaf(leaves[i], base[i], names[i], errs)
              for i in quantized}
    bf16_leaf = names.index(BF16_LEAF)
    _check_ckpt_leaf(leaves[bf16_leaf], bf16_base, names[bf16_leaf], errs)
    n_q = sum(leaves[i].numel() for i in quantized)
    log(f"[ckpt] at the proactive save: quantize/dequantize kernel == plain "
        f"on all 24 quantized leaves ({n_q} elements, fp32) and on the bf16 "
        f"leaf {names[bf16_leaf]} ({leaves[bf16_leaf].numel()} elements); "
        f"largest differences {errs}")
    timing = _time_ckpt_kernels([(leaves[i], base[i]) for i in quantized])
    cd.quantize_delta.launches, cd.dequantize_delta.launches = launches
    return {"leaves": leaves, "names": names, "scales": scales,
            "base": {i: base[i] for i in quantized}, "timing": timing}


def _check_restored(restored, saved: dict) -> float:
    """The leaves a delta restore gave back against the state the
    proactive save wrote: quantized leaves within their block's scale/2,
    raw leaves ``==``.  Returns the worst error as a share of its bound."""
    import torch
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.tree import flatten

    names, base, scales = saved["names"], saved["base"], saved["scales"]
    worst = 0.0
    for i, (live, got) in enumerate(zip(saved["leaves"], flatten(restored))):
        if got.dtype != live.dtype or got.device != live.device:
            raise AssertionError(f"{names[i]}: restored as {got.dtype} on "
                                 f"{got.device}")
        if i not in scales:
            if not _bits_equal(got, live):
                raise AssertionError(f"{names[i]}: raw leaf not == after "
                                     f"restore")
            continue
        err = cd._pad_blocks((got.float() - live.float()).abs(), cd.BLOCK)
        mag = cd._pad_blocks(torch.maximum(live.float().abs(),
                                           base[i].float().abs()), cd.BLOCK)
        # scale/2, plus 4 float32 ulps of the operands for the roundings of
        # cur - base and of base + q*scale.
        bound = scales[i][:, None] / 2 + mag * 2.0 ** -21
        if not bool((err <= bound).all()):
            raise AssertionError(f"{names[i]}: restored leaf off by more "
                                 f"than scale/2")
        worst = max(worst, float((err / bound).max()))
    return worst


def _step_breakdown(tr) -> None:
    """Where one full-width train step goes: forward + backward and the
    AdamW update by CUDA events, and the device's busy share of one whole
    step (profiler).  The trainer's state is read, not changed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import loss_fn
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.tree import flatten, unflatten

    params, opt = tr.state["params"], tr.state["opt"]
    batch = tr.data.batch_at(0)

    def fwd_bwd():
        leaves = [p.detach().requires_grad_() for p in flatten(params)]
        loss, _ = loss_fn(tr.cfg, unflatten(params, leaves), batch)
        return torch.autograd.grad(loss, leaves)

    grads = unflatten(params, list(fwd_bwd()))
    fb_ms = _time_ms(fwd_bwd, 3)
    opt_ms = _time_ms(lambda: adamw_update(params, grads, opt, tr.opt_cfg),
                      3)
    del grads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr._train_step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[step] forward + backward {fb_ms:.3f} ms, AdamW update "
        f"{opt_ms:.3f} ms (CUDA events); one profiled step: wall "
        f"{wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms "
        f"({busy / wall:.3f} of wall), {sum(r[2] for r in rows)} device "
        f"events")
    for dev_us, key, count in sorted(rows, reverse=True)[:6]:
        log(f"[step]   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:70]}")


def _time_ckpt_kernels(pairs) -> dict:
    """Both kernels and their plain versions over the leaves of one save
    (quantize) and of one restore (dequantize), by CUDA events."""
    from repro_torch.kernels import ckpt_delta as cd
    qs = [cd.quantize_delta(c, b) for c, b in pairs]
    nbytes = sum(cd.bytes_moved(c.numel(), c.dtype) for c, _ in pairs)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {}
    for name, kernel, plain in (
            ("quantize_delta",
             lambda: [cd.quantize_delta(c, b) for c, b in pairs],
             lambda: [cd.quantize_delta_ref(c, b) for c, b in pairs]),
            ("dequantize_delta",
             lambda: [cd.dequantize_delta(q, s, b)
                      for (q, s), (_, b) in zip(qs, pairs)],
             lambda: [cd.dequantize_delta_ref(q, s, b)
                      for (q, s), (_, b) in zip(qs, pairs)])):
        ms = _time_ms(kernel, TIMING_REPS)
        plain_ms = _time_ms(plain, TIMING_REPS)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": "bytes"}
        log(f"[timing] {name} over the {len(pairs)} leaves of one "
            f"{'save' if name.startswith('q') else 'restore'}: kernel "
            f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
            f"by bytes ({nbytes} bytes), {bound_ms / ms:.3f} of the bound")
    return out


def _fault_trace_for(decision):
    """One fault, predicted, 60 s after the first periodic save ends: the
    trainer saves periodically, trusts the prediction (60 s >= beta_lim),
    takes a proactive save that completes at the fault date, and the fault
    rolls it back to that delta."""
    import math

    import numpy as np
    from repro_torch.core.traces import FAULT_PRED, EventTrace
    c = 3.0 * STEP_TIME
    first_save_end = STEP_TIME * math.ceil((decision.period - c)
                                           / STEP_TIME) + c
    date = first_save_end + 6 * STEP_TIME
    if not (decision.use_predictions and 6 * STEP_TIME >= decision.beta_lim):
        raise AssertionError(f"the CLI platform's plan {decision} would not "
                             f"act on the prediction")
    trace = EventTrace(np.array([date]), np.array([FAULT_PRED], np.int8),
                       horizon=1e9)
    # Steps before the periodic save, 5 more up to the proactive save, and
    # 3 after the rollback to it.
    n_steps = round((first_save_end - c) / STEP_TIME) + 5 + 3
    return trace, n_steps


def phase_trainer(root: str, errs: dict) -> dict:
    """The slice's main path: the full-width trainer through a periodic
    save, a trusted prediction's proactive save and a delta rollback.
    Before the run, the step's time and where it goes.  Inside the run,
    through the manager's hooks: the kernels held to plain and timed at
    the proactive save, and the delta restore held to the saved state."""
    import math

    import torch
    from repro_torch.ckpt.manager import state_bytes
    from repro_torch.ft.scheduler import CheckpointScheduler
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.launch.train import cli_platform
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import flatten, leaf_names

    decision = CheckpointScheduler(cli_platform(STEP_TIME, MTBF), 1).decision
    trace, n_steps = _fault_trace_for(decision)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = _full_width_trainer(os.path.join(root, "trainer"), trace)
    torch.cuda.synchronize()
    if tr.scheduler.decision != decision:
        raise AssertionError("the trainer planned another schedule")
    nbytes = state_bytes(tr.state)
    cfg = tr.cfg
    n_params = sum(t.numel() for t in flatten(tr.state["params"]))
    log(f"[trainer] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} params; train "
        f"state {nbytes} bytes; built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    # Two fulls, the .tmp of a third, a delta, and slack.
    _disk_check(root, int(3.5 * nbytes))
    step_ms = _step_ms(tr)
    _step_breakdown(tr)

    # Record every save's SaveInfo and time every restore; check the
    # kernels at the proactive save and the restored state after the
    # restore (neither check is inside the times the manager reports).
    bf16_leaf = leaf_names(tr.state).index(BF16_LEAF)
    saves, restores, held = [], [], {}
    mgr = tr.manager
    save, save_pro, restore = mgr.save, mgr.save_proactive, mgr.restore

    def full_save(step, state):
        saves.append(save(step, state))
        held["bf16_base"] = flatten(state)[bf16_leaf].clone()
        return saves[-1]

    def proactive_save(step, state):
        if "bf16_base" not in held:
            raise AssertionError("a proactive save before any full save")
        held["saved"] = _check_proactive(tr, state, held["bf16_base"], errs)
        held["timing"] = held["saved"].pop("timing")
        saves.append(save_pro(step, state))
        return saves[-1]

    def timed_restore(**kw):
        t0 = time.perf_counter()
        out = restore(**kw)
        torch.cuda.synchronize()
        restores.append((out[0], time.perf_counter() - t0))
        held["worst"] = _check_restored(out[1], held.pop("saved"))
        return out

    mgr.save, mgr.save_proactive = full_save, proactive_save
    mgr.restore = timed_restore
    with torch.no_grad():
        first_loss = float(loss_fn(tr.cfg, tr.state["params"],
                                   tr.data.batch_at(0))[1]["loss"])

    cd.quantize_delta.launches = 0
    cd.dequantize_delta.launches = 0
    t0 = time.perf_counter()
    stats = tr.run(n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"quantize_delta": cd.quantize_delta.launches,
                "dequantize_delta": cd.dequantize_delta.launches}

    log(f"[trainer] plan: period T* {decision.period!r} s, beta_lim "
        f"{decision.beta_lim!r} s, use_predictions "
        f"{decision.use_predictions}; fault (predicted) at "
        f"{float(trace.times[0])!r} s; {n_steps} steps")
    log(f"[trainer] {json.dumps(dataclasses.asdict(stats))}")
    log(f"[trainer] measured waste {stats.waste!r}, analytic "
        f"{decision.expected_waste!r}; loss {first_loss!r} -> "
        f"{stats.final_loss!r}; wall {wall:.3f} s (checks and kernel "
        f"timing included); step {step_ms:.3f} ms, "
        f"{SEQ * BATCH / step_ms * 1e3:.1f} tokens/s")
    for info in saves:
        log(f"[trainer] {info.kind} save at step {info.step}: {info.bytes} "
            f"bytes in {info.seconds:.3f} s "
            f"({info.bytes / info.seconds / 1e9:.3f} GB/s)")
    for step, secs in restores:
        log(f"[trainer] restore of step {step}: {secs:.3f} s")
    c, cp = mgr.modeled_costs(tr.state)
    log(f"[trainer] measured delta ratio {mgr.measured_delta_ratio!r}; "
        f"modeled C {c!r} s, C_p {cp!r} s at {mgr.bandwidth:.3g} B/s")
    log(f"[trainer] kernel launches on this path: {launches}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    kinds = [i.kind for i in saves]
    if not (stats.n_periodic >= 2 and "full" in kinds[:-1]):
        raise AssertionError("no periodic full save before the end")
    if not (stats.n_proactive == 1 and stats.n_trusted_true == 1
            and kinds.count("proactive") == 1):
        raise AssertionError("no trusted true prediction with a proactive "
                             "(delta) save")
    if not (stats.n_rollbacks == 1 and len(restores) == 1
            and restores[0][0] == saves[kinds.index("proactive")].step
            and "worst" in held):
        raise AssertionError("the fault did not roll back to the delta")
    log(f"[trainer] the delta restore against the state the proactive save "
        f"wrote: quantized leaves within scale/2 (+4 ulps; worst "
        f"{held['worst']:.4f} of the bound), raw leaves ==")
    if launches["quantize_delta"] != 24 or launches["dequantize_delta"] != 24:
        raise AssertionError(f"the trainer's save and restore did not run "
                             f"the kernels on the 24 leaves: {launches}")
    if not (math.isfinite(stats.final_loss)
            and stats.final_loss < first_loss):
        raise AssertionError(f"loss {first_loss} -> {stats.final_loss}")
    timing = held["timing"]
    del tr, held
    _free_cuda()
    shutil.rmtree(os.path.join(root, "trainer"))
    return {"launches": launches, "timing": timing}


def phase_trainer_cuda_cpu(root: str) -> None:
    """The reduced trainer of tests/test_ft.py on CUDA and on the CPU."""
    import math

    import numpy as np
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape, PlatformConfig
    from repro_torch.core.traces import Exponential, make_event_trace
    from repro_torch.train import FaultTolerantTrainer
    from repro_torch.tree import tree_map

    cfg = get("llama3.2-1b").reduced()
    shape = InputShape("t", 64, 4, "train")
    plat = PlatformConfig(mu_ind=300.0, c=30.0, cp=10.0, d=5.0, r=15.0,
                          recall=0.85, precision=0.82)
    trace = make_event_trace(Exponential(1.0), 300.0, 0.85, 0.82,
                             horizon=1e5, rng=np.random.default_rng(3))
    trainers = {device: FaultTolerantTrainer(
        cfg, shape, plat, workdir=os.path.join(root, device), step_time=10.0,
        trace=trace, seed=0, device=device) for device in ("cuda", "cpu")}
    trainers["cpu"].state = tree_map(lambda t: t.cpu(),
                                     trainers["cuda"].state)
    runs, restored = {}, {}
    for device, tr in trainers.items():
        restored[device] = _record_restores(tr.manager)
        t0 = time.perf_counter()
        runs[device] = (tr.run(30), time.perf_counter() - t0)
    (gpu, t_gpu), (cpu, t_cpu) = runs["cuda"], runs["cpu"]
    for f in dataclasses.fields(gpu):
        if f.name != "final_loss" \
                and getattr(gpu, f.name) != getattr(cpu, f.name):
            raise AssertionError(f"reduced trainer: {f.name} CUDA "
                                 f"{getattr(gpu, f.name)!r} != CPU "
                                 f"{getattr(cpu, f.name)!r}")
    if not any(kind == "delta" for _, kind in restored["cuda"]):
        raise AssertionError(f"reduced trainer restored no delta: "
                             f"{restored['cuda']}")
    if restored["cuda"] != restored["cpu"]:
        raise AssertionError(f"reduced trainer restored {restored['cuda']} "
                             f"on CUDA, {restored['cpu']} on the CPU")
    rel = abs(gpu.final_loss - cpu.final_loss) / abs(cpu.final_loss)
    if not (math.isfinite(gpu.final_loss) and rel <= LOSS_RTOL_BF16):
        raise AssertionError(f"reduced trainer final loss CUDA "
                             f"{gpu.final_loss} vs CPU {cpu.final_loss} "
                             f"(rel {rel:.3e} > {LOSS_RTOL_BF16})")
    log(f"[cuda-cpu] {cfg.name}, 30 steps: every TrainerStats counter and "
        f"virtual time CUDA == CPU ({gpu.n_faults} faults, "
        f"{gpu.n_proactive} proactive, {gpu.n_periodic} periodic; restores "
        f"of (step, kind) {restored['cuda']} on both); final loss "
        f"{gpu.final_loss!r} vs {cpu.final_loss!r} (rel {rel:.2e}, limit "
        f"{LOSS_RTOL_BF16}); cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s")


def _record_restores(mgr) -> list:
    """Wrap ``mgr.restore`` to append the (step, kind) of each restore to
    the list it returns."""
    kinds, restore = [], mgr.restore

    def recorded(**kw):
        on_disk = dict(mgr.checkpoints())
        out = restore(**kw)
        kinds.append((out[0], on_disk[out[0]]))
        return out

    mgr.restore = recorded
    return kinds


# -- the serving path (flash_attention and decode_attention kernels) ----------

# The reference's kernel cases (tests/test_kernels.py:17-115), one case of
# each kernel at the main path's heads (g = 8) and lengths, and uneven tiles
# (flash) and cluster ranges (decode).
FLASH_CASES = (
    # (b, sq, skv, h, kv, hd, causal, window, q_offset)
    (2, 128, 128, 4, 4, 64, True, 0, 0), (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 256, 256, 8, 1, 64, True, 0, 0), (1, 128, 128, 4, 2, 64, True, 64, 0),
    (2, 128, 256, 4, 2, 32, True, 0, 128),
    (2, 128, 128, 4, 4, 64, False, 0, 0), (1, 64, 64, 2, 2, 128, True, 0, 0),
    (1, 96, 96, 2, 2, 32, True, 0, 0), (1, 2048, 2048, 32, 4, 64, True, 0, 0),
    (1, 130, 130, 4, 2, 64, True, 0, 0), (1, 64, 200, 4, 2, 64, True, 0, 136))
DECODE_CASES = (
    # (b, s, h, kv, hd, window, lengths)
    (2, 256, 8, 2, 64, 0, (200, 200)), (2, 256, 8, 8, 64, 0, (17, 17)),
    (3, 128, 10, 1, 32, 64, (100, 100, 100)), (1, 512, 4, 4, 128, 0, (512,)),
    (2, 128, 4, 2, 64, 128, (40, 40)), (3, 128, 4, 2, 32, 0, (1, 64, 128)),
    (8, 2176, 32, 4, 64, 0, (2176, 2175, 2113, 2049, 2048, 1000, 64, 1)),
    (2, 2176, 32, 4, 64, 0, (2175, 273)))
# Kernel against plain, as (atol, rtol): float32 at the reference's 2e-6;
# bfloat16 to one bf16 ulp, since kernel and plain each round one float32
# result to bf16 once (atol for values near 0).
ATTN_TOL = {"float32": (2e-6, 2e-6), "bfloat16": (1e-6, 2.0 ** -7)}
SERVE_BATCH, PROMPT, NEW_TOKENS = 8, 2048, 128
SERVE_CACHE = PROMPT + NEW_TOKENS    # 2176
# The kernel route's logits against the "ref" route's, as a share of the
# largest |logit|.  bfloat16: the rule of tests/test_torch_model.py:130,
# which bf16 rounding through 22 layers alone nearly fills; float32: a
# limit that separates a faulty kernel from rounding.
LOGIT_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}


def _check_close(got, want, tol: tuple, what: str) -> float:
    """|got - want| <= atol + rtol * |want| everywhere (in float32), with
    ``tol = (atol, rtol)``; returns the largest absolute difference."""
    import torch
    atol, rtol = tol
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not (bool(torch.isfinite(got).all())
            and bool((err <= atol + rtol * want.abs()).all())):
        raise AssertionError(f"{what}: kernel != plain (largest difference "
                             f"{float(err.max())}, atol {atol}, rtol {rtol})")
    return float(err.max())


def _randn(shape, dtype, seed: int):
    import numpy as np
    import torch
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(getattr(torch, dtype)).cuda()


def phase_attention_kernels(errs: dict) -> None:
    """Both attention kernels against their plain versions on the
    reference's cases and one at the main path's shapes, float32 and
    bfloat16."""
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    worst = {}
    for dtype, tol in ATTN_TOL.items():
        for case in FLASH_CASES:
            b, sq, skv, h, kv, hd, causal, window, q_offset = case
            q = _randn((b, sq, h, hd), dtype, 0)
            k = _randn((b, skv, kv, hd), dtype, 1)
            v = _randn((b, skv, kv, hd), dtype, 2)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = _check_close(out, fa.flash_attention_ref(q, k, v, **kw),
                               tol, f"flash_attention {case} {dtype}")
            key = ("flash_attention", dtype)
            worst[key] = max(worst.get(key, 0.0), err)
        for b, s, h, kv, hd, window, lengths in DECODE_CASES:
            q = _randn((b, 1, h, hd), dtype, 3)
            kc = _randn((b, s, kv, hd), dtype, 4)
            vc = _randn((b, s, kv, hd), dtype, 5)
            n = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            out = da.decode_attention(q, kc, vc, n, window=window)
            torch.cuda.synchronize()
            err = _check_close(
                out, da.decode_attention_ref(q, kc, vc, n, window=window),
                tol, f"decode_attention {(b, s, h, kv, hd, window, lengths)}"
                     f" {dtype}")
            key = ("decode_attention", dtype)
            worst[key] = max(worst.get(key, 0.0), err)
    for (name, _), err in worst.items():
        errs[name] = max(errs[name], err)
    log(f"[attn-kernels] flash_attention on {len(FLASH_CASES)} cases and "
        f"decode_attention on {len(DECODE_CASES)} cases, float32 (2e-6) and "
        f"bfloat16 (one bf16 ulp): kernel == plain within tolerance; "
        f"largest differences "
        f"{ {f'{n} {d}': e for (n, d), e in worst.items()} }")


def _serving_setup(dtype: str):
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model import init_params, make_batch
    from repro_torch.serve import ServingEngine
    cfg = dataclasses.replace(get(ARCH), attn_impl="pallas", dtype=dtype)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = make_batch(cfg, InputShape("serve", PROMPT, SERVE_BATCH,
                                       "prefill"), gen)
    engine = ServingEngine(cfg, params, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, attn_impl "
        f"{cfg.attn_impl}, attn_layout {cfg.attn_layout}; batch "
        f"{SERVE_BATCH}, prompt {PROMPT}, {NEW_TOKENS} new tokens, cache_len "
        f"{SERVE_CACHE}; built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params, batch, engine


def _profile_decode(engine, batch, n_steps: int = 8) -> None:
    """Device busy share over a window of decode steps (profiler), and one
    decode-attention kernel per layer per step in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    logits, cache = engine.prefill(batch)
    tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
    gen = torch.Generator(device="cuda")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            tok, _, cache = engine._step(tok, cache, 0.0, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    events = sum(r[2] for r in rows)
    log(f"[serve] {n_steps} profiled decode steps: wall {wall * 1e3:.3f} ms "
        f"({wall / n_steps * 1e3:.3f} ms a step), device busy "
        f"{busy * 1e3:.3f} ms ({busy / wall:.3f} of wall), {events} device "
        f"events ({events / n_steps:.1f} a step)")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"[serve]   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:70]}")
    decode = [(key, count) for _, key, count in rows if "decode_kernel" in key]
    want = engine.cfg.n_layers * n_steps
    log(f"[serve] decode-attention kernels in the window: "
        f"{sum(c for _, c in decode)} ({want} wanted: one per layer per "
        f"step); {[k[:60] for k, _ in decode]}")
    if len(decode) != 1 or decode[0][1] != want:
        raise AssertionError(f"the profiled decode window holds "
                             f"{decode}, not one decode kernel {want} times")


def _time_attention(name: str, kernel, plain, library, bound: dict,
                    reps: int, plain_reps: int, per_call: int = 1) -> dict:
    """Kernel, plain version and library call by CUDA events; each of the
    three runs ``per_call`` calls, and the times are per call."""
    ms = _time_ms(kernel, reps) / per_call
    plain_ms = _time_ms(plain, plain_reps) / per_call
    library_ms = _time_ms(library, reps) / per_call
    log(f"[timing] {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"scaled_dot_product_attention {library_ms:.5f} ms, bound "
        f"{bound['bound_ms']:.6f} ms by {bound['bound_by']} "
        f"({bound['note']}); kernel at {bound['bound_ms'] / ms:.4f} of the "
        f"bound")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def _device_ms(fn, calls: int, runs: int = 3) -> float:
    """Device time per call (profiler): the device time of everything
    ``runs`` runs of ``fn`` launch, over their ``runs * calls`` calls.  A
    profile that recorded no device event (the tracer lost the window) is
    taken again, up to three times, then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(r[0] for r in _device_rows(prof))
        if busy_us > 0:
            return busy_us / 1e3 / (runs * calls)
    raise RuntimeError("the profiler recorded no device time in three "
                       "tries")


def _time_decode(layers: list) -> dict:
    """decode_attention over the last decode step's inputs of every layer
    in turn (22 x 17.9 MB of caches, so L2 is cold as in a decode step),
    per call, beside its plain version, SDPA and the bytes bound: by CUDA
    events around back-to-back calls, and as device time (profiler), which
    the result carries.  The kernel takes less device time than its
    wrapper takes on the host, so back-to-back calls time the host."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    q, kc, _, n = layers[0]
    g = q.shape[2] // kc.shape[2]
    nbytes = da.bytes_moved(q, kc, n)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # The library call: SDPA over the same caches (head-major views, the
    # kv heads repeated outside the timed call) with the length mask.
    mask = (torch.arange(kc.shape[1], device="cuda")[None, :]
            < n[:, None])[:, None, None, :]
    sdpa_in = [(q.transpose(1, 2),
                kc.transpose(1, 2).repeat_interleave(g, dim=1),
                vc.transpose(1, 2).repeat_interleave(g, dim=1))
               for q, kc, vc, _ in layers]
    per = len(layers)
    launches = da.decode_attention.launches

    def kernel():
        return [da.decode_attention(*x) for x in layers]

    def plain():
        return [da.decode_attention_ref(*x) for x in layers]

    def library():
        return [F.scaled_dot_product_attention(*x, attn_mask=mask)
                for x in sdpa_in]

    out = _time_attention(
        f"decode_attention at the last decode step, over the {per} layers' "
        f"inputs in turn (each: q {tuple(q.shape)}, caches "
        f"{tuple(kc.shape)}, length {int(n[0])}), per call, CUDA events",
        kernel, plain, library,
        {"bound_ms": bound_ms, "bound_by": "bytes",
         "note": f"{nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s"}, 20, 3,
        per_call=per)
    dev = {key: _device_ms(fn, per) for key, fn in
           (("ms", kernel), ("plain_ms", plain), ("library_ms", library))}
    log(f"[timing] decode_attention, device time per call (profiler): "
        f"kernel {dev['ms']:.5f} ms, plain {dev['plain_ms']:.5f} ms, "
        f"scaled_dot_product_attention {dev['library_ms']:.5f} ms; kernel at "
        f"{bound_ms / dev['ms']:.4f} of the bound")
    da.decode_attention.launches = launches       # timing does not count
    return {**out, **dev}


def _time_flash(q, k, v) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    ops = fa.flops(tuple(q.shape), k.shape[1], causal=True)
    ops_ms = ops / BF16_FLOP_PER_S * 1e3
    # The bf16 kernel's own tensor work: p @ v three times (p in three bf16
    # parts), so 8 * hd flops per valid pair instead of 4 * hd.
    split_ms = 2 * ops_ms
    nbytes = fa.bytes_moved(q, k, v)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = {"bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "note": f"{ops} flops at the bf16 tensor-core peak "
                     f"{BF16_FLOP_PER_S:.3g}/s = {ops_ms:.6f} ms (at the fp32 "
                     f"CUDA-core peak {FP32_FLOP_PER_S:.3g}/s: "
                     f"{ops / FP32_FLOP_PER_S * 1e3:.6f} ms; with p in three "
                     f"bf16 parts, the kernel's tensor work: {split_ms:.6f} "
                     f"ms); {nbytes} bytes = {bytes_ms:.6f} ms"}
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    launches = fa.flash_attention.launches
    out = _time_attention(
        f"flash_attention in forward_train (layer 0: q, k, v "
        f"{tuple(q.shape)}, causal)",
        lambda: fa.flash_attention(q, k, v),
        lambda: fa.flash_attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True),
        bound, 5, 2)
    fa.flash_attention.launches = launches        # timing does not count
    return out


def _generate_checked(cfg, engine, batch, errs: dict) -> tuple:
    """A generate whose decode kernel is held to its plain version on every
    layer's inputs at the first and last step (ATTN_TOL of the model's
    dtype) and whose steps' logits are kept: (result, step logits, the
    last step's (q, k cache, v cache, length) of every layer)."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    calls, held, step_logits = [0], [], []
    decode_kernel, decode_step = ops.decode_attention, engine_mod.decode_step

    def checked(q, kc, vc, n, *, window=0, impl="ref"):
        out = decode_kernel(q, kc, vc, n, window=window, impl=impl)
        step, layer = divmod(calls[0], cfg.n_layers)
        calls[0] += 1
        if step in (0, NEW_TOKENS - 1):
            errs["decode_attention"] = max(
                errs["decode_attention"], _check_close(
                    out, da.decode_attention_ref(q, kc, vc, n, window=window),
                    ATTN_TOL[cfg.dtype],
                    f"{cfg.dtype} decode step {step} layer {layer}"))
            if step == NEW_TOKENS - 1:        # the caches are final
                held.append((q.clone(), kc, vc, n))
        return out

    def recorded(*args):
        logits, cache = decode_step(*args)
        step_logits.append(logits.float())
        return logits, cache

    ops.decode_attention, engine_mod.decode_step = checked, recorded
    try:
        res = engine.generate(batch, NEW_TOKENS)
    finally:
        ops.decode_attention, engine_mod.decode_step = decode_kernel, \
            decode_step
    return res, step_logits, held


def _teacher_forced(cfg, params, batch, tokens, step_logits) -> float:
    """The "ref" route teacher-forced over the kernel route's ``tokens``:
    every step's logits within LOGIT_RTOL[cfg.dtype] of the largest
    |logit| of the kernel route's; returns the worst share."""
    import torch
    from repro_torch.models import transformer as tf
    limit = LOGIT_RTOL[cfg.dtype]
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    worst = 0.0
    with torch.no_grad():
        logits, cache = tf.prefill(cfg_ref, params, batch,
                                   cache_len=SERVE_CACHE)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        for i in range(NEW_TOKENS):
            logits, cache = tf.decode_step(cfg_ref, params, tok, cache)
            want_l = logits.float()
            diff = float((step_logits[i] - want_l).abs().max())
            scale = float(want_l.abs().max())
            worst = max(worst, diff / scale)
            if diff > limit * scale:
                raise AssertionError(f"{cfg.dtype} decode step {i}: kernel "
                                     f"route logits off the ref route's by "
                                     f"{diff} (largest |logit| {scale})")
            tok = tokens[:, i]
    log(f"[serve] {cfg.dtype}: ref route teacher-forced over the "
        f"{NEW_TOKENS} generated tokens: every step's logits within {limit} "
        f"of the largest (worst {worst:.3e} of it)")
    return worst


def _hold_decode_f32(layers: list, errs: dict) -> float:
    """The decode kernel against its plain version in float32 on every
    layer's last-step inputs, at 2e-6; returns the largest difference."""
    from repro_torch.kernels import decode_attention as da
    launches, worst = da.decode_attention.launches, 0.0
    for i, (q, kc, vc, n) in enumerate(layers):
        qf, kf, vf = q.float(), kc.float(), vc.float()
        worst = max(worst, _check_close(
            da.decode_attention(qf, kf, vf, n),
            da.decode_attention_ref(qf, kf, vf, n), ATTN_TOL["float32"],
            f"float32 decode, last step, layer {i}"))
    errs["decode_attention"] = max(errs["decode_attention"], worst)
    da.decode_attention.launches = launches       # checks do not count
    return worst


def phase_serving(errs: dict) -> dict:
    """The slice's main path at full width in bf16: generate with the
    decode kernel (counted), then a checked generate, the ref route
    teacher-forced over its tokens, and forward_train through the flash
    kernel (:func:`_serve_forward`)."""
    import torch
    from repro_torch.kernels import decode_attention as da

    cfg, params, batch, engine = _serving_setup("bfloat16")
    engine.generate(batch, 2)                      # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    da.decode_attention.launches = 0
    t0 = time.perf_counter()
    res = engine.generate(batch, NEW_TOKENS)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = da.decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    step_ms = (gen_s - prefill_s) / NEW_TOKENS * 1e3
    log(f"[serve] prefill {prefill_s:.4f} s "
        f"({SERVE_BATCH * PROMPT / prefill_s:.1f} prompt tokens/s); generate "
        f"{gen_s:.4f} s: decode {step_ms:.4f} ms per step, "
        f"{SERVE_BATCH * NEW_TOKENS / gen_s:.1f} generated tokens/s "
        f"(prefill included), {SERVE_BATCH / step_ms * 1e3:.1f} tokens/s in "
        f"decode; peak device memory {peak / 1e9:.3f} GB; decode_attention "
        f"launches {launches}")
    want = cfg.n_layers * NEW_TOKENS
    if launches != want:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"in the generate, not {want}")
    if not (res.tokens.shape == (SERVE_BATCH, NEW_TOKENS)
            and bool(torch.isfinite(res.logprobs).all())
            and float(res.logprobs.max()) <= 0.0
            and int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < cfg.vocab_size):
        raise AssertionError("generate: tokens or logprobs out of range")
    _profile_decode(engine, batch)

    res2, step_logits, held = _generate_checked(cfg, engine, batch, errs)
    if not torch.equal(res2.tokens, res.tokens):
        raise AssertionError("the checked generate gave other tokens")
    err32 = _hold_decode_f32(held, errs)
    log(f"[serve] checked generate: decode_attention kernel == plain to one "
        f"bf16 ulp on all {cfg.n_layers} layers at steps 1 and {NEW_TOKENS},"
        f" and within 2e-6 on the last step's inputs cast to float32 "
        f"(largest difference {err32}); same tokens as the counted run")
    _teacher_forced(cfg, params, batch, res.tokens, step_logits)
    del step_logits
    decode_timing = _time_decode(held)

    flash = _serve_forward(cfg, params, batch, errs)
    del engine, params, batch, res, res2, held
    _free_cuda()
    return {"launches": {"decode_attention": launches,
                         "flash_attention": flash["launches"]},
            "timing": {"decode_attention": decode_timing,
                       "flash_attention": flash["timing"]}}


def _forward_vs_ref(cfg, params, batch) -> tuple:
    """forward_train over the prompts through the flash kernel (launches
    counted, layer 0's q, k, v kept) against attn_impl="ref": logits
    within LOGIT_RTOL[cfg.dtype] of the largest; returns (launches, layer
    0's (q, k, v))."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    held, flash_kernel = [], ops.flash_attention

    def capture(q, k, v, **kw):
        if not held:
            held.append((q.clone(), k.clone(), v.clone()))
        return flash_kernel(q, k, v, **kw)

    fa.flash_attention.launches = 0
    ops.flash_attention = capture
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            logits_k, _ = tf.forward_train(cfg, params, batch)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
    finally:
        ops.flash_attention = flash_kernel
    launches = fa.flash_attention.launches
    with torch.no_grad():
        t0 = time.perf_counter()
        logits_r, _ = tf.forward_train(
            dataclasses.replace(cfg, attn_impl="ref"), params, batch)
        torch.cuda.synchronize()
        fwd_ref_s = time.perf_counter() - t0
    diff = float((logits_k.float() - logits_r.float()).abs().max())
    scale = float(logits_r.float().abs().max())
    limit = LOGIT_RTOL[cfg.dtype]
    log(f"[serve] {cfg.dtype} forward_train over the prompts: attn_impl="
        f"pallas {fwd_s:.4f} s ({launches} flash_attention launches), "
        f"attn_impl=ref {fwd_ref_s:.4f} s; logits differ by {diff} (largest "
        f"|logit| {scale}, {diff / scale:.3e} of it; limit {limit})")
    if launches != cfg.n_layers:
        raise AssertionError(f"forward_train launched flash_attention "
                             f"{launches} times, not {cfg.n_layers}")
    if not (bool(torch.isfinite(logits_k).all()) and diff <= limit * scale):
        raise AssertionError(f"{cfg.dtype} forward_train: kernel route "
                             f"logits off the ref route's")
    return launches, held[0]


def _serve_forward(cfg, params, batch, errs: dict) -> dict:
    """forward_train through the flash kernel against attn_impl="ref",
    then the kernel held to plain on layer 0's inputs (bf16 and cast to
    float32; repeat_kv and grouped) and timed there."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    launches, (q, k, v) = _forward_vs_ref(cfg, params, batch)
    # attn_layout="grouped": the same layer on its 4 kv heads (g = 8), which
    # repeat_kv had expanded to 32; the kernel gives the same bits.
    g = cfg.n_heads // cfg.n_kv_heads
    kg, vg = k[:, :, ::g].contiguous(), v[:, :, ::g].contiguous()
    worst = {}
    for dtype in ("bfloat16", "float32"):
        x = [t.to(getattr(torch, dtype)) for t in (q, k, v, kg, vg)]
        out = fa.flash_attention(*x[:3])
        out_g = fa.flash_attention(x[0], x[3], x[4])
        worst[dtype] = max(
            _check_close(out, fa.flash_attention_ref(*x[:3]),
                         ATTN_TOL[dtype],
                         f"flash_attention at full width, {dtype}"),
            _check_close(out_g, fa.flash_attention_ref(x[0], x[3], x[4]),
                         ATTN_TOL[dtype],
                         f"flash_attention at full width, grouped, {dtype}"))
        if not torch.equal(out_g, out):
            raise AssertionError(f"flash_attention: grouped != repeat_kv in "
                                 f"{dtype}")
        errs["flash_attention"] = max(errs["flash_attention"], worst[dtype])
        del x, out, out_g
    log(f"[serve] flash_attention on layer 0's inputs: kernel == plain to "
        f"one bf16 ulp in bf16 and within 2e-6 cast to float32, with "
        f"repeat_kv (g = 1) and grouped (g = {g}), and the two kernel "
        f"outputs ==; largest differences {worst}")
    fa.flash_attention.launches = launches      # checks do not count
    return {"launches": launches, "timing": _time_flash(q, k, v)}


def phase_serving_f32(errs: dict) -> None:
    """The main path at full width in float32, where rounding leaves room
    for a limit that separates a faulty kernel: the checked generate
    (decode kernel within 2e-6 of plain at the first and last step) with
    the ref route teacher-forced over its tokens, and forward_train through
    the flash kernel, both within LOGIT_RTOL["float32"] of the ref route's
    largest logit."""
    import torch
    cfg, params, batch, engine = _serving_setup("float32")
    res, step_logits, held = _generate_checked(cfg, engine, batch, errs)
    if not (bool(torch.isfinite(res.logprobs).all())
            and float(res.logprobs.max()) <= 0.0):
        raise AssertionError("float32 generate: logprobs out of range")
    del held
    _teacher_forced(cfg, params, batch, res.tokens, step_logits)
    del step_logits
    _forward_vs_ref(cfg, params, batch)
    del engine, params, batch, res
    _free_cuda()


def phase_serving_cuda_cpu() -> None:
    """Reduced llama3.2-1b, float32, served on CUDA (the decode kernel) and
    on the CPU (its plain version) from one set of weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get("llama3.2-1b").reduced(), dtype="float32",
                              attn_impl="pallas")
    params = init_params(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 24)).astype(np.int32))
    out = {}
    for device, p in (("cuda", params),
                      ("cpu", tree_map(lambda t: t.cpu(), params))):
        launches = da.decode_attention.launches
        out[device] = ServingEngine(cfg, p, cache_len=48).generate(
            {"tokens": toks.to(device)}, 8)
        out[device + "_launches"] = da.decode_attention.launches - launches
    gpu, cpu = out["cuda"], out["cpu"]
    same = torch.equal(gpu.tokens.cpu(), cpu.tokens)
    lp = float((gpu.logprobs.cpu() - cpu.logprobs).abs().max())
    log(f"[serve-cuda-cpu] {cfg.name} float32, batch 3, prompt 24, 8 new: "
        f"greedy tokens CUDA == CPU {same}, logprobs differ by {lp:.3e}; "
        f"decode_attention launches cuda {out['cuda_launches']}, cpu "
        f"{out['cpu_launches']}")
    if not same or lp > 1e-4:
        raise AssertionError("reduced serving: CUDA and CPU disagree")
    if out["cuda_launches"] != cfg.n_layers * 8 or out["cpu_launches"]:
        raise AssertionError("reduced serving: the CUDA run did not go "
                             "through the decode kernel")


def main() -> int:
    t_start = time.perf_counter()
    device = phase_device()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    study = study_setup()
    phase_kernel((300, 4800, study["n_lanes"], BIG_LANES))
    loop_check = phase_lane_loop(study)
    adaptive = phase_adaptive(study)
    main_run = phase_main(study)
    phase_scale()
    phase_timing(study["n_lanes"])
    loop_timing = phase_loop_timing(loop_check)
    log(f"[done] study phases {time.perf_counter() - t_start:.1f} s")
    predictor = phase_predictor_study()
    phase_convergence()
    phase_overflow()
    log(f"[done] simulation phases {time.perf_counter() - t_start:.1f} s")
    errs = {"quantize_delta": 0.0, "dequantize_delta": 0.0}
    phase_ckpt_kernels(errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        trainer = phase_trainer(root, errs)
        phase_trainer_cuda_cpu(root)
    log(f"[done] trainer phases {time.perf_counter() - t_start:.1f} s")
    _free_cuda()        # the trainers' hook cycles still hold device state
    errs.update(flash_attention=0.0, decode_attention=0.0)
    phase_attention_kernels(errs)
    serving = phase_serving(errs)
    phase_serving_f32(errs)
    phase_serving_cuda_cpu()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "event_step", "kernel": "lane_loop_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_step.cu",
        "replaces": "src/repro/kernels/event_step.py:275",
        "launches": main_run["launches"],
        "max_abs_err": loop_check["max_abs_err"],
        "ms": loop_timing["ms"], "plain_ms": loop_timing["plain_ms"],
        "bound_ms": loop_timing["bound_ms"],
        "bound_by": loop_timing["bound_by"], "library_ms": None,
        "adaptive_max_abs_err": adaptive["max_abs_err"],
        "adaptive_ms": adaptive["ms"],
        "adaptive_launches": adaptive["launches"],
        "adaptive_plain_ms": adaptive["plain_ms"],
        "adaptive_bound_ms": adaptive["bound_ms"],
        "predictor_study_launches": predictor["launches"]}]
    for name, replaces in (("quantize_delta",
                            "src/repro/kernels/ckpt_delta.py:54"),
                           ("dequantize_delta",
                            "src/repro/kernels/ckpt_delta.py:90")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ckpt_delta.cu",
            "replaces": replaces, "launches": trainer["launches"][name],
            "max_abs_err": errs[name], **trainer["timing"][name],
            "library_ms": None})
    for name, replaces in (("flash_attention",
                            "src/repro/kernels/flash_attention.py:81"),
                           ("decode_attention",
                            "src/repro/kernels/decode_attention.py:72")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": serving["launches"][name],
            "max_abs_err": errs[name], **serving["timing"][name]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
