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
               (wgmma.mma_async, its bf16 route), also in its head-dim-80
               bf16 instantiation (hubert-xlarge), whose registers and
               spills are printed beside the fp32 one's.
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
6d. experiments - the paper's experiment layer through
               ``run_experiment`` on CUDA, one call per sweep cell, each
               cell's lanes, launches, ``make_traces`` seconds, wall, lanes/s
               and host split printed: (a) Tables 3-5
               (``benchmarks/exec_times.py``'s grid at its non-quick size,
               12 cells x 5 heuristics x 40 traces, 2,400 lanes; the launch
               counts set to 0 just before and read just after:
               lane_loop > 0 in every cell, event_step 0) in days beside
               the paper's and its trend claims; (b) the same experiment
               at 2 traces on CUDA and on the CPU lanes (in
               ``CPU_ROW_PARTS`` child processes started with the script,
               compared at its end), every row ``==``; (c) the same with
               ``engine="scalar"`` (the host oracle) and ``"batch"``
               (the kernel), every row ``==``; (d) the five experiment items
               of ``suites/quick_torch.json`` (the specs stored in
               ``suites/baselines/quick.json``): rows ``==`` the record's
               (one row the JAX package itself no longer gives is printed,
               ROADMAP Queue C R1) and every claim of the file holds
               (``ClaimSpec.evaluate``); (e) lane_loop_kernel ``==`` the
               plain loop on
               window_sweep's widest-window chunk (at the engine's cap and
               at 1) and on the first 2,000 iterations of silent_sweep's
               harsh chunk (one launch and 8; its whole run, tens of
               thousands of iterations, kernel at the engine's cap == at a
               cap of 1); (f) ``benchmarks/beyond.py``
               at its quick size (5 traces): the dynamic rows through the
               oracle (``period == "dynamic"``), the static ones through
               the kernel.
6e. observability, fleet and two-level - (a) attribute_batch on phase
               4's study pass (5,200 lanes) and phase 5's 65,536-lane
               chunk, both from lane_loop_kernel: the buckets sum ``==``
               to the makespan on every lane, the CUDA buckets ``==`` the
               CPU's on the lanes those phases rerun on the CPU, and the
               mean measured fraction of every bucket printed beside
               ``expected_fractions`` (RFO, OptimalPrediction and
               BestPeriod(RFO) held to ``tests/test_obs.py:220-266``'s
               bounds); (b) ``record_run`` replays 12 study lanes through
               the oracle: every field ``==`` the kernel's lane, the event
               counts ``==`` the counters, the buckets ``==`` (a)'s; (c)
               ``benchmarks/obs_metrics.py`` at its size: every field but
               wall_s ``==`` its record in ``suites/baselines/quick.json``,
               and its Perfetto JSON written, read back and checked; (d)
               ``benchmarks/fleet_sweep.py`` at its quick size ``==`` its
               record and its four claims, then at its full size (25
               traces) with the suite's model-vs-simulator bound and the
               0.5 period ratio, both tenants' measured outages and the
               twins' contention printed (the JAX package's own numbers
               break the other two claims there: ROADMAP Queue C);
               (e) 1-job fleets ``==`` the oracle field for field and
               ``==`` the kernel's lanes on the study's first 8 traces; (f)
               ``benchmarks/multilevel.py`` at its full size (30 traces),
               the table and its claim.  Each part's seconds printed.
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
               bfloat16 to one bf16 ulp.  Head dim 256 (recurrentgemma-2b's
               10 heads over one kv head): flash at seq 2,048 with window
               2,048, uneven tiles, a window, q_offset and no mask; decode
               over the wrapped, ragged 2,048-slot ring, a short ring and
               an append cache; the first two timed in bf16 beside plain,
               SDPA and the bound.  Head dim 80 (hubert-xlarge's, flash
               only): bidirectional at hubert's own (1, 2,048, 16 heads)
               and with uneven tiles, causal with a window, and with
               q_offset.
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
13. serving cuda vs cpu - reduced llama3.2-1b, qwen2-moe-a2.7b,
               recurrentgemma-2b, xlstm-125m and qwen2-vl-72b (its prompts
               a quarter vision patches, M-RoPE positions) in float32
               (batch 3, prompt 24, 8 new tokens, cache_len 48, as
               ``tests/test_serve.py``) with attn_impl="pallas" on CUDA
               (the kernel) and on the CPU (its plain version): greedy
               tokens ``==``, logprobs within 1e-4, one decode launch per
               attention layer and step.  Reduced hubert-xlarge (head dim
               64, and 80 as at full size): forward_train logits and
               loss_fn's loss through the flash kernel on CUDA against its
               plain version on the CPU, within 1e-4.
14. families  - qwen2-moe-a2.7b (24 layers, d 2048, 16/16 heads of 128, 60
               routed experts stored as 64, top 4, 4 shared, expert d_ff
               1408, vocab 151,936), recurrentgemma-2b (26 layers: rec,
               rec, local x 8 and rec, rec; d 2560, 10 heads of 256 over one
               kv head, window 2,048, vocab 256,000) and xlstm-125m (12
               layers of mLSTM, sLSTM; d 768, 4 heads, tied head) at their
               published widths, served as phase 11's cell (bf16, random
               weights from seed 0, attn_impl="pallas", batch 8, prompt
               2,048, 128 new tokens, greedy, cache_len 2,176): prefill s
               (and where a synchronised prefill spends it by block
               function), decode ms a step beside the step's bytes bound,
               tokens/s with and without the prefill, peak memory, the
               launch counts read from 0 before the generate (decode 24 x
               128, 8 x 128, 0), a profiled window; a checked generate:
               the decode kernel held to plain on every attention layer's
               inputs at the first and last step (one bf16 ulp; 2e-6 cast
               to float32), the ref route teacher-forced over the tokens
               (each step's logits against the largest; prefill is
               the same code in both routes and decode is dropless in
               both, so the MoE capacity does not enter; for MoE the ref
               route replays the kernel route's expert choices, see
               ``_Replay``), the decode kernel timed on the last step's
               inputs; forward_train through the flash kernel (24, 8, 0
               launches) against the ref route, the kernel held to
               plain on the first attention layer's inputs and timed
               there.  The bf16 logit comparisons are printed and not
               held: bf16 rounding alone passes 2e-2 in these 24- and
               26-layer cells (``_limit_note``).  Then each cell in float32
               at full width: the checked generate (decode kernel within
               2e-6), the ref route teacher-forced within 1e-4 of the
               largest logit and forward_train over two prompts within
               1e-4, MoE expert choices replayed and each held to a near
               tie (within 2e-2 of the ref route's own k-th gate).
15. modalities - (a) qwen2-vl-72b at its published widths (d 8192, 64
               query heads over 8 kv heads of 128, d_ff 29,568, vocab
               152,064, M-RoPE sections (16, 24, 24), theta 1e6) with its
               depth cut to fit one card: 16 of 80 layers in bf16 (16.53 B
               parameters, 33.1 GB), served as phase 14's cells (batch 8,
               prompt 2,048 of which the first 512 are vision patches from
               ``make_batch``'s stub on its (t, h, w) grid, 128 new tokens,
               greedy, cache_len 2,176; decode launches 16 x 128, flash 16
               in forward_train; bf16 logit comparisons printed), then 8
               layers in float32 (9.51 B, 38.1 GB) held at 1e-4 (the
               teacher-forced ref route with the same positions_thw, and
               forward_train over two prompts).  (b) hubert-xlarge at full
               size (48 layers, d 1280, 16 heads of 80, bidirectional, 504
               units): batch 8 x 2,048 frames with a 0.35 mask, bf16 then
               float32: forward_train and loss_fn through the flash kernel
               (48 launches each, causal=False, head dim 80) and through
               the ref route (held at 1e-4 of the largest logit and of the
               loss in float32, printed in bf16); the kernel held to plain
               on layer 0's real inputs (one bf16 ulp; 2e-6 cast to
               float32) and timed beside
               scaled_dot_product_attention(is_causal=False) and its
               operations bound; forward s on each route, frames/s, peak
               memory.
16. store and examples - (a) ``python -m repro_torch.store run
               suites/quick_torch.json --update-baseline`` in this process
               on CUDA, the launch counts set to 0 just before and read
               just after: rc 0, every claim, lane_loop launches > 0,
               event_step 0; each record against the record of the same
               (kind, name) in ``suites/baselines/quick.json``: rows
               ``==`` on the bits (R1's row printed), payload ``==``,
               identity ``==`` but engine_fingerprint, which must name
               this torch and this card, and another record id.  (b) The
               same run with ``--require-cached --gate`` on (a)'s bundle:
               every item from the store, no launch, no divergence.  (c)
               table2's first period x 1.5 in a copy of the bundle:
               ``diff`` exits 1.  (d) ``python -m repro_torch.store list``
               in a process: 6 records.  (e) The five example copies on
               the card through their own entry points: quickstart (its
               rows ``==`` engine="scalar", the host oracle),
               predictor_study (its asserts; lane_loop launches),
               trace_timeline (its Perfetto JSON read back), serving
               (greedy deterministic, sampling differs),
               fault_tolerant_training's phase 1 (the xLSTM-100M variant
               at its width, ``FT_STEPS`` steps; loss decreases) and
               phase 2 (the waste assert), the ckpt_delta launches
               counted against the proactive saves and delta restores
               they made, and every leaf they quantized or restored held
               to the plain version on the bits; each part's seconds and
               the xLSTM step time.  (f) ``ops.quantize_delta`` /
               ``dequantize_delta`` with impl="pallas" ``==`` impl="ref"
               on CUDA leaves.  The phase fails past its 180 s budget.

The last two lines are the ``kernels`` JSON line (all five TPU kernels;
the event_step entry reports lane_loop_kernel, which carries the advance
on the main path, with its adaptive instantiation's check, time, launches
and bound from phase 3a, the predictor study's launches, the
experiment phase's launches and check, and phase 16's store-run and
examples launches; the ckpt_delta entries add phase 16's example
launches; the attention entries add the
families' and modalities' launches per cell and the hd-256, per-family,
qwen2-vl-72b and (flash) hubert-xlarge timings) and
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


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    log(_smi())
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
    m = re.search(r"([a-z][a-z0-9_]*_kernel)I((?:Li\d+E)+)E", mangled)
    if m:                  # integer template arguments, e.g. head dims
        args = re.findall(r"Li(\d+)E", m.group(2))
        return f"{m.group(1)}<{', '.join(args)}>"
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
        if name == "flash_attention":
            # Head dim 80 (hubert-xlarge): both routes instantiated, the
            # bf16 one on the tensor cores.
            hd80 = {_entry_label(k): v for k, v in _ptx_entries(ptx).items()
                    if re.search(r"kernelILi80E", k)}
            bf16 = [b for label, b in hd80.items() if "wgmma" in label]
            if len(hd80) != 2 or len(bf16) != 1 \
                    or "wgmma.mma_async" not in bf16[0]:
                raise RuntimeError(f"flash_attention: head-dim-80 entries "
                                   f"{sorted(hd80)} lack a wgmma route")
            log(f"[build] flash_attention: head dim 80 instantiated as "
                f"{sorted(hd80)}; the bf16 one's PTX has wgmma.mma_async")


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
    from repro_torch.experiments import best_means, candidate_results
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
    result = candidate_results(traces, plat, sc.time_base, sc.cp, unique,
                               seed=sc.seed)
    ms = result.makespan
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
    cpu_result = candidate_results(traces, plat, sc.time_base, sc.cp,
                                   unique, seed=sc.seed,
                                   trace_indices=range(SUB_TRACES),
                                   device="cpu")
    t_cpu = time.perf_counter() - t0
    if not (ms[:, :SUB_TRACES].view(np.int64)
            == cpu_result.makespan.view(np.int64)).all():
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
    return {"launches": launches, "wall_s": wall, "iterations": iters,
            "result": result, "cpu_result": cpu_result}


def phase_scale() -> dict:
    """65,536 lanes as one chunk on the engine_perf.py big-lane setup;
    returns the chunk's results and its CPU rerun's (phase 6e reads
    them)."""
    import numpy as np
    import torch
    from repro_torch.core.batch import lane_results
    from repro_torch.core.simulator import ThresholdTrust
    from repro_torch.core.traces import Exponential, make_event_trace
    from repro_torch.core.waste import Platform

    lp = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    bank = [make_event_trace(Exponential(1.0), lp.mu, 0.7, 0.6, 200000.0,
                             np.random.default_rng(s)) for s in range(64)]
    idx = np.arange(BIG_LANES) % len(bank)

    def run(lanes: np.ndarray, device=None):
        return lane_results(
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
    result = run(everything)
    wall = time.perf_counter() - t0
    set_registry(prev)
    ms = result.makespan[0]
    if not (np.isfinite(ms).all() and (ms > 50000.0).all()):
        raise AssertionError("scale run: makespans not finite above "
                             "time_base")
    cpu_result = run(everything[:64], device="cpu")
    if not (cpu_result.makespan[0] == ms[:64]).all():
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
    return {"result": result, "cpu_result": cpu_result}


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


# -- the paper's experiment layer (run_experiment) ---------------------------

EXEC_TRACES = 40        # benchmarks/exec_times.py:51, non-quick
EXEC_CHECK_TRACES = 2   # (b) CUDA == CPU and (c) oracle == lanes
BEYOND_TRACES = 5       # benchmarks/beyond.py:45, quick
HARSH_PREFIX = 2000     # (e): the harsh chunk held to plain this far
# benchmarks/exec_times.py:20-35: the paper's days, (dist, log2 N, predictor).
PAPER_DAYS = {
    ("exp", 16, "good"): {"RFO": 65.2, "OptimalPrediction": 60.0,
                          "InexactPrediction": 60.6},
    ("exp", 19, "good"): {"RFO": 11.7, "OptimalPrediction": 9.5,
                          "InexactPrediction": 10.2},
    ("exp", 16, "fair"): {"RFO": 65.2, "OptimalPrediction": 61.7},
    ("exp", 19, "fair"): {"RFO": 11.7, "OptimalPrediction": 10.7},
    ("w07", 16, "good"): {"RFO": 80.3, "OptimalPrediction": 65.9,
                          "InexactPrediction": 68.0},
    ("w07", 19, "good"): {"RFO": 25.5, "OptimalPrediction": 15.9},
    ("w07", 16, "fair"): {"RFO": 80.3, "OptimalPrediction": 69.7},
    ("w07", 19, "fair"): {"RFO": 25.5, "OptimalPrediction": 20.2},
    ("w05", 16, "good"): {"RFO": 120.2, "OptimalPrediction": 75.9},
    ("w05", 19, "good"): {"RFO": 114.8, "OptimalPrediction": 39.5},
    ("w05", 16, "fair"): {"RFO": 120.2, "OptimalPrediction": 83.0},
    ("w05", 19, "fair"): {"RFO": 114.8, "OptimalPrediction": 60.8},
}
# The five experiment items of suites/quick.yaml with their claims, as the
# port's suite file holds them (JSON: the card's machine has no YAML
# reader).  Phase 6d (d) and phase 16 read it; recall_axis is the record of
# recall_precision's recall axis.
QUICK_TORCH = ROOT / "suites" / "quick_torch.json"
# A row of the record that the JAX package itself no longer gives on this
# numpy: the exact model's optimizer lands 7.5e-4 s away on the harshest
# cell (tests/test_torch_baseline_rows.py holds the port == the JAX package
# there).  It is printed, not held to the record.
RECORD_DRIFT = {("exact_vs_first_order",
                 (("model_order", "exact"), ("predictor", "0.85/0.82"),
                  ("scale", "2^19/C1800"), ("strategy", "Prediction")))}


def _exec_times_spec(n_traces: int):
    """benchmarks/exec_times.py:46-64 through the port's classes: the
    paper's Tables 3-5 grid (three distributions x good/fair predictors x
    2^16/2^19 processors) and its five heuristics
    (benchmarks/common.py:32-38)."""
    from repro_torch.experiments import (PREDICTORS, DistributionSpec,
                                         ExperimentSpec, ScenarioSpec,
                                         StrategySpec, SweepSpec)
    dists = {"exp": DistributionSpec("exponential"),
             "w07": DistributionSpec("weibull", {"shape": 0.7}),
             "w05": DistributionSpec("weibull", {"shape": 0.5})}
    return ExperimentSpec(
        name="exec_times",
        description="Execution time (days) of the paper's five heuristics",
        scenario=ScenarioSpec(n_traces=n_traces),
        sweep=SweepSpec(
            axes={"dist": list(dists.values()),
                  "recall,precision": [PREDICTORS["good"],
                                       PREDICTORS["fair"]],
                  "n": [2 ** 16, 2 ** 19]},
            labels={"dist": list(dists), "recall,precision": ["good", "fair"]},
            names={"recall,precision": "predictor"}),
        strategies=tuple(StrategySpec(s) for s in (
            "young", "daly", "rfo", "optimal_prediction",
            "inexact_prediction")),
        metrics=("makespan_days",))


def _beyond_spec(n_traces: int):
    """benchmarks/beyond.py:40-53 through the port's classes: static and
    hazard-tracking periods on Weibull faults."""
    from repro_torch.experiments import (DistributionSpec, ExperimentSpec,
                                         ScenarioSpec, StrategySpec,
                                         SweepSpec)
    return ExperimentSpec(
        name="beyond",
        description="Static vs hazard-tracking periods on Weibull faults",
        scenario=ScenarioSpec(dist=DistributionSpec("weibull",
                                                    {"shape": 0.7}),
                              n_traces=n_traces),
        sweep=SweepSpec(axes={"dist.params.shape": [0.5, 0.7],
                              "n": [2 ** 16, 2 ** 19]},
                        names={"dist.params.shape": "shape"}),
        strategies=tuple(StrategySpec(s) for s in (
            "rfo", "dynamic_rfo", "optimal_prediction",
            "dynamic_prediction")),
        metrics=("makespan_days",))


def _rows_bits(rows: list) -> list:
    """Rows with every float as its int64 bits, so ``==`` compares bits."""
    import numpy as np
    return [{k: (int(np.float64(v).view(np.int64)) if isinstance(v, float)
                 else v) for k, v in row.items()} for row in rows]


def _row_key(row: dict) -> tuple:
    return tuple(sorted((k, v) for k, v in row.items()
                        if isinstance(v, str) or k in (
                            "n", "window", "recall", "shape")))


def _record_routes():
    """Count the lanes the runner hands the lane engine and the pairs it
    hands the scalar oracle.  Returns the counts and a restore function."""
    import repro_torch.experiments.runner as runner
    real_lanes, real_pair = runner.lane_results, runner._simulate_pair
    counts = {"lanes": 0, "oracle": 0}

    def lanes(*args, **kw):
        counts["lanes"] += len(kw["trace_indices"])
        return real_lanes(*args, **kw)

    def pair(*args, **kw):
        counts["oracle"] += 1
        return real_pair(*args, **kw)

    runner.lane_results, runner._simulate_pair = lanes, pair

    def restore() -> None:
        runner.lane_results, runner._simulate_pair = real_lanes, real_pair
    return counts, restore


def _run_cells(exp, tag: str, **kw) -> tuple[list, list]:
    """run_experiment on CUDA, one call per sweep cell (the same rows as
    one call over the sweep), so that each cell's trace bank, lanes,
    launches and host split are read on their own.  Returns the rows and
    the per-cell numbers."""
    import dataclasses as dc

    import torch
    from repro_torch.experiments import run_experiment, trace_bank
    from repro_torch.kernels.event_step import event_step
    from repro_torch.kernels.lane_loop import lane_loop
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    rows, cells = [], []
    for cols, cell in exp.cells():
        t0 = time.perf_counter()
        trace_bank(cell)
        make_s = time.perf_counter() - t0
        one = dc.replace(exp, scenario=cell, sweep=None)
        reg = MetricsRegistry()
        prev = set_registry(reg)
        counts, restore = _record_routes()
        launches = lane_loop.launches, event_step.launches
        try:
            t0 = time.perf_counter()
            table = run_experiment(one, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            restore()
            set_registry(prev)
        n_loop = lane_loop.launches - launches[0]
        n_step = event_step.launches - launches[1]
        rows += [dict(cols, **row) for row in table.rows]
        name = ", ".join(f"{k}={v}" for k, v in cols.items())
        log(f"[{tag}] {name}: {counts['lanes']} lanes, {counts['oracle']} "
            f"oracle runs, {n_loop} lane_loop launches (longest lane "
            f"{reg.counters.get('torch.iterations', 0)} iterations), "
            f"{n_step} event_step launches; make_traces {make_s:.4f} s, "
            f"run_experiment "
            f"{wall:.4f} s ({counts['lanes'] / wall:.1f} lanes/s), cache "
            f"{reg.counters['runner.cache_misses']} runs; "
            f"{_host_split(reg, wall)}")
        cells.append(dict(cols=cols, lanes=counts["lanes"],
                          oracle=counts["oracle"], launches=n_loop,
                          step_launches=n_step, make_s=make_s, wall=wall))
    return rows, cells


def _exec_table(rows: list) -> None:
    """The Tables 3-5 grid in days beside the paper's values, and the trend
    claims of benchmarks/exec_times.py:94-101."""
    from repro_torch.experiments import ResultTable
    table = ResultTable(rows)
    gains = {}
    for dist in ("exp", "w07", "w05"):
        for pred in ("good", "fair"):
            for n_exp in (16, 19):
                res = table.strategy_dict("makespan_days", dist=dist,
                                          predictor=pred, n=2 ** n_exp)
                g_opt = round(100.0 * (1.0 - res["OptimalPrediction"]
                                       / res["RFO"]), 1)
                g_inx = round(100.0 * (1.0 - res["InexactPrediction"]
                                       / res["RFO"]), 1)
                gains[(dist, n_exp, pred)] = g_opt
                paper = PAPER_DAYS[(dist, n_exp, pred)]
                log(f"[exec_times] {dist} N=2^{n_exp} {pred}: "
                    + ", ".join(f"{k} {v!r} d" for k, v in res.items())
                    + f"; gain Opt {g_opt}%, Inexact {g_inx}%; paper "
                    + ", ".join(f"{k} {v}" for k, v in paper.items()))
    bad = []
    for dist in ("exp", "w07", "w05"):
        for pred in ("good", "fair"):
            if not gains[(dist, 19, pred)] > 0:
                bad.append(f"{dist}/{pred}: gain at 2^19 "
                           f"{gains[(dist, 19, pred)]} <= 0")
            if not gains[(dist, 19, pred)] >= gains[(dist, 16, pred)] - 3.0:
                bad.append(f"{dist}/{pred}: gain falls from 2^16 to 2^19")
    if not gains[("w05", 19, "good")] > gains[("exp", 19, "good")]:
        bad.append("w05 gain at 2^19 not above the exponential's")
    if bad:
        raise AssertionError("exec_times trend claims: " + "; ".join(bad))
    log("[exec_times] the paper's trend claims hold (exec_times.py:94-101): "
        "prediction gains at 2^19 in every cell, no gain falls by more than "
        "3 points from 2^16 to 2^19, and Weibull 0.5 gains more than "
        "exponential at 2^19 (good predictor)")


def _quick_suite(record_cells: dict) -> dict:
    """(d): the five experiment items of suites/quick_torch.json (the
    specs stored in suites/baselines/quick.json) on CUDA: rows == the
    record's rows, every claim holds (the port's ClaimSpec.evaluate).
    (e)'s two cells run again alone with their chunks recorded."""
    import dataclasses as dc

    from repro_torch.experiments import ExperimentSpec, run_experiment
    from repro_torch.kernels.lane_loop import lane_loop
    from repro_torch.store import ClaimSpec
    with open(ROOT / "suites" / "baselines" / "quick.json") as fh:
        records = {r["name"]: r for r in json.load(fh)["records"].values()}
    with open(QUICK_TORCH) as fh:
        items = json.load(fh)["items"]
    chunks = {}
    for item in items:
        name = item["label"]
        rec = records[name]
        exp = ExperimentSpec.from_dict(item["spec"])
        launches = lane_loop.launches
        t0 = time.perf_counter()
        table = run_experiment(exp)
        wall = time.perf_counter() - t0
        want = {_row_key(r): r for r in _rows_bits(rec["rows"])}
        got = {_row_key(r): r for r in _rows_bits(table.rows)}
        if got.keys() != want.keys() or len(got) != len(table.rows):
            raise AssertionError(f"{name}: rows {sorted(got)} != record "
                                 f"{sorted(want)}")
        drift = []
        for key, row in got.items():
            if row == want[key]:
                continue
            if (name, key) not in RECORD_DRIFT:
                raise AssertionError(f"{name}: row {key} != the record: "
                                     f"{row} vs {want[key]}")
            drift.append(key)
        results = [ClaimSpec.from_dict(c).evaluate(table, {})
                   for c in item["claims"]]
        failed = [r for r in results if not r["ok"]]
        if failed:
            raise AssertionError(f"{name}: claims fail: {failed}")
        log(f"[quick] {name}: {len(table.rows)} rows in {wall:.4f} s, "
            f"{lane_loop.launches - launches} lane_loop launches; rows == "
            f"the record"
            + (f" except {len(drift)} row(s) where the JAX package itself "
               f"no longer gives the record ({drift})" if drift else "")
            + f"; {len(results)} claims hold: "
            + "; ".join(r["detail"] for r in results))
        if name in record_cells:
            match = record_cells[name]
            cell = next(c for cols, c in exp.cells()
                        if all(cols.get(k) == v for k, v in match.items()))
            seen, restore = _record_chunks()
            try:
                run_experiment(dc.replace(exp, scenario=cell, sweep=None))
            finally:
                restore()
            chunks[name] = seen[0]
    return chunks


def _check_lane_prefix(lanes, g, what: str, iters: int) -> float:
    """lane_loop_kernel == the plain loop on the first ``iters`` iterations
    of a chunk (the kernel in one launch and in 8, the plain loop once),
    and the kernel's whole run at the engine's cap == at a cap of 1; every
    row of F, I and Q on the bits.  For a chunk whose longest lane runs
    tens of thousands of iterations, which the plain loop would take
    minutes over.  Returns the largest difference."""
    import torch
    from repro_torch.core.batch_torch import _LAUNCH_CAP, _run_chunk
    from repro_torch.kernels.lane_loop import LQ_ITERS, lane_loop, lane_loop_ref

    def same(a, b, how: str) -> float:
        err = 0.0
        for name in ("f", "i", "q"):
            x, y = getattr(a, name), getattr(b, name)
            err = max(err, _max_abs_err(x.double(), y.double()))
            if not _bits_equal(x, y):
                raise AssertionError(f"lane_loop on {what}, {how}: matrix "
                                     f"{name} differs")
        return err

    plain = lanes.clone()
    lane_loop_ref(plain, g, cap=iters)
    max_err = 0.0
    for calls in (1, 8):
        kern = lanes.clone()
        for _ in range(calls):
            lane_loop(kern, g, cap=iters // calls)
        torch.cuda.synchronize()
        max_err = max(max_err, same(kern, plain, f"kernel != plain after "
                                    f"{iters} iterations in {calls} "
                                    f"launch(es)"))
    whole = [lanes.clone(), lanes.clone()]
    calls = [_run_chunk(lane_loop, whole[0], g, _LAUNCH_CAP),
             _run_chunk(lane_loop, whole[1], g, 1)]
    torch.cuda.synchronize()
    same(whole[0], whole[1], "the whole run at the engine's cap != at 1")
    log(f"[kernel] lane_loop {what}, {lanes.f.shape[1]} lanes: kernel == "
        f"plain on every row after {iters} iterations (1 launch and 8); "
        f"the whole run ({int(whole[0].q[LQ_ITERS].max())} iterations of "
        f"the longest lane) at the engine's cap ({calls[0]} launches) == at "
        f"a cap of 1 ({calls[1]} launches)")
    return max_err


CPU_ROW_PARTS = 3       # (b)'s CPU side: processes, each a third of the cells


def _cpu_exec_rows(path: str, part: int) -> None:
    """(b)'s CPU side, in a process of its own: the cells ``part``,
    ``part + CPU_ROW_PARTS``, ... of the Tables 3-5 experiment at
    EXEC_CHECK_TRACES traces, each through run_experiment on the CPU
    lanes; the rows, with their cell's index, written to ``path``."""
    import dataclasses as dc

    import torch
    torch.set_num_threads(1)
    from repro_torch.experiments import run_experiment
    exp = _exec_times_spec(EXEC_CHECK_TRACES)
    t0 = time.perf_counter()
    rows = []
    for k, (cols, cell) in enumerate(exp.cells()):
        if k % CPU_ROW_PARTS == part:
            table = run_experiment(dc.replace(exp, scenario=cell, sweep=None),
                                   engine="batch", device="cpu")
            rows += [(k, dict(cols, **row)) for row in table.rows]
    with open(path, "w") as fh:
        json.dump({"rows": rows, "seconds": time.perf_counter() - t0}, fh)


def start_cpu_rows(workdir: str) -> list:
    """Start (b)'s CPU side beside the other phases (minutes on the CPU):
    CPU_ROW_PARTS child processes without the card.  Returns each one and
    its output path."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    children = []
    for part in range(CPU_ROW_PARTS):
        path = os.path.join(workdir, f"exec_rows_cpu_{part}.json")
        children.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--exec-rows-cpu",
             path, str(part)], env=env, stdout=subprocess.DEVNULL), path))
    return children


def finish_cpu_rows(children: list, cuda_rows: list) -> None:
    """(b): the children's CPU rows, in cell order, == the CUDA rows, as
    int64 bits."""
    t0 = time.perf_counter()
    rows, seconds = [], []
    for proc, path in children:
        rc = proc.wait(timeout=900)
        if rc != 0:
            raise AssertionError(f"a CPU rows' process exited {rc}")
        with open(path) as fh:
            got = json.load(fh)
        rows += got["rows"]
        seconds.append(got["seconds"])
    rows = [row for _, row in sorted(rows, key=lambda kr: kr[0])]
    if _rows_bits(rows) != _rows_bits(cuda_rows):
        raise AssertionError("exec_times at 2 traces: CUDA rows != CPU rows")
    log(f"[experiments] (b) exec_times at {EXEC_CHECK_TRACES} traces: CUDA "
        f"== CPU on all {len(cuda_rows)} rows (makespan_days and period as "
        f"int64 bits; the CPU side ran in {len(children)} processes of its "
        f"own beside the other phases, "
        + ", ".join(f"{t:.1f}" for t in seconds)
        + f" s, and was waited for {time.perf_counter() - t0:.1f} s here)")


def phase_experiments() -> dict:
    """The paper's experiment layer on the card: (a) Tables 3-5 at full
    size, (c) the oracle == the lanes, (d) the quick suite's experiment
    items against their records, (e) the kernel == plain on two of their
    chunks, (f) the dynamic route; (b)'s CUDA rows are returned for the
    CPU comparison at the end of the script."""
    import math

    from repro_torch.experiments import run_experiment
    from repro_torch.kernels.event_step import event_step
    from repro_torch.kernels.lane_loop import lane_loop
    t_start = time.perf_counter()

    # (a) the main path of this phase: counts at 0 just before, read after.
    lane_loop.launches = 0
    event_step.launches = 0
    rows, cells = _run_cells(_exec_times_spec(EXEC_TRACES), "exec_times")
    launches = lane_loop.launches
    if event_step.launches != 0:
        raise AssertionError(f"exec_times launched event_step "
                             f"{event_step.launches} times")
    if any(c["launches"] < 1 or c["oracle"] for c in cells):
        raise AssertionError("an exec_times cell launched no lane_loop "
                             "kernel or took the oracle")
    lanes = sum(c["lanes"] for c in cells)
    wall = sum(c["wall"] for c in cells)
    make_s = sum(c["make_s"] for c in cells)
    log(f"[exec_times] {len(cells)} cells, {lanes} lanes, {launches} "
        f"lane_loop launches, 0 event_step launches; make_traces "
        f"{make_s:.4f} s, run_experiment {wall:.4f} s "
        f"({lanes / wall:.1f} lanes/s)")
    _exec_table(rows)

    # (b) CUDA side and (c): the oracle on the host == the lanes on CUDA.
    small = _exec_times_spec(EXEC_CHECK_TRACES)
    cuda_rows = run_experiment(small, engine="batch").rows
    t0 = time.perf_counter()
    oracle_rows = run_experiment(small, engine="scalar", workers=0).rows
    t_oracle = time.perf_counter() - t0
    if _rows_bits(oracle_rows) != _rows_bits(cuda_rows):
        raise AssertionError("exec_times at 2 traces: oracle != lanes")
    log(f"[experiments] (c) exec_times at {EXEC_CHECK_TRACES} traces: "
        f"engine='scalar' (the oracle, {t_oracle:.2f} s on the host) == "
        f"engine='batch' (lane_loop_kernel) on all {len(cuda_rows)} rows")

    # (d) the quick suite, (e) two of its chunks.
    chunks = _quick_suite({"silent_sweep": {"silent": "harsh"},
                           "window_sweep": {"predictor": "good",
                                            "window": 18000.0}})
    lane_loop_counts = lane_loop.launches, event_step.launches
    chunk, g = chunks["window_sweep"]
    err = _check_lane_loop(chunk, g, "window_sweep widest-window chunk")[
        "max_abs_err"]
    chunk, g = chunks["silent_sweep"]
    err = max(err, _check_lane_prefix(chunk, g, "silent_sweep harsh chunk",
                                      HARSH_PREFIX))
    lane_loop.launches, event_step.launches = lane_loop_counts

    # (f) the dynamic route.
    beyond, bcells = _run_cells(_beyond_spec(BEYOND_TRACES), "beyond")
    for row in beyond:
        dynamic = row["strategy"].startswith("Dynamic")
        if dynamic != (row["period"] == "dynamic") or \
                not math.isfinite(row["makespan_days"]):
            raise AssertionError(f"beyond: row {row}")
    if any(c["oracle"] != 2 * BEYOND_TRACES or
           c["lanes"] != 2 * BEYOND_TRACES or c["launches"] < 1
           for c in bcells):
        raise AssertionError("beyond: a cell did not send its dynamic rows "
                             "to the oracle and its static rows to the "
                             "lanes")
    for row in beyond:
        log(f"[beyond] shape={row['shape']} n={row['n']} "
            f"{row['strategy']}: {row['makespan_days']!r} d, period "
            f"{row['period']}")
    log(f"[experiments] phase {time.perf_counter() - t_start:.1f} s")
    return {"launches": launches, "cells": cells, "max_abs_err": err,
            "cuda_rows": cuda_rows}


# -- 6e. observability, fleet and two-level -----------------------------------

OBS_RECORD = "r8a5a94055adfca2d8bae"    # obs_metrics in suites/baselines/quick.json
FLEET_RECORD = "raee798c647ad4e79c83a"  # fleet_sweep (quick) in the same file
FLEET_QUICK, FLEET_FULL = 5, 25         # benchmarks/fleet_sweep.py:63
FLEET_MU_IND = 3650.0 * 86400.0         # fleet_sweep.py:40: 10 years a chip
FLEET_TRACK = (0.9, 1.1)                # suites/quick.yaml:137
TWO_LEVEL_TRACES = 30                   # benchmarks/multilevel.py:37, full
REPLAY_TRACES = 4                       # (b): study traces per strategy
DEGENERACY_TRACES = 8                   # (e): study traces per strategy


def _quick_record(record_id: str) -> dict:
    with open(ROOT / "suites" / "baselines" / "quick.json") as fh:
        return json.load(fh)["records"][record_id]


def obs_metrics_payload() -> tuple[dict, dict]:
    """benchmarks/obs_metrics.py:17-70 through the port: one traced run of
    the prediction cell, attributed, and its two traces as a contended
    fleet.  Returns the payload as the suite runner records it (with the
    ``metrics`` counters of a registry of its own) and the fleet's
    Perfetto trace object."""
    import numpy as np
    from repro_torch.core.simulator import simulate
    from repro_torch.experiments import ScenarioSpec, StrategySpec
    from repro_torch.fleet.sim import FleetJobInput, simulate_fleet
    from repro_torch.obs import (MetricsRegistry, RecordingSink,
                                 attribute_fleet_job, attribute_result,
                                 fleet_to_perfetto, set_registry)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        t0 = time.perf_counter()
        scenario = ScenarioSpec(n=2 ** 16, c=600.0, d=60.0, r=600.0,
                                n_traces=2, time_base_years_total=2000.0,
                                seed=5)
        strat = StrategySpec("optimal_prediction").build(scenario)
        traces = scenario.make_traces()
        seeds = [scenario.seed + 7919 * i for i in range(len(traces))]
        sink = RecordingSink()
        res = simulate(traces[0], scenario.platform, scenario.time_base,
                       strat.period, cp=scenario.cp, trust=strat.trust,
                       rng=np.random.default_rng(seeds[0]), sink=sink)
        att = attribute_result(res)
        if att.total() != res.makespan:
            raise AssertionError("obs_metrics: bucket closure broke")
        counts = sink.counts()
        single = dict(att.buckets())
        single.update(
            makespan=res.makespan,
            n_proactive_ckpts=res.n_proactive_ckpts,
            n_rollbacks=res.n_rollbacks,
            n_events=len(sink),
            n_fault_events=counts.get("fault", 0),
            n_trust_events=counts.get("trust", 0),
            sum_exact=int(att.total() == res.makespan))
        sinks = [RecordingSink() for _ in traces]
        fleet = simulate_fleet(
            [FleetJobInput(trace=tr, platform=scenario.platform,
                           time_base=scenario.time_base,
                           period=strat.period, cp=scenario.cp,
                           trust=strat.trust,
                           rng=np.random.default_rng(seeds[i]),
                           name=f"job{i}", sink=sinks[i])
             for i, tr in enumerate(traces)],
            storage_streams=1, repair_slots=1)
        fatts = [attribute_fleet_job(j) for j in fleet.jobs]
        trace_json = fleet_to_perfetto(
            [(j.name, s.events) for j, s in zip(fleet.jobs, sinks)])
        fleet_out = {
            "n_jobs": len(fleet.jobs),
            "wait_total": sum(a.wait for a in fatts),
            "makespan": fleet.makespan,
            "n_trace_events": len(trace_json["traceEvents"]),
            "sum_exact": int(all(a.total() == j.sim.makespan
                                 for a, j in zip(fatts, fleet.jobs))),
        }
        payload = {"single": single, "fleet": fleet_out,
                   "wall_s": time.perf_counter() - t0}
    finally:
        set_registry(prev)
    payload["metrics"] = dict(reg.counters)
    return payload, trace_json


def _fleet_jobs(n_traces: int) -> tuple:
    """fleet_sweep.py:44-48: a 1B model on 256 devices beside a 405B model
    on 8,192, sized from the port's model zoo, 20 days each."""
    from repro_torch.fleet import job_from_model
    return (job_from_model("llama3.2-1b", n_devices=256, n_traces=n_traces,
                           seed=0, mu_ind=FLEET_MU_IND, time_base_days=20.0),
            job_from_model("llama3-405b", n_devices=8192, n_traces=n_traces,
                           seed=1, mu_ind=FLEET_MU_IND, time_base_days=20.0))


def _fleet_twins(n_traces: int) -> tuple:
    """fleet_sweep.py:51-55: twin 405B tenants for the staggering cell."""
    from repro_torch.fleet import job_from_model
    return tuple(job_from_model("llama3-405b", n_devices=8192,
                                n_traces=n_traces, seed=s,
                                mu_ind=FLEET_MU_IND, time_base_days=20.0,
                                name=f"tenant{s}")
                 for s in (1, 2))


def fleet_sweep_payload(n_traces: int) -> tuple[dict, dict]:
    """benchmarks/fleet_sweep.py:61-134 through the port, its claims left
    to :func:`fleet_sweep_claims`: the payload as the suite runner records
    it (both objectives' rows, ``model_vs_sim`` by the script's
    operations, ``contention_s``, the ``metrics`` counters) and the two
    objectives' tables."""
    from repro_torch.fleet import FleetSpec, OutageWeights, evaluate_fleet
    from repro_torch.obs import MetricsRegistry, set_registry
    # fleet_sweep.py:37: mostly-concurrent checkpoints, full-outage replay.
    weights = OutageWeights(ckpt=0.25, prockpt=0.25, replay=1.0)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        jobs = _fleet_jobs(n_traces)
        tables = {obj: evaluate_fleet(FleetSpec(
            jobs=jobs, objective=obj, outage=weights, name=f"hetero-{obj}"))
            for obj in ("waste", "availability")}
        out: dict = {"rows": {obj: t.rows for obj, t in tables.items()}}
        rows = {r["job"]: r for r in tables["availability"].rows}
        big = rows["llama3-405b"]
        rel = big["expected_objective"] / big["unavailability"] - 1.0
        small = rows["llama3.2-1b"]
        out["model_vs_sim"] = {
            "llama3-405b": 1.0 + rel,
            "llama3.2-1b_unasserted":
                small["expected_objective"] / small["unavailability"],
        }
        cont = {}
        for stagger in (False, True):
            t = evaluate_fleet(FleetSpec(
                jobs=_fleet_twins(n_traces), objective="availability",
                outage=weights, storage_streams=1, stagger=stagger,
                name=f"twins-stagger={stagger}"))
            cont[stagger] = sum(r["contention_ckpt_s"]
                                + r["contention_prockpt_s"] for r in t.rows)
        out["contention_s"] = {"synchronized": cont[False],
                               "staggered": cont[True]}
    finally:
        set_registry(prev)
    out["metrics"] = dict(reg.counters)
    return out, tables


def fleet_sweep_claims(payload: dict, *, all_claims: bool) -> list[str]:
    """fleet_sweep.py's claims on a payload, raising on a failure: the
    sqrt(phi_c/rho) = 0.5 period ratio on every tenant and the suite's
    bound on the 405B tenant's model/simulator ratio
    (``suites/quick.yaml:137``); with ``all_claims`` also the script's
    other two, the availability plan's lower measured outage on every
    tenant (``fleet_sweep.py:87``) and staggering cutting contention by
    more than 10x (``:125``).  The JAX package's own numbers break those
    two at the full size (ROADMAP Queue C), so there they are printed.
    Returns a line for each claim."""
    rows = {obj: {r["job"]: r for r in rs}
            for obj, rs in payload["rows"].items()}
    said = []
    for job in ("llama3.2-1b", "llama3-405b"):
        t_w = rows["waste"][job]["period"]
        t_a = rows["availability"][job]["period"]
        u_w = rows["waste"][job]["unavailability"]
        u_a = rows["availability"][job]["unavailability"]
        if not abs(t_a / t_w - 0.5) < 5e-4:
            raise AssertionError(f"fleet_sweep {job}: period ratio "
                                 f"{t_a / t_w!r}, not 0.5")
        if all_claims and not u_a < u_w:
            raise AssertionError(f"fleet_sweep {job}: the availability "
                                 f"plan measures {u_a!r} >= {u_w!r}")
        said.append(f"{job}: T {t_w!r} -> {t_a!r} s (ratio {t_a / t_w!r}), "
                    f"measured U {u_w!r} (waste plan) -> {u_a!r} "
                    f"(availability plan)"
                    + ("" if all_claims else ", order not held"))
    ratio = payload["model_vs_sim"]["llama3-405b"]
    lo, hi = FLEET_TRACK
    if not lo <= ratio <= hi:
        raise AssertionError(f"fleet_sweep: 405B model/sim {ratio!r} "
                             f"outside [{lo}, {hi}]")
    said.append(f"405B model/sim {ratio!r} in [{lo}, {hi}] (1B, quoted: "
                f"{payload['model_vs_sim']['llama3.2-1b_unasserted']!r})")
    cont = payload["contention_s"]
    cut = cont["synchronized"] / cont["staggered"]
    if all_claims and not cont["staggered"] < 0.1 * cont["synchronized"]:
        raise AssertionError(f"fleet_sweep: staggering left {cont}")
    said.append(f"twin contention {cont['synchronized']!r} s synchronized "
                f"-> {cont['staggered']!r} s staggered ({cut!r}x"
                + (")" if all_claims else ", > 10x not held)"))
    return said


def two_level_rows(n_traces: int) -> list[dict]:
    """benchmarks/multilevel.py:26-81 through the port: single-level RFO
    against the optimal two-level schedule over N x phi, each cell's
    optimum simulated on ``n_traces`` two-level streams; ``w1`` and ``w2``
    are the unrounded wastes the script compares."""
    import numpy as np
    from repro_torch.core.multilevel import (TwoLevelPlatform,
                                             optimal_two_level,
                                             simulate_two_level,
                                             two_level_stream)
    from repro_torch.core.waste import t_rfo, waste
    from repro_torch.experiments import (DistributionSpec, ExperimentSpec,
                                         ScenarioSpec, SweepSpec)
    exp = ExperimentSpec(
        name="multilevel",
        scenario=ScenarioSpec(dist=DistributionSpec("exponential"),
                              c=600.0, d=60.0, r=600.0,
                              extras={"phi": 0.6, "c1": 30.0, "r1": 30.0},
                              n_traces=n_traces),
        sweep=SweepSpec(axes={"n": [2 ** 16, 2 ** 18, 2 ** 19],
                              "extras.phi": [0.6, 0.8]},
                        names={"extras.phi": "phi"}),
        strategies=(), metrics=())
    rows = []
    for _, cell in exp.cells():
        phi = cell.extras["phi"]
        p1 = cell.platform
        p2 = TwoLevelPlatform(mu=cell.mu, phi=phi, c1=cell.extras["c1"],
                              c2=cell.c, r1=cell.extras["r1"], r2=cell.r,
                              d=cell.d)
        w1 = waste(t_rfo(p1), p1)
        t1, k, w2 = optimal_two_level(p2)
        sims = []
        for seed in range(cell.n_traces):
            faults, soft = two_level_stream(
                p2, 5.0 * cell.time_base, np.random.default_rng(seed))
            sims.append(simulate_two_level(
                faults, soft, p2, cell.time_base, t1, k).waste)
        rows.append({"N": f"2^{cell.n.bit_length() - 1}", "phi": phi,
                     "waste_single": round(w1, 4),
                     "waste_two_level": round(w2, 4),
                     "k_star": k, "t1_star": round(t1, 0),
                     "waste_sim": round(float(np.mean(sims)), 4),
                     "gain_pct": round(100 * (1 - w2 / w1), 1),
                     "w1": w1, "w2": w2})
    return rows


def check_perfetto(trace: dict, jobs: list[str]) -> int:
    """A Perfetto trace object is well formed: each job a named thread
    track; every slice of a kind with a non-negative duration and after
    the last slice of that kind on its track ended; instants scoped.
    Returns the number of slices."""
    evs = trace["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    if sorted(names.values()) != sorted(jobs):
        raise AssertionError(f"Perfetto tracks {names} != jobs {jobs}")
    ends: dict = {}
    n = 0
    for e in evs:
        if e["ph"] == "X":
            key = (e["tid"], e["name"])
            if not (e["dur"] >= 0.0 and e["ts"] >= ends.get(key, 0.0)):
                raise AssertionError(f"Perfetto slice {e} overlaps the last "
                                     f"{e['name']} on its track")
            ends[key] = e["ts"] + e["dur"]
            n += 1
        elif e["ph"] == "i" and e.get("s") != "t":
            raise AssertionError(f"Perfetto instant {e} is not "
                                 f"thread-scoped")
        elif e["ph"] not in ("X", "i", "M"):
            raise AssertionError(f"Perfetto event {e}")
    return n


def _bucket_means(buckets: dict, makespan, ci) -> dict:
    """Each bucket's measured fraction of the makespan, averaged over
    candidate ``ci``'s traces."""
    import numpy as np
    return {name: float(np.mean(b[ci] / makespan[ci]))
            for name, b in buckets.items()}


def _attribute(result, what: str) -> tuple[dict, object]:
    """attribute_lanes on a BatchResult: the buckets sum ``==`` to the
    makespan on every lane the closure reaches, and within one ulp of it
    on the others (where attribute_batch raises, as the JAX package's
    does); no bucket is negative.  Returns the buckets and the mask."""
    import numpy as np
    from repro_torch.obs import BUCKETS, attribute_lanes
    b, closed = attribute_lanes(result)
    tot = b["work"].copy()
    for name in BUCKETS[1:]:
        tot = tot + b[name]
    mk = result.makespan
    if not (tot[closed] == mk[closed]).all():
        raise AssertionError(f"{what}: a closed lane's buckets do not sum "
                             f"to its makespan")
    if not (np.abs(tot - mk) <= np.spacing(mk)).all():
        raise AssertionError(f"{what}: a lane's buckets sum more than one "
                             f"ulp from its makespan")
    if any((b[name] < 0.0).any() for name in BUCKETS):
        raise AssertionError(f"{what}: a negative bucket")
    log(f"[obs] (a) {what}: {mk.size} lanes, sum(buckets) == makespan on "
        f"{int(closed.sum())}; on {int((~closed).sum())} the closure's fold "
        f"cannot reach the makespan (one ulp either side; attribute_batch "
        f"raises there, as the JAX package's does)")
    return b, closed


def _same_buckets(cuda: tuple, cpu: tuple, cols, what: str) -> None:
    import numpy as np
    (cb, cclosed), (pb, pclosed) = cuda, cpu
    if not (cclosed[cols] == pclosed).all():
        raise AssertionError(f"{what}: CUDA lanes close where the CPU's "
                             f"do not")
    for name, b in pb.items():
        if not (cb[name][cols].view(np.int64) == b.view(np.int64)).all():
            raise AssertionError(f"{what}: CUDA bucket {name} != the CPU's")
    log(f"[obs] (a) {what}: CUDA buckets == CPU buckets on the "
        f"{pb['work'].size} lanes rerun on the CPU")


def _reconcile(means: dict, exp: dict, t: float, platform, with_pred: bool,
               what: str) -> None:
    """tests/test_obs.py:220-266: the expected fractions' own checks, then
    each term's measured mean within max(0.02, 1.5 x expected) and work
    within 0.05."""
    import math
    from repro_torch.core.waste import waste
    from repro_torch.obs import expected_fractions
    ok = math.isclose(sum(exp.values()), 1.0, rel_tol=1e-12)
    if with_pred:
        terms = ("ckpt", "downtime", "recovery", "proactive_ckpt", "re_exec")
        ok = ok and exp["proactive_ckpt"] > 0.0 and exp["re_exec"] \
            < expected_fractions(t, platform)["re_exec"]
    else:
        terms = ("ckpt", "downtime", "recovery", "re_exec")
        ok = ok and exp["ckpt"] == platform.c / t \
            and exp["proactive_ckpt"] == 0.0 \
            and math.isclose(1.0 - exp["work"], waste(t, platform),
                             rel_tol=0.05)
    if not ok:
        raise AssertionError(f"{what}: expected fractions {exp}")
    for b in terms:
        if not abs(means[b] - exp[b]) < max(0.02, 1.5 * exp[b]):
            raise AssertionError(f"{what} {b}: measured {means[b]!r} vs "
                                 f"expected {exp[b]!r}")
    if not abs(means["work"] - exp["work"]) < 0.05:
        raise AssertionError(f"{what} work: measured {means['work']!r} vs "
                             f"expected {exp['work']!r}")


def _log_fractions(what: str, means: dict, exp: dict) -> None:
    from repro_torch.obs import BUCKETS
    log(f"[obs] (a) {what}; bucket: mean measured fraction / expected")
    for name in BUCKETS:
        log(f"[obs]         {name:15s} {means[name]!r} / {exp[name]!r}")


def _obs_attribution(study: dict, main_run: dict, scale: dict) -> tuple:
    """(a): the study pass's and the scale chunk's BatchResults from the
    card, attributed; returns the study pass's buckets and closed lanes."""
    import numpy as np
    from repro_torch.core.prediction import PredictedPlatform, Predictor
    from repro_torch.core.waste import Platform
    from repro_torch.experiments import best_means
    from repro_torch.obs import expected_fractions
    sc, rows, unique = study["sc"], study["rows"], study["unique"]
    res = main_run["result"]
    study_att = _attribute(res, f"study pass ({len(unique)} candidates x "
                                f"{N_TRACES} traces)")
    _same_buckets(study_att,
                  _attribute(main_run["cpu_result"], "study pass, CPU"),
                  np.s_[:, :SUB_TRACES], "study pass")
    b = study_att[0]
    per = best_means(res.makespan, [[j] for j in rows[2]])
    best = rows[2][int(np.argmin(per))]
    for name, ci, with_pred in (("RFO", rows[0][0], False),
                                ("OptimalPrediction", rows[1][0], True),
                                ("BestPeriod(RFO)", best, False)):
        t = float(unique[ci].period)
        exp = expected_fractions(t, sc.platform, sc.pp if with_pred else None)
        means = _bucket_means(b, res.makespan, ci)
        _log_fractions(f"{name} at T = {t!r} s over {N_TRACES} traces",
                       means, exp)
        _reconcile(means, exp, t, sc.platform, with_pred, name)
    log("[obs] (a) RFO, OptimalPrediction and BestPeriod(RFO) reconcile "
        "with expected_fractions at tests/test_obs.py:220-266's bounds")

    sres = scale["result"]
    scale_att = _attribute(sres, f"scale chunk ({BIG_LANES} lanes)")
    _same_buckets(scale_att,
                  _attribute(scale["cpu_result"], "scale chunk, CPU"),
                  np.s_[:, :64], "scale chunk")
    lp = Platform(mu=2500.0, c=60.0, d=10.0, r=30.0)
    _log_fractions(
        "scale chunk at T = 1200 s (trust threshold 100 s, 300 s windows, "
        "T/2mu = 0.24: beyond first order, printed and not held)",
        _bucket_means(scale_att[0], sres.makespan, 0),
        expected_fractions(1200.0, lp,
                           PredictedPlatform(lp, Predictor(0.7, 0.6), 30.0)))
    return study_att


def _obs_replay(study: dict, main_run: dict, attributed: tuple) -> None:
    """(b): record_run replays study lanes through the port's oracle: each
    replay ``==`` the kernel's lane, its event counts ``==`` the lane's
    counters (tests/test_obs.py:137-152), its buckets ``==`` (a)'s where
    the closure reaches the makespan, and attribute_result raises where
    (a) found it does not."""
    import numpy as np
    from repro_torch.obs import attribute_result, record_run
    sc, rows, unique, traces = (study["sc"], study["rows"], study["unique"],
                                study["traces"])
    res = main_run["result"]
    buckets, closed = attributed
    n_events, kinds, n_open = 0, set(), 0
    for ci in (rows[0][0], rows[1][0], rows[2][-1]):
        strat = unique[ci]
        for ti in range(REPLAY_TRACES):
            got, sink = record_run(
                traces[ti], sc.platform, sc.time_base, strat.period,
                cp=sc.cp, trust=strat.trust,
                inexact_window=strat.inexact_window,
                rng=np.random.default_rng(sc.seed + 7919 * ti))
            where = f"replay of lane ({ci}, {ti})"
            if dataclasses.asdict(got) != dataclasses.asdict(
                    res.result(ci, ti)):
                raise AssertionError(f"{where} != the kernel's lane")
            counts = sink.counts()
            want = {"fault": got.n_faults_hit, "rollback": got.n_rollbacks,
                    "prockpt_end": got.n_proactive_ckpts,
                    "ckpt_end": got.n_periodic_ckpts,
                    "prediction": got.n_predictions,
                    "re_exec": got.n_rollbacks, "replan": got.n_replans}
            if any(counts.get(k, 0) != v for k, v in want.items()):
                raise AssertionError(f"{where}: event counts {counts} != "
                                     f"the counters {want}")
            if not closed[ci, ti]:
                try:
                    attribute_result(got)
                except ArithmeticError:
                    n_open += 1
                else:
                    raise AssertionError(f"{where}: the scalar closure "
                                         f"closed where the lanes' did not")
            elif any(attribute_result(got).buckets()[k] != float(b[ci, ti])
                     for k, b in buckets.items()):
                raise AssertionError(f"{where}: buckets != attribute_batch's")
            n_events += len(sink)
            kinds |= set(counts)
    periods = ", ".join(repr(float(unique[ci].period))
                        for ci in (rows[0][0], rows[1][0], rows[2][-1]))
    log(f"[obs] (b) record_run on {3 * REPLAY_TRACES} study lanes (RFO, "
        f"OptimalPrediction and BestPeriod's last grid point, periods "
        f"{periods} s, x the first {REPLAY_TRACES} traces): every "
        f"SimResult field == the kernel's "
        f"lane; {n_events} events of {len(kinds)} kinds, counts == the "
        f"counters; buckets == attribute_lanes' ({n_open} lane(s) that do "
        f"not close raise in attribute_result too)")


def _obs_metrics(workdir: str) -> None:
    """(c): obs_metrics at its size against its record; the Perfetto JSON
    written, read back and checked."""
    from repro_torch.obs import write_trace
    payload, trace = obs_metrics_payload()
    want = {k: v for k, v in _quick_record(OBS_RECORD)["payload"].items()
            if k != "wall_s"}
    got = {k: v for k, v in payload.items() if k != "wall_s"}
    if got != want:
        raise AssertionError(f"obs_metrics: {got} != the record {want}")
    path = os.path.join(workdir, "obs_metrics_fleet.json")
    write_trace(path, trace)
    with open(path, encoding="utf-8") as fh:
        loaded = json.load(fh)
    if loaded != trace:
        raise AssertionError("obs_metrics: the Perfetto JSON read back "
                             "differs")
    n = check_perfetto(loaded, ["job0", "job1"])
    log(f"[obs] (c) obs_metrics: every field but wall_s == record "
        f"{OBS_RECORD} (single: {payload['single']['n_events']} events, "
        f"makespan {payload['single']['makespan']!r}; fleet wait "
        f"{payload['fleet']['wait_total']!r} s; metrics "
        f"{payload['metrics']}); wall_s {payload['wall_s']:.4f} s; "
        f"Perfetto JSON {os.path.getsize(path)} bytes, "
        f"{len(loaded['traceEvents'])} events, {n} slices, well formed")


def _fleet_sweep() -> None:
    """(d): fleet_sweep at its quick size against its record, then at its
    full size with the suite's claim."""
    quick, _ = fleet_sweep_payload(FLEET_QUICK)
    rec = _quick_record(FLEET_RECORD)["payload"]
    for key in ("rows", "contention_s", "model_vs_sim", "metrics"):
        if quick[key] != rec[key]:
            raise AssertionError(f"fleet_sweep quick {key}: {quick[key]} != "
                                 f"the record's {rec[key]}")
    said = fleet_sweep_claims(quick, all_claims=True)
    log(f"[fleet] (d) fleet_sweep at {FLEET_QUICK} traces: rows, "
        f"contention_s, model_vs_sim and metrics == record {FLEET_RECORD}; "
        f"the script's claims hold: " + "; ".join(said))
    full, tables = fleet_sweep_payload(FLEET_FULL)
    for table in tables.values():
        for line in table.format().splitlines():
            log(f"[fleet]   {line}")
    said = fleet_sweep_claims(full, all_claims=False)
    log(f"[fleet] (d) fleet_sweep at {FLEET_FULL} traces: " + "; ".join(said))
    rows = {obj: {r["job"]: r for r in rs}
            for obj, rs in full["rows"].items()}
    pairs = ", ".join(
        f"{job} {rows['waste'][job]['unavailability']!r} (waste plan) / "
        f"{rows['availability'][job]['unavailability']!r} (availability "
        f"plan)" for job in ("llama3.2-1b", "llama3-405b"))
    log(f"[fleet] (d) measured weighted outage: {pairs}; the outage order "
        f"and staggering's 10x are not held at this size, where the JAX "
        f"package's own numbers break them (ROADMAP Queue C); fleet.faults "
        f"{full['metrics'].get('fleet.faults', 0)} (quick: "
        f"{quick['metrics'].get('fleet.faults', 0)})")


def _fleet_degeneracy(study: dict, main_run: dict) -> None:
    """(e): 1-job fleets == the oracle's simulate on the study's first
    traces, field for field, and == the kernel's lanes; then one coupled
    fleet of those jobs on one storage stream (benchmarks/engine_perf.py:
    120-160)."""
    import numpy as np
    from repro_torch.core.simulator import simulate
    from repro_torch.fleet.sim import FleetJobInput, simulate_fleet
    sc, rows, unique, traces = (study["sc"], study["rows"], study["unique"],
                                study["traces"])
    res = main_run["result"]
    for name, ci in (("RFO", rows[0][0]), ("OptimalPrediction", rows[1][0])):
        strat = unique[ci]

        def inp(ti: int) -> FleetJobInput:
            return FleetJobInput(
                trace=traces[ti], platform=sc.platform,
                time_base=sc.time_base, period=strat.period, cp=sc.cp,
                trust=strat.trust, inexact_window=strat.inexact_window,
                rng=np.random.default_rng(sc.seed + 7919 * ti))

        t0 = time.perf_counter()
        oracle = [simulate(traces[ti], sc.platform, sc.time_base,
                           strat.period, cp=sc.cp, trust=strat.trust,
                           inexact_window=strat.inexact_window,
                           rng=np.random.default_rng(sc.seed + 7919 * ti))
                  for ti in range(DEGENERACY_TRACES)]
        t_oracle = time.perf_counter() - t0
        t0 = time.perf_counter()
        solo = [simulate_fleet([inp(ti)]).jobs[0]
                for ti in range(DEGENERACY_TRACES)]
        t_solo = time.perf_counter() - t0
        for ti, (job, want) in enumerate(zip(solo, oracle)):
            if dataclasses.asdict(job.sim) != dataclasses.asdict(want) or (
                    job.time_contention_ckpt, job.time_contention_prockpt,
                    job.time_repair_wait) != (0.0, 0.0, 0.0):
                raise AssertionError(f"{name} trace {ti}: the 1-job fleet "
                                     f"!= simulate")
            if job.sim.makespan != res.makespan[ci, ti]:
                raise AssertionError(f"{name} trace {ti}: the 1-job fleet "
                                     f"!= the kernel's lane")
        t0 = time.perf_counter()
        coupled = simulate_fleet([inp(ti) for ti in range(DEGENERACY_TRACES)],
                                 storage_streams=1)
        t_coupled = time.perf_counter() - t0
        cont = sum(j.time_contention_ckpt + j.time_contention_prockpt
                   for j in coupled.jobs)
        log(f"[fleet] (e) {name}: {DEGENERACY_TRACES} 1-job fleets == "
            f"simulate on every SimResult field and == the kernel's lanes; "
            f"oracle {t_oracle:.4f} s, 1-job fleets {t_solo:.4f} s "
            f"({t_solo / t_oracle:.2f}x); the {DEGENERACY_TRACES} jobs "
            f"coupled on one storage stream {t_coupled:.4f} s, contention "
            f"{cont!r} s, makespan {coupled.makespan!r} s")


def _two_level() -> None:
    """(f): benchmarks/multilevel.py at its full size, with its claim that
    two-level checkpointing beats single-level RFO in every cell."""
    rows = two_level_rows(TWO_LEVEL_TRACES)
    log(f"[two-level] (f) {TWO_LEVEL_TRACES} traces a cell; | N | phi | "
        f"single waste | two-level waste | k* | T1* | sim 2-level | gain % |")
    for r in rows:
        log(f"[two-level]   | {r['N']} | {r['phi']} | {r['w1']!r} | "
            f"{r['w2']!r} | {r['k_star']} | {r['t1_star']} | "
            f"{r['waste_sim']} | {r['gain_pct']} |")
        if not r["w2"] < r["w1"]:
            raise AssertionError(f"two-level: {r}")
    log("[two-level] (f) two-level waste < single-level waste in every "
        "cell (benchmarks/multilevel.py:77)")


def phase_obs_fleet(study: dict, main_run: dict, scale: dict) -> None:
    """6e: observability, the fleet and the two-level model on the card's
    lanes and the port's host modules."""
    smi = _smi()
    t_start = time.perf_counter()
    times = {}
    t0 = time.perf_counter()
    buckets = _obs_attribution(study, main_run, scale)
    times["(a) attribution"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _obs_replay(study, main_run, buckets)
    times["(b) replay"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as workdir:
        t0 = time.perf_counter()
        _obs_metrics(workdir)
        times["(c) obs_metrics"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _fleet_sweep()
    times["(d) fleet_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _fleet_degeneracy(study, main_run)
    times["(e) degeneracy"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _two_level()
    times["(f) two-level"] = time.perf_counter() - t0
    log(f"[obs-fleet] phase 6e on {smi}: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
        + f"; total {time.perf_counter() - t_start:.4f} s")


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
    (1, 130, 130, 4, 2, 64, True, 0, 0), (1, 64, 200, 4, 2, 64, True, 0, 136),
    # head dim 256: recurrentgemma-2b's local attention (10 heads over one
    # kv head, window 2,048) at the families phase's sequence, and uneven
    # tiles, a window, q_offset and no mask.
    (1, 2048, 2048, 10, 1, 256, True, 2048, 0),
    (2, 130, 130, 4, 2, 256, True, 64, 0), (1, 64, 200, 4, 2, 256, True, 0, 136),
    (2, 128, 128, 4, 4, 256, False, 0, 0),
    # head dim 80 (flash only): hubert-xlarge's bidirectional attention at
    # its own heads and frames, uneven tiles, a window and q_offset.
    (2, 128, 128, 4, 4, 80, False, 0, 0), (1, 130, 200, 4, 2, 80, False, 0, 0),
    (1, 2048, 2048, 16, 16, 80, False, 0, 0),
    (2, 130, 130, 4, 2, 80, True, 64, 0), (1, 64, 200, 4, 2, 80, True, 0, 136))
DECODE_CASES = (
    # (b, s, h, kv, hd, window, lengths)
    (2, 256, 8, 2, 64, 0, (200, 200)), (2, 256, 8, 8, 64, 0, (17, 17)),
    (3, 128, 10, 1, 32, 64, (100, 100, 100)), (1, 512, 4, 4, 128, 0, (512,)),
    (2, 128, 4, 2, 64, 128, (40, 40)), (3, 128, 4, 2, 32, 0, (1, 64, 128)),
    (8, 2176, 32, 4, 64, 0, (2176, 2175, 2113, 2049, 2048, 1000, 64, 1)),
    (2, 2176, 32, 4, 64, 0, (2175, 273)),
    # head dim 256, g = 10: recurrentgemma-2b's 2,048-slot ring, wrapped
    # and ragged; a short ring and an append cache.
    (8, 2048, 10, 1, 256, 2048, (2176, 2175, 2113, 2049, 2048, 1000, 64, 1)),
    (3, 128, 10, 1, 256, 64, (100, 1, 128)), (2, 256, 8, 2, 256, 0, (200, 17)))
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


def phase_attention_kernels(errs: dict) -> dict:
    """Both attention kernels against their plain versions on the
    reference's cases and one at the main path's shapes, float32 and
    bfloat16 (head dims 32-256, and 80 for flash); then the head-dim-256
    cases at recurrentgemma-2b's shapes timed (:func:`_time_hd256`)."""
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
    return _time_hd256()


def _time_hd256() -> dict:
    """Both kernels at head dim 256 in bf16 on phase 10's cases at
    recurrentgemma-2b's shapes (10 heads over one kv head): flash at seq
    2,048 with window 2,048, decode over the wrapped, ragged 2,048-slot
    ring (8 such caches in turn, as the model's 8 attention layers, so L2
    is cold); timed beside plain, SDPA and the bound."""
    import torch
    b, sq, skv, h, kv, hd, _, window, _ = FLASH_CASES[11]
    q = _randn((b, sq, h, hd), "bfloat16", 0)
    k = _randn((b, skv, kv, hd), "bfloat16", 1)
    v = _randn((b, skv, kv, hd), "bfloat16", 2)
    flash = _time_flash(q, k, v, window, "at head dim 256 (phase 10's case")
    b, s, h, kv, hd, window, lengths = DECODE_CASES[8]
    n = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    layers = [(_randn((b, 1, h, hd), "bfloat16", 3 + 3 * i),
               _randn((b, s, kv, hd), "bfloat16", 4 + 3 * i),
               _randn((b, s, kv, hd), "bfloat16", 5 + 3 * i), n, window)
              for i in range(8)]
    decode = _time_decode(layers, "head dim 256 (phase 10's case)")
    return {"flash_attention": flash, "decode_attention": decode}


def _serving_setup(dtype: str, arch: str = ARCH, tag: str = "[serve]",
                   prompt: int = PROMPT, n_new: int = NEW_TOKENS,
                   n_layers: int | None = None):
    """The config at its published widths (``n_layers`` cuts the depth),
    random weights from seed 0, ``make_batch``'s prompts and the engine,
    on the card."""
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model import init_params, make_batch
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import flatten
    cfg = dataclasses.replace(get(arch), attn_impl="pallas", dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = make_batch(cfg, InputShape("serve", prompt, SERVE_BATCH,
                                       "prefill"), gen)
    engine = ServingEngine(cfg, params, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    leaves = flatten(params)
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers"
        f"{'' if n_layers is None else f' (cut from {get(arch).n_layers})'}"
        f" {cfg.block_unit}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, experts {cfg.n_experts} (stored "
        f"{max(cfg.n_experts, cfg.pad_experts_to)}) top {cfg.top_k} + "
        f"{cfg.n_shared_experts} shared of {cfg.expert_d_ff}, lru_width "
        f"{cfg.lru_width if 'rec' in cfg.blocks else 0}, window "
        f"{cfg.attn_window if 'local' in cfg.blocks else 0}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, {cfg.dtype}, attn_impl "
        f"{cfg.attn_impl}, attn_layout {cfg.attn_layout}; param_count "
        f"{cfg.param_count()}, stored {sum(t.numel() for t in leaves)} "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} "
        f"GB); batch {SERVE_BATCH}, prompt {prompt}, {n_new} new tokens,"
        f" cache_len {SERVE_CACHE}; built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return cfg, params, batch, engine


def _attn_layers(cfg) -> int:
    """The attention layers of ``cfg``: decode_attention launches a decode
    step, flash_attention launches a forward_train."""
    return sum(kind in ("attn", "local") for kind in cfg.blocks)


class _Routes:
    """While ``on``, each MoE call's expert choices (``moe._top_k``'s
    indices), call by call."""

    def __init__(self):
        self.calls, self.on = [], False

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = moe._top_k

        def recorded(gates, k):
            vals, idx = self._orig(gates, k)
            if self.on:
                self.calls.append(idx.clone())
            return vals, idx

        moe._top_k = recorded
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe
        moe._top_k = self._orig


class _Replay:
    """While ``on``, the MoE layers take the experts recorded in ``calls``
    (a :class:`_Routes` of another run, call for call) instead of their
    own top-k, with the weights of their own gates at those experts.

    The kernel route and the ref route differ by rounding only, but in
    bf16 that rounding tips router choices that nearly tie, a tipped token
    routes otherwise in its later layers, and the difference spreads
    through the cached k and v: two bf16 runs of a 24-layer MoE part after
    some steps whatever their attention (the diagnostic in ``PERF.md``
    §6).  Replaying the kernel route's choices in the ref route
    leaves attention as the only difference.  Each replayed choice is held
    to be a near tie of the ref route's own: ``margin`` is the largest
    (own k-th gate - the smallest replayed gate) / own k-th gate over all
    tokens and calls (0 where the two pick the same), and ``moved`` counts
    the (token, call) pairs whose picks differ."""

    def __init__(self, calls: list):
        self.calls, self.i, self.on = calls, 0, False
        self.margin, self.moved, self.picks = 0.0, 0, 0

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._orig = moe._top_k

        def replayed(gates, k):
            own_vals, own_idx = self._orig(gates, k)
            if not self.on:
                return own_vals, own_idx
            idx = self.calls[self.i]
            self.i += 1
            vals = gates.gather(-1, idx)
            worst = torch.clamp((own_vals[..., -1] - vals.amin(dim=-1))
                                / own_vals[..., -1], min=0.0)
            self.margin = max(self.margin, float(worst.max()))
            self.moved += int((torch.sort(idx, dim=-1).values
                               != torch.sort(own_idx, dim=-1).values)
                              .any(dim=-1).sum())
            self.picks += idx.numel() // k
            return vals, idx

        moe._top_k = replayed
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import moe
        moe._top_k = self._orig
        if exc[0] is None and self.i != len(self.calls):
            raise AssertionError(f"replayed {self.i} of {len(self.calls)} "
                                 f"recorded MoE calls")


# Where the logits are held, a replayed expert choice must be a near tie of
# the ref route's own: its gate within this share of the own k-th largest.
ROUTE_MARGIN = 2e-2


def _profile_decode(engine, batch, n_steps: int = 8,
                    tag: str = "[serve]") -> float:
    """Device busy share over a window of decode steps (profiler), and one
    decode-attention kernel per attention layer per step in it (none
    without attention); returns the busy share."""
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
    log(f"{tag} {n_steps} profiled decode steps: wall {wall * 1e3:.3f} ms "
        f"({wall / n_steps * 1e3:.3f} ms a step), device busy "
        f"{busy * 1e3:.3f} ms ({busy / wall:.3f} of wall), {events} device "
        f"events ({events / n_steps:.1f} a step)")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"{tag}   {dev_us / 1e3:10.3f} ms  {count:6d}x  {key[:70]}")
    decode = [(key, count) for _, key, count in rows if "decode_kernel" in key]
    want = _attn_layers(engine.cfg) * n_steps
    log(f"{tag} decode-attention kernels in the window: "
        f"{sum(c for _, c in decode)} ({want} wanted: one per attention "
        f"layer per step); {[k[:60] for k, _ in decode]}")
    if (len(decode) != 1 or decode[0][1] != want) if want else decode:
        raise AssertionError(f"the profiled decode window holds "
                             f"{decode}, not one decode kernel {want} times")
    return busy / wall


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


# Host-side calls that put one event on the device: the runtime's and the
# driver's kernel launches, and the asynchronous copies and sets.
_DEVICE_WORK_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                      "cudaMemsetAsync")


def _host_launches(prof) -> int:
    """Device work the host asked for in a profile window: the count of
    :data:`_DEVICE_WORK_CALLS` events, which the host side records whole
    even where the device side loses events."""
    from torch.autograd import DeviceType
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == DeviceType.CPU
               and evt.key.startswith(_DEVICE_WORK_CALLS))


def _device_ms(fn, calls: int, runs: int = 3,
               one_event: bool = False) -> tuple[float | None, str]:
    """Device time per call (profiler) and the profile's event counts.

    The busy time of everything ``runs`` runs of ``fn`` put on the device,
    over the ``runs * calls`` calls, where the profile recorded every event
    the host asked for (:func:`_host_launches`).  Where it lost some
    (qwen2-vl-72b's decode calls read below the kernel's bytes bound that
    way, ``PERF.md`` §7): with ``one_event`` (each call launches one kernel
    and nothing else) the mean of the recorded launches is still the time
    of a call; a call of several kernels of unlike lengths has no such
    mean, so the profile is taken again, with three and nine times the
    runs, and after three short profiles the time is None (not measured).
    The counts come back as "recorded R of W device events" and are
    printed beside the times.  A profile that recorded no device event
    (the tracer lost the window) is taken again the same way; three such
    profiles raise."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = None
    for runs in (runs, 3 * runs, 9 * runs):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = _device_rows(prof)
        busy_us = sum(r[0] for r in rows)
        if busy_us <= 0:
            continue
        recorded = sum(r[2] for r in rows)
        wanted = runs * calls if one_event else _host_launches(prof)
        counts = f"recorded {recorded} of {wanted} device events"
        if wanted <= recorded:
            return busy_us / 1e3 / (runs * calls), counts
        if one_event:
            return busy_us / 1e3 / recorded, \
                counts + " (short: per recorded launch)"
    if counts is None:
        raise RuntimeError("the profiler recorded no device time in three "
                           "tries")
    return None, counts + " (short in three profiles: not measured)"


def _time_decode(layers: list, what: str = "the last decode step") -> dict:
    """decode_attention over ``layers``' (q, k cache, v cache, length,
    window) in turn (22 x 17.9 MB of caches at the serving cell, so L2 is
    cold as in a decode step), per call, beside its plain version, SDPA
    and the bytes bound: by CUDA events around back-to-back calls, and as
    device time (profiler), which the result carries.  The kernel takes
    less device time than its wrapper takes on the host, so back-to-back
    calls time the host."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    q, kc, _, n, window = layers[0]
    g = q.shape[2] // kc.shape[2]
    nbytes = da.bytes_moved(q, kc, n, window=window)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # The library call: SDPA over the same caches (head-major views, the
    # kv heads repeated outside the timed call) with the length mask.
    lim = torch.clamp(n, max=window) if window else n
    mask = (torch.arange(kc.shape[1], device="cuda")[None, :]
            < lim[:, None])[:, None, None, :]
    sdpa_in = [(q.transpose(1, 2),
                kc.transpose(1, 2).repeat_interleave(g, dim=1),
                vc.transpose(1, 2).repeat_interleave(g, dim=1))
               for q, kc, vc, _, _ in layers]
    per = len(layers)
    launches = da.decode_attention.launches

    def kernel():
        return [da.decode_attention(q, kc, vc, n, window=w)
                for q, kc, vc, n, w in layers]

    def plain():
        return [da.decode_attention_ref(q, kc, vc, n, window=w)
                for q, kc, vc, n, w in layers]

    def library():
        return [F.scaled_dot_product_attention(*x, attn_mask=mask)
                for x in sdpa_in]

    out = _time_attention(
        f"decode_attention at {what}, over {per} layers' inputs in turn "
        f"(each: q {tuple(q.shape)} {q.dtype}, caches {tuple(kc.shape)}, "
        f"window {window}, length {int(n[0])}), per call, CUDA events",
        kernel, plain, library,
        {"bound_ms": bound_ms, "bound_by": "bytes",
         "note": f"{nbytes} bytes at {HBM_BYTES_PER_S:.3g} B/s"}, 20, 3,
        per_call=per)
    # Where a route's profiles all came up short its device time is not
    # measured, and the CUDA-event time above stays in the result.
    dev, counts, said = {}, {}, []
    for key, fn, what in (("ms", kernel, "kernel"), ("plain_ms", plain,
                                                     "plain"),
                          ("library_ms", library,
                           "scaled_dot_product_attention")):
        ms, counts[key] = _device_ms(fn, per, one_event=key == "ms")
        if ms is None:
            counts[key] += f"; kept: {out[key]:.5f} ms by CUDA events"
            said.append(f"{what} not measured ({counts[key]})")
        else:
            dev[key] = ms
            said.append(f"{what} {ms:.5f} ms ({counts[key]})")
    log(f"[timing] decode_attention, device time per call (profiler): "
        + ", ".join(said) + f"; kernel at {bound_ms / dev['ms']:.4f} of "
        f"the bound")
    da.decode_attention.launches = launches       # timing does not count
    return {**out, **dev, "device_events": counts}


def _time_flash(q, k, v, window: int = 0,
                what: str = "in forward_train (layer 0",
                causal: bool = True) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    ops = fa.flops(tuple(q.shape), k.shape[1], causal=causal, window=window)
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
    g = q.shape[2] // k.shape[2]
    if g > 1:                     # SDPA takes as many kv heads as q heads
        ks, vs = (t.repeat_interleave(g, dim=1) for t in (ks, vs))
    sq, skv = q.shape[1], k.shape[1]
    if window and window < skv:
        pos = torch.arange(skv, device=q.device)
        qp = pos[skv - sq:, None]
        mask = (qp >= pos[None, :]) & (qp - pos[None, :] < window)
        sdpa = dict(attn_mask=mask)
    else:                         # a window of at least Skv cuts nothing
        sdpa = dict(is_causal=causal)
    launches = fa.flash_attention.launches
    out = _time_attention(
        f"flash_attention {what}: q {tuple(q.shape)}, k, v "
        f"{tuple(k.shape)}, {q.dtype}, "
        f"{'causal' if causal else 'bidirectional'}, window {window})",
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
        lambda: fa.flash_attention_ref(q, k, v, causal=causal,
                                       window=window),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, **sdpa),
        bound, 5, 2)
    fa.flash_attention.launches = launches        # timing does not count
    return out


def _generate_checked(cfg, engine, batch, errs: dict,
                      routes: "_Routes | None" = None,
                      n_new: int = NEW_TOKENS) -> tuple:
    """A generate whose decode kernel is held to its plain version on every
    attention layer's inputs at the first and last step (ATTN_TOL of the
    model's dtype) and whose steps' logits are kept (and, with ``routes``,
    the decode steps' MoE routing): (result, step logits, the last step's
    (q, k cache, v cache, length, window) of every attention layer)."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    calls, held, step_logits = [0], [], []
    n_attn = _attn_layers(cfg)
    decode_kernel, decode_step = ops.decode_attention, engine_mod.decode_step

    def checked(q, kc, vc, n, *, window=0, impl="ref"):
        out = decode_kernel(q, kc, vc, n, window=window, impl=impl)
        step, layer = divmod(calls[0], n_attn)
        calls[0] += 1
        if step in (0, n_new - 1):
            errs["decode_attention"] = max(
                errs["decode_attention"], _check_close(
                    out, da.decode_attention_ref(q, kc, vc, n, window=window),
                    ATTN_TOL[cfg.dtype],
                    f"{cfg.dtype} decode step {step} attention layer "
                    f"{layer}"))
            if step == n_new - 1:             # the caches are final
                held.append((q.clone(), kc, vc, n, window))
        return out

    def recorded(*args):
        if routes is not None:
            routes.on = True
        logits, cache = decode_step(*args)
        if routes is not None:
            routes.on = False
        step_logits.append(logits.float())
        return logits, cache

    ops.decode_attention, engine_mod.decode_step = checked, recorded
    try:
        res = engine.generate(batch, n_new)
    finally:
        ops.decode_attention, engine_mod.decode_step = decode_kernel, \
            decode_step
    return res, step_logits, held


def _teacher_forced(cfg, params, batch, tokens, step_logits,
                    routes: "_Routes | None" = None,
                    hold: bool = True) -> float:
    """The "ref" route teacher-forced over the kernel route's ``tokens``:
    every step's logits within LOGIT_RTOL[cfg.dtype] of the largest
    |logit| of the ref route's (printed only unless ``hold``); returns
    the worst share.  With ``routes`` (the kernel route's decode-step MoE
    routing), the ref route replays those expert choices
    (:class:`_Replay`)."""
    import contextlib
    import torch
    from repro_torch.models import transformer as tf
    limit = LOGIT_RTOL[cfg.dtype] if hold else None
    cfg_ref = dataclasses.replace(cfg, attn_impl="ref")
    replay = _Replay(routes.calls) if routes is not None else None
    worst = 0.0
    with torch.no_grad(), (replay or contextlib.nullcontext()):
        logits, cache = tf.prefill(cfg_ref, params, batch,
                                   cache_len=SERVE_CACHE)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        for i in range(tokens.shape[1]):
            if replay is not None:
                replay.on = True
            logits, cache = tf.decode_step(cfg_ref, params, tok, cache)
            if replay is not None:
                replay.on = False
            want_l = logits.float()
            diff = float((step_logits[i] - want_l).abs().max())
            scale = float(want_l.abs().max())
            worst = max(worst, diff / scale)
            if limit is not None and diff > limit * scale:
                raise AssertionError(f"{cfg.dtype} decode step {i}: kernel "
                                     f"route logits off the ref route's by "
                                     f"{diff} (largest |logit| {scale})")
            tok = tokens[:, i]
    log(f"[{cfg.name}] {cfg.dtype}: ref route teacher-forced over the "
        f"{tokens.shape[1]} generated tokens: each step's logits within "
        f"{worst:.3e} of the largest ({_limit_note(cfg, limit)})"
        + _replay_note(replay))
    _check_replay(cfg, replay, limit)
    return worst


def _limit_note(cfg, limit) -> str:
    """How a comparison's share is used.  The families' bf16 comparisons
    are printed, not held: bf16 rounding alone moves their logits past 2e-2
    of the largest, while the decode kernel is within one ulp of plain on
    every layer's inputs (``PERF.md`` §6); each family is held in
    float32 instead (:func:`_family_cell_f32`)."""
    return (f"limit {limit}" if limit is not None else
            f"printed, not held: bf16 rounding through {cfg.n_layers} "
            f"layers; held in float32")


def _replay_note(replay) -> str:
    if replay is None:
        return ""
    return (f"; the kernel route's expert choices replayed: they differ "
            f"from the ref route's own in {replay.moved} of {replay.picks} "
            f"(token, layer) picks, each within {replay.margin:.3e} of its "
            f"own k-th gate")


def _check_replay(cfg, replay, limit) -> None:
    """Where the logits are held, every replayed expert choice must be a
    near tie of the ref route's own (ROUTE_MARGIN)."""
    if replay is not None and limit is not None \
            and replay.margin > ROUTE_MARGIN:
        raise AssertionError(f"{cfg.name}: a replayed expert choice is "
                             f"{replay.margin} off the ref route's own")


def _hold_decode_f32(layers: list, errs: dict) -> float:
    """The decode kernel against its plain version in float32 on every
    attention layer's last-step inputs, at 2e-6; returns the largest
    difference."""
    from repro_torch.kernels import decode_attention as da
    launches, worst = da.decode_attention.launches, 0.0
    for i, (q, kc, vc, n, window) in enumerate(layers):
        qf, kf, vf = q.float(), kc.float(), vc.float()
        worst = max(worst, _check_close(
            da.decode_attention(qf, kf, vf, n, window=window),
            da.decode_attention_ref(qf, kf, vf, n, window=window),
            ATTN_TOL["float32"],
            f"float32 decode, last step, attention layer {i}"))
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
    _check_generated(cfg, res)
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


def _check_generated(cfg, res, n_new: int = NEW_TOKENS) -> None:
    import torch
    if not (res.tokens.shape == (SERVE_BATCH, n_new)
            and bool(torch.isfinite(res.logprobs).all())
            and float(res.logprobs.max()) <= 0.0
            and int(res.tokens.min()) >= 0
            and int(res.tokens.max()) < cfg.vocab_size):
        raise AssertionError(f"{cfg.name} generate: tokens or logprobs out "
                             f"of range")


def _forward_vs_ref(cfg, params, batch, hold: bool = True) -> tuple:
    """forward_train over the prompts through the flash kernel (launches
    counted, the first attention layer's q, k, v and window kept) against
    attn_impl="ref": every token's logits within LOGIT_RTOL[cfg.dtype] of
    the largest, compared a batch row at a time (the logits take 5-8 GB at
    the families' vocabularies).  For MoE the ref route replays the kernel
    route's expert choices (:class:`_Replay`), each within ROUTE_MARGIN of
    its own.  Unless ``hold``, the share is printed only.  Returns
    (launches, (q, k, v, window) or None, (kernel route s, ref route
    s))."""
    import contextlib
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    held, flash_kernel = [], ops.flash_attention

    def capture(q, k, v, **kw):
        if not held:
            held.append((q.clone(), k.clone(), v.clone(), kw["window"]))
        return flash_kernel(q, k, v, **kw)

    routes = _Routes() if cfg.n_experts else None
    fa.flash_attention.launches = 0
    ops.flash_attention = capture
    try:
        with torch.no_grad(), (routes or contextlib.nullcontext()):
            if routes is not None:
                routes.on = True
            t0 = time.perf_counter()
            logits_k, _ = tf.forward_train(cfg, params, batch)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
    finally:
        ops.flash_attention = flash_kernel
    launches = fa.flash_attention.launches
    replay = _Replay(routes.calls) if routes is not None else None
    with torch.no_grad(), (replay or contextlib.nullcontext()):
        if replay is not None:
            replay.on = True
        t0 = time.perf_counter()
        logits_r, _ = tf.forward_train(
            dataclasses.replace(cfg, attn_impl="ref"), params, batch)
        torch.cuda.synchronize()
        fwd_ref_s = time.perf_counter() - t0
    b = logits_r.shape[0]
    with torch.no_grad():
        diff = max(float((logits_k[i].float() - logits_r[i].float())
                         .abs().max()) for i in range(b))
        scale = max(float(logits_r[i].float().abs().max()) for i in range(b))
        finite = all(bool(torch.isfinite(logits_k[i]).all())
                     for i in range(b))
    limit = LOGIT_RTOL[cfg.dtype] if hold else None
    log(f"[{cfg.name}] {cfg.dtype} forward_train over {b} prompts: attn_impl"
        f"=pallas {fwd_s:.4f} s ({launches} flash_attention launches), "
        f"attn_impl=ref {fwd_ref_s:.4f} s; logits differ by {diff} (largest "
        f"|logit| {scale}, {diff / scale:.3e} of it; "
        f"{_limit_note(cfg, limit)})" + _replay_note(replay))
    if launches != _attn_layers(cfg):
        raise AssertionError(f"forward_train launched flash_attention "
                             f"{launches} times, not {_attn_layers(cfg)}")
    if not finite or (limit is not None and diff > limit * scale):
        raise AssertionError(f"{cfg.dtype} forward_train: kernel route "
                             f"logits off the ref route's")
    _check_replay(cfg, replay, limit)
    del logits_k, logits_r
    return launches, (held[0] if held else None), (fwd_s, fwd_ref_s)


def _serve_forward(cfg, params, batch, errs: dict,
                   hold: bool = True) -> dict:
    """forward_train through the flash kernel against attn_impl="ref"
    (:func:`_forward_vs_ref`), then the kernel held to plain on the first
    attention layer's inputs (bf16 and cast to float32; repeat_kv and
    grouped) and timed there."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    launches, inputs, seconds = _forward_vs_ref(cfg, params, batch, hold)
    if inputs is None:
        return {"launches": launches, "timing": None, "seconds": seconds}
    q, k, v, window = inputs
    # attn_layout="grouped": the same layer on its kv heads (g = H / KV),
    # which repeat_kv had expanded to H; the kernel gives the same bits.
    g = cfg.n_heads // cfg.n_kv_heads
    kg, vg = k[:, :, ::g].contiguous(), v[:, :, ::g].contiguous()
    kw = dict(causal=cfg.causal, window=window)
    worst = {}
    for dtype in ("bfloat16", "float32"):
        x = [t.to(getattr(torch, dtype)) for t in (q, k, v, kg, vg)]
        out = fa.flash_attention(*x[:3], **kw)
        out_g = fa.flash_attention(x[0], x[3], x[4], **kw)
        worst[dtype] = max(
            _check_close(out, fa.flash_attention_ref(*x[:3], **kw),
                         ATTN_TOL[dtype],
                         f"flash_attention at full width, {dtype}"),
            _check_close(out_g, fa.flash_attention_ref(x[0], x[3], x[4],
                                                       **kw),
                         ATTN_TOL[dtype],
                         f"flash_attention at full width, grouped, {dtype}"))
        if not torch.equal(out_g, out):
            raise AssertionError(f"flash_attention: grouped != repeat_kv in "
                                 f"{dtype}")
        errs["flash_attention"] = max(errs["flash_attention"], worst[dtype])
        del x, out, out_g
    log(f"[{cfg.name}] flash_attention on the first attention layer's inputs"
        f" (window {window}): kernel == plain to one bf16 ulp in bf16 and "
        f"within 2e-6 cast to float32, with repeat_kv (g = 1) and grouped "
        f"(g = {g}), and the two kernel outputs ==; largest differences "
        f"{worst}")
    fa.flash_attention.launches = launches      # checks do not count
    return {"launches": launches, "seconds": seconds,
            "timing": _time_flash(q, k, v, window,
                                  f"in {cfg.name}'s forward_train (the first "
                                  f"attention layer", cfg.causal)}


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


SERVE_CUDA_CPU = ("llama3.2-1b", "qwen2-moe-a2.7b", "recurrentgemma-2b",
                  "xlstm-125m", "qwen2-vl-72b")


def _reduced_prompts(cfg) -> dict:
    """Phase 13's prompts (3 x 24) on the CPU: numpy tokens, and for the
    VLM ``make_batch``'s patch embeddings (a CPU generator), vision mask
    and (t, h, w) positions."""
    import numpy as np
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model import make_batch
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 24)).astype(np.int32))}
    if cfg.mrope_sections is not None:
        gen = torch.Generator()
        gen.manual_seed(1)
        stub = make_batch(cfg, InputShape("serve", 24, 3, "prefill"), gen)
        batch.update({k: stub[k] for k in ("vision_embeds", "vision_mask",
                                           "positions_thw")})
    return batch


def phase_serving_cuda_cpu() -> None:
    """Reduced configs in float32 (llama3.2-1b, the three families and the
    VLM), served on CUDA (the decode kernel) and on the CPU (its plain
    version) from one set of weights; then the reduced encoder's forward
    and loss (:func:`_encoder_cuda_cpu`)."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServingEngine
    from repro_torch.tree import tree_map

    for arch in SERVE_CUDA_CPU:
        cfg = dataclasses.replace(get(arch).reduced(), dtype="float32",
                                  attn_impl="pallas")
        params = init_params(cfg, seed=0)
        prompts = _reduced_prompts(cfg)
        out = {}
        for device, p in (("cuda", params),
                          ("cpu", tree_map(lambda t: t.cpu(), params))):
            launches = da.decode_attention.launches
            out[device] = ServingEngine(cfg, p, cache_len=48).generate(
                {k: t.to(device) for k, t in prompts.items()}, 8)
            out[device + "_launches"] = da.decode_attention.launches \
                - launches
        gpu, cpu = out["cuda"], out["cpu"]
        same = torch.equal(gpu.tokens.cpu(), cpu.tokens)
        lp = float((gpu.logprobs.cpu() - cpu.logprobs).abs().max())
        log(f"[serve-cuda-cpu] {cfg.name} float32, batch 3, prompt 24, 8 new:"
            f" greedy tokens CUDA == CPU {same}, logprobs differ by "
            f"{lp:.3e}; decode_attention launches cuda "
            f"{out['cuda_launches']}, cpu {out['cpu_launches']}")
        if not same or lp > 1e-4:
            raise AssertionError(f"reduced serving of {cfg.name}: CUDA and "
                                 f"CPU disagree")
        if out["cuda_launches"] != _attn_layers(cfg) * 8 \
                or out["cpu_launches"]:
            raise AssertionError(f"reduced serving of {cfg.name}: the CUDA "
                                 f"run did not go through the decode kernel")
    for head_dim in (None, 80):
        _encoder_cuda_cpu(head_dim)


def _encoder_cuda_cpu(head_dim: int | None) -> None:
    """Reduced hubert-xlarge in float32 (at ``head_dim`` 80 as at full
    size, else the reduced 64): forward_train logits and loss_fn's loss
    with attn_impl="pallas" on CUDA (the flash kernel, one launch per
    layer) against the same on the CPU (its plain version), within 1e-4
    of the largest logit and of the loss."""
    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import (forward_train, init_params,
                                          loss_fn, make_batch)
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get("hubert-xlarge").reduced(),
                              dtype="float32", attn_impl="pallas")
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    gen = torch.Generator()
    gen.manual_seed(1)
    batch = make_batch(cfg, InputShape("t", 24, 3, "train"), gen)
    params = init_params(cfg, seed=0)
    out = {}
    with torch.no_grad():
        for device, p in (("cuda", params),
                          ("cpu", tree_map(lambda t: t.cpu(), params))):
            b = {k: t.to(device) for k, t in batch.items()}
            launches = fa.flash_attention.launches
            logits, _ = forward_train(cfg, p, b)
            loss, _ = loss_fn(cfg, p, b)
            out[device] = (logits.cpu(), float(loss),
                           fa.flash_attention.launches - launches)
    (lg, loss_g, n_g), (lc, loss_c, n_c) = out["cuda"], out["cpu"]
    diff, scale = float((lg - lc).abs().max()), float(lc.abs().max())
    log(f"[serve-cuda-cpu] {cfg.name} float32 (head_dim {cfg.head_dim}, "
        f"bidirectional), 3 x 24 frames: forward_train logits CUDA vs CPU "
        f"differ by {diff:.3e} ({diff / scale:.3e} of the largest), loss "
        f"{loss_g} vs {loss_c}; flash_attention launches cuda {n_g}, cpu "
        f"{n_c}")
    if diff > 1e-4 * scale or abs(loss_g - loss_c) > 1e-4 * abs(loss_c):
        raise AssertionError(f"reduced {cfg.name}: CUDA and CPU disagree")
    if n_g != 2 * _attn_layers(cfg) or n_c:
        raise AssertionError(f"reduced {cfg.name}: the CUDA run did not go "
                             f"through the flash kernel")


# -- the families phase: MoE, the RG-LRU hybrid and xLSTM at full width --------

FAMILY_ARCHS = ("qwen2-moe-a2.7b", "recurrentgemma-2b", "xlstm-125m")
# (prompt, new tokens) of a cell that cannot take phase 11's 2,048 + 128.
# The reference's RG-LRU gate exponent has the wrong sign (ROADMAP Queue C
# R2): log a = -8 r log sigmoid(Lambda) >= 0, so its state grows by up to
# e^0.42 a token and overflows float32 within a few hundred tokens; the
# port copies it.  64 + 32 tokens keep the growth under e^41.
FAMILY_SHAPES = {"recurrentgemma-2b": (64, 32)}


def _step_bytes(cfg, params, length: int) -> tuple[int, int]:
    """Least bytes one decode step moves at ``length`` cached tokens:
    every weight read once (the embedding table's batch rows only, unless
    the head is tied to it), the valid k and v of every attention layer,
    and the recurrent states read and written.  Returns (all of it, the
    routed experts' weights alone)."""
    from repro_torch.tree import flatten, leaf_names
    total = experts = 0
    for name, t in zip(leaf_names(params), flatten(params)):
        nbytes = t.numel() * t.element_size()
        if name == "['embed']" and not cfg.tie_embeddings:
            nbytes = SERVE_BATCH * cfg.d_model * t.element_size()
        total += nbytes
        if "['experts']" in name:
            experts += nbytes
    itemsize = 2 if cfg.dtype == "bfloat16" else 4
    for kind in cfg.blocks:
        if kind in ("attn", "local"):
            rows = min(length, cfg.attn_window) if kind == "local" else length
            total += 2 * SERVE_BATCH * rows * cfg.n_kv_heads * cfg.head_dim \
                * itemsize
        elif kind == "rec":
            total += 2 * SERVE_BATCH * cfg.lru_width \
                * (4 + (cfg.conv1d_width - 1) * itemsize)
        elif kind == "mlstm":
            hd = 2 * cfg.d_model // cfg.n_heads
            total += 2 * SERVE_BATCH * cfg.n_heads * (hd * hd + hd + 1) * 4
        else:
            total += 2 * SERVE_BATCH * 4 * cfg.d_model * 4
    return total, experts


def _prefill_split(cfg, engine, batch) -> dict:
    """One prefill with each block function timed (synchronised before and
    after each call): seconds per function, and the prefill's."""
    import torch
    from repro_torch.models import transformer as tf
    names = ("chunked_attention", "moe_apply", "rglru_block_apply",
             "mlstm_block_apply", "slstm_block_apply")
    orig = {n: getattr(tf, n) for n in names}
    spent = dict.fromkeys(names, 0.0)

    def timed(name):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*args, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    for n in names:
        setattr(tf, n, timed(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(batch)
        torch.cuda.synchronize()
        spent["prefill"] = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(tf, n, orig[n])
    return {k: v for k, v in spent.items() if v}


def _family_cell(arch: str, errs: dict, n_layers: int | None = None
                 ) -> dict:
    """One family at its published widths (``n_layers`` cuts the depth),
    served as the tinyllama cell is (bf16, attn_impl="pallas", batch 8,
    prompt 2,048, 128 new tokens, greedy, cache_len 2,176): timed and
    counted generate, a profiled window, a checked generate with the ref
    route teacher-forced over it, forward_train through the flash kernel
    against the ref route."""
    import torch
    import repro_torch.serve.engine as engine_mod
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    tag = f"[{arch}]"
    prompt, n_new = FAMILY_SHAPES.get(arch, (PROMPT, NEW_TOKENS))
    cfg, params, batch, engine = _serving_setup("bfloat16", arch, tag,
                                                prompt, n_new, n_layers)
    n_attn = _attn_layers(cfg)
    engine.generate(batch, 2)                      # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    split = _prefill_split(cfg, engine, batch)
    log(f"{tag} prefill split (each block function synchronised; its own "
        f"prefill {split['prefill']:.4f} s): "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split.items()
                    if k != "prefill"))

    # The decode steps are timed from the end of the generate's own
    # prefill (synchronised there): the generate's time less a separately
    # timed prefill went negative where prefill varies by more than the
    # decode steps take (xlstm-125m's sLSTM loop).
    prefill_end, model_prefill = [], engine_mod.prefill

    def timed_prefill(*args, **kw):
        out = model_prefill(*args, **kw)
        torch.cuda.synchronize()
        prefill_end.append(time.perf_counter())
        return out

    engine_mod.prefill = timed_prefill
    torch.cuda.reset_peak_memory_stats()
    da.decode_attention.launches = 0
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    try:
        res = engine.generate(batch, n_new)
        torch.cuda.synchronize()
    finally:
        engine_mod.prefill = model_prefill
    gen_s = time.perf_counter() - t0
    launches = da.decode_attention.launches
    flash_in_generate = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    step_ms = (t0 + gen_s - prefill_end[0]) / n_new * 1e3
    step_bytes, expert_bytes = _step_bytes(cfg, params, prompt + n_new)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"{tag} prefill {prefill_s:.4f} s "
        f"({SERVE_BATCH * prompt / prefill_s:.1f} prompt tokens/s); generate "
        f"{gen_s:.4f} s: decode {step_ms:.4f} ms per step, "
        f"{SERVE_BATCH * n_new / gen_s:.1f} generated tokens/s "
        f"(prefill included), {SERVE_BATCH / step_ms * 1e3:.1f} tokens/s in "
        f"decode; peak device memory {peak / 1e9:.3f} GB; decode_attention "
        f"launches {launches}, flash_attention launches {flash_in_generate}")
    log(f"{tag} decode step {step_ms:.4f} ms beside its bytes bound "
        f"{bound_ms:.4f} ms ({step_bytes} B at {HBM_BYTES_PER_S:.3g} B/s at "
        f"the last step's {prompt + n_new} tokens; the routed experts' "
        f"weights {expert_bytes} B of it, "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms): {bound_ms / step_ms:.4f}"
        f" of the bound")
    if launches != n_attn * n_new or flash_in_generate:
        raise AssertionError(f"{cfg.name}: decode_attention launched "
                             f"{launches} times in the generate, not "
                             f"{n_attn * n_new} (flash "
                             f"{flash_in_generate})")
    _check_generated(cfg, res, n_new)
    busy = _profile_decode(engine, batch, tag=tag)

    routes = _Routes() if cfg.n_experts else None
    import contextlib
    with routes or contextlib.nullcontext():
        res2, step_logits, held = _generate_checked(cfg, engine, batch, errs,
                                                    routes, n_new)
        if not torch.equal(res2.tokens, res.tokens):
            raise AssertionError(f"{cfg.name}: the checked generate gave "
                                 f"other tokens")
        if held:
            err32 = _hold_decode_f32(held, errs)
            log(f"{tag} checked generate: decode_attention kernel == plain "
                f"to one bf16 ulp on all {n_attn} attention layers at steps "
                f"1 and {n_new}, and within 2e-6 on the last step's "
                f"inputs cast to float32 (largest difference {err32}); same "
                f"tokens as the counted run")
        _teacher_forced(cfg, params, batch, res.tokens, step_logits, routes,
                        hold=False)
    del step_logits
    decode_timing = _time_decode(held, f"{cfg.name}'s last decode step") \
        if held else None
    flash = _serve_forward(cfg, params, batch, errs, hold=False)
    del engine, params, batch, res, res2, held
    _free_cuda()
    return {"decode_attention": launches, "flash_attention": flash["launches"],
            "decode_timing": decode_timing, "flash_timing": flash["timing"],
            "prefill_s": prefill_s, "step_ms": step_ms,
            "step_bound_ms": bound_ms, "peak_gb": peak / 1e9,
            "busy": busy}


def _family_cell_f32(arch: str, errs: dict,
                     n_layers: int | None = None) -> None:
    """The cell's comparisons in float32, where rounding leaves room for a
    limit that separates a faulty kernel (as phase 12 for tinyllama): the
    checked generate (decode kernel within 2e-6 of plain at the first and
    last step) with the ref route teacher-forced over its tokens, and
    forward_train through the flash kernel over the first two prompts
    (qwen2-moe-a2.7b's float32 weights take 60.6 GB), both within
    LOGIT_RTOL["float32"] of the ref route's largest logit, MoE choices
    replayed."""
    import contextlib
    import torch
    tag = f"[{arch}]"
    prompt, n_new = FAMILY_SHAPES.get(arch, (PROMPT, NEW_TOKENS))
    cfg, params, batch, engine = _serving_setup("float32", arch, tag,
                                                prompt, n_new, n_layers)
    routes = _Routes() if cfg.n_experts else None
    with routes or contextlib.nullcontext():
        res, step_logits, held = _generate_checked(cfg, engine, batch, errs,
                                                   routes, n_new)
        del held
        _check_generated(cfg, res, n_new)
        _teacher_forced(cfg, params, batch, res.tokens, step_logits, routes)
    del step_logits, engine
    _forward_vs_ref(cfg, params, {k: t[:2] for k, t in batch.items()})
    del params, batch, res
    _free_cuda()


def phase_families(errs: dict) -> dict:
    """qwen2-moe-a2.7b, recurrentgemma-2b and xlstm-125m at their published
    widths through the port's serving path (:func:`_family_cell`)."""
    out = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        out[arch] = _family_cell(arch, errs)
        t1 = time.perf_counter()
        _family_cell_f32(arch, errs)
        c = out[arch]
        log(f"[{arch}] on {_smi()}: prefill {c['prefill_s']:.4f} s, decode "
            f"{c['step_ms']:.4f} ms a step (bound {c['step_bound_ms']:.4f} "
            f"ms), peak {c['peak_gb']:.3f} GB, launches decode_attention "
            f"{c['decode_attention']}, flash_attention "
            f"{c['flash_attention']}; cell {t1 - t0:.1f} s in bf16, "
            f"{time.perf_counter() - t1:.1f} s in float32")
    return out


# -- the modalities phase: the M-RoPE VLM and the encoder-only audio model ----

VLM_ARCH, AUDIO_ARCH = "qwen2-vl-72b", "hubert-xlarge"
# qwen2-vl-72b's 80 layers (72.7 B parameters, about 145 GB in bf16) do not
# fit one 80 GB card: its depth is cut, its widths kept (16 layers: 16.53 B
# parameters, 33.1 GB in bf16; 8 layers: 9.51 B, 38.1 GB in float32).
VLM_LAYERS = {"bfloat16": 16, "float32": 8}


def _encoder_cell(dtype: str, errs: dict) -> dict:
    """hubert-xlarge at full size (48 layers, 16 heads of 80,
    bidirectional) on ``make_batch``'s 8 x 2,048 frames: forward_train
    through the flash kernel against the ref route (:func:`_serve_forward`
    in bf16, with the kernel held to plain on layer 0's inputs and timed
    there; :func:`_forward_vs_ref` in float32, held at 1e-4, and the kernel
    held to plain at 2e-6 on layer 0's float32 inputs), then loss_fn's
    masked-prediction loss on both routes (held at 1e-4 of it in
    float32)."""
    import math

    import torch
    from repro_torch.configs import get
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import init_params, loss_fn, make_batch
    from repro_torch.tree import flatten
    tag = f"[{AUDIO_ARCH}]"
    cfg = dataclasses.replace(get(AUDIO_ARCH), attn_impl="pallas",
                              dtype=dtype)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    batch = make_batch(cfg, InputShape("audio", PROMPT, SERVE_BATCH,
                                       "train"), gen)
    torch.cuda.synchronize()
    leaves = flatten(params)
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers {cfg.block_unit}, "
        f"causal {cfg.causal}, embed_inputs {cfg.embed_inputs}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.vocab_size} units, "
        f"{cfg.dtype}; param_count {cfg.param_count()}, stored "
        f"{sum(t.numel() for t in leaves)} "
        f"({sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} "
        f"GB); {SERVE_BATCH} x {PROMPT} frames, "
        f"{float(batch['mask'].float().mean()):.4f} of them masked; built "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    with torch.no_grad():
        tf.forward_train(cfg, params, batch)          # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timing = None
    if dtype == "bfloat16":
        fwd = _serve_forward(cfg, params, batch, errs, hold=False)
        launches, seconds, timing = (fwd["launches"], fwd["seconds"],
                                     fwd["timing"])
    else:
        launches, (q, k, v, _), seconds = _forward_vs_ref(cfg, params, batch)
        err = _check_close(fa.flash_attention(q, k, v, causal=False),
                           fa.flash_attention_ref(q, k, v, causal=False),
                           ATTN_TOL["float32"],
                           "flash_attention on hubert's layer 0, float32")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"{tag} flash_attention on layer 0's float32 inputs: kernel "
            f"within 2e-6 of plain (largest difference {err})")
        fa.flash_attention.launches = launches    # checks do not count
    with torch.no_grad():
        fa.flash_attention.launches = 0
        loss_k = float(loss_fn(cfg, params, batch)[0])
        loss_launches = fa.flash_attention.launches
        loss_r = float(loss_fn(dataclasses.replace(cfg, attn_impl="ref"),
                               params, batch)[0])
    peak = torch.cuda.max_memory_allocated()
    hold = dtype == "float32"
    fwd_s, fwd_ref_s = seconds
    log(f"{tag} {dtype}: forward_train {fwd_s:.4f} s through the kernel "
        f"({SERVE_BATCH * PROMPT / fwd_s:.1f} frames/s), {fwd_ref_s:.4f} s "
        f"through the ref route ({SERVE_BATCH * PROMPT / fwd_ref_s:.1f} "
        f"frames/s); loss_fn {loss_k} (kernel route, {loss_launches} "
        f"flash_attention launches) vs {loss_r} (ref route), "
        f"{abs(loss_k - loss_r) / abs(loss_r):.3e} of it ("
        + ("limit 1e-4" if hold else f"printed, not held: bf16 rounding "
           f"through {cfg.n_layers} layers; held in float32")
        + f"); peak device memory {peak / 1e9:.3f} GB")
    if launches != cfg.n_layers or loss_launches != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: flash_attention launched "
                             f"{launches} / {loss_launches} times in "
                             f"forward_train / loss_fn, not {cfg.n_layers}")
    if not math.isfinite(loss_k) or (
            hold and abs(loss_k - loss_r) > 1e-4 * abs(loss_r)):
        raise AssertionError(f"{cfg.name} {dtype}: kernel route loss "
                             f"{loss_k} off the ref route's {loss_r}")
    del params, batch
    _free_cuda()
    return {"flash_attention": launches, "decode_attention": 0,
            "flash_timing": timing, "forward_s": fwd_s,
            "forward_ref_s": fwd_ref_s, "peak_gb": peak / 1e9}


def phase_modalities(errs: dict) -> dict:
    """qwen2-vl-72b at its published widths, its depth cut to fit the card
    (:data:`VLM_LAYERS`), through the serving path (:func:`_family_cell`,
    then :func:`_family_cell_f32`), and hubert-xlarge at full size through
    forward_train and loss_fn (:func:`_encoder_cell`), bf16 then float32."""
    out = {}
    t0 = time.perf_counter()
    out[VLM_ARCH] = c = _family_cell(VLM_ARCH, errs, VLM_LAYERS["bfloat16"])
    t1 = time.perf_counter()
    _family_cell_f32(VLM_ARCH, errs, VLM_LAYERS["float32"])
    log(f"[{VLM_ARCH}] on {_smi()}: {VLM_LAYERS['bfloat16']} of 80 layers "
        f"in bf16 ({VLM_LAYERS['float32']} in float32): prefill "
        f"{c['prefill_s']:.4f} s, decode {c['step_ms']:.4f} ms a step "
        f"(bound {c['step_bound_ms']:.4f} ms), peak {c['peak_gb']:.3f} GB, "
        f"launches decode_attention {c['decode_attention']}, "
        f"flash_attention {c['flash_attention']}; cell {t1 - t0:.1f} s in "
        f"bf16, {time.perf_counter() - t1:.1f} s in float32")
    t0 = time.perf_counter()
    out[AUDIO_ARCH] = c = _encoder_cell("bfloat16", errs)
    t1 = time.perf_counter()
    f32 = _encoder_cell("float32", errs)
    log(f"[{AUDIO_ARCH}] on {_smi()}: forward_train {c['forward_s']:.4f} s "
        f"(ref route {c['forward_ref_s']:.4f} s) in bf16, "
        f"{f32['forward_s']:.4f} s ({f32['forward_ref_s']:.4f} s) in "
        f"float32; peak {c['peak_gb']:.3f} / {f32['peak_gb']:.3f} GB; "
        f"flash_attention launches {c['flash_attention']} a forward_train; "
        f"cell {t1 - t0:.1f} s in bf16, {time.perf_counter() - t1:.1f} s in "
        f"float32")
    return out


# -- 16. the result store and the examples ------------------------------------

STORE_BUDGET_S = 180.0      # the phase's time budget on the card
# fault_tolerant_training's phase 1 (xLSTM-100M at its full width) takes
# 0.92-1.99 s a train step on the card (H100 80GB HBM3, 700 W), so its
# default 200 steps (302 s) do not fit the budget: its steps are cut, its
# width is not.  Phase 2 keeps the example's 120.
FT_STEPS = {"phase1": 60, "phase2": 120}
RECORD_ID = re.compile(r"^r[0-9a-f]{20} ")


def _store_cli(argv: list[str]) -> tuple[int, str]:
    """``python -m repro_torch.store`` in this process: (exit code, what it
    printed), the output echoed to the log."""
    import contextlib
    import io

    from repro_torch.store.cli import main as store_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = store_main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"[store]   {line}")
    return rc, out


def _hold_store_records(store_dir: str) -> None:
    """(a): each experiment record of the store against the record of the
    same (kind, name) in suites/baselines/quick.json: rows == on the bits
    (R1's row printed, not held), payload ==, identity == but for the
    engine fingerprint, which names this torch and this card."""
    import torch
    from repro_torch.store import ResultStore
    with open(ROOT / "suites" / "baselines" / "quick.json") as fh:
        base = {(r["kind"], r["name"]): r
                for r in json.load(fh)["records"].values()}
    tag = f"torch-{torch.__version__}-cuda-{torch.cuda.get_device_name(0)}|"
    with open(QUICK_TORCH) as fh:
        names = sorted(it["label"] for it in json.load(fh)["items"])
    recs = ResultStore(store_dir).find(kind="experiment")
    if sorted(r.name for r in recs) != names:
        raise AssertionError(f"store records {[r.name for r in recs]}")
    for rec in recs:
        want = base[("experiment", rec.name)]
        got = rec.to_dict()
        drift = []
        for i, (a, b) in enumerate(zip(_rows_bits(got["rows"]),
                                       _rows_bits(want["rows"]))):
            if a != b:
                if (rec.name, _row_key(got["rows"][i])) not in RECORD_DRIFT:
                    raise AssertionError(f"{rec.name}: row {i} {a} != the "
                                         f"record's {b}")
                drift.append((got["rows"][i], want["rows"][i]))
        if len(got["rows"]) != len(want["rows"]):
            raise AssertionError(f"{rec.name}: {len(got['rows'])} rows, the "
                                 f"record {len(want['rows'])}")
        if got["payload"] != want["payload"]:
            raise AssertionError(f"{rec.name}: payload {got['payload']} != "
                                 f"{want['payload']}")
        mine, theirs = dict(got["identity"]), dict(want["identity"])
        if mine.pop("engine_fingerprint") != tag \
                or theirs.pop("engine_fingerprint") != "" or mine != theirs:
            raise AssertionError(f"{rec.name}: identity {got['identity']} "
                                 f"vs {want['identity']}")
        if got["record_id"] == want["record_id"]:
            raise AssertionError(f"{rec.name}: the port's record has the "
                                 f"reference's id")
        log(f"[store] (a) {rec.name}: {len(got['rows'])} rows == the "
            f"baseline's"
            + (f" but R1's row, printed: {drift}" if drift else "")
            + f"; payload == {got['payload']}; identity == but "
            f"engine_fingerprint {tag!r}; record {got['record_id']} (the "
            f"baseline's {want['record_id']}); timings {got['timings']}")


def _load_example(name: str):
    """``examples/<name>.py`` as a module (``examples/`` is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _examples_sim(workdir: str) -> dict:
    """(e), the simulation examples: quickstart (rows == the host oracle),
    predictor_study (its asserts; lane_loop launches), trace_timeline (its
    Perfetto JSON written and read back).  Returns each part's seconds and
    the lane_loop launches."""
    from repro_torch.experiments import run_experiment
    from repro_torch.kernels.event_step import event_step
    from repro_torch.kernels.lane_loop import lane_loop
    out = {}

    qs = _load_example("quickstart_torch")
    t0 = time.perf_counter()
    got = qs.main()
    out["quickstart_s"] = time.perf_counter() - t0
    oracle = run_experiment(got["experiment"], engine="scalar").rows
    if _rows_bits(got["table"].rows) != _rows_bits(oracle):
        raise AssertionError("quickstart: rows on the card != the host "
                             "oracle's")
    launches = lane_loop.launches
    log(f"[examples] quickstart: {out['quickstart_s']:.2f} s, "
        f"{launches} lane_loop launches; its {len(oracle)} rows == "
        f"engine='scalar' (the host oracle); trainer "
        f"{got['stats'].n_steps} steps, {got['stats'].n_faults} faults, "
        f"{got['stats'].n_proactive} proactive saves")

    ps = _load_example("predictor_study_torch")
    t0 = time.perf_counter()
    got = ps.main()             # its asserts hold or it raises
    out["predictor_study_s"] = time.perf_counter() - t0
    if lane_loop.launches == launches:
        raise AssertionError("predictor_study launched no lane_loop kernel")
    log(f"[examples] predictor_study: {out['predictor_study_s']:.2f} s, "
        f"{lane_loop.launches - launches} lane_loop launches; makespans "
        f"(days) {[m / 86400 for m in got['adaptive']['makespans']]}; "
        f"re-plans {got['adaptive']['batch'].n_replans.tolist()}")

    tt = _load_example("trace_timeline_torch")
    path = os.path.join(workdir, "trace_timeline.json")
    t0 = time.perf_counter()
    got = tt.main(path)
    out["trace_timeline_s"] = time.perf_counter() - t0
    with open(path) as fh:
        n = check_perfetto(json.load(fh), [j.name for j in got["fleet"].jobs])
    log(f"[examples] trace_timeline: {out['trace_timeline_s']:.2f} s, "
        f"{os.path.getsize(path)} bytes of Perfetto JSON read back, {n} "
        f"slices")
    if event_step.launches:
        raise AssertionError(f"the examples launched event_step "
                             f"{event_step.launches} times")
    out["lane_loop_launches"] = lane_loop.launches
    return out


def _hold_delta_save(mgr, state, info) -> int:
    """A proactive save's stored (q, scales) == quantize_delta_ref on the
    same CUDA leaves against the manager's base, on the bits.  Returns the
    leaves held."""
    import numpy as np
    import torch
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.tree import flatten
    if info.kind != "proactive":
        return 0
    leaves = [t.detach() for t in flatten(state)]
    base = mgr._last_full_state
    held = 0
    with np.load(info.path, allow_pickle=False) as z:
        for i, cur in enumerate(leaves):
            if f"q_{i}" not in z:
                continue
            rq, rs = cd.quantize_delta_ref(cur, base[i], block=mgr.block)
            q = torch.from_numpy(z[f"q_{i}"]).to(cur.device)
            sc = torch.from_numpy(z[f"s_{i}"]).to(cur.device)
            if not (torch.equal(q, rq) and _bits_equal(sc, rs)):
                raise AssertionError(f"proactive save at step {info.step}: "
                                     f"leaf {i} {tuple(cur.shape)} != "
                                     f"quantize_delta_ref")
            held += 1
    return held


def _hold_delta_restore(mgr, like, step: int, restored) -> int:
    """A delta restore's leaves == dequantize_delta_ref of the stored
    (q, scales) over the same base leaves on the card, on the bits.
    Returns the leaves held."""
    import numpy as np
    import torch
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.tree import flatten
    got = flatten(restored)
    held = 0
    with np.load(mgr._delta_path(step), allow_pickle=False) as z:
        base = flatten(mgr._restore_full(like, int(z["__base__"])))
        for i, b in enumerate(base):
            if f"q_{i}" not in z:
                continue
            q = torch.from_numpy(z[f"q_{i}"]).to(b.device)
            sc = torch.from_numpy(z[f"s_{i}"]).to(b.device)
            want = cd.dequantize_delta_ref(q, sc, b, block=mgr.block)
            if not _bits_equal(got[i], want.to(b.dtype)):
                raise AssertionError(f"delta restore of step {step}: leaf "
                                     f"{i} {tuple(b.shape)} != "
                                     f"dequantize_delta_ref")
            held += 1
    return held


def _examples_models() -> dict:
    """(e), the model examples: serving (its determinism checks) and
    fault_tolerant_training's phases 1 and 2 (the loss and waste asserts;
    the ckpt_delta kernels launched where a proactive save and a delta
    restore happened, every such save's and restore's leaves held to the
    plain versions on the bits; the xLSTM-100M step time)."""
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.train import FaultTolerantTrainer
    out = {}

    sv = _load_example("serving_torch")
    t0 = time.perf_counter()
    got = sv.main()
    out["serving_s"] = time.perf_counter() - t0
    if not all(r["sampled_differs"] for r in got.values()):
        raise AssertionError("serving: a sampled run == the greedy one")
    log(f"[examples] serving: {out['serving_s']:.2f} s; greedy decoding "
        f"deterministic and sampling differs for {list(got)}")
    _free_cuda()

    ft = _load_example("fault_tolerant_training_torch")
    seen = {"proactive": 0, "delta_restores": 0, "step_s": [],
            "held_q": 0, "held_dq": 0}
    real = (CheckpointManager.save_proactive,
            CheckpointManager._restore_delta, FaultTolerantTrainer._do_step)

    def save_proactive(self, step, state):
        seen["proactive"] += 1
        info = real[0](self, step, state)
        seen["held_q"] += _hold_delta_save(self, state, info)
        return info

    def restore_delta(self, like, step):
        seen["delta_restores"] += 1
        out = real[1](self, like, step)
        seen["held_dq"] += _hold_delta_restore(self, like, step, out)
        return out

    def do_step(self, stats):
        t0 = time.perf_counter()
        m = real[2](self, stats)
        torch.cuda.synchronize()
        seen["step_s"].append(time.perf_counter() - t0)
        return m

    CheckpointManager.save_proactive = save_proactive
    CheckpointManager._restore_delta = restore_delta
    FaultTolerantTrainer._do_step = do_step
    try:
        for phase, run in (("phase1", ft.phase1), ("phase2", ft.phase2)):
            steps = FT_STEPS[phase]
            seen.update(proactive=0, delta_restores=0, step_s=[],
                        held_q=0, held_dq=0)
            cd.quantize_delta.launches = 0
            cd.dequantize_delta.launches = 0
            t0 = time.perf_counter()
            got = run(steps)     # the loss / waste asserts hold or it raises
            out[f"{phase}_s"] = time.perf_counter() - t0
            q, dq = cd.quantize_delta.launches, cd.dequantize_delta.launches
            out[f"{phase}_launches"] = {"quantize_delta": q,
                                        "dequantize_delta": dq}
            if (seen["proactive"] > 0) != (q > 0) \
                    or (seen["delta_restores"] > 0) != (dq > 0) \
                    or (seen["held_q"], seen["held_dq"]) != (q, dq):
                raise AssertionError(
                    f"fault_tolerant_training {phase}: "
                    f"{seen['proactive']} proactive saves with {q} "
                    f"quantize_delta launches ({seen['held_q']} leaves held "
                    f"to plain), {seen['delta_restores']} delta restores "
                    f"with {dq} dequantize_delta launches "
                    f"({seen['held_dq']} held)")
            steps_s = sorted(seen["step_s"])
            med_ms = steps_s[len(steps_s) // 2] * 1e3
            if phase == "phase1":
                out["xlstm_step_ms"] = med_ms
                stats = got["stats"]
                what = (f"{got['cfg'].name} ({got['cfg'].param_count()} "
                        f"parameters), loss {got['first_loss']:.4f} -> "
                        f"{stats.final_loss:.4f}, {stats.n_faults} faults, "
                        f"{stats.n_proactive} proactive saves")
            else:
                what = ", ".join(f"{k} waste {v.waste:.4f} ({v.n_faults} "
                                 f"faults, {v.n_proactive} proactive)"
                                 for k, v in got.items())
            log(f"[examples] fault_tolerant_training {phase}: {steps} "
                f"steps in {out[f'{phase}_s']:.2f} s; {what}; "
                f"{len(steps_s)} train steps, median {med_ms:.3f} ms a step "
                f"(min {steps_s[0] * 1e3:.3f}, max {steps_s[-1] * 1e3:.3f}); "
                f"{seen['proactive']} proactive saves -> {q} quantize_delta "
                f"launches, {seen['delta_restores']} delta restores -> {dq} "
                f"dequantize_delta launches; every launch's leaf == the "
                f"plain version on the bits (q, scales and restored leaves)")
    finally:
        (CheckpointManager.save_proactive, CheckpointManager._restore_delta,
         FaultTolerantTrainer._do_step) = real
    if not (out["phase1_launches"]["quantize_delta"]
            + out["phase2_launches"]["quantize_delta"]):
        raise AssertionError("fault_tolerant_training made no proactive "
                             "save: the quantize_delta kernel never ran")
    _free_cuda()
    return out


def _check_dispatchers() -> None:
    """(f): ops.quantize_delta / dequantize_delta with impl="pallas" (the
    kernels) == impl="ref" (the plain versions) on CUDA leaves; these
    launches do not count."""
    import torch
    from repro_torch.kernels import ckpt_delta as cd
    from repro_torch.kernels import ops
    counts = cd.quantize_delta.launches, cd.dequantize_delta.launches
    for shape, dtype in (((1000, 37), "float32"), ((4096, 16), "bfloat16")):
        base = _randn(shape, dtype, 21)
        cur = base + (0.01 * _randn(shape, "float32", 22)).to(base.dtype)
        q, s = ops.quantize_delta(cur, base, impl="pallas")
        rq, rs = ops.quantize_delta(cur, base, impl="ref")
        out = ops.dequantize_delta(q, s, base, impl="pallas")
        ref = ops.dequantize_delta(rq, rs, base, impl="ref")
        if not (torch.equal(q, rq) and _bits_equal(s, rs)
                and _bits_equal(out, ref)):
            raise AssertionError(f"ops dispatchers at {shape} {dtype}: "
                                 f"impl='pallas' != impl='ref'")
    if (cd.quantize_delta.launches - counts[0],
            cd.dequantize_delta.launches - counts[1]) != (2, 2):
        raise AssertionError("ops dispatchers did not launch the kernels")
    cd.quantize_delta.launches, cd.dequantize_delta.launches = counts
    log("[store] (f) ops.quantize_delta / ops.dequantize_delta "
        "impl='pallas' (the CUDA kernels) == impl='ref' on the bits at "
        "(1000, 37) float32 and (4096, 16) bfloat16")


def phase_store_examples() -> dict:
    """Phase 16: the result store on the card, then the examples."""
    import torch
    from repro_torch.kernels.event_step import event_step
    from repro_torch.kernels.lane_loop import lane_loop
    t_start = time.perf_counter()
    smi = _smi()
    out = {}
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        bundle = os.path.join(store, "bundle.json")
        # (a) the main path of this phase: counts at 0 just before, read
        # just after.
        lane_loop.launches = 0
        event_step.launches = 0
        t0 = time.perf_counter()
        rc, text = _store_cli(["--store", store, "run", str(QUICK_TORCH),
                               "--update-baseline", bundle])
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        out["launches"] = lane_loop.launches
        if rc != 0 or "FAILED" in text or "0 from store, OK" not in text:
            raise AssertionError(f"store run: rc {rc}")
        if out["launches"] < 1 or event_step.launches != 0:
            raise AssertionError(f"store run: {out['launches']} lane_loop, "
                                 f"{event_step.launches} event_step "
                                 f"launches")
        log(f"[store] (a) run {QUICK_TORCH.name} on CUDA: rc 0, every "
            f"claim holds, {out['launches']} lane_loop launches, 0 "
            f"event_step launches, {out['run_s']:.2f} s")
        _hold_store_records(store)

        # (b) resume from the store and gate against (a)'s bundle.
        lane_loop.launches = 0
        t0 = time.perf_counter()
        rc, text = _store_cli(["--store", store, "run", str(QUICK_TORCH),
                               "--require-cached", "--gate", bundle])
        out["resume_s"] = time.perf_counter() - t0
        if rc != 0 or "5 items, 5 from store" not in text \
                or "gate: no divergence" not in text or lane_loop.launches:
            raise AssertionError(f"store resume: rc {rc}, "
                                 f"{lane_loop.launches} launches")
        log(f"[store] (b) resumed: rc 0, 5 of 5 items from the store, 0 "
            f"lane_loop launches, the gate finds no divergence, "
            f"{out['resume_s']:.2f} s")

        # (c) an injected regression (.github/workflows/ci.yml:57-72).
        with open(bundle) as fh:
            bad = json.load(fh)
        rec = next(r for r in bad["records"].values()
                   if r["name"] == "table2")
        rec["rows"][0]["period"] *= 1.5
        bad_path = os.path.join(store, "bundle_regressed.json")
        with open(bad_path, "w") as fh:
            json.dump(bad, fh)
        rc, text = _store_cli(["--store", store, "diff", bad_path])
        if rc != 1 or "period" not in text:
            raise AssertionError(f"diff on the regressed bundle: rc {rc}")
        log("[store] (c) table2's first period x 1.5 in a copy of the "
            "bundle: diff exits 1 and names it")

        # (d) the CLI as a process.
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.store", "--store", store,
             "list"], capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        listed = [ln for ln in proc.stdout.splitlines()
                  if RECORD_ID.match(ln)]
        if proc.returncode != 0 or len(listed) != 6:
            raise AssertionError(f"store list: rc {proc.returncode}, "
                                 f"{proc.stdout}{proc.stderr}")
        log(f"[store] (d) python -m repro_torch.store list: rc 0, "
            f"{len(listed)} records (5 items and the suite record)")
        out["store_s"] = time.perf_counter() - t_start

        # (e) the examples on the card, each through its own entry point.
        lane_loop.launches = 0
        event_step.launches = 0
        out.update(_examples_sim(store))
        out.update(_examples_models())
        # (f) the dispatchers.
        _check_dispatchers()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_start
    parts = ", ".join(f"{k} {v:.2f}" for k, v in out.items()
                      if k.endswith("_s"))
    log(f"[store] phase 16 on {smi}: {out['phase_s']:.1f} s (budget "
        f"{STORE_BUDGET_S:.0f} s); seconds: {parts}; xLSTM-100M train step "
        f"{out['xlstm_step_ms']:.3f} ms (median)")
    if out["phase_s"] > STORE_BUDGET_S:
        raise AssertionError(f"phase 16 took {out['phase_s']:.1f} s, past "
                             f"its {STORE_BUDGET_S:.0f} s budget")
    return out


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--exec-rows-cpu":
        _cpu_exec_rows(sys.argv[2], int(sys.argv[3]))
        return 0
    t_start = time.perf_counter()
    device = phase_device()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rows_") as rows_dir:
        children = start_cpu_rows(rows_dir)
        try:
            return _main(t_start, device, children)
        finally:
            for proc, _ in children:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _main(t_start: float, device: dict, children: list) -> int:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    study = study_setup()
    phase_kernel((300, 4800, study["n_lanes"], BIG_LANES))
    loop_check = phase_lane_loop(study)
    adaptive = phase_adaptive(study)
    main_run = phase_main(study)
    scale = phase_scale()
    phase_timing(study["n_lanes"])
    loop_timing = phase_loop_timing(loop_check)
    log(f"[done] study phases {time.perf_counter() - t_start:.1f} s")
    predictor = phase_predictor_study()
    phase_convergence()
    phase_overflow()
    experiments = phase_experiments()
    phase_obs_fleet(study, main_run, scale)
    log(f"[done] simulation phases {time.perf_counter() - t_start:.1f} s")
    errs = {"quantize_delta": 0.0, "dequantize_delta": 0.0}
    phase_ckpt_kernels(errs)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        trainer = phase_trainer(root, errs)
        phase_trainer_cuda_cpu(root)
    log(f"[done] trainer phases {time.perf_counter() - t_start:.1f} s")
    _free_cuda()        # the trainers' hook cycles still hold device state
    errs.update(flash_attention=0.0, decode_attention=0.0)
    hd256 = phase_attention_kernels(errs)
    serving = phase_serving(errs)
    phase_serving_f32(errs)
    phase_serving_cuda_cpu()
    log(f"[done] serving phases {time.perf_counter() - t_start:.1f} s")
    families = phase_families(errs)
    log(f"[done] families phase {time.perf_counter() - t_start:.1f} s")
    modalities = phase_modalities(errs)
    log(f"[done] modalities phase {time.perf_counter() - t_start:.1f} s")
    _free_cuda()
    store = phase_store_examples()
    log(f"[done] store and examples phase "
        f"{time.perf_counter() - t_start:.1f} s")
    finish_cpu_rows(children, experiments["cuda_rows"])
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
        "predictor_study_launches": predictor["launches"],
        "experiments_launches": experiments["launches"],
        "experiments_max_abs_err": experiments["max_abs_err"],
        "store_launches": store["launches"],
        "examples_launches": store["lane_loop_launches"]}]
    for name, replaces in (("quantize_delta",
                            "src/repro/kernels/ckpt_delta.py:54"),
                           ("dequantize_delta",
                            "src/repro/kernels/ckpt_delta.py:90")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ckpt_delta.cu",
            "replaces": replaces, "launches": trainer["launches"][name],
            "max_abs_err": errs[name], **trainer["timing"][name],
            "library_ms": None,
            "examples_launches": {p: store[f"{p}_launches"][name]
                                  for p in ("phase1", "phase2")}})
    for name, replaces in (("flash_attention",
                            "src/repro/kernels/flash_attention.py:81"),
                           ("decode_attention",
                            "src/repro/kernels/decode_attention.py:72")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": serving["launches"][name],
            "max_abs_err": errs[name], **serving["timing"][name],
            "families_launches": {a: c[name] for a, c in
                                  {**families, **modalities}.items()},
            "hd256": hd256[name],
            **{key: cells[arch][
                "decode_timing" if name == "decode_attention"
                else "flash_timing"]
               for key, arch, cells in (
                   ("recurrentgemma_2b", "recurrentgemma-2b", families),
                   ("qwen2_moe_a2_7b", "qwen2-moe-a2.7b", families),
                   ("qwen2_vl_72b", VLM_ARCH, modalities))},
            **({"hubert_xlarge": modalities[AUDIO_ARCH]["flash_timing"]}
               if name == "flash_attention" else {})})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
