"""The benchmark's harness: finds a cell by name, runs it, reports it.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``:

* ``portbench/workloads/<cell>.json``: the cell's configuration, its
  driver ``kind``, its traffic parameters, its chips and why it exists;
* ``portbench/configs/<config>.json``: the deployment (the file that
  ``BENCHMARK.json``'s configuration names);
* ``portbench/drivers/<kind>.py``: how a cell of that kind sets up, what
  one unit of work (a pass) is, and how its outputs are checked;
* ``portbench/metrics/<metric>.py``: one metric, ``read(rec)`` over the
  run's records, returning a number or ``None`` when it finds nothing.
  A quantity split by cells (``lanes_per_s.long``, ``lanes_per_s.short``)
  shares the quantity's reader (``lanes_per_s.py``).

A run sets up, runs passes back to back for ``seconds`` (one client, a
closed loop), then checks what the passes produced against the plain
reference, and prints one JSON line.  With ``trace`` the window runs
under ``torch.profiler`` and the line carries the per-layer metrics.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Top-level module names that may not be loaded in a run: JAX, flax, the
# JAX package and the JAX package's old benchmarks.
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PASS_SPAN = "portbench.pass"
# Prefixes of the labels that the harness and the drivers record.
LABEL_PREFIXES = ("portbench.", "study.")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict           # the cell's entry in BENCHMARK.json
    spec: dict            # portbench/workloads/<cell>.json
    cfg: dict             # the configuration's file
    driver: object
    metrics: dict         # {"end_to_end": [...], "per_layer": [...]}
    readers: dict         # metric name -> reader module


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _metrics_of(bench: dict, name: str) -> dict:
    """The cell's end-to-end metrics and the per-layer metrics it reports."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def reader_path(pb: Path, name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    the quantity it splits (``lanes_per_s.long`` -> ``lanes_per_s.py``)."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        path = pb / "metrics" / (".".join(parts[:k]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{pb / 'metrics'}")


def load_cell(root: Path, name: str) -> Cell:
    """Cell ``name`` of the benchmark at checkout ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    entry = entries[0]
    pb = root / "portbench"
    spec = json.loads((pb / "workloads" / f"{name}.json").read_text())
    for key in ("config", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"cell {name}: {key} {spec[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    if spec["traffic"]["name"] != entry["traffic"]:
        raise ValueError(f"cell {name}: traffic {spec['traffic']['name']!r} "
                         f"in its file, {entry['traffic']!r} in "
                         f"BENCHMARK.json")
    conf = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if len(conf) != 1:
        raise KeyError(f"no configuration {entry['config']!r}")
    cfg = json.loads((root / conf[0]["file"]).read_text())
    driver = load_module(pb / "drivers" / f"{spec['kind']}.py",
                         f"portbench_driver_{spec['kind']}")
    metrics = _metrics_of(bench, name)
    readers = {m["name"]: load_module(reader_path(pb, m["name"]),
                                      f"portbench_metric_{m['name']}")
               for group in metrics.values() for m in group}
    return Cell(name, entry, spec, cfg, driver, metrics, readers)


# ---------------------------------------------------------------------------
# The profiler's timeline
# ---------------------------------------------------------------------------

def _event_times(e) -> tuple[float, float]:
    """(start, end) seconds of a kineto event."""
    if hasattr(e, "start_ns"):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def timeline(prof) -> tuple[list, list]:
    """(device events, host events) of a profile, each ``(name, start_s,
    end_s)``: kernels, copies and sets on the card; operators, runtime
    calls and labelled ranges on the host."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = _event_times(e)
        on_card = "CUDA" in str(e.device_type())
        if on_card and (getattr(e, "is_user_annotation", lambda: False)()
                        or e.name().startswith(LABEL_PREFIXES)):
            continue    # a host label drawn on the card's timeline
        (dev if on_card else host).append((e.name(), s, t))
    return dev, host


def _merge(intervals: list) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def clip(events: list, lo: float, hi: float) -> list:
    """Events cut to the window [lo, hi]; those outside it dropped."""
    return [(n, max(s, lo), min(t, hi)) for n, s, t in events
            if t > lo and s < hi]


def busy_seconds(events: list) -> float:
    """Seconds in which at least one of ``events`` ran."""
    return sum(t - s for s, t in _merge([(s, t) for _, s, t in events]))


def breakdown(dev: list, host: list, lo: float, hi: float) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the card named by the innermost host event around each."""
    by_name: dict = {}
    for n, s, t in dev:
        by_name[n] = by_name.get(n, 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = _merge([(s, t) for _, s, t in dev])
    gaps, last = [], lo
    for s, t in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if hi > last:
        gaps.append((last, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, t in gaps:
        mid = 0.5 * (s + t)
        around = [(te - ts, n) for n, ts, te in host if ts <= mid <= te]
        named.append([min(around)[1] if around else "host (untraced)",
                      t - s])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is banned, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def card(device: str) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _sync(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, the check;
    returns the result line's object, ``checks`` last."""
    import torch
    from repro_torch.obs.metrics import MetricsRegistry, set_registry
    drv = cell.driver
    state = drv.setup(cell.cfg, cell.spec["traffic"], seed, device)
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    reg = MetricsRegistry()
    prev = set_registry(reg)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    outs, pass_s = [], []
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    try:
        while True:
            req = drv.request(state, len(outs))
            a = time.perf_counter()
            with torch.profiler.record_function(PASS_SPAN):
                out = drv.run_pass(state, req)
            b = time.perf_counter()
            outs.append(out)
            pass_s.append(b - a)
            if b - t0 >= seconds:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        set_registry(prev)
    window_s = b - t0
    device_info = card(device)

    rec = {"setup_s": setup_s, "window_s": window_s, "pass_s": pass_s,
           "passes": len(outs), "units": sum(drv.units(state, o)
                                             for o in outs),
           "timers": dict(reg.timers), "counters": dict(reg.counters),
           "least_s": None, "device_events": None, "trace_window_s": None}
    bd = None
    if trace:
        dev, host = timeline(prof)
        spans = [(s, t) for n, s, t in host if n == PASS_SPAN]
        lo, hi = min(s for s, _ in spans), max(t for _, t in spans)
        dev = clip(dev, lo, hi)
        rec["device_events"] = dev
        rec["trace_window_s"] = hi - lo
        rec["least_s"] = [drv.least_seconds(state, o) for o in outs]
        device_info["busy_s"] = busy_seconds(dev)
        device_info["window_s"] = hi - lo
        bd = breakdown(dev, clip(host, lo, hi), lo, hi)
        del prof, host

    group = cell.metrics["per_layer" if trace else "end_to_end"]
    metrics = {}
    for m in group:
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    checks, info = drv.check(state, outs)
    info["check_s"] = time.perf_counter() - t_check
    from portbench.reference.judge import correct
    ok = correct(checks)
    out = {"correct": ok, "attempted": len(outs),
           "failed": len(info["passes_off"]) if not ok else 0,
           "metrics": metrics, "device": device_info}
    if bd is not None:
        out["breakdown"] = bd
    out["card"] = power_limit() if device_info["platform"] == "gpu" else ""
    info["pass_ms"] = [float(np.percentile(pass_s, q)) * 1e3
                       for q in (0, 50, 100)]
    info["counters"] = rec["counters"]
    out["info"] = {k: v for k, v in info.items() if k != "passes_off"}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
