"""Chrome/Perfetto ``trace_event`` JSON timelines of simulated runs.

Converts a :class:`repro_torch.obs.trace.RecordingSink` event stream (or one
stream per fleet job) into the Trace Event Format that
https://ui.perfetto.dev and ``chrome://tracing`` load directly: phases
as complete slices (``ph: "X"``), faults / predictions / decisions as
instants (``ph: "i"``), one process per run and one thread track per
lane or fleet job.

Time base: **1 trace microsecond == 1 simulated second** (``ts`` values
are simulated seconds written verbatim), so durations in the UI read
directly as simulated seconds.

The port's own copy of ``repro/obs/perfetto.py``: the JSON it writes is
the JAX package's, byte for byte, for the same event streams.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Sequence

__all__ = ["events_to_trace_events", "fleet_to_perfetto", "write_trace"]

# Slice-shaped kinds: (start-kind, end-kind, slice name).  The end event
# carries the nominal duration, but pairing start -> end keeps stretched
# or interrupted phases honest in the timeline.
_SLICES = (
    ("ckpt_start", "ckpt_end", "ckpt"),
    ("prockpt_start", "prockpt_end", "proactive_ckpt"),
    ("verify_start", "verify_end", "verify"),
    ("down_start", "recover_start", "downtime"),
    ("recover_start", "recover_end", "recovery"),
)
_INSTANTS = {"fault", "rollback", "re_exec", "prediction", "trust",
             "replan", "silent_detect"}


def _num(v: Any) -> Any:
    return float(v) if isinstance(v, (int, float)) else v


def events_to_trace_events(events: Iterable, *, pid: int = 1,
                           tid: int = 1) -> list[dict]:
    """Lower one event stream to a list of ``traceEvents`` dicts."""
    evs = list(events)
    out: list[dict] = []
    for start_kind, end_kind, name in _SLICES:
        open_t: float | None = None
        for e in evs:
            if e.kind == start_kind:
                open_t = e.t
            elif e.kind == end_kind and open_t is not None:
                out.append({"name": name, "ph": "X", "pid": pid,
                            "tid": tid, "ts": open_t,
                            "dur": e.t - open_t, "cat": "phase"})
                open_t = None
        # A phase interrupted by the end of the run (or a fault with no
        # recorded closer) still gets its nominal duration.
        if open_t is not None:
            nominal = next((e.dur for e in evs
                            if e.kind == end_kind and e.dur > 0.0), 0.0)
            out.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                        "ts": open_t, "dur": nominal, "cat": "phase"})
    for e in evs:
        if e.kind in _INSTANTS:
            out.append({"name": e.kind, "ph": "i", "pid": pid, "tid": tid,
                        "ts": e.t, "s": "t", "cat": "event",
                        "args": {k: _num(v) for k, v in e.args.items()}})
    out.sort(key=lambda d: (d["ts"], d["ph"] != "X"))
    return out


def _meta(pid: int, tid: int | None, name: str) -> dict:
    ev = {"name": "process_name" if tid is None else "thread_name",
          "ph": "M", "pid": pid, "args": {"name": name}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def fleet_to_perfetto(job_streams: Sequence[tuple[str, Iterable]],
                      *, title: str = "fleet") -> dict:
    """Timeline of a fleet run: one thread track per ``(name, events)``.

    Returns the Trace Event Format top-level object (``traceEvents`` +
    metadata); dump it with :func:`write_trace` and load it in
    https://ui.perfetto.dev.
    """
    trace_events: list[dict] = [_meta(1, None, title)]
    for tid, (name, events) in enumerate(job_streams, start=1):
        trace_events.append(_meta(1, tid, name or f"job{tid}"))
        trace_events.extend(events_to_trace_events(events, pid=1, tid=tid))
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"time_base": "1 trace us == 1 simulated second"},
    }


def write_trace(path: str, trace: dict | Sequence[tuple[str, Iterable]],
                **kwargs) -> str:
    """Write a Perfetto-loadable JSON file; accepts either a prebuilt
    trace object or the ``fleet_to_perfetto`` job-stream argument."""
    if not isinstance(trace, dict):
        trace = fleet_to_perfetto(trace, **kwargs)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(trace, fh, indent=1)
    return path
