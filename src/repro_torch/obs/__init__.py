"""Observability of the port: tracing, waste attribution, metrics, timelines.

The port's own copy of ``repro/obs``.  The paper's first-order analysis
is a *decomposition* — waste is a sum of named terms (periodic
checkpoints, proactive checkpoints on predictions, re-execution after
unpredicted faults, downtime + recovery).  This package attributes every
simulated second to one of those terms and exposes the decision points as
structured events:

  * :mod:`repro_torch.obs.trace` — the ``TraceSink`` protocol the scalar
    oracle and the fleet engine emit structured events into;
    ``RecordingSink`` captures them, ``NullSink`` drops them.  The lane
    engine is bit-for-bit the oracle, so a lane's trace is reconstructed
    by replaying the oracle (:func:`repro_torch.obs.trace.record_run`).
  * :mod:`repro_torch.obs.attribution` — ``WasteAttribution`` buckets
    {work, ckpt, proactive_ckpt, verify, re_exec, downtime, recovery,
    wait} with ``sum(buckets) == makespan`` bit-for-bit, for a
    ``SimResult``, a fleet job or a ``BatchResult`` from either device,
    plus the analytic first-order expectations to reconcile against.
  * :mod:`repro_torch.obs.metrics` — a process-local ``MetricsRegistry``
    (counters / gauges / timers) threaded through the runner, the lane
    engine's chunk loop, the ft runtime and the fleet simulator.
  * :mod:`repro_torch.obs.perfetto` — Chrome/Perfetto ``trace_event``
    JSON timelines of a run or a fleet (jobs as tracks, checkpoints as
    slices, faults as instants).
"""

from .attribution import (BUCKETS, WasteAttribution, attribute_batch,
                          attribute_fleet_job, attribute_lanes,
                          attribute_result, expected_fractions)
from .metrics import MetricsRegistry, get_registry, set_registry
from .perfetto import events_to_trace_events, fleet_to_perfetto, write_trace
from .trace import NullSink, RecordingSink, TraceEvent, TraceSink, record_run

__all__ = [
    "BUCKETS",
    "WasteAttribution",
    "attribute_result",
    "attribute_batch",
    "attribute_lanes",
    "attribute_fleet_job",
    "expected_fractions",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "TraceEvent",
    "TraceSink",
    "NullSink",
    "RecordingSink",
    "record_run",
    "events_to_trace_events",
    "fleet_to_perfetto",
    "write_trace",
]
