"""Structured run tracing: the ``TraceSink`` protocol and its sinks.

The scalar engine (:func:`repro_torch.core.simulator.simulate`) and the fleet
engine accept a ``sink`` argument.  The default ``sink=None`` is the
zero-overhead-off switch: every hook site is a single ``is not None``
test, tracing never touches the RNG stream or any float the simulation
computes, so enabling it cannot change results (pinned by
``tests/test_torch_obs.py``).

Event vocabulary (the ``kind`` strings the engines emit):

======================  =====================================================
kind                    meaning / args
======================  =====================================================
``ckpt_start``          periodic checkpoint begins
``ckpt_end``            ... completes (``dur`` = C)
``prockpt_start``       proactive checkpoint begins (on a trusted prediction
                        or the in-window cadence)
``prockpt_end``         ... completes (``dur`` = C_p)
``fault``               a fault strikes (``phase`` = machine phase code)
``rollback``            the fault discarded progress (``lost``, ``saved``)
``re_exec``             re-execution debt created (``dur`` = lost work)
``down_start``          downtime begins (``dur`` = D)
``recover_start``       recovery begins (``dur`` = R)
``recover_end``         recovery completes, schedule restarts (``dur`` = R)
``prediction``          a prediction is announced (``true``, ``window``)
``trust``               the trust decision (``trusted``, ``acted``, and
                        ``ignored`` = ignored by necessity)
``replan``              adaptive re-plan fired (``period``, ``threshold``)
======================  =====================================================

The lane engine (``lane_loop_kernel`` on CUDA, its plain loop on the
CPU) is bit-for-bit equivalent to the scalar engine, so a lane's event
stream is *reconstructed* post hoc by replaying the scalar engine on that
lane's inputs (:func:`record_run`) in place of host callbacks, exact by
the parity contract the golden tests pin.

The port's own copy of ``repro/obs/trace.py``; :func:`record_run` runs
the port's oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

__all__ = ["TraceEvent", "TraceSink", "NullSink", "RecordingSink",
           "record_run"]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured record emitted by an engine hook point."""

    t: float                  # simulated time of the event
    kind: str                 # vocabulary above
    dur: float = 0.0          # span length for phase-shaped events
    args: dict = dataclasses.field(default_factory=dict)


class TraceSink:
    """Protocol: engines call ``emit`` at every hook point."""

    def emit(self, t: float, kind: str, dur: float = 0.0,
             **args: Any) -> None:
        raise NotImplementedError


class NullSink(TraceSink):
    """Drops every event (for callers that want a sink object anyway;
    the engines' ``sink=None`` default skips the call entirely)."""

    def emit(self, t: float, kind: str, dur: float = 0.0,
             **args: Any) -> None:
        pass


class RecordingSink(TraceSink):
    """Appends every event to an in-memory list."""

    def __init__(self) -> None:
        self.events: list[TraceEvent] = []

    def emit(self, t: float, kind: str, dur: float = 0.0,
             **args: Any) -> None:
        self.events.append(TraceEvent(t, kind, dur, args))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events)

    def by_kind(self, kind: str) -> list[TraceEvent]:
        return [e for e in self.events if e.kind == kind]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out


def record_run(trace, platform, time_base, period,
               **kwargs) -> tuple[Any, RecordingSink]:
    """Run the scalar engine with a fresh :class:`RecordingSink`.

    Returns ``(SimResult, sink)``.  Because the lane engines are
    bit-for-bit the scalar engine, this is also the post-hoc trace
    reconstruction for any lane of the port's engine: call it with that lane's
    inputs and the recorded stream is exactly what a host callback
    inside the lane engine would have seen.
    """
    from ..core.simulator import simulate

    sink = RecordingSink()
    res = simulate(trace, platform, time_base, period, sink=sink, **kwargs)
    return res, sink
