"""Fault-tolerance runtime: virtual clock, fault injector, predictor runtime.

The port's own copy of ``repro/ft/runtime.py:32-95``, over the port's
``core/traces.py`` and ``obs/metrics.py``.  These three pieces replay an
:class:`repro_torch.core.traces.EventTrace` against a *real* training loop
(:mod:`repro_torch.train.loop`):

  * :class:`VirtualClock` — the loop's notion of wall-clock.  Training steps,
    checkpoint writes, downtimes and recoveries advance it; fault/prediction
    events are timestamped against it.  Using a virtual clock makes fault-
    dense end-to-end tests run in seconds while keeping every duration
    (C, C_p, D, R, T) in real units.
  * :class:`FaultInjector` — replays the fault events of a trace: queries of
    the form "does a fault strike in [t0, t1)?" drive rollbacks.
  * :class:`PredictorRuntime` — surfaces predictions (true and false)
    ``lead_time`` seconds before their predicted date, mirroring §2.2: only
    predictions with lead time >= C_p are actionable, the trust decision is
    the scheduler's.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from ..core.traces import FALSE_PRED, FAULT_PRED, FAULT_UNPRED, EventTrace
from ..obs.metrics import get_registry

__all__ = ["VirtualClock", "FaultInjector", "PredictorRuntime", "Prediction"]


class VirtualClock:
    """Monotone virtual time in seconds."""

    def __init__(self, start: float = 0.0) -> None:
        self.now = float(start)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance clock by {dt}")
        self.now += dt
        return self.now


@dataclasses.dataclass(frozen=True)
class Prediction:
    """A prediction announced at ``announce_time`` for date ``date``."""

    announce_time: float
    date: float
    is_true: bool  # hidden from the consumer; used for accounting only


class FaultInjector:
    """Replays actual faults (predicted or not) from a trace."""

    def __init__(self, trace: EventTrace) -> None:
        sel = trace.kinds != FALSE_PRED
        self.fault_times = np.asarray(trace.times[sel], np.float64)

    def next_fault_in(self, t0: float, t1: float) -> float | None:
        """Earliest fault time in [t0, t1), or None."""
        i = bisect.bisect_left(self.fault_times, t0)
        if i < len(self.fault_times) and self.fault_times[i] < t1:
            get_registry().count("ft.faults_injected")
            return float(self.fault_times[i])
        return None


class PredictorRuntime:
    """Surfaces predictions with a fixed lead time (paper §2.2).

    Predictions whose lead time is < C_p are unusable; the paper folds them
    into the unpredicted-fault rate.  Here the consumer simply cannot act on
    them (the proactive checkpoint would not fit), producing exactly the
    same behaviour.
    """

    def __init__(self, trace: EventTrace, lead_time: float) -> None:
        sel = trace.kinds != FAULT_UNPRED
        self.pred_dates = np.asarray(trace.times[sel], np.float64)
        self.pred_true = np.asarray(trace.kinds[sel] == FAULT_PRED)
        self.lead_time = float(lead_time)

    def announced_in(self, t0: float, t1: float) -> list[Prediction]:
        """Predictions whose announce time falls in [t0, t1)."""
        a0, a1 = t0 + self.lead_time, t1 + self.lead_time
        i = bisect.bisect_left(self.pred_dates, a0)
        j = bisect.bisect_left(self.pred_dates, a1)
        if j > i:
            get_registry().count("ft.predictions", j - i)
        return [
            Prediction(float(d) - self.lead_time, float(d), bool(tr))
            for d, tr in zip(self.pred_dates[i:j], self.pred_true[i:j])
        ]
