"""Process-local metrics registry: counters, gauges, timers.

The port's own copy of ``repro/obs/metrics.py``.  A
:class:`MetricsRegistry` is a plain dict-of-dicts with no locking or
export machinery — the torch lane engine's chunk loop, the ft runtime
and the fleet simulator increment into whichever registry is *installed*
(:func:`get_registry`).  Deterministic
counters (replans, deferred-fault overflows, total cache lookups) are
safe to diff exactly; wall-clock timers and
rates (``*_s``, ``lanes_per_s``) carry the store's timing-key naming so
diffs band them instead of comparing bitwise.

Metric names used by the instrumented call sites:

======================================  ==================================
``torch.chunks``                        lane chunks driven (counter)
``torch.iterations``                    per chunk, the largest number of
                                        iterations a lane ran; summed over
                                        chunks
``torch.shards``                        per chunk, the shards it was cut
                                        into (1 unsplit; a device list
                                        splits it); summed over chunks
``torch.loop_calls``                    ``lane_loop`` calls of the host
                                        loop (each a kernel launch on the
                                        card, a plain-loop run on the CPU)
``torch.tables_s``                      host seconds drawing the lanes'
                                        uniforms (``_draw_tables``)
``torch.upload_s``                      seconds building chunk state and
                                        the bank on the device
``torch.run_s``                         host-loop seconds (each call's
                                        flag read back: synced)
``torch.readback_s``                    seconds copying results back
``torch.replan_rounds``                 host round trips that re-planned
                                        the adaptive lanes stopped in a
                                        ``lane_loop`` call (counter)
``torch.replan_s``                      host seconds of those round trips
                                        (read back, ``maybe_replan``,
                                        write back)
``torch.lanes_per_s``                   lanes/second of the last call
``engine.replans``                      adaptive re-plans made (counter;
                                        the lanes' ``n_replans`` summed)
``engine.deferred_overflows``           chunks whose lanes overflowed the
                                        8 deferred-fault slots and reran
                                        with more
``kernels.lane_loop.launches``          lane_loop kernel launches
``kernels.event_step.launches``         event_step kernel launches (0 on
                                        the lane engine's CUDA path, whose
                                        advance runs in lane_loop)
``fleet.faults`` / ``fleet.repair_waits``  fleet coupling events (counters)
``ft.predictions`` / ``ft.faults_injected``  ft-runtime activity (counters)
======================================  ==================================
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["MetricsRegistry", "get_registry", "set_registry"]


class MetricsRegistry:
    """Counters / gauges / timers with a mergeable snapshot."""

    def __init__(self) -> None:
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.timers: dict[str, float] = {}

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def add_time(self, name: str, seconds: float) -> None:
        self.timers[name] = self.timers.get(name, 0.0) + float(seconds)

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_time(name, time.perf_counter() - t0)

    def snapshot(self) -> dict[str, dict]:
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timers": dict(self.timers)}

    def merge(self, other: "MetricsRegistry") -> None:
        for k, v in other.counters.items():
            self.count(k, v)
        self.gauges.update(other.gauges)
        for k, v in other.timers.items():
            self.add_time(k, v)

    def clear(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.timers.clear()

    def flat_timings(self) -> dict[str, float]:
        """Timers + gauges flattened for ``RunRecord.timings`` (every key
        already carries a timing-shaped name, so diffs band them)."""
        out = dict(self.timers)
        out.update(self.gauges)
        return out


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The installed process-local registry (instrumented sites use it)."""
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Install ``registry`` (e.g. a fresh one per suite item) and return
    the previously installed one."""
    global _registry
    prev = _registry
    _registry = registry
    return prev
