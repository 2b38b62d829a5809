"""Fleet discrete-event simulator: N jobs, shared storage + repair capacity.

Runs N heterogeneous single-job simulations — each the exact mechanics of
:func:`repro_torch.core.simulator.simulate` — under one global clock with two
cross-job couplings:

  * **checkpoint-storage contention**: the storage fabric sustains
    ``storage_streams`` concurrent full-rate writers; when k jobs save
    (periodic or proactive) at once, each proceeds at rate
    ``min(1, storage_streams / k)`` — concurrent saves stretch each
    other's C.  A proactive checkpoint that gets stretched slips past its
    predicted date, so contention eats prediction lead time (the effect
    bandwidth-aware staggering mitigates).
  * **shared repair capacity**: at most ``repair_slots`` jobs can be in
    downtime + recovery at once; further faulted jobs queue FIFO, and the
    queueing time counts as (unweighted) outage.

Architecture: each job runs as a *coroutine* that executes the scalar
engine's event loop verbatim, yielding to the coordinator at every point
where cross-job state can matter — save starts, phase completions, fault
arrivals, and trust decisions.  The coordinator resumes whichever job has
the earliest next interaction time, so the couplings are causally ordered
across jobs.  Between yields a job performs *exactly* the scalar engine's
float arithmetic; with 1 job (or ``storage_streams=None`` and
``repair_slots=None``) no coordinator intervention ever fires and the
per-trace makespans are **bit-for-bit** those of ``simulate`` — the golden
degeneracy contract ``tests/test_torch_fleet.py`` pins against
``tests/golden/parity_v1.json``.

Unsupported in the fleet engine (raise): ``window_mode="within"`` and
adaptive re-planning — both remain single-job engine features.

The port's own copy of ``repro/fleet/sim.py``: its jobs drive the port's
``core/simulator.py::_Machine`` (the oracle's machine, field for field the
JAX package's) and count into the port's ``obs/metrics.py``.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Sequence

import numpy as np

from ..core.simulator import (_CKPT, _DOWN, _EV_FAULT, _EV_PREDICTION,
                                  _FAULT_DEFERRED, _FAULT_FROM_TRACE,
                                  _PROCKPT, _RECOVER, _WORK, NeverTrust,
                                  SimResult, TrustPolicy)
from ..core.simulator import _Machine
from ..core.traces import FAULT_PRED, FAULT_UNPRED, EventTrace
from ..core.waste import Platform
from ..obs.metrics import get_registry

__all__ = ["FleetJobInput", "FleetJobResult", "FleetSimResult",
           "simulate_fleet"]

# Coroutine yield kinds: ("at", t) = resume when the global frontier
# reaches wall time t; ("end", target) = resume at min(phase_end, target),
# reading phase_end *live* (the coordinator may move it while suspended).
_AT, _END = 0, 1


@dataclasses.dataclass
class FleetJobInput:
    """One job's single-run inputs (the ``simulate()`` argument set)."""

    trace: EventTrace
    platform: Platform
    time_base: float
    period: float | object            # float or callable t -> T (stagger)
    cp: float
    trust: TrustPolicy
    inexact_window: float = 0.0
    rng: np.random.Generator | None = None
    name: str = ""
    sink: object | None = None        # repro_torch.obs TraceSink (None = off)


@dataclasses.dataclass
class FleetJobResult:
    """Per-job :class:`SimResult` plus the fleet-level couplings' costs."""

    name: str
    sim: SimResult
    time_contention_ckpt: float = 0.0     # stretch added to periodic saves
    time_contention_prockpt: float = 0.0  # ... to proactive saves
    time_repair_wait: float = 0.0         # queueing for a repair slot


@dataclasses.dataclass
class FleetSimResult:
    jobs: list[FleetJobResult]

    @property
    def makespan(self) -> float:
        return max(j.sim.makespan for j in self.jobs)


class _OpenSave:
    """Coordinator-side state of one in-flight (possibly stretched) save."""

    __slots__ = ("kind", "nominal", "done", "last", "start", "stretched")

    def __init__(self, kind: int, nominal: float, start: float) -> None:
        self.kind = kind          # _CKPT or _PROCKPT
        self.nominal = nominal    # unstretched duration (C or C_p)
        self.done = 0.0           # nominal progress so far
        self.last = start         # wall time of the last progress update
        self.start = start        # wall time the save started
        self.stretched = False    # ever ran below full rate


class _JobRun:
    """One job: the scalar event loop as a coordinator-driven coroutine."""

    def __init__(self, idx: int, inp: FleetJobInput,
                 coord: "_Coordinator") -> None:
        self.idx = idx
        self.coord = coord
        self.name = inp.name or f"job{idx}"
        self.res = SimResult(makespan=0.0, time_base=inp.time_base)
        self.sink = inp.sink
        self.m = _Machine(inp.platform, inp.cp, inp.period, inp.time_base,
                          self.res, sink=inp.sink)
        self.cp = inp.cp
        self.period_arg = inp.period
        self.trust = inp.trust or NeverTrust()
        self.window = inp.inexact_window
        self.rng = inp.rng or np.random.default_rng(0)
        # Event queue: identical layout + ordering to simulate()'s heap.
        trace = inp.trace
        wins = trace.windows
        self.queue: list[tuple[float, int, int, int, float]] = []
        seq = 0
        for i, (t, k) in enumerate(zip(trace.times, trace.kinds)):
            w = -1.0 if wins is None else float(wins[i])
            if k == FAULT_UNPRED:
                self.queue.append((float(t), seq, _EV_FAULT,
                                   _FAULT_FROM_TRACE, 0.0))
            else:
                self.queue.append((float(t), seq, _EV_PREDICTION, int(k), w))
            seq += 1
        heapq.heapify(self.queue)
        self.seq = seq
        # Fleet couplings' state.
        self.save: _OpenSave | None = None
        self.has_slot = False
        self.waiting = False
        self.wait_since = 0.0
        self.time_contention_ckpt = 0.0
        self.time_contention_prockpt = 0.0
        self.time_repair_wait = 0.0
        self.pending: tuple[int, float] | None = None  # last yield
        self.gen = self._run()

    # -- scheduling ----------------------------------------------------------

    def wake(self) -> float:
        """Wall time of this job's next interaction (phase_end read live)."""
        kind, t = self.pending
        if kind == _AT:
            return t
        return min(self.m.phase_end, t)

    # -- the engine, cooperative ---------------------------------------------

    def _advance(self, target: float):
        """``_Machine.advance_to`` with a coordinator yield at every phase
        boundary; between yields the float ops are the scalar engine's."""
        m = self.m
        while m.now < target and not m.finished:
            if m.phase == _WORK:
                if m.w_rem <= 0.0:
                    yield (_AT, m.now)
                    self.coord.start_save(self, _CKPT, m.p.c, m.now + m.p.c)
                    continue
                dt = min(m.w_rem, target - m.now)
                m.now += dt
                m.done += dt
                m.w_rem -= dt
                if m.w_rem <= 0.0:
                    yield (_AT, m.now)
                    self.coord.start_save(self, _CKPT, m.p.c, m.now + m.p.c)
            elif m.phase_end <= target:
                yield (_END, target)
                e = m.phase_end      # may have moved while suspended
                if e <= target:
                    m.now = e
                    ph = m.phase
                    m._complete_phase()
                    self.coord.on_phase_complete(self, ph, e)
                # else: re-evaluate (stretch pushed the end past target)
            elif math.isinf(m.phase_end):
                # Waiting for a repair slot: suspend so the grant (which
                # sets a finite phase_end) can land *before* the local
                # clock advances past it.
                yield (_END, target)
                if m.phase_end <= target:
                    continue         # granted; complete on the next pass
                m.now = target       # frontier reached target, still queued
            else:
                m.now = target

    def _run(self):
        """The ``simulate()`` event loop, yielding at cross-job points."""
        m, res, queue = self.m, self.res, self.queue
        while queue and not m.finished:
            t, _, ev, payload, w = heapq.heappop(queue)
            if ev == _EV_FAULT:
                if payload == _FAULT_FROM_TRACE:
                    res.n_faults += 1
                yield from self._advance(t)
                if m.finished:
                    break
                yield (_AT, t)
                self.coord.on_fault(self, t)
                continue

            res.n_predictions += 1
            is_true = payload == FAULT_PRED
            w_i = self.window if w < 0.0 else w
            fault_date = t
            if is_true:
                res.n_faults += 1
                if w_i > 0.0:
                    fault_date = t + float(self.rng.uniform(0.0, w_i))
            if self.sink is not None:
                self.sink.emit(t, "prediction", true=is_true, window=w_i)

            ckpt_start = t - self.cp
            if ckpt_start >= m.now:
                yield from self._advance(ckpt_start)
                if m.finished:
                    break
                yield (_AT, ckpt_start)
                if m.phase == _WORK:
                    offset = t - m.period_start
                    trusted = self.trust.trust(offset, self.rng)
                    acted = trusted and self.coord.try_proactive(self, t)
                    if acted:
                        res.n_trusted += 1
                        if is_true:
                            res.n_trusted_true += 1
                    if self.sink is not None:
                        self.sink.emit(t, "trust", trusted=trusted,
                                       acted=acted, offset=offset)
                else:
                    res.n_ignored_by_necessity += 1
                    if self.sink is not None:
                        self.sink.emit(t, "trust", trusted=False,
                                       acted=False, ignored=True)
            else:
                res.n_ignored_by_necessity += 1
                if self.sink is not None:
                    self.sink.emit(t, "trust", trusted=False, acted=False,
                                   ignored=True)

            if is_true:
                heapq.heappush(queue, (fault_date, self.seq, _EV_FAULT,
                                       _FAULT_DEFERRED, 0.0))
                self.seq += 1

        yield from self._advance(math.inf)
        res.makespan = m.now
        if isinstance(self.period_arg, (int, float)):
            res.final_period = float(self.period_arg)


class _Coordinator:
    """Global clock: storage contention + repair slots across jobs."""

    def __init__(self, storage_streams: int | None,
                 repair_slots: int | None) -> None:
        if storage_streams is not None and storage_streams < 1:
            raise ValueError(f"storage_streams must be >= 1, "
                             f"got {storage_streams}")
        if repair_slots is not None and repair_slots < 1:
            raise ValueError(f"repair_slots must be >= 1, got {repair_slots}")
        self.streams = storage_streams
        self.repair_slots = repair_slots
        self.slots_free = repair_slots
        self.repair_q: deque[_JobRun] = deque()
        self.saving: list[_JobRun] = []
        self.cur_stretch = 1.0

    # -- storage contention --------------------------------------------------

    def _stretch(self, k: int) -> float:
        if self.streams is None or k <= self.streams:
            return 1.0
        return k / self.streams

    def _progress(self, t: float) -> None:
        """Advance every open save's nominal progress to wall time t."""
        for j in self.saving:
            sv = j.save
            if t > sv.last:
                sv.done += (t - sv.last) / self.cur_stretch
                sv.last = t

    def _set_stretch(self, t: float) -> None:
        """Recompute the shared rate and every open save's end time."""
        new = self._stretch(len(self.saving))
        if new == 1.0 and self.cur_stretch == 1.0:
            # Below capacity before and after: phase_end values already
            # advance at full rate — leave the scalar-exact floats alone
            # (this is the whole of the 1-job bit-for-bit degeneracy).
            return
        self.cur_stretch = new
        for j in self.saving:
            sv = j.save
            sv.stretched = True
            j.m.phase_end = t + (sv.nominal - sv.done) * new

    def start_save(self, job: _JobRun, kind: int, nominal: float,
                   scalar_end: float) -> None:
        """Register a starting save; ``scalar_end`` is the uncontended
        completion time computed with the scalar engine's float ops."""
        m = job.m
        m.phase = kind
        m.phase_end = scalar_end
        if job.sink is not None:     # the fleet bypasses _start_ckpt
            job.sink.emit(m.now, "ckpt_start" if kind == _CKPT
                          else "prockpt_start")
        job.save = _OpenSave(kind, nominal, m.now)
        self.saving.append(job)
        self._progress(m.now)
        self._set_stretch(m.now)

    def try_proactive(self, job: _JobRun, pred_date: float) -> bool:
        """``_Machine.try_proactive`` + contention registration: the
        uncontended save completes exactly at the predicted date."""
        m = job.m
        if m.finished or m.phase != _WORK:
            return False
        self.start_save(job, _PROCKPT, job.cp, pred_date)
        return True

    def _close_save(self, job: _JobRun, t: float) -> None:
        self._progress(t)
        sv = job.save
        job.save = None
        self.saving.remove(job)
        if sv.stretched:
            extra = max(0.0, (t - sv.start) - sv.nominal)
            if sv.kind == _CKPT:
                job.time_contention_ckpt += extra
            else:
                job.time_contention_prockpt += extra
        self._set_stretch(t)

    # -- phase completions / faults ------------------------------------------

    def on_phase_complete(self, job: _JobRun, phase: int, t: float) -> None:
        if phase in (_CKPT, _PROCKPT):
            self._close_save(job, t)
        elif phase == _RECOVER:
            self._release_slot(job, t)

    def on_fault(self, job: _JobRun, t: float) -> None:
        m = job.m
        if job.save is not None:
            # Abort the in-flight save.  For a stretched save, restore the
            # *nominal* remaining time into phase_end so _Machine.fault's
            # elapsed arithmetic charges nominal seconds; the stretch extra
            # already elapsed is contention time.  Unstretched saves keep
            # their scalar-exact phase_end untouched.
            self._progress(t)
            sv = job.save
            if sv.stretched:
                extra = max(0.0, (t - sv.start) - sv.done)
                if sv.kind == _CKPT:
                    job.time_contention_ckpt += extra
                else:
                    job.time_contention_prockpt += extra
                m.phase_end = t + (sv.nominal - sv.done)
            job.save = None
            self.saving.remove(job)
            self._set_stretch(t)
        was_waiting = job.waiting
        m.fault(t)
        get_registry().count("fleet.faults")
        if self.repair_slots is None:
            return
        if job.has_slot:
            return                       # restarts D holding its slot
        if was_waiting:
            m.phase_end = math.inf       # still queued; keep waiting
            return
        if self.slots_free > 0:
            self.slots_free -= 1
            job.has_slot = True
        else:
            job.waiting = True
            job.wait_since = t
            self.repair_q.append(job)
            m.phase_end = math.inf
            get_registry().count("fleet.repair_waits")

    def _release_slot(self, job: _JobRun, t: float) -> None:
        if self.repair_slots is None or not job.has_slot:
            return
        job.has_slot = False
        if self.repair_q:
            nxt = self.repair_q.popleft()
            nxt.waiting = False
            nxt.has_slot = True
            nxt.time_repair_wait += t - nxt.wait_since
            nxt.m.phase_end = t + nxt.m.p.d
        else:
            self.slots_free += 1


def simulate_fleet(
    inputs: Sequence[FleetJobInput],
    *,
    storage_streams: int | None = None,
    repair_slots: int | None = None,
) -> FleetSimResult:
    """Run all jobs to completion under the shared couplings.

    ``storage_streams=None`` / ``repair_slots=None`` disable the
    respective coupling entirely (every job runs at full rate / repairs
    immediately), which together with a single job reproduces
    :func:`repro_torch.core.simulator.simulate` bit-for-bit.
    """
    if not inputs:
        return FleetSimResult(jobs=[])
    coord = _Coordinator(storage_streams, repair_slots)
    jobs = [_JobRun(i, inp, coord) for i, inp in enumerate(inputs)]
    live: list[_JobRun] = []
    for job in jobs:
        try:
            job.pending = next(job.gen)
            live.append(job)
        except StopIteration:
            pass
    while live:
        nxt = min(live, key=lambda j: (j.wake(), j.idx))
        if math.isinf(nxt.wake()):
            raise RuntimeError(
                "fleet deadlock: every live job waits forever "
                "(repair queue with no slot holder?)")
        try:
            nxt.pending = next(nxt.gen)
        except StopIteration:
            live.remove(nxt)
    return FleetSimResult(jobs=[
        FleetJobResult(name=j.name, sim=j.res,
                       time_contention_ckpt=j.time_contention_ckpt,
                       time_contention_prockpt=j.time_contention_prockpt,
                       time_repair_wait=j.time_repair_wait)
        for j in jobs
    ])
