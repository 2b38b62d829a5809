"""Discrete-event simulator for checkpointing under faults + predictions (paper §5.1).

The simulator executes a job of ``time_base`` useful seconds on a platform
described by :class:`repro_torch.core.waste.Platform`, against a merged event trace
(:class:`repro_torch.core.traces.EventTrace`).  It reproduces the exact mechanics of
the paper:

  * periodic checkpoints of length C every period T (work W = T - C, then C);
  * a final checkpoint at the end of the execution;
  * on a fault: lose all work since the last completed checkpoint, pay
    downtime D then recovery R, then start a fresh period;
  * faults striking during a checkpoint, a downtime, or a recovery are
    handled (checkpoint abandoned / downtime restarted);
  * on a trusted prediction at date ``e``: take a proactive checkpoint of
    length C_p scheduled to *complete exactly at* ``e`` (paper §4.1); if the
    prediction is true the fault then destroys nothing, else C_p seconds
    were lost for nothing;
  * the trust decision is a threshold on the offset of the prediction date
    within the current period (Theorem 1: act iff offset >= beta_lim = C_p/p;
    the simple policy of §4.1 uses a fixed probability q instead);
  * predictions that cannot be honoured (not enough time to fit C_p, or the
    platform is checkpointing / down) are ignored by necessity (Fig. 2(b,c));
  * InexactPrediction (§5.1): a true prediction announced for date ``e``
    materializes at ``e + U(0, window)``; the proactive checkpoint still
    completes at ``e``, so the work done in [e, actual fault) is lost.
  * Prediction *windows* (companion paper, arXiv:1302.4558): a prediction
    announces the interval [e, e+I].  The per-event window I comes from
    ``EventTrace.windows`` when present, else from the ``inexact_window``
    argument.  ``window_mode`` selects what a trusted prediction does with
    the window: ``"instant"`` (default) takes the single proactive
    checkpoint completing at the window start — today's InexactPrediction
    mechanics — while ``"within"`` additionally keeps taking proactive
    checkpoints of length C_p every ``window_period`` seconds while the
    window is open, bounding the work at risk to W_p = window_period - C_p.

  * Silent data corruptions (arXiv:1310.8486): a ``SILENT`` trace event
    corrupts the application state *latently* — execution continues, and
    checkpoints taken while corrupted are corrupted too.  The corruption
    is revealed by the next *verification* (``n_verify`` checks per
    period, each costing ``verify_cost``; the last one guards the
    periodic checkpoint) or by a detected fail-stop fault; detection
    rolls back to the newest *clean* retained checkpoint (``keep_ckpts``
    retained snapshots; rolling past every retained checkpoint restarts
    from the job start) and pays one recovery R.  A corrupted final
    checkpoint is caught by the end-of-job acceptance check.

The engine is a small phase machine (WORK / CKPT / PROCKPT / DOWN /
RECOVER / VERIFY) advanced event by event; between events it follows the
periodic schedule.

The port's own copy of ``repro/core/simulator.py``: the scalar oracle,
host Python on floats and ``heapq``, with the same operations and the same
``rng`` draws in the same order, so a :class:`SimResult` is bitwise the JAX
package's.  The lane engine (:mod:`repro_torch.core.batch`) replays those
draws from per-lane tables and is held ``==`` to this loop; the runner
sends it the candidates the lanes cannot run (dynamic periods, custom
trust policies).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Sequence

import numpy as np

from .traces import FALSE_PRED, FAULT_PRED, FAULT_UNPRED, SILENT, EventTrace
from .waste import Platform

__all__ = [
    "WINDOW_MODES",
    "TrustPolicy",
    "NeverTrust",
    "AlwaysTrust",
    "FixedProbabilityTrust",
    "ThresholdTrust",
    "SimResult",
    "simulate",
    "average_makespan",
]

# Phases of the execution machine.
_WORK, _CKPT, _PROCKPT, _DOWN, _RECOVER, _VERIFY = range(6)

# Event kinds inside the simulator queue (trace kinds + deferred faults).
_EV_FAULT = 0        # an actual fault strikes now
_EV_PREDICTION = 1   # a prediction (true or false) is announced for date t
_EV_SILENT = 2       # a silent corruption strikes now (latent until detected)

# _EV_FAULT payloads: trace faults are counted at pop; deferred faults of
# true predictions were already counted at announcement.
_FAULT_FROM_TRACE = 0
_FAULT_DEFERRED = 1

# Window action modes (companion paper, arXiv:1302.4558).
WINDOW_MODES = ("instant", "within")


# ---------------------------------------------------------------------------
# Trust policies (whether to act on a prediction)
# ---------------------------------------------------------------------------

class TrustPolicy:
    """Decides whether to act on a prediction given its offset in the period."""

    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        raise NotImplementedError


class NeverTrust(TrustPolicy):
    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return False


class AlwaysTrust(TrustPolicy):
    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class FixedProbabilityTrust(TrustPolicy):
    """Paper §4.1: trust each actionable prediction with probability q."""

    q: float

    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.q)


@dataclasses.dataclass(frozen=True)
class ThresholdTrust(TrustPolicy):
    """Paper Theorem 1: trust iff the prediction offset >= threshold."""

    threshold: float

    def trust(self, offset: float, rng: np.random.Generator) -> bool:
        return offset >= self.threshold


# ---------------------------------------------------------------------------
# Simulation result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimResult:
    makespan: float
    time_base: float
    n_faults: int = 0
    n_faults_hit: int = 0          # faults that destroyed work or a phase
    n_predictions: int = 0
    n_trusted: int = 0             # proactive checkpoints taken
    n_trusted_true: int = 0        # ... that did precede an actual fault
    n_ignored_by_necessity: int = 0
    n_periodic_ckpts: int = 0
    time_ckpt: float = 0.0         # periodic checkpointing time
    time_prockpt: float = 0.0      # proactive checkpointing time
    time_down: float = 0.0         # downtime + recovery
    time_lost: float = 0.0         # destroyed (re-executed) work
    # Waste-attribution split of ``time_down`` (repro_torch.obs): independent
    # accumulators for the downtime (D, incl. interrupted downtimes) and
    # recovery (R, incl. interrupted recoveries) portions.  ``time_down``
    # stays the authoritative merged accrual; the split is accrued from the
    # same per-event terms, so time_downtime + time_recovery == time_down
    # up to summation order (not bitwise).
    time_downtime: float = 0.0     # downtime-only portion of time_down
    time_recovery: float = 0.0     # recovery-only portion of time_down
    n_proactive_ckpts: int = 0     # completed proactive checkpoints
    n_rollbacks: int = 0           # faults that discarded positive progress
    # Silent-error + verification diagnostics (arXiv:1310.8486).
    n_silent: int = 0              # silent strikes that corrupted state
    n_verifications: int = 0       # completed verification points
    n_deep_rollbacks: int = 0      # detections past >= 1 corrupted ckpt
    time_verify: float = 0.0       # completed verification time
    # Adaptive re-planning diagnostics (repro_torch.predictors.estimator); the
    # sentinels keep non-adaptive runs comparable across engines.
    n_replans: int = 0
    final_period: float = -1.0     # last planned period (static: the period)
    final_threshold: float = -1.0  # last planned trust threshold (-1: static)
    est_recall: float = -1.0       # final r-hat (-1: no estimator / no data)
    est_precision: float = -1.0    # final p-hat
    est_mu: float = -1.0           # final mu-hat (-1: mu not estimated)

    @property
    def waste(self) -> float:
        return 1.0 - self.time_base / self.makespan if self.makespan > 0 else 0.0


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class _Machine:
    """Phase machine executing the periodic schedule between events."""

    def __init__(self, platform: Platform, cp: float, period,
                 time_base: float, res: SimResult, *, sink=None,
                 n_verify: int = 0, verify_cost: float = 0.0,
                 keep_ckpts: int = 1) -> None:
        # ``period`` may be a float or a callable t -> T (dynamic policies,
        # e.g. hazard-aware periods for Weibull faults; see
        # benchmarks/beyond.py).  Evaluated at each period start.
        self.period_fn = period if callable(period) else (lambda t: period)
        if self.period_fn(0.0) < platform.c:
            raise ValueError(
                f"period {self.period_fn(0.0)} < checkpoint {platform.c}")
        self.p = platform
        self.cp = cp
        self.work_per_period = self.period_fn(0.0) - platform.c
        self.time_base = time_base
        self.res = res
        # Optional repro_torch.obs.TraceSink (duck-typed: ``emit(t, kind,
        # **fields)``); None = tracing off (zero overhead
        # beyond one ``is not None`` test per hook point).
        self.sink = sink

        self.now = 0.0
        self.done = 0.0          # useful work completed (volatile + saved)
        self.saved = 0.0         # useful work secured by a completed checkpoint
        self.phase = _WORK
        self.phase_end = math.inf
        self.period_start = 0.0  # completion time of the last checkpoint/recovery
        self.w_rem = self._fresh_work()
        self.finished = False
        # Active prediction window ("within" mode): while now < win_end the
        # machine takes a proactive checkpoint every win_wp seconds of work.
        self.win_end = -math.inf
        self.win_rem = math.inf  # work left until the next in-window prockpt
        self.win_wp = math.inf   # in-window work quantum (window_period - cp)
        # Silent-error verification state (arXiv:1310.8486).  With
        # ``n_verify`` k >= 1 the period's work splits into k chunks, each
        # followed by a verification of length ``verify_cost``; the k-th
        # verification guards the periodic checkpoint.  ``v_rem`` is inf
        # when verification is off, so it never wins the work-chunk min.
        self.n_verify = n_verify
        self.vcost = verify_cost
        self.keep = keep_ckpts
        self.v_wp = (self.work_per_period / n_verify if n_verify >= 1
                     else math.inf)
        self.v_rem = self.v_wp
        self.verify_then_ckpt = False
        self.corrupted = False    # latent corruption since the last detection
        self.saved_clean = 0.0    # newest *clean* retained progress (0 = start)
        self.n_dirty = 0          # retained checkpoints written corrupted

    def _fresh_work(self) -> float:
        return min(self.work_per_period, self.time_base - self.saved)

    # -- schedule advancement ------------------------------------------------

    def advance_to(self, target: float) -> None:
        """Follow the fault-free schedule up to ``target`` (or completion)."""
        while self.now < target and not self.finished:
            if self.phase == _WORK:
                if self.w_rem <= 0.0:
                    self._finish_work()
                    continue
                in_win = self.now < self.win_end
                if in_win:
                    dt = min(self.w_rem, self.v_rem, self.win_rem,
                             self.win_end - self.now, target - self.now)
                else:
                    dt = min(self.w_rem, self.v_rem, target - self.now)
                self.now += dt
                self.done += dt
                self.w_rem -= dt
                self.v_rem -= dt
                if in_win:
                    self.win_rem -= dt
                if self.w_rem <= 0.0:
                    self._finish_work()
                elif self.v_rem <= 0.0:
                    self._start_verify(then_ckpt=False)
                elif in_win:
                    if self.win_rem <= 0.0 and self.now < self.win_end:
                        self._start_prockpt()
                    elif self.now >= self.win_end:
                        self._close_window()
            else:
                if self.phase_end <= target:
                    self.now = self.phase_end
                    self._complete_phase()
                else:
                    self.now = target

    def run_to_completion(self) -> None:
        self.advance_to(math.inf)

    def _finish_work(self) -> None:
        """End of the period's work: checkpoint, guarded by a verification
        when the verification cadence is on (checkpoints are verified)."""
        if self.n_verify >= 1:
            self._start_verify(then_ckpt=True)
        else:
            self._start_ckpt()

    def _start_ckpt(self) -> None:
        self.phase = _CKPT
        self.phase_end = self.now + self.p.c
        if self.sink is not None:
            self.sink.emit(self.now, "ckpt_start")

    def _start_verify(self, then_ckpt: bool) -> None:
        self.phase = _VERIFY
        self.phase_end = self.now + self.vcost
        self.verify_then_ckpt = then_ckpt
        if self.sink is not None:
            self.sink.emit(self.now, "verify_start")

    def _start_prockpt(self) -> None:
        self.phase = _PROCKPT
        self.phase_end = self.now + self.cp
        if self.sink is not None:
            self.sink.emit(self.now, "prockpt_start")

    def _close_window(self) -> None:
        self.win_end = -math.inf
        self.win_rem = math.inf

    def _record_save(self) -> None:
        """Retained-ring bookkeeping at any completed checkpoint: a save
        while corrupted writes a *dirty* snapshot; once the dirty snapshots
        fill the retained ring (``keep``), the clean one is evicted and
        detection will restart from the job start."""
        if self.corrupted:
            self.n_dirty += 1
            if self.n_dirty >= self.keep:
                self.saved_clean = 0.0
        else:
            self.saved_clean = self.done
            self.n_dirty = 0

    def _complete_phase(self) -> None:
        if self.phase == _CKPT:
            self.res.n_periodic_ckpts += 1
            self.res.time_ckpt += self.p.c
            self.saved = self.done
            self._record_save()
            if self.sink is not None:
                self.sink.emit(self.now, "ckpt_end", dur=self.p.c)
            if self.saved >= self.time_base - 1e-9:
                if self.corrupted:
                    # End-of-job acceptance check: a corrupted final
                    # checkpoint is rejected, not shipped.
                    self._detect()
                    return
                self.finished = True
                return
            if self.now < self.win_end:
                self.win_rem = self.win_wp
            self._new_period()
        elif self.phase == _PROCKPT:
            self.res.time_prockpt += self.cp
            self.res.n_proactive_ckpts += 1
            self.saved = self.done
            self._record_save()
            if self.sink is not None:
                self.sink.emit(self.now, "prockpt_end", dur=self.cp)
            # Period continues (paper §4.1); offsets for later predictions are
            # measured from the last save, which is now.
            self.period_start = self.now
            self.phase = _WORK
            self.phase_end = math.inf
            # In-window and verification cadences restart from every save.
            if self.now < self.win_end:
                self.win_rem = self.win_wp
            self.v_rem = self.v_wp
        elif self.phase == _VERIFY:
            self.res.time_verify += self.vcost
            self.res.n_verifications += 1
            if self.sink is not None:
                self.sink.emit(self.now, "verify_end", dur=self.vcost)
            if self.corrupted:
                self._detect()
                return
            self.v_rem = self.v_wp
            if self.verify_then_ckpt:
                self._start_ckpt()
            else:
                self.phase = _WORK
                self.phase_end = math.inf
        elif self.phase == _DOWN:
            self.res.time_down += self.p.d
            self.res.time_downtime += self.p.d
            self.phase = _RECOVER
            self.phase_end = self.now + self.p.r
            if self.sink is not None:
                self.sink.emit(self.now, "recover_start", dur=self.p.r)
        elif self.phase == _RECOVER:
            self.res.time_down += self.p.r
            self.res.time_recovery += self.p.r
            if self.sink is not None:
                self.sink.emit(self.now, "recover_end", dur=self.p.r)
            self._new_period()

    def _new_period(self) -> None:
        self.phase = _WORK
        self.phase_end = math.inf
        self.period_start = self.now
        self.work_per_period = max(1e-9,
                                   self.period_fn(self.now) - self.p.c)
        self.w_rem = self._fresh_work()
        if self.n_verify >= 1:
            self.v_wp = self.work_per_period / self.n_verify
        self.v_rem = self.v_wp

    def _detect(self) -> None:
        """A verification (or acceptance check) caught latent corruption:
        roll back to the newest clean retained checkpoint and pay one
        recovery R (the platform is up — no downtime D)."""
        lost = self.done - self.saved_clean
        self.res.time_lost += lost
        if lost > 0.0:
            self.res.n_rollbacks += 1
        if self.n_dirty > 0:
            self.res.n_deep_rollbacks += 1
        if self.sink is not None:
            self.sink.emit(self.now, "silent_detect", lost=lost,
                           saved=self.saved_clean, n_dirty=self.n_dirty)
            if lost > 0.0:
                self.sink.emit(self.now, "re_exec", dur=lost)
            self.sink.emit(self.now, "recover_start", dur=self.p.r)
        self.done = self.saved_clean
        self.saved = self.saved_clean
        self.n_dirty = 0
        self.corrupted = False
        self.phase = _RECOVER
        self.phase_end = self.now + self.p.r
        self._close_window()

    # -- event reactions ------------------------------------------------------

    def _phase_duration(self, phase: int) -> float:
        return {_CKPT: self.p.c, _PROCKPT: self.cp, _DOWN: self.p.d,
                _RECOVER: self.p.r, _VERIFY: self.vcost}.get(phase, 0.0)

    def fault(self, t: float) -> None:
        """An actual fault strikes at absolute time t (requires now == t).

        Accounting is accrual-exact: completed checkpoint/downtime phases
        are charged at completion, so a fault mid-phase charges only the
        elapsed fraction (to time_lost for aborted checkpoints, time_down
        for interrupted down/recovery) — makespan then decomposes exactly
        as base + ckpt + prockpt + lost + down.
        """
        self.res.n_faults_hit += 1
        # A detected fault reveals latent corruption: when corrupted
        # checkpoints are retained, roll back past them to the newest
        # clean snapshot (arXiv:1310.8486); a volatile-only corruption
        # (n_dirty == 0) is wiped by the ordinary rollback.
        deep = self.n_dirty > 0
        base = self.saved_clean if deep else self.saved
        lost = self.done - base
        # Partial phase destroyed by the fault.
        if self.phase in (_CKPT, _PROCKPT, _VERIFY, _DOWN, _RECOVER) \
                and self.phase_end != math.inf:
            elapsed = self._phase_duration(self.phase) \
                - (self.phase_end - self.now)
            if self.phase in (_CKPT, _PROCKPT, _VERIFY):
                lost += max(0.0, elapsed)
            elif self.phase == _DOWN:
                self.res.time_down += max(0.0, elapsed)
                self.res.time_downtime += max(0.0, elapsed)
            else:
                self.res.time_down += max(0.0, elapsed)
                self.res.time_recovery += max(0.0, elapsed)
        self.res.time_lost += lost
        if lost > 0.0:
            self.res.n_rollbacks += 1
        if deep:
            self.res.n_deep_rollbacks += 1
            self.saved = self.saved_clean
            self.n_dirty = 0
        self.corrupted = False
        if self.sink is not None:
            self.sink.emit(t, "fault", phase=self.phase)
            if lost > 0.0:
                self.sink.emit(t, "rollback", lost=lost, saved=self.saved)
                self.sink.emit(t, "re_exec", dur=lost)
            self.sink.emit(t, "down_start", dur=self.p.d)
        self.done = self.saved
        # Restart (or start) downtime; a fault during DOWN/RECOVER restarts D.
        self.phase = _DOWN
        self.phase_end = t + self.p.d
        # A fault ends any active prediction window.
        self._close_window()

    def silent(self, t: float) -> None:
        """A silent corruption strikes at absolute time t (now == t).

        Latent: only marks the state corrupted — work, checkpoints and
        verifications in progress continue; nothing is charged until a
        verification or a detected fault reveals it.  Strikes while the
        platform is down or recovering touch no application state.
        """
        if self.phase in (_WORK, _CKPT, _PROCKPT, _VERIFY):
            self.res.n_silent += 1
            self.corrupted = True

    def try_proactive(self, pred_date: float) -> bool:
        """Attempt a proactive checkpoint completing exactly at ``pred_date``.

        Returns True if the checkpoint was scheduled (platform is working and
        there is room for C_p).  Must be called with now == pred_date - C_p.
        """
        if self.finished or self.phase != _WORK:
            return False
        self.phase = _PROCKPT
        self.phase_end = pred_date
        return True


def simulate(
    trace: EventTrace,
    platform: Platform,
    time_base: float,
    period,
    *,
    cp: float | None = None,
    trust: TrustPolicy | None = None,
    inexact_window: float = 0.0,
    window_mode: str = "instant",
    window_period: float = 0.0,
    n_verify: int = 0,
    verify_cost: float = 0.0,
    keep_ckpts: int = 1,
    start: float = 0.0,
    rng: np.random.Generator | None = None,
    adaptive=None,
    sink=None,
) -> SimResult:
    """Simulate one execution; returns the :class:`SimResult`.

    Args:
      trace: merged platform event stream (faults + predictions).
      platform: (mu, C, D, R) parameters.
      time_base: useful work to complete (seconds).
      period: checkpointing period T (>= C).
      cp: proactive checkpoint duration C_p (defaults to C).
      trust: trust policy for predictions (default: never trust).
      inexact_window: width of the uncertainty window for true predictions
        (paper's InexactPrediction uses 2C); 0 = exact dates.  Used as the
        fallback when the trace carries no per-event window lengths
        (:attr:`EventTrace.windows` takes precedence).
      window_mode: what a trusted prediction does with its window
        (arXiv:1302.4558): ``"instant"`` takes only the proactive
        checkpoint completing at the window start; ``"within"``
        additionally checkpoints every ``window_period`` seconds while the
        window is open.
      window_period: in-window proactive period T_p (> C_p); required for
        ``window_mode="within"``.
      n_verify: verifications per period k (arXiv:1310.8486): the period's
        work splits into k chunks, each ending in a verification; the last
        one guards the periodic checkpoint.  0 disables verification —
        silent corruptions are then only caught by detected faults and the
        end-of-job acceptance check.
      verify_cost: duration V of one verification (>= 0; 0 models a free
        detector, still revealing latent corruption).
      keep_ckpts: retained-checkpoint depth: how many snapshots stay
        restorable.  Detection rolls back to the newest clean one; if all
        retained snapshots are corrupted, the job restarts from scratch.
      start: job start offset into the trace (paper: one year).
      rng: used for the trust policy randomness and inexact fault dates.
      adaptive: an :class:`repro_torch.predictors.AdaptiveConfig` to run the
        online (r-hat, p-hat) estimator and re-plan (period, trust
        threshold) from the gated estimates as they drift.  Requires a
        constant initial period and a Threshold/Never trust policy (the
        plan *is* the threshold); the re-planned period takes effect at
        the next period start.
      sink: an optional :class:`repro_torch.obs.TraceSink` (any object
        with ``emit(t, kind, **fields)``)
        receiving structured records (checkpoint start/end, proactive checkpoints, faults,
        rollbacks, re-execution spans, prediction arrival + trust
        decision, adaptive replans).  ``None`` (the default) disables
        tracing at zero overhead; tracing never touches the RNG or any
        float in the simulation, so results are bit-for-bit identical
        with tracing on or off.
    """
    cp = platform.c if cp is None else cp
    trust = trust or NeverTrust()
    rng = rng or np.random.default_rng(0)
    if window_mode not in WINDOW_MODES:
        raise ValueError(f"unknown window_mode {window_mode!r} "
                         f"(expected one of {WINDOW_MODES})")
    within = window_mode == "within"
    if within and window_period <= cp:
        raise ValueError(f"window_period {window_period} <= C_p {cp}: "
                         f"no work fits between in-window checkpoints")
    n_verify = int(n_verify)
    if n_verify < 0:
        raise ValueError(f"n_verify must be >= 0, got {n_verify}")
    if verify_cost < 0.0 or not math.isfinite(verify_cost):
        raise ValueError(f"verify_cost must be finite and >= 0, "
                         f"got {verify_cost}")
    if keep_ckpts < 1:
        raise ValueError(f"keep_ckpts must be >= 1, got {keep_ckpts}")

    # Adaptive re-planning state (repro_torch.predictors.estimator): integer
    # outcome counters, the (r, p) last planned on, and the live plan.
    ad_thr = math.inf
    if adaptive is not None:
        if not isinstance(period, (int, float)):
            raise ValueError("adaptive re-planning needs a constant "
                             "initial period")
        if isinstance(trust, ThresholdTrust):
            ad_thr = trust.threshold
        elif isinstance(trust, NeverTrust):
            ad_thr = math.inf
        else:
            raise ValueError(
                "adaptive re-planning requires a Threshold or Never trust "
                f"policy (the plan sets the threshold), got {trust!r}")
        ad_ntp = ad_nfp = ad_nuf = 0
        ad_planned_r = adaptive.prior_recall
        ad_planned_p = adaptive.prior_precision
        ad_period = float(period)
        # Windowed (EW) estimator: decay all counters before each
        # observation.  ad_dec == 1.0 keeps the legacy integer counters
        # (and their arithmetic) bit-for-bit.
        ad_dec = adaptive.decay
        # Online MTBF (estimate_mu): EW mean of observed fault inter-arrival
        # gaps, kept as decayed (sum, count) pairs so both engines replay
        # the identical float sequence (mirrors ft/estimator.py's _EWMean).
        ad_est_mu = getattr(adaptive, "estimate_mu", False)
        ad_mu_gs = 0.0           # decayed sum of gaps
        ad_mu_gn = 0.0           # decayed count of gaps
        ad_last_fault = None     # strike time of the previous actual fault
        ad_planned_mu = platform.mu

    res = SimResult(makespan=0.0, time_base=time_base)
    m = _Machine(platform, cp, period, time_base, res, sink=sink,
                 n_verify=n_verify, verify_cost=verify_cost,
                 keep_ckpts=keep_ckpts)

    def _ad_replan() -> None:
        nonlocal ad_thr, ad_planned_r, ad_planned_p, ad_period, ad_planned_mu
        from ..predictors.estimator import maybe_replan
        mu_hat = (ad_mu_gs / ad_mu_gn
                  if ad_est_mu and ad_mu_gn > 0.0 else None)
        out = maybe_replan(adaptive, platform, cp, ad_ntp, ad_nfp, ad_nuf,
                           ad_planned_r, ad_planned_p,
                           mu_hat=mu_hat, planned_mu=ad_planned_mu)
        if out is None:
            return
        ad_planned_r, ad_planned_p, ad_period, ad_thr = out
        if mu_hat is not None:
            ad_planned_mu = mu_hat
        m.period_fn = (lambda t, _T=ad_period: _T)
        res.n_replans += 1
        if sink is not None:
            sink.emit(m.now, "replan", period=ad_period, threshold=ad_thr)

    # Shift the trace so the job starts at time 0.
    sel = trace.times >= start
    times = trace.times[sel] - start
    kinds = trace.kinds[sel]
    wins = trace.windows[sel] if trace.windows is not None else None

    # Event queue: (time, seq, ev_kind, payload, window). Predictions enter
    # at their *predicted date* (the lead time is assumed >= C_p, §2.2);
    # deferred actual faults (inexact mode / untrusted true predictions) are
    # pushed back as _EV_FAULT.  window < 0 means "no per-event window":
    # fall back to the inexact_window argument.
    queue: list[tuple[float, int, int, int, float]] = []
    seq = 0
    for i, (t, k) in enumerate(zip(times, kinds)):
        w = -1.0 if wins is None else float(wins[i])
        if k == FAULT_UNPRED:
            queue.append((float(t), seq, _EV_FAULT, _FAULT_FROM_TRACE, 0.0))
        elif k == SILENT:
            queue.append((float(t), seq, _EV_SILENT, 0, 0.0))
        else:
            queue.append((float(t), seq, _EV_PREDICTION, int(k), w))
        seq += 1
    heapq.heapify(queue)

    while queue and not m.finished:
        t, _, ev, payload, w = heapq.heappop(queue)
        if ev == _EV_SILENT:
            m.advance_to(t)
            if m.finished:
                break
            m.silent(t)
            continue
        if ev == _EV_FAULT:
            mu_observed = False
            if adaptive is not None and ad_est_mu:
                # Every actual fault (trace or deferred) is an MTBF
                # observation: the gap to the previous strike.
                if ad_last_fault is not None:
                    if ad_dec != 1.0:
                        ad_mu_gs *= ad_dec
                        ad_mu_gn *= ad_dec
                    ad_mu_gs += t - ad_last_fault
                    ad_mu_gn += 1
                    mu_observed = True
                ad_last_fault = t
            if payload == _FAULT_FROM_TRACE:
                res.n_faults += 1
                if adaptive is not None:
                    # An unpredicted fault: a recall observation.
                    if ad_dec != 1.0:
                        ad_ntp *= ad_dec
                        ad_nfp *= ad_dec
                        ad_nuf *= ad_dec
                    ad_nuf += 1
                    _ad_replan()
            elif mu_observed:
                # Deferred (predicted) faults carry no new (r, p)
                # information, but their strike updates mu-hat.
                _ad_replan()
            m.advance_to(t)
            if m.finished:
                break
            m.fault(t)
            continue

        # A prediction announced for date t (true iff payload == FAULT_PRED).
        res.n_predictions += 1
        is_true = payload == FAULT_PRED
        if adaptive is not None:
            # The prediction's outcome is observed at announcement (see
            # repro_torch.predictors.estimator); the re-planned threshold takes
            # effect from this very decision on.
            if ad_dec != 1.0:
                ad_ntp *= ad_dec
                ad_nfp *= ad_dec
                ad_nuf *= ad_dec
            if is_true:
                ad_ntp += 1
            else:
                ad_nfp += 1
            _ad_replan()
        w_i = inexact_window if w < 0.0 else w
        if sink is not None:
            sink.emit(t, "prediction", true=is_true, window=w_i)
        fault_date = t
        if is_true:
            # Counted at announcement — consistent with the _EV_FAULT
            # handler, which counts before advancing — so a job completing
            # during the pre-checkpoint advance still tallies the fault.
            res.n_faults += 1
            if w_i > 0.0:
                fault_date = t + float(rng.uniform(0.0, w_i))

        # Advance to the latest proactive-checkpoint start time.
        ckpt_start = t - cp
        acted = False
        if ckpt_start >= m.now:
            m.advance_to(ckpt_start)
            if m.finished:
                break
            if m.phase == _WORK:
                offset = t - m.period_start
                trusted = (offset >= ad_thr) if adaptive is not None \
                    else trust.trust(offset, rng)
                if trusted:
                    acted = m.try_proactive(t)
                    if acted:
                        res.n_trusted += 1
                        if is_true:
                            res.n_trusted_true += 1
                        if sink is not None:
                            sink.emit(m.now, "prockpt_start")
                        if within and w_i > 0.0:
                            # Arm the window: once the initial proactive
                            # checkpoint completes at t, keep checkpointing
                            # every window_period seconds until t + I.
                            m.win_end = t + w_i
                            m.win_wp = window_period - cp
                if sink is not None:
                    sink.emit(t, "trust", trusted=trusted, acted=acted,
                              offset=offset)
            else:
                res.n_ignored_by_necessity += 1
                if sink is not None:
                    sink.emit(t, "trust", trusted=False, acted=False,
                              ignored=True)
        else:
            res.n_ignored_by_necessity += 1
            if sink is not None:
                sink.emit(t, "trust", trusted=False, acted=False,
                          ignored=True)

        if is_true:
            # The actual fault still strikes (at fault_date), whether or not
            # we checkpointed proactively.
            heapq.heappush(queue, (fault_date, seq, _EV_FAULT,
                                   _FAULT_DEFERRED, 0.0))
            seq += 1

    m.run_to_completion()
    res.makespan = m.now
    if adaptive is not None:
        res.final_period = ad_period
        res.final_threshold = ad_thr
        if ad_ntp + ad_nuf > 0:
            res.est_recall = ad_ntp / (ad_ntp + ad_nuf)
        if ad_ntp + ad_nfp > 0:
            res.est_precision = ad_ntp / (ad_ntp + ad_nfp)
        if ad_est_mu and ad_mu_gn > 0.0:
            res.est_mu = ad_mu_gs / ad_mu_gn
    elif isinstance(period, (int, float)):
        res.final_period = float(period)
    return res


def average_makespan(
    make_trace: Callable[[np.random.Generator], EventTrace],
    platform: Platform,
    time_base: float,
    period,
    *,
    n_runs: int = 20,
    seed: int = 0,
    **kw,
) -> float:
    """Average makespan of ``simulate`` over ``n_runs`` random traces."""
    total = 0.0
    for i in range(n_runs):
        rng = np.random.default_rng(seed + i)
        trace = make_trace(rng)
        total += simulate(trace, platform, time_base, period, rng=rng, **kw).makespan
    return total / n_runs
