"""Frozen scalar event loop of the benchmark (paper §5.1).

One lane: a job of ``time_base`` useful seconds on a platform (C, D, R,
C_p) against one trace, checkpointing every ``period`` seconds (work
T - C, then C), and on a prediction announced for date t taking a
proactive checkpoint that completes at t when the platform is working,
C_p fits before t and the offset of t in the period is at least the
trust threshold (``None``: never trust).  A fault loses the work since
the last completed checkpoint, then costs D and R; a fault during a
checkpoint, a downtime or a recovery destroys what of it had elapsed.
A true prediction's fault strikes at its date whether or not it was
acted on.  Exact-date predictions only, constant periods.

This is the study's scalar loop for that case, with the same float
operations in the same order, so every field is bitwise the study's
own.  ``F`` is the float type every number is held in: ``float`` (IEEE
float64) for the reference, ``numpy.float32`` for the lower-precision
control.  Plain Python and NumPy; imports nothing of the program.
"""

from __future__ import annotations

import heapq
import math

_WORK, _CKPT, _PROCKPT, _DOWN, _RECOVER = range(5)
_FAULT, _PRED = 0, 1
_FROM_TRACE, _DEFERRED = 0, 1
FAULT_UNPRED, FAULT_PRED = 0, 1

# The BatchResult fields a lane gives, in order.
FIELDS = ("makespan", "n_faults", "n_faults_hit", "n_predictions",
          "n_trusted", "n_trusted_true", "n_ignored_by_necessity",
          "n_periodic_ckpts", "time_ckpt", "time_prockpt", "time_down",
          "time_lost", "time_downtime", "time_recovery",
          "n_proactive_ckpts", "n_rollbacks", "n_replans", "n_silent",
          "n_verifications", "n_deep_rollbacks", "time_verify",
          "final_period", "final_threshold", "est_recall",
          "est_precision", "est_mu")


def simulate(times, kinds, *, c: float, d: float, r: float, cp: float,
             time_base: float, period: float, threshold: float | None,
             F=float) -> dict:
    """The fields of one lane (:data:`FIELDS`) as a dict."""
    c, d, r, cp = F(c), F(d), F(r), F(cp)
    time_base, period = F(time_base), F(period)
    thr = None if threshold is None else F(threshold)
    zero, eps, inf = F(0.0), F(1e-9), F(math.inf)
    if period < c:
        raise ValueError(f"period {period} < checkpoint {c}")

    n_faults = n_hit = n_pred = n_trusted = n_trusted_true = 0
    n_ignored = n_periodic = n_proactive = n_rollbacks = 0
    t_ckpt = t_prockpt = t_down = t_lost = t_downtime = t_recovery = zero

    now = done = saved = period_start = zero
    phase, phase_end, finished = _WORK, inf, False
    wpp = period - c
    w_rem = min(wpp, time_base - saved)

    def advance_to(target):
        nonlocal now, done, w_rem, phase, phase_end, finished, saved
        nonlocal n_periodic, t_ckpt, period_start, wpp, t_prockpt
        nonlocal n_proactive, t_down, t_downtime, t_recovery
        while now < target and not finished:
            if phase == _WORK:
                if w_rem <= zero:
                    phase, phase_end = _CKPT, now + c
                    continue
                dt = min(w_rem, inf, target - now)
                now += dt
                done += dt
                w_rem -= dt
                if w_rem <= zero:
                    phase, phase_end = _CKPT, now + c
            elif phase_end <= target:
                now = phase_end
                if phase == _CKPT:
                    n_periodic += 1
                    t_ckpt += c
                    saved = done
                    if saved >= time_base - eps:
                        finished = True
                        return
                    phase, phase_end, period_start = _WORK, inf, now
                    wpp = max(eps, period - c)
                    w_rem = min(wpp, time_base - saved)
                elif phase == _PROCKPT:
                    t_prockpt += cp
                    n_proactive += 1
                    saved = done
                    period_start = now
                    phase, phase_end = _WORK, inf
                elif phase == _DOWN:
                    t_down += d
                    t_downtime += d
                    phase, phase_end = _RECOVER, now + r
                else:
                    t_down += r
                    t_recovery += r
                    phase, phase_end, period_start = _WORK, inf, now
                    wpp = max(eps, period - c)
                    w_rem = min(wpp, time_base - saved)
            else:
                now = target

    queue = []
    seq = 0
    for t, k in zip(times, kinds):
        if k == FAULT_UNPRED:
            queue.append((F(t), seq, _FAULT, _FROM_TRACE))
        else:
            queue.append((F(t), seq, _PRED, int(k)))
        seq += 1
    heapq.heapify(queue)

    while queue and not finished:
        t, _, ev, payload = heapq.heappop(queue)
        if ev == _FAULT:
            if payload == _FROM_TRACE:
                n_faults += 1
            advance_to(t)
            if finished:
                break
            n_hit += 1
            lost = done - saved
            if phase != _WORK and phase_end != inf:
                dur = {_CKPT: c, _PROCKPT: cp, _DOWN: d, _RECOVER: r}[phase]
                elapsed = dur - (phase_end - now)
                if phase in (_CKPT, _PROCKPT):
                    lost += max(zero, elapsed)
                elif phase == _DOWN:
                    t_down += max(zero, elapsed)
                    t_downtime += max(zero, elapsed)
                else:
                    t_down += max(zero, elapsed)
                    t_recovery += max(zero, elapsed)
            t_lost += lost
            if lost > zero:
                n_rollbacks += 1
            done = saved
            phase, phase_end = _DOWN, t + d
            continue

        n_pred += 1
        is_true = payload == FAULT_PRED
        if is_true:
            n_faults += 1
        ckpt_start = t - cp
        if ckpt_start >= now:
            advance_to(ckpt_start)
            if finished:
                break
            if phase == _WORK:
                offset = t - period_start
                if thr is not None and offset >= thr:
                    phase, phase_end = _PROCKPT, t
                    n_trusted += 1
                    if is_true:
                        n_trusted_true += 1
            else:
                n_ignored += 1
        else:
            n_ignored += 1
        if is_true:
            heapq.heappush(queue, (t, seq, _FAULT, _DEFERRED))
            seq += 1

    advance_to(inf)
    return dict(zip(FIELDS, (
        now, n_faults, n_hit, n_pred, n_trusted, n_trusted_true, n_ignored,
        n_periodic, t_ckpt, t_prockpt, t_down, t_lost, t_downtime,
        t_recovery, n_proactive, n_rollbacks, 0, 0, 0, 0, zero, period,
        F(-1.0), F(-1.0), F(-1.0), F(-1.0))))
