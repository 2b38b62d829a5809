"""Two-level (hierarchical) checkpointing — the paper's stated future work.

The paper's conclusion: "Future work will be devoted to the study of the
impact of fault prediction on uncoordinated or hierarchical checkpointing
protocols."  This module builds the first-order theory and a simulator for
the two-level case, in the paper's own waste framework:

  * Level 1 — cheap local checkpoints (cost C1, e.g. in-HBM/buddy copies):
    recover soft faults (fraction ``phi`` of all faults: software crashes,
    preemptions, single-host OOMs) with recovery R1.
  * Level 2 — durable global checkpoints (cost C2 >> C1): survive hard
    faults (node loss); every k-th level-1 checkpoint is promoted.

Schedule: L1 period T1, L2 period T2 = k * T1.  First-order waste (same
derivation discipline as paper §3 — one fault per period, uniform strike
position):

  WASTE(T1, k) = ((k-1) C1 + C2) / (k T1)
               + (1/mu) [ phi (T1/2 + D + R1)
                        + (1-phi) (k T1 / 2 + D + R2) ]

d/dT1 = 0 gives the closed form

  T1*(k) = sqrt( 2 mu ((k-1) C1 + C2) / (k (phi + (1-phi) k)) )

and k* is found by scanning integer k (the function is unimodal in k).
k = 1 degenerates to the paper's single-level RFO model with C = C2.

With a fault predictor, proactive checkpoints go to level 1 (cheap) and
Theorem 1 applies with beta_lim = C1p / p: a predicted fault is soft with
probability phi, so the expected loss avoided is the same mixture; the
module exposes the combined waste for the simple always-promote-to-L1
strategy.

The port's own copy of ``repro/core/multilevel.py``, operation for
operation, over the port's ``core/traces.py``: two-level makespans are
bitwise the JAX package's on the same stream.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["TwoLevelPlatform", "waste_two_level", "optimal_two_level",
           "simulate_two_level", "two_level_stream", "TwoLevelResult"]


@dataclasses.dataclass(frozen=True)
class TwoLevelPlatform:
    mu: float          # platform MTBF (all faults)
    phi: float         # fraction of faults recoverable at level 1
    c1: float          # level-1 checkpoint cost
    c2: float          # level-2 checkpoint cost
    r1: float          # level-1 recovery
    r2: float          # level-2 recovery
    d: float = 0.0     # downtime

    def __post_init__(self) -> None:
        if not (0.0 <= self.phi <= 1.0):
            raise ValueError(f"phi must be in [0,1], got {self.phi}")
        if min(self.mu, self.c1, self.c2, self.r1, self.r2) <= 0 \
                or self.d < 0:
            raise ValueError(f"invalid two-level platform: {self}")


def waste_two_level(t1: float, k: int, p: TwoLevelPlatform) -> float:
    """First-order waste of the (T1, k) two-level schedule."""
    if k < 1 or t1 <= 0:
        raise ValueError(f"need k >= 1 and T1 > 0, got ({t1}, {k})")
    t2 = k * t1
    w_ff = ((k - 1) * p.c1 + p.c2) / t2
    w_soft = p.phi * (t1 / 2.0 + p.d + p.r1)
    w_hard = (1.0 - p.phi) * (t2 / 2.0 + p.d + p.r2)
    w_fault = (w_soft + w_hard) / p.mu
    return w_ff + w_fault - w_ff * w_fault


def _t1_star(k: int, p: TwoLevelPlatform) -> float:
    num = 2.0 * p.mu * ((k - 1) * p.c1 + p.c2)
    den = k * (p.phi + (1.0 - p.phi) * k)
    return math.sqrt(num / den)


def optimal_two_level(p: TwoLevelPlatform, k_max: int = 256
                      ) -> tuple[float, int, float]:
    """(T1*, k*, waste*) minimizing the two-level waste."""
    best = (0.0, 1, math.inf)
    for k in range(1, k_max + 1):
        t1 = max(p.c1, _t1_star(k, p))
        w = waste_two_level(t1, k, p)
        if w < best[2]:
            best = (t1, k, w)
    return best


@dataclasses.dataclass
class TwoLevelResult:
    makespan: float
    time_base: float
    n_soft: int = 0
    n_hard: int = 0
    time_l1: float = 0.0
    time_l2: float = 0.0
    time_lost: float = 0.0
    time_down: float = 0.0

    @property
    def waste(self) -> float:
        return 1.0 - self.time_base / self.makespan \
            if self.makespan > 0 else 0.0


def two_level_stream(p: TwoLevelPlatform, horizon: float,
                     rng: np.random.Generator, *,
                     dist=None) -> tuple[np.ndarray, np.ndarray]:
    """Draw a (fault_times, soft) stream through ``make_event_trace``.

    Hard faults are the fail-stop stream with MTBF mu/(1-phi); soft
    faults ride the silent-error stream with MTBF mu/phi.  For the
    default Exponential law the superposition is exactly the hand-rolled
    model this replaces — a rate-1/mu process whose events are soft with
    i.i.d. probability phi — but the draw now goes through the shared
    trace machinery (validation, rescaling, seeding discipline, and any
    renewal ``dist``).  phi = 0 or 1 degenerate to a single stream.
    """
    from .traces import SILENT, Exponential, make_event_trace

    dist = dist if dist is not None else Exponential(1.0)
    if p.phi >= 1.0:
        # All-soft: one stream, every event recoverable at level 1.
        tr = make_event_trace(dist, p.mu, 0.0, 1.0, horizon, rng)
        return tr.times.astype(np.float64), np.ones(len(tr.times), bool)
    silent_mu = p.mu / p.phi if p.phi > 0.0 else None
    tr = make_event_trace(dist, p.mu / (1.0 - p.phi), 0.0, 1.0, horizon,
                          rng, silent_mu=silent_mu)
    return tr.times.astype(np.float64), tr.kinds == SILENT


def simulate_two_level(fault_times: np.ndarray, soft: np.ndarray,
                       p: TwoLevelPlatform, time_base: float,
                       t1: float, k: int) -> TwoLevelResult:
    """Discrete-event simulation of the two-level schedule.

    ``fault_times`` ascending; ``soft`` boolean per fault (see
    :func:`two_level_stream` for the trace-machinery-backed generator).
    Work W = T1 - C1 per segment; every k-th checkpoint costs C2 instead
    of C1 and becomes the hard-fault restore point.  Soft faults roll
    back to the last completed checkpoint of either level; hard faults to
    the last level-2.  A fault landing inside the downtime + recovery
    window interrupts it and restarts downtime — the same boundary rule
    as the scalar oracle (``simulator._Machine.fault``), which this
    engine cross-validates against bit-for-bit in the degenerate
    single-level limits.
    """
    res = TwoLevelResult(0.0, time_base)
    now = 0.0
    done = 0.0          # work completed (volatile)
    saved_l1 = 0.0      # work secured by the last completed ckpt (any level)
    saved_l2 = 0.0      # work secured at level 2
    seg = 0             # checkpoint counter (every k-th is level 2)
    fi = 0
    n = len(fault_times)
    work_per = t1 - p.c1  # L2 segments still do work T1-C1 (C2 at the end)

    def next_fault(a: float, b: float) -> int | None:
        nonlocal fi
        while fi < n and fault_times[fi] < a:
            fi += 1
        if fi < n and fault_times[fi] < b:
            return fi
        return None

    while saved_l1 < time_base - 1e-9:
        # One segment: work then checkpoint (level 2 every k-th).
        is_l2 = (seg + 1) % k == 0
        cost = p.c2 if is_l2 else p.c1
        w = min(work_per, time_base - done)
        seg_end = now + w + cost
        j = next_fault(now, seg_end)
        if j is None:
            now = seg_end
            done += w
            saved_l1 = done
            if is_l2:
                saved_l2 = done
                res.time_l2 += cost
            else:
                res.time_l1 += cost
            seg += 1
            fi = fi  # keep cursor
            continue
        # A fault strikes during the segment.  Destroyed: the work done
        # this segment plus any partial checkpoint (both re-executed).
        ft = float(fault_times[j])
        fi = j + 1
        elapsed = ft - now
        res.time_lost += min(elapsed, w) + max(0.0, elapsed - w)
        while True:
            if soft[j]:
                res.n_soft += 1
                lost = done - saved_l1
                done = saved_l1
                rec = p.r1
            else:
                res.n_hard += 1
                lost = done - saved_l2
                done = saved_l2
                saved_l1 = saved_l2
                rec = p.r2
                seg = 0  # restart the promotion cycle after a hard fault
            if lost > 0.0:
                # Work rolled back *past* completed checkpoints: a hard
                # fault drops saved_l1 -> saved_l2, losing the L1-secured
                # work since the last promotion (the interrupted
                # segment's own loss was charged above).
                res.time_lost += lost
            # A later fault inside the downtime + recovery window
            # interrupts it: charge the elapsed part and restart downtime
            # at the new fault (scalar-oracle boundary rule).
            j = next_fault(ft, ft + p.d + rec)
            if j is None:
                res.time_down += p.d + rec
                now = ft + p.d + rec
                break
            ft2 = float(fault_times[j])
            fi = j + 1
            res.time_down += ft2 - ft
            ft = ft2
    res.makespan = now
    return res
