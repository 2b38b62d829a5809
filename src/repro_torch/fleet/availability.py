"""Analytic availability model: the availability-optimal checkpoint interval.

Production serving fleets optimize *availability* — the fraction of wall
time the service answers — rather than the paper's *waste* (the fraction of
makespan that is not useful work).  The two objectives price the same three
ingredients differently (arXiv:2410.18124):

  * a periodic checkpoint of length C need not take the service down for
    all of C: with concurrent / fuzzy snapshotting only a stop-the-world
    fraction ``phi_c = OutageWeights.ckpt`` of it is an outage;
  * likewise a proactive checkpoint C_p is an outage for
    ``phi_p = OutageWeights.prockpt`` of its duration;
  * re-executed (replayed) work after a rollback is an outage for a
    fraction ``rho = OutageWeights.replay`` — a training job replays at
    full outage (rho = 1), a serving replica that still answers stale
    reads while catching up replays cheaper (rho < 1).

First-order unavailability per unit time, mirroring the structure of
:func:`repro_torch.core.waste.waste` (and dropping the second-order
``wff * wfault`` cross products the waste model keeps):

  U1(T) = phi_c C / T + (D + R + rho T / 2) / mu                (no predictor)

which is minimized at

  T_A* = sqrt(2 (mu - (D + R)) phi_c C / rho)                   (Eq. RFO-A)

— the waste-optimal T_RFO scaled by sqrt(phi_c / rho).  **The two optima
provably differ whenever phi_c != rho**: a service whose checkpoints are
mostly concurrent (phi_c < 1) but whose replay is a full outage (rho = 1)
should checkpoint *more often* than the waste-optimal cadence, by the
factor sqrt(phi_c / rho).

With the paper's predictor (recall r, precision p, proactive cost C_p) the
prediction term extends U the same way Eq. 15's WASTE2 extends Eq. 12: act
on predictions whose offset in the period exceeds the availability trust
breakpoint

  beta_A = phi_p C_p / (rho p)                                  (Thm. 1-A)

(act iff the expected replay outage saved, rho * offset * p, exceeds the
proactive outage phi_p C_p).  Acted predictions arrive at rate r/(p mu)
and remove their fault's replay; predictions below the breakpoint keep it:

  U2(T) = phi_c C / T
        + (D + R + rho (1-r) T / 2 + phi_p (r/p) C_p (1 - beta_A/T)
           + rho r beta_A^2 / (2 T)) / mu

With unit weights (phi_c = phi_p = rho = 1) beta_A reduces to the paper's
beta_lim = C_p/p and U2 to WASTE2 minus its O(C/mu) cross terms, so the
availability-optimal plan degenerates to the waste-optimal one — the
regression tests pin both the degeneracy and the divergence.

The port's own copy of ``repro/fleet/availability.py``, operation for
operation, over the port's ``core/waste.py`` and ``core/prediction.py``.
"""

from __future__ import annotations

import dataclasses
import math

from ..core.prediction import PredictedPlatform
from ..core.waste import ALPHA_CAP, Platform, clamp_period

__all__ = [
    "OutageWeights",
    "beta_avail",
    "unavailability_nopred",
    "unavailability_pred",
    "unavailability",
    "t_avail_nopred",
    "t_avail_pred",
    "optimal_period_availability",
    "measured_unavailability",
]


@dataclasses.dataclass(frozen=True)
class OutageWeights:
    """Outage fractions pricing each waste ingredient as service downtime.

    All three weights live in (0, 1]; unit weights make availability
    1 - waste at first order (the degenerate check the tests pin).
    """

    ckpt: float = 1.0      # phi_c: stop-the-world fraction of a periodic C
    prockpt: float = 1.0   # phi_p: ... of a proactive C_p
    replay: float = 1.0    # rho:   outage fraction of re-executed work

    def __post_init__(self) -> None:
        for name in ("ckpt", "prockpt", "replay"):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0):
                raise ValueError(f"OutageWeights.{name} must be in (0, 1], "
                                 f"got {v}")

    def to_dict(self) -> dict:
        return {"ckpt": self.ckpt, "prockpt": self.prockpt,
                "replay": self.replay}

    @classmethod
    def from_dict(cls, d) -> "OutageWeights":
        return cls(**dict(d))


def beta_avail(pp: PredictedPlatform, w: OutageWeights) -> float:
    """Availability trust breakpoint beta_A = phi_p C_p / (rho p).

    Act on a prediction iff its offset in the period >= beta_A: the
    expected replay outage saved (rho * offset * p) then exceeds the
    proactive outage spent (phi_p C_p).  Unit weights give the paper's
    beta_lim = C_p / p.
    """
    return w.prockpt * pp.cp / (w.replay * pp.predictor.precision)


# ---------------------------------------------------------------------------
# Unavailability at period T
# ---------------------------------------------------------------------------

def unavailability_nopred(t: float, plat: Platform,
                          w: OutageWeights) -> float:
    """U1(T): first-order unavailability without acting on predictions."""
    if t < plat.c:
        raise ValueError(f"T={t} < C={plat.c}")
    return w.ckpt * plat.c / t \
        + (plat.d + plat.r + w.replay * t / 2.0) / plat.mu


def unavailability_pred(t: float, pp: PredictedPlatform,
                        w: OutageWeights) -> float:
    """U2(T): unavailability of the refined policy acting past beta_A."""
    plat, pred = pp.platform, pp.predictor
    if t < plat.c:
        raise ValueError(f"T={t} < C={plat.c}")
    r, p = pred.recall, pred.precision
    beta = beta_avail(pp, w)
    act = max(0.0, 1.0 - beta / t)   # fraction of predictions past beta_A
    return w.ckpt * plat.c / t + (
        plat.d + plat.r
        + w.replay * (1.0 - r) * t / 2.0
        + w.prockpt * (r / p) * pp.cp * act
        + w.replay * r * beta * beta / (2.0 * t)
    ) / plat.mu


def unavailability(t: float, pp: PredictedPlatform, w: OutageWeights) -> float:
    """Two-branch unavailability (the availability analogue of Eq. 15)."""
    if t <= beta_avail(pp, w):
        return unavailability_nopred(t, pp.platform, w)
    return unavailability_pred(t, pp, w)


# ---------------------------------------------------------------------------
# Availability-optimal periods
# ---------------------------------------------------------------------------

def t_avail_nopred(plat: Platform, w: OutageWeights) -> float:
    """Minimizer of U1: T_A* = sqrt(2 (mu - (D+R)) phi_c C / rho).

    The waste-optimal T_RFO scaled by sqrt(phi_c / rho); clamped to the
    feasible [C, alpha mu] range like :func:`repro_torch.core.waste.clamp_period`.
    """
    slack = max(plat.mu - (plat.d + plat.r), plat.c)
    t = math.sqrt(2.0 * slack * w.ckpt * plat.c / w.replay)
    return clamp_period(t, plat)


def t_avail_pred(pp: PredictedPlatform, w: OutageWeights) -> float:
    """Minimizer of U2 on [max(C, beta_A), +inf).

    dU2/dT = 0 gives T = sqrt(v / x) with
      v = phi_c C + r (rho beta_A^2/2 - phi_p C_p beta_A / p) / mu
      x = rho (1 - r) / (2 mu)
    (v's correction term collapses to -phi_p^2 C_p^2 r / (2 rho p^2 mu)).
    """
    plat, pred = pp.platform, pp.predictor
    r, p = pred.recall, pred.precision
    beta = beta_avail(pp, w)
    lo = max(plat.c, beta)
    v = w.ckpt * plat.c + r * (w.replay * beta * beta / 2.0
                               - w.prockpt * pp.cp * beta / p) / plat.mu
    x = w.replay * (1.0 - r) / (2.0 * plat.mu)
    if x <= 0.0 or v <= 0.0:
        # r == 1 (no unpredicted replay) or degenerate v: periodic
        # checkpoints are pure overhead — fall back to the rigor cap.
        return max(lo, ALPHA_CAP * plat.mu)
    return min(max(lo, math.sqrt(v / x)), ALPHA_CAP * plat.mu)


def optimal_period_availability(
        pp: PredictedPlatform, w: OutageWeights) -> tuple[float, float, bool]:
    """(T_A*, U(T_A*), use_predictions) — availability analogue of
    :func:`repro_torch.core.prediction.optimal_period_with_prediction`."""
    tp = t_avail_pred(pp, w)
    u2 = unavailability_pred(tp, pp, w)
    if beta_avail(pp, w) < pp.platform.c:
        return tp, u2, True
    tn = t_avail_nopred(pp.platform, w)
    u1 = unavailability_nopred(tn, pp.platform, w)
    if u1 <= u2:
        return tn, u1, False
    return tp, u2, True


# ---------------------------------------------------------------------------
# Measured availability (simulator-side accounting)
# ---------------------------------------------------------------------------

def measured_unavailability(*, makespan: float, time_ckpt: float,
                            time_prockpt: float, time_down: float,
                            time_lost: float, w: OutageWeights,
                            time_contention_ckpt: float = 0.0,
                            time_contention_prockpt: float = 0.0,
                            time_repair_wait: float = 0.0) -> float:
    """Weighted outage fraction of a simulated run.

    The simulator's makespan decomposes exactly as base + ckpt + prockpt +
    lost + down (accrual-exact accounting, see ``_Machine.fault``); the
    fleet engine adds contention stretch and repair-queue waiting on top.
    With unit weights and no contention this equals ``SimResult.waste``.
    """
    if makespan <= 0.0:
        return 0.0
    outage = (w.ckpt * (time_ckpt + time_contention_ckpt)
              + w.prockpt * (time_prockpt + time_contention_prockpt)
              + (time_down + time_repair_wait)
              + w.replay * time_lost)
    return outage / makespan
