"""Checkpointing with fault prediction (paper §4).

Implements:
  * predictor algebra (recall r, precision p, event rates mu_P/mu_NP/mu_e);
  * the refined policy: Theorem 1 (single breakpoint beta_lim = C_p / p);
  * the two-branch waste WASTE1/WASTE2 (Eq. 15) and its exact minimization
    (§4.3): convex analysis on [C, C_p/p] and cubic root-finding on
    [max(C, C_p/p), +inf);
  * the post-proactive *cadence* correction: Eq. 15 implicitly restarts
    the period after every proactive checkpoint, while all three engines
    keep the original periodic cadence (``cadence="continue"``).  The
    first-order gap is :func:`cadence_correction`; ``waste2``/``t_pred``/
    ``optimal_period_with_prediction`` accept ``cadence="restart"``
    (paper, default) or ``"continue"`` (engine-faithful).

The port's own copy of ``repro/core/prediction.py:47-358`` (the
first-order model and the simple policy's waste of §4.1), operation for
operation, so planned periods and thresholds are bitwise the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .waste import ALPHA_CAP, Platform, t_rfo

__all__ = [
    "Predictor",
    "PredictedPlatform",
    "beta_lim",
    "waste1",
    "waste2",
    "waste_simple_policy",
    "optimal_q",
    "cadence_correction",
    "t_nopred",
    "t_pred",
    "optimal_period_with_prediction",
    "waste_with_prediction",
    "t_pred_asymptotic",
]


@dataclasses.dataclass(frozen=True)
class Predictor:
    """A fault predictor characterized by recall r and precision p (§2.2).

    recall r   = True_P / (True_P + False_N)  — fraction of faults predicted.
    precision p = True_P / (True_P + False_P) — fraction of predictions real.

    Predictions whose lead time is < C_p are classified as unpredicted faults
    (paper §2.2), which is a *recall adjustment* done by the caller.
    """

    recall: float
    precision: float

    def __post_init__(self) -> None:
        if not (0.0 <= self.recall <= 1.0):
            raise ValueError(f"recall must be in [0,1], got {self.recall}")
        if not (0.0 < self.precision <= 1.0):
            raise ValueError(f"precision must be in (0,1], got {self.precision}")

    # -- event rates (paper §2.3) -------------------------------------------
    def mu_np(self, mu: float) -> float:
        """Mean time between *unpredicted* faults: mu / (1 - r)."""
        if self.recall >= 1.0:
            return math.inf
        return mu / (1.0 - self.recall)

    def mu_p(self, mu: float) -> float:
        """Mean time between predictions (true or false): p mu / r."""
        if self.recall <= 0.0:
            return math.inf
        return self.precision * mu / self.recall

    def mu_e(self, mu: float) -> float:
        """Mean time between events of any kind: 1/mu_e = 1/mu_P + 1/mu_NP."""
        inv = 0.0
        if self.recall > 0.0:
            inv += 1.0 / self.mu_p(mu)
        if self.recall < 1.0:
            inv += 1.0 / self.mu_np(mu)
        return math.inf if inv == 0.0 else 1.0 / inv

    def mu_false(self, mu: float) -> float:
        """Mean time between *false* predictions: mu_P / (1-p) = p mu / (r (1-p))."""
        if self.precision >= 1.0 or self.recall <= 0.0:
            return math.inf
        return self.mu_p(mu) / (1.0 - self.precision)


@dataclasses.dataclass(frozen=True)
class PredictedPlatform:
    """Platform + predictor + proactive checkpoint cost C_p."""

    platform: Platform
    predictor: Predictor
    cp: float  # proactive checkpoint duration C_p

    def __post_init__(self) -> None:
        if self.cp <= 0:
            raise ValueError(f"C_p must be positive, got {self.cp}")


def beta_lim(pp: PredictedPlatform) -> float:
    """Trust breakpoint beta_lim = C_p / p (Theorem 1).

    A prediction arriving t seconds after the last periodic checkpoint should
    be acted upon iff t >= beta_lim.
    """
    return pp.cp / pp.predictor.precision


# ---------------------------------------------------------------------------
# Refined policy (§4.2/§4.3): WASTE1 / WASTE2 and their minimization
# ---------------------------------------------------------------------------

def waste1(t: float, pp: PredictedPlatform) -> float:
    """WASTE1(T): no proactive action taken (valid when T <= C_p/p). Eq. 15."""
    plat = pp.platform
    mu, c = plat.mu, plat.c
    return (c * (1.0 - (plat.d + plat.r) / mu)) / t \
        + (plat.d + plat.r - c / 2.0) / mu \
        + t / (2.0 * mu)


def waste_simple_policy(t: float, q: float, pp: PredictedPlatform) -> float:
    """Total waste of the simple policy (Eq. 14 plugged into Eq. 11)."""
    plat, pred = pp.platform, pp.predictor
    mu, c, cp = plat.mu, plat.c, pp.cp
    r, p = pred.recall, pred.precision
    if t < c:
        raise ValueError(f"T={t} < C={c}")
    wff = c / t
    wfault = (1.0 / mu) * (
        (1.0 - r * q) * t / 2.0
        + plat.d + plat.r
        + q * r / p * cp
        - q * r * cp * cp / (p * t) * (1.0 - p / 2.0)
    )
    return wff + wfault - wff * wfault


def optimal_q(t: float, pp: PredictedPlatform) -> int:
    """Optimal fixed trust probability: 0 or 1 (waste is linear in q).

    Compares the waste at q=0 and q=1 for the given period.
    """
    w0 = waste_simple_policy(t, 0.0, pp)
    w1 = waste_simple_policy(t, 1.0, pp)
    return 0 if w0 <= w1 else 1


def _waste2_coeffs(pp: PredictedPlatform) -> tuple[float, float, float, float]:
    """Coefficients (u, v, w, x) of WASTE2(T) = u/T^2 + v/T + w + x*T."""
    plat, pred = pp.platform, pp.predictor
    mu, c, cp = plat.mu, plat.c, pp.cp
    r, p = pred.recall, pred.precision
    dr = plat.d + plat.r
    u = r * c * cp * cp / (2.0 * mu * p * p)
    v = c * (1.0 - (r * cp / p + dr) / mu) - r * cp * cp / (2.0 * mu * p * p)
    w = (-(1.0 - r) * c / 2.0 + r * cp / p + dr) / mu
    x = (1.0 - r) / (2.0 * mu)
    return u, v, w, x


def cadence_correction(t: float, pp: PredictedPlatform) -> float:
    """First-order waste delta of the engines' continued periodic cadence.

    Eq. 15's WASTE2 implicitly *restarts* the period after every
    proactive checkpoint, so an unpredicted fault always loses T/2 on
    average — its re-execution term is (1-r) T / (2 mu).  The engines
    instead keep the original cadence (``simulator._complete_phase``:
    "Period continues"): an acted prediction at offset tau from the last
    periodic checkpoint *splits* the period's loss window into [0, tau]
    and [tau, T], and an unpredicted fault striking later in the same
    period rolls back only to the proactive save.  The time-averaged
    time-since-last-save over a split period is

        (tau^2/2 + (T - tau)^2/2) / T  =  T/2 - tau (T - tau) / T,

    so each acted prediction shaves E[tau (T - tau)] / T off the mean
    loss.  With acted offsets uniform on [beta_lim, T],
    E[tau (T - tau)] = (T - beta_lim)(T + 2 beta_lim) / 6, and acted
    predictions hit a period with expected multiplicity
    q = min(1, (T - beta_lim) / mu_P) (arrival rate 1/mu_P; clamped to
    one split per period — the regime the split formula models — which
    also keeps the corrected objective coercive in T).  The correction is

        Delta(T) = - (1-r)/mu * q * (T - beta_lim)(T + 2 beta_lim) / (6T)

    Delta <= 0 always: continued cadence *reduces* waste relative to the
    restart model, because the proactive save keeps protecting the rest
    of the period — this is the large-r/p model-vs-engine gap of ROADMAP
    item 6 (the restart model overestimates engine waste).  Returns 0
    when T <= beta_lim (no acted predictions), the predictor never fires
    (recall 0), or every fault is predicted (recall 1: no unpredicted
    faults to lose re-execution on).
    """
    plat, pred = pp.platform, pp.predictor
    beta = beta_lim(pp)
    if t <= beta or pred.recall <= 0.0 or pred.recall >= 1.0:
        return 0.0
    mu_p = pred.mu_p(plat.mu)
    q = min(1.0, (t - beta) / mu_p)
    split = (t - beta) * (t + 2.0 * beta) / (6.0 * t)
    return -(1.0 - pred.recall) / plat.mu * q * split


def _check_cadence(cadence: str) -> None:
    if cadence not in ("restart", "continue"):
        raise ValueError(f"cadence must be 'restart' or 'continue', "
                         f"got {cadence!r}")


def waste2(t: float, pp: PredictedPlatform, *,
           cadence: str = "restart") -> float:
    """WASTE2(T): proactive action for predictions in [C_p/p, T]. Eq. 15.

    ``cadence="restart"`` is the paper's model (period restarts after a
    proactive checkpoint); ``"continue"`` adds :func:`cadence_correction`
    to match the engines' continued periodic cadence.
    """
    _check_cadence(cadence)
    u, v, w, x = _waste2_coeffs(pp)
    base = u / (t * t) + v / t + w + x * t
    if cadence == "continue":
        base += cadence_correction(t, pp)
    return base


def waste_with_prediction(t: float, pp: PredictedPlatform, *,
                          cadence: str = "restart") -> float:
    """Waste of the optimal (Theorem 1) strategy at period T: the two-branch Eq. 15."""
    if t <= beta_lim(pp):
        return waste1(t, pp)
    return waste2(t, pp, cadence=cadence)


def t_nopred(pp: PredictedPlatform, alpha: float = ALPHA_CAP,
             enforce_cap: bool = False) -> float:
    """Minimizer of WASTE1 on [C, C_p/p] (Eq. 16): clamp T_RFO to the interval.

    When ``beta_lim(pp) < C`` the validity interval is empty — every legal
    period exceeds the trust breakpoint, so the WASTE1 branch does not exist
    and :func:`optimal_period_with_prediction` skips it.  The clamp below
    still returns C in that regime (callers that only need a feasible period
    keep working), but WASTE1 evaluated there is out of domain.
    """
    plat = pp.platform
    hi = beta_lim(pp)
    t = t_rfo(plat)
    if enforce_cap:
        t = min(t, alpha * plat.mu)
    return max(plat.c, min(t, hi))


def t_pred(pp: PredictedPlatform, *, cadence: str = "restart") -> float:
    """Minimizer of WASTE2 on [max(C, C_p/p), +inf) (Eq. 17).

    dWASTE2/dT = -2u/T^3 - v/T^2 + x = 0  <=>  x T^3 - v T - 2u = 0.
    Handles both the convex case (v >= 0: unique positive root) and the
    general case (v < 0: inspect all real roots and interval bounds).

    With ``cadence="continue"`` the corrected objective has no closed
    form; the cubic root seeds a deterministic grid + ternary refinement
    over [lo, ALPHA_CAP * mu].
    """
    _check_cadence(cadence)
    u, v, _, x = _waste2_coeffs(pp)
    lo = max(pp.platform.c, beta_lim(pp))
    if x <= 0.0:
        # r == 1: no unpredicted faults, so the linear term vanishes.  The
        # stationary point solves -2u/T^3 - v/T^2 = 0 -> T = -2u/v (v<0);
        # with v >= 0 waste2 = u/T^2 + v/T + w decreases monotonically —
        # periodic checkpoints are pure overhead — so return the paper's
        # rigor cap alpha*mu rather than the interval's (worst) low end.
        if v < 0.0 and u > 0.0:
            cubic = max(lo, -2.0 * u / v)
        else:
            cubic = max(lo, ALPHA_CAP * pp.platform.mu)
        candidates = [cubic]
    else:
        roots = np.roots([x, 0.0, -v, -2.0 * u])
        candidates = [lo]
        for root in roots:
            if abs(root.imag) < 1e-9 * max(1.0, abs(root.real)) \
                    and root.real > lo:
                candidates.append(float(root.real))
    if cadence == "restart":
        return min(candidates, key=lambda t: waste2(t, pp))

    # Continued cadence: minimize the corrected objective numerically.
    def f(t: float) -> float:
        return waste2(t, pp, cadence="continue")

    hi = max(ALPHA_CAP * pp.platform.mu, lo * 1.001, *candidates)
    grid = list(np.geomspace(lo, hi, 512)) + candidates
    grid = sorted(set(float(t) for t in grid))
    i = min(range(len(grid)), key=lambda j: f(grid[j]))
    a = grid[max(0, i - 1)]
    b = grid[min(len(grid) - 1, i + 1)]
    for _ in range(200):
        m1 = a + (b - a) / 3.0
        m2 = b - (b - a) / 3.0
        if f(m1) <= f(m2):
            b = m2
        else:
            a = m1
    t_best = 0.5 * (a + b)
    return min(grid[i], t_best, key=f)


def optimal_period_with_prediction(
        pp: PredictedPlatform, *,
        cadence: str = "restart") -> tuple[float, float, bool]:
    """Optimal period for the refined policy (§4.3).

    Returns (T*, waste(T*), use_predictions) where ``use_predictions`` tells
    whether the optimal regime is the WASTE2 branch (act on predictions past
    beta_lim) or the WASTE1 branch (ignore the predictor entirely).

    When ``beta_lim(pp) < C`` the WASTE1 validity interval [C, C_p/p] is
    empty — any legal period sits past the breakpoint, so the policy always
    acts and only the WASTE2 branch exists.

    ``cadence="continue"`` scores (and optimizes) the WASTE2 branch under
    the engines' continued periodic cadence; the WASTE1 branch never acts
    on predictions, so it needs no correction.
    """
    _check_cadence(cadence)
    tp = t_pred(pp, cadence=cadence)
    w2 = waste2(tp, pp, cadence=cadence)
    if beta_lim(pp) < pp.platform.c:
        return tp, w2, True
    tn = t_nopred(pp)
    w1 = waste1(tn, pp)
    if w1 <= w2:
        return tn, w1, False
    return tp, w2, True


def t_pred_asymptotic(pp: PredictedPlatform) -> float:
    """Large-mu approximation of the optimal period: sqrt(2 mu C / (1 - r)).

    (paper §4.3 closing remark — equivalent to RFO with mu -> mu/(1-r).)
    """
    r = pp.predictor.recall
    if r >= 1.0:
        return math.inf
    return math.sqrt(2.0 * pp.platform.mu * pp.platform.c / (1.0 - r))
