"""Exact expected-makespan analysis under Exponential faults *with prediction*.

The first-order model of :mod:`repro_torch.core.waste` / :mod:`repro_torch.core.prediction`
(Eqs. 12/15) drops every O((T/mu)^2) term: it is the C/mu -> 0 limit.  The
companion research report "Impact of fault prediction on checkpointing
strategies" (Aupy et al., arXiv:1207.6936) keeps the full Exponential
expressions instead and derives the *exact* expected makespan of the
threshold policy, recovering the first-order formulas in the limit.  This
module is that exact layer, built as a renewal-reward analysis of the very
mechanics the simulator executes:

  * **cycles** run from one save (periodic checkpoint, proactive checkpoint,
    or completed recovery) to the next.  With Exponential faults every save
    is a regeneration point, so the renewal-reward theorem gives the exact
    steady-state waste  1 - E[work per cycle] / E[time per cycle];
  * within a cycle of span T = W + C the relevant event streams are Poisson:
    unpredicted faults (rate (1-r)/mu), true predictions (rate r/mu) and
    false predictions (rate r(1-p)/(p mu), relevant only where the policy
    acts on them); the *first event by date* decides the cycle outcome —
    exactly how the simulator's date-ordered queue resolves competing
    events;
  * a prediction announced for date offset ``o`` is acted upon iff
    ``o >= max(beta, C_p)`` and the proactive checkpoint fits before the
    periodic one (``o < W + C_p``): the machine saves ``o - C_p`` of work at
    ``o``, then either the fault strikes (true prediction: downtime follows,
    zero work lost) or it does not (false prediction: the C_p was the whole
    price);
  * repair is simulator-faithful: downtime D restarts on faults, recovery R
    sends the machine back to downtime, so the expected repair time is
    (e^{(D+R)/mu} - 1) mu — slightly different from the Bougeret et al.
    model cited in :func:`repro_torch.core.waste.expected_makespan_exponential`,
    where downtime is fault-free (the two agree to O(((D+R)/mu)^2)).

Modeling deltas vs. the discrete-event engines (all second-order at the
paper's scales, bounded by the cross-validation tests):

  * the engines do *not* restart the periodic cadence after a proactive
    checkpoint (the next periodic checkpoint comes W - (o - C_p) later, not
    W) — the renewal model assumes a fresh period at every save;
  * when C_p > C a prediction dated shortly after T can still preempt the
    periodic checkpoint; the model caps the acting region at the cycle span;
  * first/last-period boundary effects, O(1/n_periods).

No closed form exists for the exact optimal (T, beta) in general: the
optimizers below use the Lambert-W solution where it exists (the
no-prediction branch) and bracketed golden-section minimization of the
closed-form waste everywhere else, per the paper's numerical approach.

The port's own copy of ``repro/core/exact.py`` (``math`` only): the same
floating-point operations in the same order, so exact plans are bitwise
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from .prediction import PredictedPlatform, beta_lim, t_pred
from .waste import Platform, t_exact_exponential

__all__ = [
    "ExactPlan",
    "repair_time_exact",
    "expected_cycle_nopred",
    "waste_exact_nopred",
    "expected_makespan_exact_nopred",
    "t_exact_nopred",
    "exact_cycle_prediction",
    "waste_exact_prediction",
    "expected_makespan_exact_prediction",
    "beta_lim_exact",
    "optimal_period_exact_nopred",
    "optimal_period_exact",
    "minimize_scalar",
]


# ---------------------------------------------------------------------------
# Repair and the no-prediction branch (exact WASTE1 analogue)
# ---------------------------------------------------------------------------

def repair_time_exact(p: Platform) -> float:
    """Expected downtime-and-recovery time, faults restarting the downtime.

    The machine needs a fault-free span of D + R measured from the last
    restart (faults during D restart D; faults during R send it back to D),
    so  E = mu (e^{(D+R)/mu} - 1).  First order: D + R.
    """
    return p.mu * math.expm1((p.d + p.r) / p.mu)


def expected_cycle_nopred(t: float, p: Platform) -> float:
    """Exact expected time of one T-second cycle with no proactive action.

    Classic renewal argument: attempts until a fault-free span of T, each
    failed attempt costing the time to the fault plus the repair:
    E = (mu + Delta)(e^{T/mu} - 1).
    """
    if t <= p.c:
        raise ValueError(f"period T={t} must exceed C={p.c}")
    return (p.mu + repair_time_exact(p)) * math.expm1(t / p.mu)


def waste_exact_nopred(t: float, p: Platform) -> float:
    """Exact waste of the periodic policy ignoring all predictions.

    1 - (T - C)/E[cycle]; the exact analogue of WASTE1 (Eq. 15 left
    branch), to which it converges as C/mu -> 0.
    """
    return 1.0 - (t - p.c) / expected_cycle_nopred(t, p)


def expected_makespan_exact_nopred(t: float, time_base: float,
                                   p: Platform) -> float:
    """Exact expected makespan: time_base / (T - C) cycles of E[cycle]."""
    return time_base * expected_cycle_nopred(t, p) / (t - p.c)


def t_exact_nopred(p: Platform) -> float:
    """Exact optimal period, Lambert-W closed form.

    The repair prefactor (mu + Delta) is T-free, so the minimizer of
    E[cycle]/(T - C) is the same T* = C + mu (1 + W(-e^{-(C/mu + 1)})) as
    :func:`repro_torch.core.waste.t_exact_exponential`.
    """
    return t_exact_exponential(p)


def optimal_period_exact_nopred(p: Platform) -> "ExactPlan":
    """The no-prediction exact plan (Lambert-W period, never trust)."""
    t = t_exact_nopred(p)
    return ExactPlan(period=t, threshold=math.inf,
                     waste=waste_exact_nopred(t, p), use_predictions=False)


# ---------------------------------------------------------------------------
# The prediction branch (exact WASTE2 analogue)
# ---------------------------------------------------------------------------

def _segment_integrals(s0: float, k: float, x0: float,
                       x1: float) -> tuple[float, float, float]:
    """(S(x1), int S, int S*o) over [x0, x1) for S(o) = s0 e^{-k (o - x0)}."""
    length = x1 - x0
    if length <= 0.0:
        return s0, 0.0, 0.0
    decay = math.exp(-k * length)
    i0 = s0 * -math.expm1(-k * length) / k
    # int_0^L e^{-k u} u du = (1 - e^{-kL})/k^2 - L e^{-kL}/k
    i1 = x0 * i0 + s0 * (-math.expm1(-k * length) / (k * k)
                         - length * decay / k)
    return s0 * decay, i0, i1


def exact_cycle_prediction(t: float, pp: PredictedPlatform,
                           beta: float) -> tuple[float, float]:
    """Exact (E[time], E[work]) of one cycle under the threshold policy.

    ``beta`` is the trust threshold: a prediction announced for date offset
    ``o`` (from the last save) triggers a proactive checkpoint completing
    at ``o`` iff ``o >= max(beta, C_p)`` and ``o < W + C_p`` (the engines'
    ignored-by-necessity regions).  Derivation in the module docstring; the
    three Poisson streams race, the first event by date decides:

      * unpredicted fault at ``o``  -> time o + Delta, no work secured;
      * true prediction at ``o``    -> acted: save o - C_p then the fault
        strikes (time o + Delta); not acted: plain fault at ``o``;
      * false prediction at ``o``   -> acted: save o - C_p, renew (time o);
        not acted: no effect (the stream is thinned to the acting region);
      * no event by T = W + C       -> the periodic save (time T, work W).
    """
    plat, pred = pp.platform, pp.predictor
    mu, c, cp = plat.mu, plat.c, pp.cp
    r, p = pred.recall, pred.precision
    if t <= c:
        raise ValueError(f"period T={t} must exceed C={c}")
    w = t - c
    lam = 1.0 / mu                       # all actual faults
    lam_t = r * lam                      # true predictions
    lam_f = r * lam * (1.0 - p) / p      # false predictions
    delta = repair_time_exact(plat)

    lo = max(beta, cp)                   # acting region [lo, hi)
    hi = min(w + cp, t)
    if lo >= hi:                         # the policy never acts
        ey = expected_cycle_nopred(t, plat) * math.exp(-t / mu)
        # expected_cycle_nopred is per *completed* cycle: convert to the
        # renewal-reward pair (E[Y], E[Z]) with E[Z] = W P(no fault).
        return ey, w * math.exp(-t / mu)

    # Survival S(o) piecewise: rate lam outside the acting region, lam +
    # lam_f inside (acted false predictions end the cycle there).
    s_lo, i0_a, i1_a = _segment_integrals(1.0, lam, 0.0, lo)
    s_hi, i0_b, i1_b = _segment_integrals(s_lo, lam + lam_f, lo, hi)
    s_t, i0_c, i1_c = _segment_integrals(s_hi, lam, hi, t)

    i0 = i0_a + i0_b + i0_c
    i1 = i1_a + i1_b + i1_c

    # E[time]: survival-to-T cycle, faults (true predictions included: the
    # fault strikes whether or not the proactive checkpoint was taken) and
    # acted false predictions.
    ey = s_t * t + lam * (i1 + delta * i0) + lam_f * i1_b
    # E[work]: the periodic save, plus o - C_p banked by every *acted*
    # prediction (true or false) in [lo, hi).
    ez = s_t * w + (lam_t + lam_f) * (i1_b - cp * i0_b)
    return ey, ez


def waste_exact_prediction(t: float, pp: PredictedPlatform,
                           beta: float | None = None) -> float:
    """Exact waste of the threshold policy (the WASTE2 analogue).

    ``beta`` defaults to the first-order Theorem-1 breakpoint C_p/p; pass
    :func:`beta_lim_exact` for the exact threshold.  Converges to
    :func:`repro_torch.core.prediction.waste2` as C/mu -> 0.
    """
    beta = beta_lim(pp) if beta is None else beta
    ey, ez = exact_cycle_prediction(t, pp, beta)
    return 1.0 - ez / ey


def expected_makespan_exact_prediction(t: float, time_base: float,
                                       pp: PredictedPlatform,
                                       beta: float | None = None) -> float:
    """Exact expected makespan under the threshold policy."""
    beta = beta_lim(pp) if beta is None else beta
    ey, ez = exact_cycle_prediction(t, pp, beta)
    return time_base * ey / ez


# ---------------------------------------------------------------------------
# Numeric optimizers (no scipy: grid pre-scan + golden section)
# ---------------------------------------------------------------------------

_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0


def minimize_scalar(f: Callable[[float], float], lo: float, hi: float,
                    *, n_scan: int = 48, tol: float = 1e-10) -> float:
    """Argmin of ``f`` on [lo, hi]: log-spaced grid scan to bracket the
    basin, then golden-section refinement.  Robust to the mild kinks of the
    piecewise-smooth exact waste (the scan pins the right basin; golden
    section needs only local unimodality)."""
    if hi <= lo:
        return lo
    if lo <= 0.0:
        grid = [lo + (hi - lo) * i / (n_scan - 1) for i in range(n_scan)]
    else:
        ratio = (hi / lo) ** (1.0 / (n_scan - 1))
        grid = [lo * ratio ** i for i in range(n_scan)]
    best_i = min(range(n_scan), key=lambda i: f(grid[i]))
    a = grid[max(0, best_i - 1)]
    b = grid[min(n_scan - 1, best_i + 1)]
    # Golden section on [a, b].
    x1 = b - _INVPHI * (b - a)
    x2 = a + _INVPHI * (b - a)
    f1, f2 = f(x1), f(x2)
    while (b - a) > tol * (1.0 + abs(a) + abs(b)):
        if f1 <= f2:
            b, x2, f2 = x2, x1, f1
            x1 = b - _INVPHI * (b - a)
            f1 = f(x1)
        else:
            a, x1, f1 = x1, x2, f2
            x2 = a + _INVPHI * (b - a)
            f2 = f(x2)
    return 0.5 * (a + b)


def beta_lim_exact(pp: PredictedPlatform, t: float | None = None) -> float:
    """Exact trust threshold: the beta minimizing the exact waste at T.

    The exact analogue of Theorem 1's beta_lim = C_p/p, to which it
    converges as C/mu -> 0 (the exact threshold also prices the work
    already banked when a false prediction forces an early save).  ``t``
    defaults to the exact optimal period at the first-order threshold.
    """
    if t is None:
        t = _best_period_at(pp, max(beta_lim(pp), pp.cp))
    hi = min(t - pp.platform.c + pp.cp, t)
    if hi <= pp.cp:
        return pp.cp
    return minimize_scalar(lambda b: waste_exact_prediction(t, pp, b),
                           pp.cp, hi)


def _best_period_at(pp: PredictedPlatform, beta: float) -> float:
    """Exact-waste-optimal period at a fixed trust threshold."""
    plat = pp.platform
    lo = plat.c * 1.0001
    hi = max(20.0 * max(t_pred(pp), t_exact_nopred(plat)), 4.0 * lo)
    return minimize_scalar(lambda t: waste_exact_prediction(t, pp, beta),
                           lo, hi)


@dataclasses.dataclass(frozen=True)
class ExactPlan:
    """One exact operating point (mirrors optimal_period_with_prediction's
    tuple, with the trust threshold made explicit)."""

    period: float
    threshold: float  # trust threshold beta; +inf = never trust
    waste: float
    use_predictions: bool


def optimal_period_exact(pp: PredictedPlatform,
                         refine_threshold: bool = True) -> ExactPlan:
    """Exact optimal plan: jointly optimized (T*, beta*) vs. never trusting.

    Coordinate descent on the closed-form exact waste — period at the
    Theorem-1 threshold, then the threshold at that period, then the period
    again (``refine_threshold=False`` keeps beta = C_p/p, the exact
    analogue of the paper's §4.3 procedure) — compared against the
    Lambert-W no-prediction optimum, ties preferring not to act.
    """
    ignore = optimal_period_exact_nopred(pp.platform)
    if pp.predictor.recall <= 0.0:
        return ignore
    beta = max(beta_lim(pp), pp.cp)
    t = _best_period_at(pp, beta)
    if refine_threshold:
        beta = beta_lim_exact(pp, t)
        t = _best_period_at(pp, beta)
    w = waste_exact_prediction(t, pp, beta)
    if w < ignore.waste:
        return ExactPlan(period=t, threshold=beta, waste=w,
                         use_predictions=True)
    return ignore
