"""Checkpointing with prediction *windows* (Aupy et al., arXiv:1302.4558).

The companion paper generalizes exact-date predictions to time intervals:
the predictor announces that a fault will strike somewhere in [t, t+I].
This module mirrors :mod:`repro_torch.core.prediction` for the window family —
first-order waste formulas and closed-form optimal periods for the three
action modes the simulator implements:

  * ``ignore``   — never act on predictions; the plain RFO analysis
                   (WASTE1) applies since every fault rolls back T/2 work
                   on average;
  * ``instant``  — take one proactive checkpoint completing at the window
                   start t, then work normally until the fault strikes at
                   t + U(0, I): the work done inside the window is lost,
                   adding r·I/2 expected re-execution per fault over the
                   exact-date WASTE2;
  * ``within``   — additionally keep taking proactive checkpoints of
                   length C_p every T_p seconds while the window is open,
                   bounding the work at risk to W_p = T_p - C_p at the
                   price of I·C_p/T_p checkpointing overhead per window.

All formulas are first-order (O(1/mu) fault rates, like Eq. 15) and
collapse to the exact-date results of :mod:`repro_torch.core.prediction` at
I = 0, which the regression tests pin.

The port's own copy of ``repro/core/windows.py``, operation for operation.
"""

from __future__ import annotations

import dataclasses
import math

from .policies import Strategy
from .prediction import PredictedPlatform, beta_lim, t_pred, waste2
from .simulator import NeverTrust, ThresholdTrust
from .waste import t_rfo

__all__ = [
    "WINDOW_STRATEGY_MODES",
    "WindowPlan",
    "beta_lim_window",
    "waste_window_ignore",
    "waste_window_instant",
    "waste_window_within",
    "waste_window",
    "t_window_period",
    "optimal_window_plan",
    "window_strategy",
]

# Simulator modes are ("instant", "within"); "ignore" is realized as a
# NeverTrust strategy, so it only exists at this analytic/strategy level.
WINDOW_STRATEGY_MODES = ("ignore", "instant", "within")


def _kappa(precision: float) -> float:
    """Expected in-window dwell fraction weight: a true prediction spends
    I/2 in the window on average, a false one the full I; per *trusted*
    prediction that is p·(I/2) + (1-p)·I = I·(2-p)/(2p) of window time per
    true-prediction-equivalent (normalizing by precision)."""
    return (2.0 - precision) / (2.0 * precision)


def beta_lim_window(pp: PredictedPlatform, window: float,
                    window_period: float | None = None) -> float:
    """Trust breakpoint for window predictions (Theorem-1 analogue).

    Acting on a prediction at offset ``o`` in the period saves p·o of
    expected rollback but costs the proactive checkpoint(s).  For
    ``instant`` mode the in-window loss I/2 is paid whether or not we act,
    so the breakpoint stays C_p/p.  For ``within`` mode (pass the
    in-window period T_p) acting also buys back the in-window loss
    (I/2 - min(W_p, I)/2) at the price of the in-window checkpointing
    overhead, shifting the breakpoint to

        C_p/p + I·C_p·(2-p)/(2p·T_p) - I/2 + min(T_p - C_p, I)/2

    clamped at 0.  Continuous in I, and equal to beta_lim at I = 0.
    """
    base = beta_lim(pp)
    if window <= 0.0 or window_period is None:
        return base
    cp, p = pp.cp, pp.predictor.precision
    wp = window_period - cp
    thr = base + window * cp * _kappa(p) / window_period \
        - window / 2.0 + min(wp, window) / 2.0
    return max(0.0, thr)


def waste_window_ignore(t: float, pp: PredictedPlatform,
                        window: float = 0.0) -> float:
    """Waste when predictions are ignored: WASTE1 for any T (the window
    length is irrelevant — every fault rolls back normally)."""
    from .prediction import waste1
    return waste1(t, pp)


def waste_window_instant(t: float, pp: PredictedPlatform,
                         window: float) -> float:
    """Waste of checkpoint-at-window-start: exact-date WASTE2 plus the
    expected in-window re-execution r·I/2 per fault."""
    r = pp.predictor.recall
    return waste2(t, pp) + r * window / (2.0 * pp.platform.mu)


def waste_window_within(t: float, pp: PredictedPlatform, window: float,
                        window_period: float) -> float:
    """Waste of periodic proactive checkpointing inside the window.

    Over the exact-date WASTE2: each *true* prediction loses only the work
    since the last in-window save (min(W_p, I)/2 in expectation, instead
    of I/2) but pays the in-window checkpoint overhead C_p/T_p for its
    expected dwell I/2; each *false* prediction pays the overhead for the
    full window I.  Rates: true predictions r/mu, false r(1-p)/(p·mu).
    """
    plat, pred = pp.platform, pp.predictor
    r, p = pred.recall, pred.precision
    cp = pp.cp
    wp = window_period - cp
    over = cp / window_period
    extra = r * (min(wp, window) / 2.0 + (window / 2.0) * over) \
        + (r * (1.0 - p) / p) * window * over
    return waste2(t, pp) + extra / plat.mu


def waste_window(t: float, pp: PredictedPlatform, window: float, mode: str,
                 window_period: float | None = None) -> float:
    """Dispatch on the window action mode (mirrors waste_with_prediction)."""
    if mode == "ignore":
        return waste_window_ignore(t, pp, window)
    if mode == "instant":
        return waste_window_instant(t, pp, window)
    if mode == "within":
        if window_period is None:
            raise ValueError("mode 'within' needs window_period")
        return waste_window_within(t, pp, window, window_period)
    raise ValueError(f"unknown window mode {mode!r} "
                     f"(expected one of {WINDOW_STRATEGY_MODES})")


def t_window_period(pp: PredictedPlatform, window: float) -> float:
    """Optimal in-window proactive period T_p* = sqrt(I·C_p·(2-p)/p).

    Minimizer of the T_p-dependent waste terms
    r·(T_p - C_p)/2 + r·I·C_p·kappa/T_p (valid while W_p <= I): balancing
    the work at risk against the in-window overhead, the exact analogue of
    the sqrt(2·mu·C) trade-off.  Returns inf when the window is empty.
    The caller decides degeneracy: T_p* <= C_p (window too small to fit
    work between checkpoints) or W_p* >= I (at most the initial checkpoint
    fits) both mean the ``instant`` mode is already optimal.
    """
    if window <= 0.0:
        return math.inf
    p = pp.predictor.precision
    return math.sqrt(2.0 * window * pp.cp * _kappa(p))


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One mode's optimized operating point (mirrors
    optimal_period_with_prediction's tuple, plus the in-window period)."""

    mode: str
    period: float
    window_period: float  # inf when the mode takes no in-window checkpoints
    waste: float

    @property
    def use_predictions(self) -> bool:
        return self.mode != "ignore"


def _plan_for_mode(pp: PredictedPlatform, window: float,
                   mode: str) -> WindowPlan:
    c = pp.platform.c
    if mode == "ignore":
        t = max(c, t_rfo(pp.platform))
        return WindowPlan("ignore", t, math.inf,
                          waste_window_ignore(t, pp, window))
    if mode == "instant":
        t = t_pred(pp)
        return WindowPlan("instant", t, math.inf,
                          waste_window_instant(t, pp, window))
    # "within": the T and T_p optimizations separate (the extra waste terms
    # are T-free), so T* = t_pred and T_p* has the closed form above.
    tp = t_window_period(pp, window)
    if not math.isfinite(tp) or tp <= pp.cp or tp - pp.cp >= window:
        # Degenerate window: in-window checkpoints cannot pay off; the
        # instant plan is the within-mode optimum.
        t = t_pred(pp)
        return WindowPlan("instant", t, math.inf,
                          waste_window_instant(t, pp, window))
    t = t_pred(pp)
    return WindowPlan("within", t, tp,
                      waste_window_within(t, pp, window, tp))


def optimal_window_plan(pp: PredictedPlatform, window: float,
                        mode: str | None = None) -> WindowPlan:
    """The best plan for a window length I, over all modes or one mode.

    Mirrors :func:`repro_torch.core.prediction.optimal_period_with_prediction`:
    compares the acting plans against ignoring the predictor and returns
    the winner (ties prefer not acting, like the WASTE1-first comparison).
    """
    if mode is not None:
        if mode not in WINDOW_STRATEGY_MODES:
            raise ValueError(f"unknown window mode {mode!r}")
        return _plan_for_mode(pp, window, mode)
    plans = [_plan_for_mode(pp, window, m) for m in WINDOW_STRATEGY_MODES]
    return min(plans, key=lambda pl: (pl.waste, pl.use_predictions))


def window_strategy(pp: PredictedPlatform, window: float, mode: str,
                    window_period: float | None = None) -> Strategy:
    """Build the simulator-ready strategy for a window mode.

    The strategy's ``inexact_window`` doubles as the fallback window width
    for traces without per-event windows, so the same strategy object runs
    against window-bearing banks (``ScenarioSpec.window``) and plain ones.
    """
    if mode == "ignore":
        plan = _plan_for_mode(pp, window, "ignore")
        return Strategy("WindowIgnore", plan.period, NeverTrust(),
                        inexact_window=window)
    if mode == "instant":
        plan = _plan_for_mode(pp, window, "instant")
        return Strategy("WindowStart", plan.period,
                        ThresholdTrust(beta_lim_window(pp, window)),
                        inexact_window=window)
    if mode == "within":
        plan = _plan_for_mode(pp, window, "within")
        if window_period is not None:
            # Fail here, at construction, rather than mid-sweep inside the
            # engines' own window_period validation.
            if window_period <= pp.cp:
                raise ValueError(f"window_period {window_period} <= C_p "
                                 f"{pp.cp}: no work fits between in-window "
                                 f"checkpoints")
            plan = dataclasses.replace(
                plan, mode="within", window_period=window_period,
                waste=waste_window_within(plan.period, pp, window,
                                          window_period))
        if plan.mode != "within":
            # Degenerate window: run as checkpoint-at-start under the
            # proactive strategy's name so sweep rows stay comparable.
            return Strategy("WindowProactive", plan.period,
                            ThresholdTrust(beta_lim_window(pp, window)),
                            inexact_window=window)
        thr = beta_lim_window(pp, window, plan.window_period)
        return Strategy("WindowProactive", plan.period, ThresholdTrust(thr),
                        inexact_window=window, window_mode="within",
                        window_period=plan.window_period)
    raise ValueError(f"unknown window mode {mode!r} "
                     f"(expected one of {WINDOW_STRATEGY_MODES})")
