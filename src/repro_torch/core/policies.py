"""Checkpointing strategies compared in the paper (§5.1 "Heuristics").

Each strategy bundles a period choice and a trust policy:

  * YOUNG             T = sqrt(2 mu C) + C,            never trust predictions
  * DALY              T = sqrt(2 (mu + D + R) C) + C,  never trust
  * RFO               T = sqrt(2 (mu - (D + R)) C),    never trust  (paper Eq. 13)
  * OPTIMALPREDICTION T = T_pred (§4.3),               threshold beta_lim = C_p/p
  * INEXACTPREDICTION same as OPTIMALPREDICTION, simulated with an uncertainty
                      window (the window is a *simulation* parameter)
  * SIMPLE(q)         T from §4.1 analysis,            fixed probability q
  * BESTPERIOD        any of the above with a brute-force-searched period

The module also exposes :func:`best_period`, the paper's BestPeriod search
(numerical sweep, each candidate period evaluated on a set of random traces).

The port's own copy of ``repro/core/policies.py``: the same periods and
trust policies, bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .prediction import (PredictedPlatform, beta_lim,
                         optimal_period_with_prediction, t_pred,
                         waste_simple_policy)
from .simulator import (AlwaysTrust, FixedProbabilityTrust, NeverTrust,
                        ThresholdTrust, TrustPolicy)
from .traces import EventTrace
from .waste import Platform, t_daly, t_rfo, t_young

__all__ = [
    "Strategy",
    "young",
    "daly",
    "rfo",
    "optimal_prediction",
    "inexact_prediction",
    "simple_policy",
    "best_period",
    "evaluate",
]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A named (period, trust policy) pair, ready to hand to the simulator.

    ``window_mode`` / ``window_period`` select the prediction-window action
    policy (arXiv:1302.4558; see :func:`repro_torch.core.simulator.simulate`):
    the defaults reproduce the exact-date behaviour.  ``adaptive`` (an
    :class:`repro_torch.predictors.AdaptiveConfig`) turns on online (r, p)
    estimation with re-planning: ``period`` and ``trust`` then only seed
    the initial plan.
    """

    name: str
    period: float
    trust: TrustPolicy
    inexact_window: float = 0.0  # simulation-side date uncertainty
    window_mode: str = "instant"
    window_period: float = 0.0   # in-window proactive period ("within")
    adaptive: object | None = None  # repro_torch.predictors.AdaptiveConfig
    # Silent-error verification knobs (arXiv:1310.8486; see
    # repro_torch.core.silent): k in-period verifications, their cost, and the
    # retained-checkpoint ring depth for rollback past dirty snapshots.
    n_verify: int = 0
    verify_cost: float = 0.0
    keep_ckpts: int = 1

    def with_period(self, period: float) -> "Strategy":
        return dataclasses.replace(self, period=period)


def young(platform: Platform) -> Strategy:
    return Strategy("Young", t_young(platform), NeverTrust())


def daly(platform: Platform) -> Strategy:
    return Strategy("Daly", t_daly(platform), NeverTrust())


def rfo(platform: Platform) -> Strategy:
    return Strategy("RFO", t_rfo(platform), NeverTrust())


def optimal_prediction(pp: PredictedPlatform) -> Strategy:
    """The refined policy of §4.2/§4.3 with its analytically optimal period."""
    t, _, use_pred = optimal_period_with_prediction(pp)
    trust: TrustPolicy = ThresholdTrust(beta_lim(pp)) if use_pred else NeverTrust()
    return Strategy("OptimalPrediction", t, trust)


def inexact_prediction(pp: PredictedPlatform, window: float | None = None) -> Strategy:
    """OptimalPrediction simulated with uncertain fault dates (paper: 2C)."""
    base = optimal_prediction(pp)
    w = 2.0 * pp.platform.c if window is None else window
    return dataclasses.replace(base, name="InexactPrediction", inexact_window=w)


def simple_policy(pp: PredictedPlatform, q: float | None = None) -> Strategy:
    """The fixed-probability policy of §4.1.

    If q is None, picks the optimal q in {0, 1} at the period minimizing the
    §4.1 waste (evaluated on a sweep, since Eq. 14's optimal T has no simple
    closed form for arbitrary q).
    """
    plat = pp.platform
    if q is None:
        # Compare the best waste achievable with q=0 and with q=1.
        candidates = np.geomspace(plat.c * 1.001, max(plat.mu, plat.c * 4), 512)
        w0 = min(waste_simple_policy(t, 0.0, pp) for t in candidates)
        w1 = min(waste_simple_policy(t, 1.0, pp) for t in candidates)
        q = 0.0 if w0 <= w1 else 1.0
    candidates = np.geomspace(plat.c * 1.001, max(plat.mu, plat.c * 4), 512)
    t_best = min(candidates, key=lambda t: waste_simple_policy(float(t), q, pp))
    trust: TrustPolicy
    if q <= 0.0:
        trust = NeverTrust()
    elif q >= 1.0:
        trust = AlwaysTrust()
    else:
        trust = FixedProbabilityTrust(q)
    return Strategy(f"Simple(q={q:g})", float(t_best), trust)


# ---------------------------------------------------------------------------
# Evaluation + BestPeriod search: thin compatibility wrappers over the
# batched runner (repro_torch.experiments.runner).  Results are bit-for-bit
# identical to the historical serial loops — the runner keeps the
# per-(strategy, trace) seeding ``default_rng(seed + 7919 * i)`` and the
# trace-order accumulation — but duplicated candidates are simulated once
# and the period grid is deduplicated.
# ---------------------------------------------------------------------------

def evaluate(
    strategy: Strategy,
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    *,
    seed: int = 0,
    device=None,
) -> float:
    """Average makespan of a strategy over a fixed set of traces (the lanes
    run on ``device``; ``None``: CUDA)."""
    from ..experiments.runner import evaluate_mean
    return evaluate_mean(strategy, traces, platform, time_base, cp, seed=seed,
                         device=device)


def best_period(
    strategy: Strategy,
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    *,
    n_points: int = 24,
    span: float = 8.0,
    seed: int = 0,
    device=None,
) -> tuple[Strategy, float]:
    """Brute-force the best period for a strategy (paper's BestPeriod).

    Sweeps ``n_points`` periods log-spaced in [T0/span, T0*span] around the
    strategy's analytic period T0 (T0 itself included: BestPeriod must never
    lose to it), evaluates each on the given traces (the lanes on
    ``device``; ``None``: CUDA), and returns (best strategy, its average
    makespan).
    """
    from ..experiments.runner import best_period_search
    return best_period_search(strategy, traces, platform, time_base, cp,
                              n_points=n_points, span=span, seed=seed,
                              device=device)
