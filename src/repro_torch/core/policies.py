"""Checkpointing strategies of the paper's study (§5.1 "Heuristics").

The port's own copy of ``repro/core/policies.py:47-94``:

  * RFO               T = sqrt(2 (mu - (D + R)) C),    never trust  (Eq. 13)
  * OPTIMALPREDICTION T = T_pred (§4.3),               threshold beta_lim = C_p/p

BestPeriod (the brute-force period search around a strategy) is
:class:`repro_torch.experiments.runner.BestPeriodSearch`.
"""

from __future__ import annotations

import dataclasses

from .prediction import (PredictedPlatform, beta_lim,
                         optimal_period_with_prediction)
from .simulator import NeverTrust, ThresholdTrust, TrustPolicy
from .waste import Platform, t_rfo

__all__ = ["Strategy", "rfo", "optimal_prediction"]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A named (period, trust policy) pair, ready to hand to the engine.

    ``window_mode`` / ``window_period`` select the prediction-window action
    policy (arXiv:1302.4558); ``n_verify`` / ``verify_cost`` /
    ``keep_ckpts`` the silent-error verification knobs (arXiv:1310.8486).
    ``adaptive`` (an :class:`repro_torch.predictors.AdaptiveConfig`) makes
    the lane re-plan (period, threshold) online.
    """

    name: str
    period: float
    trust: TrustPolicy
    inexact_window: float = 0.0  # simulation-side date uncertainty
    window_mode: str = "instant"
    window_period: float = 0.0   # in-window proactive period ("within")
    adaptive: object | None = None
    n_verify: int = 0
    verify_cost: float = 0.0
    keep_ckpts: int = 1

    def with_period(self, period: float) -> "Strategy":
        return dataclasses.replace(self, period=period)


def rfo(platform: Platform) -> Strategy:
    return Strategy("RFO", t_rfo(platform), NeverTrust())


def optimal_prediction(pp: PredictedPlatform) -> Strategy:
    """The refined policy of §4.2/§4.3 with its analytically optimal period."""
    t, _, use_pred = optimal_period_with_prediction(pp)
    trust: TrustPolicy = ThresholdTrust(beta_lim(pp)) if use_pred else NeverTrust()
    return Strategy("OptimalPrediction", t, trust)
