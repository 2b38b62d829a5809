"""Generative fault-prediction models, online (r, p) estimation, adaptive
re-planning (the port's copy of ``repro/predictors``).

Registered models: ``oracle``, ``lead_time``, ``drifting``, ``bursty``.
:class:`OnlineRPEstimator` tracks (r-hat, p-hat) behind a confidence gate,
and :class:`AdaptiveConfig` drives the ``adaptive`` strategy, which
re-plans (T*, beta_lim) inside the lane engine as the estimates drift.
"""

from .base import (PredictionStream, PredictorModel, build_predictor,
                   list_predictors, register_predictor)
from .estimator import (P_HAT_MIN, AdaptiveConfig, OnlineRPEstimator,
                        decay_factor, estimate_precision, estimate_recall,
                        maybe_replan)
from .models import (BurstyPredictor, DriftingPredictor, LeadTimePredictor,
                     OraclePredictor)

__all__ = [
    "P_HAT_MIN",
    "PredictionStream",
    "PredictorModel",
    "register_predictor",
    "build_predictor",
    "list_predictors",
    "OraclePredictor",
    "LeadTimePredictor",
    "DriftingPredictor",
    "BurstyPredictor",
    "AdaptiveConfig",
    "OnlineRPEstimator",
    "decay_factor",
    "estimate_recall",
    "estimate_precision",
    "maybe_replan",
]
