"""Fault-tolerance runtime: clock, injector, predictor, scheduler."""

from .estimator import AdaptiveScheduler, OnlineEstimator
from .runtime import FaultInjector, Prediction, PredictorRuntime, VirtualClock
from .scheduler import CheckpointScheduler, ScheduleDecision

__all__ = ["FaultInjector", "Prediction", "PredictorRuntime", "VirtualClock",
           "CheckpointScheduler", "ScheduleDecision", "OnlineEstimator",
           "AdaptiveScheduler"]
