"""Fault-tolerance runtime: clock, injector, predictor, scheduler."""

from .runtime import FaultInjector, Prediction, PredictorRuntime, VirtualClock
from .scheduler import CheckpointScheduler, ScheduleDecision

__all__ = ["FaultInjector", "Prediction", "PredictorRuntime", "VirtualClock",
           "CheckpointScheduler", "ScheduleDecision"]
