"""Scenario specs, the strategy registry and strategy evaluation of the
port."""

from .registry import build_strategy, list_strategies, register_strategy
from .runner import (BestPeriodSearch, best_means, best_period_grid,
                     candidate_makespans, evaluate_strategies,
                     expand_candidates)
from .spec import DistributionSpec, PredictorSpec, ScenarioSpec

__all__ = ["BestPeriodSearch", "DistributionSpec", "PredictorSpec",
           "ScenarioSpec", "best_means", "best_period_grid",
           "build_strategy", "candidate_makespans", "evaluate_strategies",
           "expand_candidates", "list_strategies", "register_strategy"]
