"""Scenario specs and strategy evaluation of the port."""

from .runner import (BestPeriodSearch, best_means, best_period_grid,
                     candidate_makespans, evaluate_strategies,
                     expand_candidates)
from .spec import DistributionSpec, ScenarioSpec

__all__ = ["BestPeriodSearch", "DistributionSpec", "ScenarioSpec",
           "best_means", "best_period_grid", "candidate_makespans",
           "evaluate_strategies", "expand_candidates"]
