"""Experiment API of the port: declarative scenarios, the strategy,
distribution and experiment registries, and the batched runner.

Define an experiment as data, run it, read the results table::

    from repro_torch.experiments import (ExperimentSpec, ScenarioSpec,
                                         StrategySpec, SweepSpec,
                                         run_experiment)

    exp = ExperimentSpec(
        name="demo", scenario=ScenarioSpec(n=2 ** 16, n_traces=5),
        sweep=SweepSpec(axes={"n": [2 ** 16, 2 ** 19]}),
        strategies=[StrategySpec("rfo"), StrategySpec("optimal_prediction"),
                    StrategySpec("best_period", {"base": "rfo"})])
    table = run_experiment(exp, device="cpu")     # device=None: CUDA
    print(table.format(["n", "strategy", "period", "makespan_days"]))

The rows are bitwise the JAX package's ``run_experiment`` on the same spec.
"""

from .registry import (PREDICTORS, HazardPeriod, aggregate_hazard,
                       build_distribution, build_experiment, build_strategy,
                       list_distributions, list_experiments, list_strategies,
                       register_distribution, register_experiment,
                       register_strategy)
from .runner import (BestPeriodSearch, EvalCache, ResultTable, best_means,
                     best_period_grid, best_period_search,
                     candidate_makespans, candidate_results,
                     clear_trace_bank,
                     default_cache_dir, evaluate_mean, evaluate_strategies,
                     expand_candidates, run_experiment, run_suite,
                     SuiteItemResult, SuiteRunResult, trace_bank)
from .spec import (MU_IND_SYNTH, SECONDS_PER_DAY, DistributionSpec,
                   ExperimentSpec, PredictorSpec, ScenarioSpec, StrategySpec,
                   SweepSpec)

__all__ = [
    "MU_IND_SYNTH",
    "SECONDS_PER_DAY",
    "PREDICTORS",
    "DistributionSpec",
    "PredictorSpec",
    "ScenarioSpec",
    "StrategySpec",
    "SweepSpec",
    "ExperimentSpec",
    "BestPeriodSearch",
    "EvalCache",
    "ResultTable",
    "HazardPeriod",
    "aggregate_hazard",
    "register_strategy",
    "register_distribution",
    "register_experiment",
    "build_strategy",
    "build_distribution",
    "build_experiment",
    "list_strategies",
    "list_distributions",
    "list_experiments",
    "default_cache_dir",
    "trace_bank",
    "clear_trace_bank",
    "best_means",
    "best_period_grid",
    "best_period_search",
    "candidate_makespans",
    "candidate_results",
    "evaluate_mean",
    "evaluate_strategies",
    "expand_candidates",
    "run_experiment",
    "run_suite",
    "SuiteItemResult",
    "SuiteRunResult",
]
