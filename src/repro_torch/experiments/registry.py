"""Strategy registry of the port: the strategies of the predictor study.

The port's own copy of part of ``repro/experiments/registry.py``:
``@register_strategy(name)`` registers ``factory(scenario, **params)``,
which returns a :class:`repro_torch.core.policies.Strategy` or a
:class:`~repro_torch.experiments.runner.BestPeriodSearch`, and
:func:`build_strategy` builds one by name for a
:class:`~repro_torch.experiments.spec.ScenarioSpec`.  Registered here:
``rfo``, ``optimal_prediction``, ``adaptive``, ``fixed_period`` and
``best_period`` (the strategies ``benchmarks/predictor_sweep.py`` uses),
with the reference's parameters and defaults.

The reference's other strategies (young, daly, the exact, window, silent
and dynamic families), its distribution and experiment registries,
``run_experiment``, ``ExperimentSpec`` and ``SweepSpec`` are ROADMAP A4:
building one of those names raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable

from ..core import policies
from ..core.simulator import NeverTrust, ThresholdTrust
from .spec import ScenarioSpec

__all__ = ["build_strategy", "list_strategies", "register_strategy"]

_STRATEGIES: dict[str, Callable[..., Any]] = {}

# The reference's registered strategies that the port has not copied yet.
_NOT_PORTED = ("daly", "dynamic_prediction", "dynamic_rfo",
               "exact_exponential", "exact_nopred", "exact_prediction",
               "inexact_prediction", "nopred", "prediction", "silent_ignore",
               "silent_verify", "silent_verify_pred", "simple_policy",
               "window_ignore", "window_proactive", "window_start", "young")


def register_strategy(name: str):
    """Register ``factory(scenario: ScenarioSpec, **params)`` under ``name``."""
    def wrap(factory: Callable[..., Any]) -> Callable[..., Any]:
        if name in _STRATEGIES:
            raise ValueError(f"strategy {name!r} already registered")
        _STRATEGIES[name] = factory
        return factory
    return wrap


def build_strategy(name: str, scenario: ScenarioSpec, **params: Any):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet: see ROADMAP.md, Queue A "
            f"item A4 (engine front, the rest)")
    if name not in _STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"registered: {sorted(_STRATEGIES)}")
    return _STRATEGIES[name](scenario, **params)


def list_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def _scenario_order(scenario: ScenarioSpec, model_order: str | None) -> str:
    order = scenario.model_order if model_order is None else model_order
    if order not in ("first", "exact"):
        raise ValueError(f"model_order must be 'first' or 'exact', "
                         f"got {order!r}")
    return order


@register_strategy("rfo")
def _rfo(scenario: ScenarioSpec) -> policies.Strategy:
    return policies.rfo(scenario.platform)


@register_strategy("optimal_prediction")
def _optimal_prediction(scenario: ScenarioSpec) -> policies.Strategy:
    return policies.optimal_prediction(scenario.pp)


@register_strategy("adaptive")
def _adaptive(scenario: ScenarioSpec, prior_recall: float | None = None,
              prior_precision: float | None = None, min_preds: int = 32,
              min_faults: int = 16, tol: float = 0.05,
              model_order: str | None = None,
              halflife: float | None = None) -> policies.Strategy:
    """Online (r-hat, p-hat) estimation with adaptive re-planning.

    Starts on the model-optimal plan for the *prior* (r, p) — the
    scenario's nominal predictor by default, or an explicitly stale
    ``prior_recall`` / ``prior_precision`` — then re-plans T* and the
    trust threshold from the gated running estimates as they drift
    (:mod:`repro_torch.predictors.estimator`).  Both the initial plan and
    every re-plan solve the scenario's ``model_order`` analysis;
    ``halflife`` (observations) switches the estimator to its windowed
    (EW) variant.
    """
    from ..predictors.estimator import AdaptiveConfig
    r0 = scenario.recall if prior_recall is None else float(prior_recall)
    p0 = scenario.precision if prior_precision is None \
        else float(prior_precision)
    cfg = AdaptiveConfig(prior_recall=r0, prior_precision=p0,
                         min_preds=min_preds, min_faults=min_faults, tol=tol,
                         model_order=_scenario_order(scenario, model_order),
                         halflife=halflife)
    t0, thr0 = cfg.plan(scenario.platform, scenario.cp, r0, p0)
    return policies.Strategy("Adaptive", float(t0), ThresholdTrust(thr0),
                             adaptive=cfg)


@register_strategy("fixed_period")
def _fixed_period(scenario: ScenarioSpec, period: float = 0.0,
                  trust_threshold: float | None = None) -> policies.Strategy:
    """An explicit period (seconds); optional Theorem-1 threshold trust."""
    if period <= 0.0:
        raise ValueError("fixed_period requires period > 0")
    trust = (ThresholdTrust(trust_threshold)
             if trust_threshold is not None else NeverTrust())
    return policies.Strategy(f"Fixed(T={period:g})", period, trust)


@register_strategy("best_period")
def _best_period(scenario: ScenarioSpec, base: str = "rfo",
                 base_params: dict | None = None, n_points: int = 24,
                 span: float = 8.0):
    """BestPeriod search (paper §5.1) wrapped around any registered strategy."""
    from .runner import BestPeriodSearch
    inner = build_strategy(base, scenario, **(base_params or {}))
    if isinstance(inner, BestPeriodSearch):
        raise ValueError("cannot nest best_period searches")
    return BestPeriodSearch(base=inner, n_points=n_points, span=span)
