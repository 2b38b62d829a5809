"""Registries: strategies, trace distributions, named experiments.

The port's own copy of ``repro/experiments/registry.py``, with every
strategy and distribution the JAX package registers, the same parameters
and defaults.  A :class:`~repro_torch.experiments.spec.StrategySpec` or
:class:`~repro_torch.experiments.spec.DistributionSpec` names a registered
factory and supplies its parameters, so experiments serialize to JSON:

  * ``@register_distribution(name)`` — factory ``(**params) -> Distribution``;
  * ``@register_strategy(name)``     — factory ``(scenario, **params)`` that
    returns either a :class:`repro_torch.core.policies.Strategy` or a
    :class:`~repro_torch.experiments.runner.BestPeriodSearch`;
  * ``@register_experiment(name)``   — builder ``(quick=True) -> ExperimentSpec``.
    The JAX package's builders live in its ``benchmarks/`` scripts, which
    register themselves on import; none is ported, so this registry starts
    empty.

Strategy factories receive the full :class:`ScenarioSpec`, so scenario-aware
strategies (hazard-tracking dynamic periods, prediction-based policies) can
derive their parameters from the cell they run in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np

from ..core import policies
from ..core.simulator import NeverTrust, ThresholdTrust
from ..core.traces import (Distribution, Empirical, Exponential,
                               LogNormalDist, UniformDist, Weibull,
                               lanl_like_log)
from ..core.exact import optimal_period_exact, t_exact_nopred
from ..core.prediction import beta_lim
from ..core.waste import t_exact_exponential

from .spec import ExperimentSpec, ScenarioSpec

__all__ = [
    "register_strategy",
    "register_distribution",
    "register_experiment",
    "build_strategy",
    "build_distribution",
    "build_experiment",
    "list_strategies",
    "list_distributions",
    "list_experiments",
    "PREDICTORS",
    "HazardPeriod",
    "aggregate_hazard",
]

_STRATEGIES: dict[str, Callable[..., Any]] = {}
_DISTRIBUTIONS: dict[str, Callable[..., Distribution]] = {}
_EXPERIMENTS: dict[str, tuple[Callable[..., ExperimentSpec], str]] = {}

# Literature predictors used throughout the paper's simulations (§5.1).
PREDICTORS = {
    "good": (0.85, 0.82),   # Yu et al. [7]
    "fair": (0.70, 0.40),   # Zheng et al. [8]
}


def register_strategy(name: str):
    """Register ``factory(scenario: ScenarioSpec, **params)`` under ``name``."""
    def wrap(factory: Callable[..., Any]) -> Callable[..., Any]:
        if name in _STRATEGIES:
            raise ValueError(f"strategy {name!r} already registered")
        _STRATEGIES[name] = factory
        return factory
    return wrap


def register_distribution(name: str):
    """Register ``factory(**params) -> Distribution`` under ``name``."""
    def wrap(factory: Callable[..., Distribution]) -> Callable[..., Distribution]:
        if name in _DISTRIBUTIONS:
            raise ValueError(f"distribution {name!r} already registered")
        _DISTRIBUTIONS[name] = factory
        return factory
    return wrap


def register_experiment(name: str, description: str = ""):
    """Register ``builder(quick=True) -> ExperimentSpec`` under ``name``."""
    def wrap(builder: Callable[..., ExperimentSpec]) -> Callable[..., ExperimentSpec]:
        if name in _EXPERIMENTS:
            raise ValueError(f"experiment {name!r} already registered")
        _EXPERIMENTS[name] = (builder, description or (builder.__doc__ or "")
                              .strip().split("\n")[0])
        return builder
    return wrap


def build_strategy(name: str, scenario: ScenarioSpec, **params: Any):
    if name not in _STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; "
                       f"registered: {sorted(_STRATEGIES)}")
    return _STRATEGIES[name](scenario, **params)


def build_distribution(name: str, **params: Any) -> Distribution:
    if name not in _DISTRIBUTIONS:
        raise KeyError(f"unknown distribution {name!r}; "
                       f"registered: {sorted(_DISTRIBUTIONS)}")
    return _DISTRIBUTIONS[name](**params)


def build_experiment(name: str, **kw: Any) -> ExperimentSpec:
    if name not in _EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; "
                       f"registered: {sorted(_EXPERIMENTS)}")
    return _EXPERIMENTS[name][0](**kw)


def list_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def list_distributions() -> list[str]:
    return sorted(_DISTRIBUTIONS)


def list_experiments() -> dict[str, str]:
    return {name: desc for name, (_, desc) in sorted(_EXPERIMENTS.items())}


# ---------------------------------------------------------------------------
# Built-in distributions (core/traces.py families)
# ---------------------------------------------------------------------------

@register_distribution("exponential")
def _exponential(mean: float = 1.0) -> Exponential:
    return Exponential(mean)


@register_distribution("weibull")
def _weibull(shape: float = 0.7, mean: float = 1.0) -> Weibull:
    return Weibull(shape, mean)


@register_distribution("uniform")
def _uniform(mean: float = 1.0) -> UniformDist:
    return UniformDist(mean)


@register_distribution("lognormal")
def _lognormal(sigma: float = 1.0, mean: float = 1.0) -> LogNormalDist:
    return LogNormalDist(sigma, mean)


@register_distribution("empirical")
def _empirical(samples: tuple | list = ()) -> Empirical:
    return Empirical(tuple(float(s) for s in samples))


@register_distribution("lanl")
def _lanl(n_intervals: int = 3010, mu_ind_days: float = 691.0,
          shape: float = 0.6, seed: int = 42) -> Empirical:
    """LANL-like empirical availability-interval log (paper §5.3 mechanism)."""
    return lanl_like_log(np.random.default_rng(seed),
                         n_intervals=n_intervals, mu_ind_days=mu_ind_days,
                         shape=shape)


# ---------------------------------------------------------------------------
# Built-in strategies (paper §5.1 heuristics + beyond-paper extensions)
# ---------------------------------------------------------------------------

@register_strategy("young")
def _young(scenario: ScenarioSpec) -> policies.Strategy:
    return policies.young(scenario.platform)


@register_strategy("daly")
def _daly(scenario: ScenarioSpec) -> policies.Strategy:
    return policies.daly(scenario.platform)


@register_strategy("rfo")
def _rfo(scenario: ScenarioSpec) -> policies.Strategy:
    return policies.rfo(scenario.platform)


@register_strategy("exact_exponential")
def _exact_exponential(scenario: ScenarioSpec) -> policies.Strategy:
    """Lambert-W optimal period for Exponential faults (paper §3 end)."""
    return policies.Strategy("ExactExponential",
                             t_exact_exponential(scenario.platform),
                             NeverTrust())


@register_strategy("optimal_prediction")
def _optimal_prediction(scenario: ScenarioSpec) -> policies.Strategy:
    return policies.optimal_prediction(scenario.pp)


# -- exact-Exponential strategies (arXiv:1207.6936; core/exact.py) ----------

@register_strategy("exact_nopred")
def _exact_nopred(scenario: ScenarioSpec) -> policies.Strategy:
    """The exact no-prediction optimum (Lambert-W period, never trust) —
    the renewal-analysis counterpart of ``rfo``."""
    return policies.Strategy("ExactNoPred", t_exact_nopred(scenario.platform),
                             NeverTrust())


@register_strategy("exact_prediction")
def _exact_prediction(scenario: ScenarioSpec,
                      refine_threshold: bool = True) -> policies.Strategy:
    """The exact threshold-policy optimum: (T*, beta*) jointly minimizing
    the exact renewal waste — the counterpart of ``optimal_prediction``."""
    plan = optimal_period_exact(scenario.pp,
                                refine_threshold=refine_threshold)
    trust = (ThresholdTrust(plan.threshold) if plan.use_predictions
             else NeverTrust())
    return policies.Strategy("ExactPrediction", plan.period, trust)


# -- model-order-aware planners (follow ScenarioSpec.model_order) -----------

def _scenario_order(scenario: ScenarioSpec, model_order: str | None) -> str:
    order = scenario.model_order if model_order is None else model_order
    if order not in ("first", "exact"):
        raise ValueError(f"model_order must be 'first' or 'exact', "
                         f"got {order!r}")
    return order


@register_strategy("nopred")
def _nopred(scenario: ScenarioSpec,
            model_order: str | None = None) -> policies.Strategy:
    """The no-prediction baseline planned at the scenario's model order:
    RFO (first order) or the Lambert-W exact optimum."""
    if _scenario_order(scenario, model_order) == "exact":
        period = t_exact_nopred(scenario.platform)
    else:
        period = policies.rfo(scenario.platform).period
    return policies.Strategy("NoPred", period, NeverTrust())


@register_strategy("prediction")
def _prediction(scenario: ScenarioSpec,
                model_order: str | None = None) -> policies.Strategy:
    """The prediction-aware threshold policy planned at the scenario's
    model order (§4.3 first-order vs the exact renewal optimum)."""
    if _scenario_order(scenario, model_order) == "exact":
        inner = _exact_prediction(scenario)
    else:
        inner = policies.optimal_prediction(scenario.pp)
    return dataclasses.replace(inner, name="Prediction")


@register_strategy("inexact_prediction")
def _inexact_prediction(scenario: ScenarioSpec,
                        window: float | None = None) -> policies.Strategy:
    return policies.inexact_prediction(scenario.pp, window=window)


@register_strategy("simple_policy")
def _simple_policy(scenario: ScenarioSpec,
                   q: float | None = None) -> policies.Strategy:
    return policies.simple_policy(scenario.pp, q=q)


# -- prediction-window strategies (arXiv:1302.4558; core/windows.py) --------

def _scenario_window(scenario: ScenarioSpec, window: float | None) -> float:
    return scenario.window if window is None else float(window)


@register_strategy("window_ignore")
def _window_ignore(scenario: ScenarioSpec,
                   window: float | None = None) -> policies.Strategy:
    """Ignore window predictions entirely (the RFO baseline on the window
    scenario; faults still materialize inside their windows)."""
    from ..core.windows import window_strategy
    return window_strategy(scenario.pp, _scenario_window(scenario, window),
                           mode="ignore")


@register_strategy("window_start")
def _window_start(scenario: ScenarioSpec,
                  window: float | None = None) -> policies.Strategy:
    """One proactive checkpoint completing at the window start (the
    'instant' reduction of a window prediction)."""
    from ..core.windows import window_strategy
    return window_strategy(scenario.pp, _scenario_window(scenario, window),
                           mode="instant")


@register_strategy("window_proactive")
def _window_proactive(scenario: ScenarioSpec, window: float | None = None,
                      window_period: float | None = None) -> policies.Strategy:
    """Periodic proactive checkpointing inside the window (period T_p*, or
    an explicit ``window_period``), with the window trust breakpoint."""
    from ..core.windows import window_strategy
    return window_strategy(scenario.pp, _scenario_window(scenario, window),
                           mode="within", window_period=window_period)


# -- silent-error strategies (arXiv:1310.8486; core/silent.py) --------------

def _scenario_verify(scenario: ScenarioSpec, verify_cost: float | None,
                     keep_ckpts: int | None) -> tuple[float, int]:
    from ..core.silent import DEFAULT_KEEP_CKPTS
    vc = scenario.verify_cost if verify_cost is None else float(verify_cost)
    if keep_ckpts is None:
        # The scenario default of 1 is the fail-stop value; verifying
        # strategies need depth >= 2 to survive a corrupted save.
        kc = max(scenario.keep_ckpts, DEFAULT_KEEP_CKPTS)
    else:
        kc = int(keep_ckpts)
    return vc, kc


@register_strategy("silent_ignore")
def _silent_ignore(scenario: ScenarioSpec) -> policies.Strategy:
    """The fail-stop RFO baseline running blind on the silent stream (no
    verifications; corruption is only caught by the acceptance check)."""
    from ..core.silent import silent_strategy
    return silent_strategy(scenario.platform, scenario.silent_mu,
                           mode="ignore")


@register_strategy("silent_verify")
def _silent_verify(scenario: ScenarioSpec, verify_cost: float | None = None,
                   keep_ckpts: int | None = None,
                   k_max: int = 16) -> policies.Strategy:
    """The jointly optimal (T*, k*) verification plan, never trusting
    predictions (core/silent.py)."""
    from ..core.silent import silent_strategy
    vc, kc = _scenario_verify(scenario, verify_cost, keep_ckpts)
    return silent_strategy(scenario.platform, scenario.silent_mu, vc,
                           mode="verify", k_max=k_max, keep_ckpts=kc)


@register_strategy("silent_verify_pred")
def _silent_verify_pred(scenario: ScenarioSpec,
                        verify_cost: float | None = None,
                        keep_ckpts: int | None = None,
                        k_max: int = 16) -> policies.Strategy:
    """The combined silent + prediction plan (Theorem-1 threshold trust
    on top of the (T*, k*) verification cadence)."""
    from ..core.silent import silent_strategy
    vc, kc = _scenario_verify(scenario, verify_cost, keep_ckpts)
    return silent_strategy(scenario.platform, scenario.silent_mu, vc,
                           mode="verify_pred", pp=scenario.pp, k_max=k_max,
                           keep_ckpts=kc)


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
    (:mod:`repro_torch.predictors.estimator`).  Both the initial plan and every
    re-plan solve the scenario's ``model_order`` analysis.  ``halflife``
    (observations) switches the estimator to its windowed (EW) variant so
    the plan tracks a drifting predictor instead of the all-time average.
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


# -- hazard-aware dynamic periods (beyond the paper; see benchmarks/beyond.py)

def aggregate_hazard(n: int, shape: float, mu_ind: float, t: float) -> float:
    """h(t) for N superposed fresh Weibull(shape) processors."""
    lam = mu_ind / math.gamma(1.0 + 1.0 / shape)
    t = max(t, 1.0)
    return n * (shape / lam) * (t / lam) ** (shape - 1.0)


@dataclasses.dataclass(frozen=True)
class HazardPeriod:
    """Callable period T(t) = sqrt(2 C / ((1-r) h(start + t))).

    Picklable (unlike a closure), so dynamic strategies survive the runner's
    process-parallel path and result caching.
    """

    n: int
    shape: float
    mu_ind: float
    start: float
    c: float
    recall: float = 0.0
    floor_mult: float = 1.0

    def __call__(self, t: float) -> float:
        h = aggregate_hazard(self.n, self.shape, self.mu_ind, self.start + t)
        mu_eff = 1.0 / max(h, 1e-12)
        t_opt = math.sqrt(2.0 * mu_eff * self.c
                          / max(1.0 - self.recall, 1e-6))
        return max(self.floor_mult * self.c, t_opt)


def _scenario_shape(scenario: ScenarioSpec, shape: float | None) -> float:
    if shape is not None:
        return shape
    if "shape" in scenario.dist.params:
        return float(scenario.dist.params["shape"])
    raise ValueError("dynamic strategies need a Weibull shape: pass "
                     "params={'shape': k} or use a weibull fault distribution")


@register_strategy("dynamic_rfo")
def _dynamic_rfo(scenario: ScenarioSpec, shape: float | None = None,
                 floor_mult: float = 1.0) -> policies.Strategy:
    """RFO with the period tracking the decaying aggregate Weibull hazard."""
    period = HazardPeriod(scenario.n, _scenario_shape(scenario, shape),
                          scenario.mu_ind, scenario.start, scenario.c,
                          floor_mult=floor_mult)
    return policies.Strategy("DynamicRFO", period, NeverTrust())


@register_strategy("dynamic_prediction")
def _dynamic_prediction(scenario: ScenarioSpec, shape: float | None = None,
                        floor_mult: float = 1.0) -> policies.Strategy:
    """OptimalPrediction with a hazard-tracking period (beta_lim unchanged)."""
    period = HazardPeriod(scenario.n, _scenario_shape(scenario, shape),
                          scenario.mu_ind, scenario.start, scenario.c,
                          recall=scenario.recall, floor_mult=floor_mult)
    return policies.Strategy("DynamicPrediction", period,
                             ThresholdTrust(beta_lim(scenario.pp)))
