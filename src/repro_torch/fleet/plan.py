"""Fleet planning: per-job (period, trust) under a shared objective.

Three planning layers compose here:

  * **objective**: a job without an explicit strategy gets the analytic
    optimum for the fleet's objective — the paper's waste-optimal plan
    (:func:`repro_torch.core.prediction.optimal_period_with_prediction`, with
    Theorem 1's beta_lim trust threshold) or the availability-optimal plan
    (:func:`repro_torch.fleet.availability.optimal_period_availability`, with the
    beta_A threshold), honouring each job's own (mu, C, C_p, r, p);
  * **shared predictor, per-job trust**: every job consumes the same
    (r, p)-characterized prediction stream, but each trusts it past its
    *own* threshold — a cheap-C_p job acts on predictions a costly-C_p job
    ignores;
  * **bandwidth-aware staggering**: jobs' first periods are offset by
    ``rank/n * T_job`` so their periodic save cadences start spread out
    instead of synchronized, reducing storage contention (the offset is a
    one-time callable-period shim; steady-state periods are unchanged).

The port's own copy of ``repro/fleet/plan.py``.
"""

from __future__ import annotations

import dataclasses

from ..core.prediction import (beta_lim, optimal_period_with_prediction,
                                   waste_with_prediction)
from ..core.simulator import NeverTrust, ThresholdTrust, TrustPolicy
from ..core.waste import waste
from .availability import (OutageWeights, beta_avail,
                                      optimal_period_availability,
                                      unavailability, unavailability_nopred)
from .spec import FleetJobSpec, FleetSpec

__all__ = ["JobPlan", "plan_job", "plan_fleet", "staggered_period",
           "expected_objective"]


@dataclasses.dataclass(frozen=True)
class JobPlan:
    """A planned job, ready for :class:`repro_torch.fleet.sim.FleetJobInput`."""

    period: float                # steady-state period T
    trust: TrustPolicy
    use_predictions: bool
    expected: float              # analytic objective value at T
    inexact_window: float = 0.0
    stagger_offset: float = 0.0  # added to the first period only

    @property
    def period_arg(self) -> object:
        """What the simulator gets: a float, or the staggered callable."""
        if self.stagger_offset <= 0.0:
            return self.period
        return staggered_period(self.period, self.stagger_offset)


def staggered_period(period: float, offset: float):
    """A callable period whose first evaluation (t == 0) is offset.

    ``_Machine`` evaluates the period function at every period start; only
    the initial one happens at t == 0, so the job's first checkpoint lands
    ``offset`` seconds later and the steady-state cadence is untouched.
    """
    def fn(t: float) -> float:
        return period + offset if t <= 0.0 else period
    return fn


def plan_job(job: FleetJobSpec, objective: str = "waste",
             outage: OutageWeights | None = None) -> JobPlan:
    """The analytic plan for one job under the fleet objective."""
    scenario = job.scenario
    if job.strategy is not None:
        strat = job.strategy.build(scenario)
        if strat.window_mode != "instant":
            raise ValueError(
                f"fleet jobs do not support window_mode="
                f"{strat.window_mode!r} (single-job engine feature)")
        if strat.adaptive is not None:
            raise ValueError("fleet jobs do not support adaptive "
                             "re-planning (single-job engine feature)")
        if callable(strat.period):
            raise ValueError("fleet jobs need a constant planned period")
        use = not isinstance(strat.trust, NeverTrust)
        t = float(strat.period)
        w = (waste_with_prediction(t, scenario.pp) if use
             else waste(t, scenario.platform))
        return JobPlan(period=t, trust=strat.trust, use_predictions=use,
                       expected=w, inexact_window=strat.inexact_window)

    if objective == "availability":
        w = outage or OutageWeights()
        t, u, use = optimal_period_availability(scenario.pp, w)
        trust: TrustPolicy = (ThresholdTrust(beta_avail(scenario.pp, w))
                              if use else NeverTrust())
        return JobPlan(period=t, trust=trust, use_predictions=use,
                       expected=u, inexact_window=scenario.window)

    t, w_star, use = optimal_period_with_prediction(scenario.pp)
    trust = ThresholdTrust(beta_lim(scenario.pp)) if use else NeverTrust()
    return JobPlan(period=t, trust=trust, use_predictions=use,
                   expected=w_star, inexact_window=scenario.window)


def plan_fleet(spec: FleetSpec) -> list[JobPlan]:
    """Plan every job; apply first-period staggering when enabled."""
    plans = [plan_job(j, spec.objective, spec.outage) for j in spec.jobs]
    if spec.stagger and len(plans) > 1:
        n = len(plans)
        plans = [dataclasses.replace(p, stagger_offset=(i / n) * p.period)
                 for i, p in enumerate(plans)]
    return plans


def expected_objective(job: FleetJobSpec, plan: JobPlan, objective: str,
                       outage: OutageWeights) -> float:
    """The analytic objective value of a plan (for simulator comparison)."""
    if objective == "availability":
        if plan.use_predictions:
            return unavailability(plan.period, job.scenario.pp, outage)
        return unavailability_nopred(plan.period, job.scenario.platform,
                                     outage)
    if plan.use_predictions:
        return waste_with_prediction(plan.period, job.scenario.pp)
    return waste(plan.period, job.scenario.platform)
