"""Fleet evaluation: simulate a :class:`FleetSpec`, report per-tenant SLOs.

``fleet_sweep`` path through :mod:`repro_torch.experiments`: plan every job
(:func:`repro_torch.fleet.plan.plan_fleet`), replicate the fleet over ``n_runs``
independent trace draws (per-job trace ``i`` and simulation RNG seeded by
the *same* ``seed + 1009*i`` / ``seed + 7919*i`` recipe as the single-job
runner — the bit-for-bit degeneracy contract), and reduce to one
:class:`~repro_torch.experiments.runner.ResultTable` row per job with:

  * ``waste`` / ``unavailability`` — measured, averaged over runs
    (unavailability weighs checkpoint / proactive / replay time by the
    fleet's :class:`~repro_torch.fleet.availability.OutageWeights` and adds
    contention stretch + repair-queue waiting in full);
  * ``expected_unavailability`` (or expected waste) — the analytic model
    at the planned period, for model-vs-simulator tracking;
  * ``slo_met`` — fraction of runs with availability >= the tenant's SLO;
  * contention / repair-wait seconds, fault / prediction counters.

The port's own copy of ``repro/fleet/experiment.py``; it returns the
port's :class:`~repro_torch.experiments.runner.ResultTable`.
"""

from __future__ import annotations

import numpy as np

from ..experiments.runner import ResultTable
from ..experiments.spec import SECONDS_PER_DAY
from .availability import measured_unavailability
from .plan import JobPlan, expected_objective, plan_fleet
from .sim import FleetJobInput, FleetJobResult, simulate_fleet
from .spec import FleetSpec

__all__ = ["evaluate_fleet", "fleet_run_results"]


def fleet_run_results(spec: FleetSpec,
                      plans: list[JobPlan] | None = None,
                      ) -> list[list[FleetJobResult]]:
    """Raw per-run, per-job results (run-major: ``out[run][job]``)."""
    plans = plan_fleet(spec) if plans is None else plans
    out: list[list[FleetJobResult]] = []
    for i in range(spec.n_runs):
        inputs = []
        for job, plan in zip(spec.jobs, plans):
            sc = job.scenario
            inputs.append(FleetJobInput(
                trace=sc.make_trace(i),
                platform=sc.platform,
                time_base=sc.time_base,
                period=plan.period_arg,
                cp=sc.cp,
                trust=plan.trust,
                inexact_window=plan.inexact_window,
                rng=np.random.default_rng(sc.seed + 7919 * i),
                name=job.name))
        fleet = simulate_fleet(inputs,
                               storage_streams=spec.storage_streams,
                               repair_slots=spec.repair_slots)
        out.append(fleet.jobs)
    return out


def evaluate_fleet(spec: FleetSpec) -> ResultTable:
    """Simulate the fleet; one :class:`ResultTable` row per job."""
    plans = plan_fleet(spec)
    runs = fleet_run_results(spec, plans)
    rows = []
    for j, (job, plan) in enumerate(zip(spec.jobs, plans)):
        per_run = [run[j] for run in runs]
        unavail = [
            measured_unavailability(
                makespan=r.sim.makespan,
                time_ckpt=r.sim.time_ckpt,
                time_prockpt=r.sim.time_prockpt,
                time_down=r.sim.time_down,
                time_lost=r.sim.time_lost,
                w=spec.outage,
                time_contention_ckpt=r.time_contention_ckpt,
                time_contention_prockpt=r.time_contention_prockpt,
                time_repair_wait=r.time_repair_wait)
            for r in per_run
        ]
        availability = [1.0 - u for u in unavail]
        slo_met = (None if job.slo is None else
                   float(np.mean([a >= job.slo for a in availability])))
        rows.append({
            "fleet": spec.name,
            "job": spec.job_name(j),
            "objective": spec.objective,
            "period": plan.period,
            "use_predictions": plan.use_predictions,
            "stagger_offset": plan.stagger_offset,
            "makespan_days": float(np.mean(
                [r.sim.makespan for r in per_run])) / SECONDS_PER_DAY,
            "waste": float(np.mean([r.sim.waste for r in per_run])),
            "unavailability": float(np.mean(unavail)),
            "availability": float(np.mean(availability)),
            "expected_objective": expected_objective(
                job, plan, spec.objective, spec.outage),
            "slo": job.slo,
            "slo_met": slo_met,
            "contention_ckpt_s": float(np.mean(
                [r.time_contention_ckpt for r in per_run])),
            "contention_prockpt_s": float(np.mean(
                [r.time_contention_prockpt for r in per_run])),
            "repair_wait_s": float(np.mean(
                [r.time_repair_wait for r in per_run])),
            "n_faults": float(np.mean([r.sim.n_faults for r in per_run])),
            "n_trusted": float(np.mean([r.sim.n_trusted for r in per_run])),
        })
    return ResultTable(rows)
