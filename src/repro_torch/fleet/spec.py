"""Declarative fleet specifications: heterogeneous jobs under shared limits.

A :class:`FleetSpec` is N jobs — each a full single-job
:class:`~repro_torch.experiments.spec.ScenarioSpec` (so every knob of the paper
model is available per job) plus an optional explicit
:class:`~repro_torch.experiments.spec.StrategySpec` — sharing:

  * one **objective** for the jobs planned implicitly: ``"waste"`` (the
    paper's makespan overhead) or ``"availability"`` (the weighted outage
    fraction of :mod:`repro_torch.fleet.availability` under ``outage`` weights);
  * **checkpoint-storage bandwidth**: ``storage_streams`` concurrent
    full-rate savers (None = uncontended);
  * **spare repair capacity**: ``repair_slots`` concurrent repairs
    (None = unbounded);
  * optionally **staggered** first checkpoints to desynchronize the
    periodic save cadences.

:func:`job_from_model` sizes a job from the ``repro_torch.configs`` model zoo:
C comes from the architecture's analytic parameter count through the
checkpoint manager's bytes/bandwidth cost model
(:func:`repro_torch.ckpt.manager.modeled_costs_from_bytes`), C_p from the
measured-or-prior proactive delta ratio, and mu from the per-chip MTBF and
the mesh size (mu = mu_ind / n_devices, paper Prop. 2).

Specs round-trip through ``to_dict`` / ``from_dict`` like every spec in
:mod:`repro_torch.experiments.spec`.

The port's own copy of ``repro/fleet/spec.py``: the specs are the port's
``ScenarioSpec``/``StrategySpec``, and :func:`job_from_model` sizes a job
from the port's ``configs`` and ``ckpt/manager.py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from ..experiments.spec import (SECONDS_PER_DAY, ScenarioSpec,
                                    StrategySpec, _jsonable)
from .availability import OutageWeights

__all__ = [
    "STATE_BYTES_PER_PARAM",
    "FleetJobSpec",
    "FleetSpec",
    "job_from_model",
]

# Mixed-precision training state: bf16 params + fp32 Adam m and v moments.
STATE_BYTES_PER_PARAM = 10.0

_OBJECTIVES = ("waste", "availability")


@dataclasses.dataclass(frozen=True)
class FleetJobSpec:
    """One tenant: a single-job scenario + how it plans + its SLO.

    ``strategy`` None means the fleet plans the job from the shared
    objective (:func:`repro_torch.fleet.plan.plan_job`); an explicit
    :class:`StrategySpec` reuses any registered single-job strategy.
    ``slo`` is the tenant's availability target in (0, 1): the per-tenant
    metric reports the fraction of runs meeting it.
    """

    scenario: ScenarioSpec
    strategy: StrategySpec | None = None
    name: str = ""
    slo: float | None = None

    def __post_init__(self) -> None:
        if not isinstance(self.scenario, ScenarioSpec):
            object.__setattr__(self, "scenario",
                               ScenarioSpec.from_dict(self.scenario))
        if self.strategy is not None \
                and not isinstance(self.strategy, StrategySpec):
            object.__setattr__(self, "strategy",
                               StrategySpec.from_dict(self.strategy))
        if self.slo is not None and not (0.0 < self.slo < 1.0):
            raise ValueError(f"slo must be in (0, 1), got {self.slo}")

    def to_dict(self) -> dict:
        return {"scenario": self.scenario.to_dict(),
                "strategy": (self.strategy.to_dict()
                             if self.strategy is not None else None),
                "name": self.name,
                "slo": self.slo}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetJobSpec":
        return cls(scenario=ScenarioSpec.from_dict(d["scenario"]),
                   strategy=(StrategySpec.from_dict(d["strategy"])
                             if d.get("strategy") else None),
                   name=d.get("name", ""),
                   slo=d.get("slo"))


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """N jobs + the shared objective, storage and repair limits."""

    jobs: tuple = ()
    objective: str = "waste"
    outage: OutageWeights = dataclasses.field(default_factory=OutageWeights)
    storage_streams: int | None = None
    repair_slots: int | None = None
    stagger: bool = False
    n_traces: int | None = None   # None: min over the jobs' scenarios
    name: str = "fleet"

    def __post_init__(self) -> None:
        jobs = tuple(j if isinstance(j, FleetJobSpec)
                     else FleetJobSpec.from_dict(j) for j in self.jobs)
        object.__setattr__(self, "jobs", jobs)
        if not isinstance(self.outage, OutageWeights):
            object.__setattr__(self, "outage",
                               OutageWeights.from_dict(self.outage))
        if self.objective not in _OBJECTIVES:
            raise ValueError(f"objective must be one of {_OBJECTIVES}, "
                             f"got {self.objective!r}")

    @property
    def n_runs(self) -> int:
        """Fleet replications: bounded by every job's trace bank."""
        if not self.jobs:
            return 0
        n = min(j.scenario.n_traces for j in self.jobs)
        return n if self.n_traces is None else min(n, self.n_traces)

    def job_name(self, idx: int) -> str:
        return self.jobs[idx].name or f"job{idx}"

    def to_dict(self) -> dict:
        return {"jobs": [j.to_dict() for j in self.jobs],
                "objective": self.objective,
                "outage": self.outage.to_dict(),
                "storage_streams": self.storage_streams,
                "repair_slots": self.repair_slots,
                "stagger": self.stagger,
                "n_traces": self.n_traces,
                "name": self.name}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FleetSpec":
        return cls(jobs=tuple(FleetJobSpec.from_dict(j)
                              for j in d.get("jobs", ())),
                   objective=d.get("objective", "waste"),
                   outage=OutageWeights.from_dict(d.get("outage", {})),
                   storage_streams=d.get("storage_streams"),
                   repair_slots=d.get("repair_slots"),
                   stagger=d.get("stagger", False),
                   n_traces=d.get("n_traces"),
                   name=d.get("name", "fleet"))

    def key(self) -> str:
        """Canonical JSON string (cache / golden-pin key)."""
        return json.dumps(_jsonable(self.to_dict()), sort_keys=True)


def job_from_model(arch: str, *, n_devices: int,
                   mu_ind: float | None = None,
                   d: float = 60.0, r: float | None = None,
                   ckpt_bandwidth: float = 2e9,
                   delta_ratio: float | None = None,
                   recall: float = 0.85, precision: float = 0.82,
                   time_base_days: float = 30.0,
                   n_traces: int = 5, seed: int = 0,
                   start_days: float = 365.0,
                   name: str | None = None,
                   slo: float | None = None,
                   strategy: StrategySpec | None = None) -> FleetJobSpec:
    """Size a fleet job from the ``repro_torch.configs`` model zoo.

    The checkpoint cost C is the architecture's analytic state size
    (``param_count() * STATE_BYTES_PER_PARAM`` bytes: bf16 params + fp32
    Adam moments) through the per-shard bytes/bandwidth model of
    :func:`repro_torch.ckpt.manager.modeled_costs_from_bytes`; C_p applies
    ``delta_ratio`` (default: the manager's measured-delta prior).
    Recovery R defaults to C (read back the same bytes).
    """
    from ..ckpt.manager import (DELTA_RATIO_PRIOR,
                                    modeled_costs_from_bytes)
    from ..configs import get as get_model
    from ..experiments.spec import MU_IND_SYNTH

    cfg = get_model(arch)
    nbytes = cfg.param_count() * STATE_BYTES_PER_PARAM
    ratio = DELTA_RATIO_PRIOR if delta_ratio is None else delta_ratio
    c, cp = modeled_costs_from_bytes(nbytes, bandwidth=ckpt_bandwidth,
                                     n_shards=n_devices, delta_ratio=ratio)
    scenario = ScenarioSpec(
        n=n_devices,
        recall=recall, precision=precision,
        c=c, cp_ratio=cp / c,
        d=d, r=(c if r is None else r),
        mu_ind=MU_IND_SYNTH if mu_ind is None else mu_ind,
        # ScenarioSpec divides the total by n: undo it for a fixed per-job
        # duration regardless of mesh size.
        time_base_years_total=time_base_days / 365.0 * n_devices,
        start=start_days * SECONDS_PER_DAY,
        n_traces=n_traces, seed=seed)
    return FleetJobSpec(scenario=scenario, strategy=strategy,
                        name=name if name is not None else arch, slo=slo)
