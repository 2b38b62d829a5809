"""Scenario specifications: one simulation cell of the paper's study.

The port's own copy of the JAX package's ``experiments/spec.py``
(:class:`DistributionSpec`, :class:`PredictorSpec`, and
:class:`ScenarioSpec` with the fields of the golden cells and their
defaults).  Traces come from the per-trace path: trace ``i`` draws from
``default_rng(seed + 1009 * i)``, so a bank made here is bitwise the JAX
package's.  The distributions are the reference's registered six
(``repro/experiments/registry.py:145-170``).

Not ported yet: the batched bank path (ROADMAP A2) and ``StrategySpec``,
``SweepSpec`` and ``ExperimentSpec`` (A4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from ..core.prediction import PredictedPlatform, Predictor
from ..core.traces import (Distribution, Empirical, EventTrace, Exponential,
                           LogNormalDist, UniformDist, Weibull,
                           lanl_like_log, make_event_trace)
from ..core.waste import Platform

__all__ = ["SECONDS_PER_DAY", "MU_IND_SYNTH", "DistributionSpec",
           "PredictorSpec", "ScenarioSpec"]

SECONDS_PER_DAY = 86400.0
MU_IND_SYNTH = 125.0 * 365.0 * 86400.0  # paper §5.1: 125-year individual MTBF

_DISTRIBUTIONS = {
    "exponential": lambda mean=1.0: Exponential(mean),
    "weibull": lambda shape=0.7, mean=1.0: Weibull(shape, mean),
    "uniform": lambda mean=1.0: UniformDist(mean),
    "lognormal": lambda sigma=1.0, mean=1.0: LogNormalDist(sigma, mean),
    "empirical": lambda samples=(): Empirical(tuple(float(s)
                                                    for s in samples)),
    # LANL-like empirical availability-interval log (paper §5.3 mechanism).
    "lanl": lambda n_intervals=3010, mu_ind_days=691.0, shape=0.6, seed=42:
        lanl_like_log(np.random.default_rng(seed), n_intervals=n_intervals,
                      mu_ind_days=mu_ind_days, shape=shape),
}


@dataclasses.dataclass(frozen=True)
class DistributionSpec:
    """A trace distribution by name, e.g. ``DistributionSpec("weibull",
    {"shape": 0.7})``."""

    name: str
    params: dict = dataclasses.field(default_factory=dict)

    def build(self) -> Distribution:
        try:
            factory = _DISTRIBUTIONS[self.name]
        except KeyError:
            raise KeyError(f"unknown distribution {self.name!r}; "
                           f"registered: {sorted(_DISTRIBUTIONS)}") from None
        return factory(**self.params)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "DistributionSpec":
        return cls(name=d["name"], params=dict(d.get("params", {})))


def _coerce_dist(value: Any) -> DistributionSpec | None:
    if value is None or isinstance(value, DistributionSpec):
        return value
    if isinstance(value, Mapping):
        return DistributionSpec.from_dict(value)
    raise TypeError(f"cannot coerce {value!r} into a DistributionSpec")


@dataclasses.dataclass(frozen=True)
class PredictorSpec:
    """A generative predictor model by registry name, e.g.
    ``PredictorSpec("drifting", {"precision_end": 0.3})``.

    The model is built at the scenario's nominal (recall, precision) —
    params carry only the model-specific knobs.  ``None`` on the scenario
    means the ``oracle`` stamping.
    """

    name: str
    params: dict = dataclasses.field(default_factory=dict)

    def build(self, recall: float, precision: float):
        from ..predictors import build_predictor
        return build_predictor(self.name, recall, precision, **self.params)

    def to_dict(self) -> dict:
        return {"name": self.name, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | str) -> "PredictorSpec":
        if isinstance(d, str):
            return cls(name=d)
        return cls(name=d["name"], params=dict(d.get("params", {})))


def _coerce_pred(value: Any) -> PredictorSpec | None:
    if value is None or isinstance(value, PredictorSpec):
        return value
    if isinstance(value, (Mapping, str)):
        return PredictorSpec.from_dict(value)
    raise TypeError(f"cannot coerce {value!r} into a PredictorSpec")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One simulation cell (paper §5.1 defaults).

    N processors of individual MTBF ``mu_ind`` (platform MTBF mu =
    mu_ind / N), checkpoints C/R/D, a fault predictor (recall, precision)
    with proactive cost C_p = cp_ratio * C, faults drawn from ``dist``
    (superposed per-processor streams when ``per_processor``), and a job
    of ``time_base_years_total / N`` years starting ``start`` seconds into
    the trace.  ``window`` stamps every prediction with the window length
    I (arXiv:1302.4558); ``silent_mu_ind`` adds a silent-corruption stream
    and ``verify_cost`` / ``n_verify`` / ``keep_ckpts`` are the scenario's
    verification knobs (arXiv:1310.8486).  ``predictor`` selects the
    generative predictor model (``None``: the oracle stamping);
    ``model_order`` the analysis the order-aware strategies plan with
    (``"first"``, the paper's first-order model, or ``"exact"``, the
    exact-Exponential renewal analysis of :mod:`repro_torch.core.exact`).
    """

    n: int = 2 ** 16
    dist: DistributionSpec = dataclasses.field(
        default_factory=lambda: DistributionSpec("exponential"))
    recall: float = 0.85
    precision: float = 0.82
    window: float = 0.0
    predictor: PredictorSpec | None = None
    model_order: str = "first"
    silent_mu_ind: float | None = None
    verify_cost: float = 0.0
    n_verify: int = 0
    keep_ckpts: int = 1
    cp_ratio: float = 1.0
    c: float = 600.0
    r: float = 600.0
    d: float = 60.0
    mu_ind: float = MU_IND_SYNTH
    time_base_years_total: float = 10_000.0
    false_pred_dist: DistributionSpec | None = None
    per_processor: bool = True
    procs_per_stream: int = 1
    start: float = 365.0 * SECONDS_PER_DAY
    n_traces: int = 10
    seed: int = 0
    extras: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(self, "dist", _coerce_dist(self.dist))
        object.__setattr__(self, "false_pred_dist",
                           _coerce_dist(self.false_pred_dist))
        object.__setattr__(self, "predictor", _coerce_pred(self.predictor))
        if self.model_order not in ("first", "exact"):
            raise ValueError(f"model_order must be 'first' or 'exact', "
                             f"got {self.model_order!r}")
        if self.silent_mu_ind is not None and not self.silent_mu_ind > 0:
            raise ValueError(f"silent_mu_ind must be positive or None, "
                             f"got {self.silent_mu_ind}")
        if not self.verify_cost >= 0.0:
            raise ValueError(f"verify_cost must be >= 0, "
                             f"got {self.verify_cost}")
        if self.n_verify < 0:
            raise ValueError(f"n_verify must be >= 0, got {self.n_verify}")
        if self.keep_ckpts < 1:
            raise ValueError(f"keep_ckpts must be >= 1, "
                             f"got {self.keep_ckpts}")

    # -- derived quantities --------------------------------------------------

    @property
    def mu(self) -> float:
        return self.mu_ind / self.n

    @property
    def silent_mu(self) -> float | None:
        """Platform-level silent-corruption MTBF (None = stream off)."""
        if self.silent_mu_ind is None:
            return None
        return self.silent_mu_ind / self.n

    @property
    def platform(self) -> Platform:
        return Platform(mu=self.mu, c=self.c, d=self.d, r=self.r)

    @property
    def nominal_predictor(self) -> Predictor:
        """The (recall, precision) pair as the analytic-model Predictor."""
        return Predictor(recall=self.recall, precision=self.precision)

    @property
    def pp(self) -> PredictedPlatform:
        return PredictedPlatform(self.platform, self.nominal_predictor,
                                 cp=self.cp_ratio * self.c)

    @property
    def cp(self) -> float:
        return self.cp_ratio * self.c

    @property
    def time_base(self) -> float:
        return self.time_base_years_total * 365.0 * SECONDS_PER_DAY / self.n

    @property
    def horizon(self) -> float:
        return self.start + max(60.0 * self.time_base, 50.0 * self.mu)

    # -- trace generation ----------------------------------------------------

    def _predictor_model(self):
        """The built generative predictor model, or None (oracle path)."""
        if self.predictor is None:
            return None
        return self.predictor.build(self.recall, self.precision)

    def _shift(self, tr: EventTrace) -> EventTrace:
        # Shift so the job starts ``start`` seconds into the trace (avoids
        # the synchronized-processor-start artifact, paper §5.1).
        sel = tr.times >= self.start
        return EventTrace(tr.times[sel] - self.start, tr.kinds[sel],
                          self.horizon - self.start,
                          windows=None if tr.windows is None
                          else tr.windows[sel])

    def make_trace(self, index: int, seed: int | None = None) -> EventTrace:
        """Trace ``index`` of this scenario's bank (seeded, reproducible)."""
        seed = self.seed if seed is None else seed
        rng = np.random.default_rng(seed + 1009 * index)
        n_streams = (max(1, self.n // self.procs_per_stream)
                     if self.per_processor else None)
        fdist = (self.false_pred_dist.build()
                 if self.false_pred_dist is not None else None)
        tr = make_event_trace(
            self.dist.build(), self.mu, self.recall, self.precision,
            self.horizon, rng, false_pred_dist=fdist, n_processors=n_streams,
            window=self.window, predictor_model=self._predictor_model(),
            silent_mu=self.silent_mu)
        return self._shift(tr)

    def make_traces(self, n_traces: int | None = None,
                    seed: int | None = None) -> list[EventTrace]:
        """The scenario's trace bank, one seeded trace at a time."""
        n = self.n_traces if n_traces is None else n_traces
        return [self.make_trace(i, seed=seed) for i in range(n)]
