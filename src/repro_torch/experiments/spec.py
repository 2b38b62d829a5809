"""Declarative experiment specifications (serializable, registry-backed).

The port's own copy of ``repro/experiments/spec.py``.  The paper's results
are all *sweeps* — over platform size, recall/precision, proactive-checkpoint
cost, candidate periods.  This module turns one sweep cell and one sweep
into data:

  * :class:`DistributionSpec` — a trace distribution by registry name + params;
  * :class:`PredictorSpec`    — a generative predictor model by name + params;
  * :class:`ScenarioSpec`     — platform + predictor + trace distribution +
                                time_base + seed (one simulation cell);
  * :class:`StrategySpec`     — a strategy by registry name + params;
  * :class:`SweepSpec`        — named axes over any scenario field, cartesian
                                or zipped;
  * :class:`ExperimentSpec`   — scenario x strategies x metrics.

Every spec round-trips through ``to_dict`` / ``from_dict`` (plain JSON types
only), and ``to_dict`` / ``key()`` give the JAX package's strings for the
same spec, so a spec stored by either package means the same cell in both.
Traces come from the per-trace path (trace ``i`` draws from
``default_rng(seed + 1009 * i)``) or, with ``make_traces(batched=True)``,
from one ``default_rng([seed, n])`` stream in shared waves; either bank is
bitwise the JAX package's.  Building runtime objects (``Distribution``,
``Strategy``) goes through :mod:`repro_torch.experiments.registry`.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Iterator, Mapping

import numpy as np

from ..core.prediction import PredictedPlatform, Predictor
from ..core.traces import (Distribution, EventTrace, make_event_trace,
                               make_event_trace_bank)
from ..core.waste import Platform

__all__ = [
    "SECONDS_PER_DAY",
    "MU_IND_SYNTH",
    "DistributionSpec",
    "PredictorSpec",
    "ScenarioSpec",
    "StrategySpec",
    "SweepSpec",
    "ExperimentSpec",
]

SECONDS_PER_DAY = 86400.0
MU_IND_SYNTH = 125.0 * 365.0 * 86400.0  # paper §5.1: 125-year individual MTBF


def _normalize(value: Any) -> Any:
    """Canonicalize lists to tuples (deep) so specs compare equal across a
    JSON round-trip (lists) and literal construction (tuples)."""
    if isinstance(value, (list, tuple)):
        return tuple(_normalize(v) for v in value)
    if isinstance(value, Mapping):
        return {str(k): _normalize(v) for k, v in value.items()}
    return value


def _jsonable(value: Any) -> Any:
    """Convert a spec field value to plain JSON types."""
    if dataclasses.is_dataclass(value) and hasattr(value, "to_dict"):
        return value.to_dict()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, Mapping):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return value


@dataclasses.dataclass(frozen=True)
class DistributionSpec:
    """A trace distribution referenced by registry name, e.g.
    ``DistributionSpec("weibull", {"shape": 0.7})``."""

    name: str
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(self, "params", _normalize(self.params))

    def build(self) -> Distribution:
        from .registry import build_distribution
        return build_distribution(self.name, **self.params)

    def to_dict(self) -> dict:
        return {"name": self.name, "params": _jsonable(self.params)}

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
    params carry only the model-specific knobs — so sweeping the nominal
    axis and the model family compose.  ``None`` on the scenario means the
    ``oracle`` stamping (bit-for-bit the legacy traces).
    """

    name: str
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(self, "params", _normalize(self.params))

    def build(self, recall: float, precision: float):
        from ..predictors import build_predictor
        return build_predictor(self.name, recall, precision, **self.params)

    def to_dict(self) -> dict:
        return {"name": self.name, "params": _jsonable(self.params)}

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

    Mirrors the paper's synthetic setting: N processors of individual MTBF
    ``mu_ind`` (platform MTBF mu = mu_ind / N), checkpoints C/R/D, a fault
    predictor (recall, precision) with proactive cost C_p = cp_ratio * C,
    faults drawn from ``dist`` (superposed per-processor streams when
    ``per_processor``), and a job of ``time_base_years_total / N`` years
    starting ``start`` seconds into the trace.

    ``window`` is the prediction-window length I (arXiv:1302.4558): with
    I > 0 every prediction event in the scenario's traces announces the
    interval [t, t+I] and the true fault materializes uniformly inside it.
    ``window=0`` (default) keeps exact-date predictions, bit-for-bit.

    ``predictor`` selects the generative predictor model
    (:mod:`repro_torch.predictors`) that turns the fault stream into the
    prediction stream; ``None`` (default) is the ``oracle`` stamping at
    the nominal (recall, precision), bit-for-bit the legacy traces.
    Model-emitted per-event windows (e.g. ``lead_time``) take precedence
    over the constant ``window`` stamping.

    ``model_order`` selects the *analysis order* scenario-aware strategies
    plan with: ``"first"`` (default) is the paper's first-order waste model
    (Eqs. 12/15), ``"exact"`` the exact-Exponential renewal analysis of
    :mod:`repro_torch.core.exact` (arXiv:1207.6936).  The order-aware registered
    strategies (``nopred``, ``prediction``, ``adaptive``) consult it, so a
    sweep axis ``{"model_order": ["first", "exact"]}`` compares the two
    analyses cell by cell on identical trace banks.
    """

    n: int = 2 ** 16
    dist: DistributionSpec = dataclasses.field(
        default_factory=lambda: DistributionSpec("exponential"))
    recall: float = 0.85
    precision: float = 0.82
    window: float = 0.0
    predictor: PredictorSpec | None = None
    model_order: str = "first"
    # Silent-error / verification axis (arXiv:1310.8486; core/silent.py):
    # ``silent_mu_ind`` is the per-processor silent-corruption MTBF (None =
    # no silent stream, bit-for-bit the legacy traces); the remaining three
    # are the scenario's default verification knobs, consulted by the
    # silent strategies the way ``window`` is by the window family.
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
        object.__setattr__(self, "extras", _normalize(self.extras))
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

    def _stream_args(self) -> tuple[int | None, Distribution | None]:
        n_streams = (max(1, self.n // self.procs_per_stream)
                     if self.per_processor else None)
        fdist = (self.false_pred_dist.build()
                 if self.false_pred_dist is not None else None)
        return n_streams, fdist

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
        n_streams, fdist = self._stream_args()
        tr = make_event_trace(
            self.dist.build(), self.mu, self.recall, self.precision,
            self.horizon, rng, false_pred_dist=fdist, n_processors=n_streams,
            window=self.window, predictor_model=self._predictor_model(),
            silent_mu=self.silent_mu)
        return self._shift(tr)

    def make_traces(self, n_traces: int | None = None,
                    seed: int | None = None, *,
                    batched: bool = False) -> list[EventTrace]:
        """The scenario's trace bank.

        ``batched=True`` samples the whole bank in shared RNG waves
        (:func:`repro_torch.core.traces.make_event_trace_bank`) — statistically
        identical; ~4x faster when the bank is many small traces (the
        per-trace Python overhead dominates) and a wash at paper-scale
        superposition where each trace already saturates the vectorized
        wave path (see ``BENCH_simulator.json``).  Drawn from one
        ``default_rng([seed, n])`` stream rather than the per-trace
        ``default_rng(seed + 1009*i)`` streams, so the two modes produce
        different (equally valid) banks.
        """
        n = self.n_traces if n_traces is None else n_traces
        if not batched:
            return [self.make_trace(i, seed=seed) for i in range(n)]
        seed = self.seed if seed is None else seed
        rng = np.random.default_rng([seed, n])
        n_streams, fdist = self._stream_args()
        bank = make_event_trace_bank(
            self.dist.build(), self.mu, self.recall, self.precision,
            self.horizon, rng, false_pred_dist=fdist,
            n_processors=n_streams, n_traces=n, window=self.window,
            predictor_model=self._predictor_model(),
            silent_mu=self.silent_mu)
        return [self._shift(tr) for tr in bank]

    # -- field update (dotted paths; how sweeps and the CLI set fields) ------

    def replace(self, **updates: Any) -> "ScenarioSpec":
        """``dataclasses.replace`` accepting dotted paths as keys.

        ``spec.replace(**{"n": 512, "dist.params.shape": 0.5})`` returns a
        new spec with the nested distribution parameter updated.
        """
        spec = self
        for path, value in updates.items():
            spec = spec._replace_path(path, value)
        return spec

    def _replace_path(self, path: str, value: Any) -> "ScenarioSpec":
        head, _, rest = path.partition(".")
        if not hasattr(self, head):
            raise KeyError(f"ScenarioSpec has no field {head!r}")
        if not rest:
            return dataclasses.replace(self, **{head: value})
        current = getattr(self, head)
        if head == "predictor" and current is None:
            # Descending into an unset predictor starts from the oracle.
            current = PredictorSpec("oracle")
        if isinstance(current, (DistributionSpec, PredictorSpec)):
            sub_head, _, sub_rest = rest.partition(".")
            if sub_head == "name" and not sub_rest:
                new = dataclasses.replace(current, name=value)
            elif sub_head == "params":
                params = dict(current.params)
                if sub_rest:
                    params[sub_rest] = value
                else:
                    params = dict(value)
                new = dataclasses.replace(current, params=params)
            else:
                raise KeyError(f"unknown {head} field {rest!r}")
            return dataclasses.replace(self, **{head: new})
        if isinstance(current, Mapping):
            sub = dict(current)
            sub[rest] = value
            return dataclasses.replace(self, **{head: sub})
        raise KeyError(f"cannot descend into scalar field {head!r}")

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            out[f.name] = _jsonable(getattr(self, f.name))
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScenarioSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown ScenarioSpec fields: {sorted(unknown)}")
        kw = dict(d)
        if "dist" in kw:
            kw["dist"] = _coerce_dist(kw["dist"])
        if kw.get("false_pred_dist") is not None:
            kw["false_pred_dist"] = _coerce_dist(kw["false_pred_dist"])
        if kw.get("predictor") is not None:
            kw["predictor"] = _coerce_pred(kw["predictor"])
        return cls(**kw)

    def key(self) -> str:
        """Canonical JSON string (cache key for the runner's trace bank)."""
        return json.dumps(self.to_dict(), sort_keys=True)


@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """A checkpointing strategy by registry name + params.

    ``label`` overrides the display name in result tables.  Examples::

        StrategySpec("rfo")
        StrategySpec("inexact_prediction", {"window": 1200.0})
        StrategySpec("best_period", {"base": "rfo", "n_points": 12})
    """

    name: str
    params: dict = dataclasses.field(default_factory=dict)
    label: str | None = None

    def build(self, scenario: ScenarioSpec):
        from .registry import build_strategy
        return build_strategy(self.name, scenario, **self.params)

    @property
    def display(self) -> str:
        return self.label if self.label is not None else self.name

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"name": self.name,
                               "params": _jsonable(self.params)}
        if self.label is not None:
            out["label"] = self.label
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | str) -> "StrategySpec":
        if isinstance(d, str):
            return cls(name=d)
        return cls(name=d["name"], params=dict(d.get("params", {})),
                   label=d.get("label"))


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Named axes over scenario fields, cartesian (default) or zipped.

    Axis keys are dotted field paths into :class:`ScenarioSpec`
    (``"n"``, ``"dist.params.shape"``, ``"extras.phi"``); a comma-separated
    key sweeps several fields together (``"recall,precision"`` with value
    pairs).  ``labels`` optionally maps an axis key to display values used
    in result-table columns (e.g. predictor names instead of number pairs);
    ``names`` renames an axis's result-table column (e.g.
    ``{"recall,precision": "predictor"}``).
    """

    axes: dict = dataclasses.field(default_factory=dict)
    mode: str = "cartesian"
    labels: dict = dataclasses.field(default_factory=dict)
    names: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        # Normalize AND coerce axis values (dist / predictor dicts become
        # specs), so directly-constructed sweeps compare equal to
        # ``from_dict`` round-trips.
        axes: dict[str, tuple] = {}
        for key, values in self.axes.items():
            fields = key.split(",")
            if len(fields) == 1:
                vals = tuple(self._coerce_axis_value(key, _normalize(v))
                             for v in values)
            else:
                vals = tuple(tuple(self._coerce_axis_value(f, _normalize(c))
                                   for f, c in zip(fields, v))
                             for v in values)
            axes[key] = vals
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "labels",
                           {k: _normalize(v) for k, v in self.labels.items()})
        if self.mode not in ("cartesian", "zip"):
            raise ValueError(f"unknown sweep mode {self.mode!r}")
        if self.mode == "zip" and self.axes:
            lengths = {len(v) for v in self.axes.values()}
            if len(lengths) > 1:
                raise ValueError(f"zip sweep axes differ in length: {lengths}")
        for key, names in self.labels.items():
            if key not in self.axes:
                raise ValueError(f"labels for unknown axis {key!r}")
            if len(names) != len(self.axes[key]):
                raise ValueError(f"labels/values length mismatch on {key!r}")
        for key in self.names:
            if key not in self.axes:
                raise ValueError(f"column name for unknown axis {key!r}")

    def _axis_column(self, key: str, idx: int, value: Any) -> Any:
        if key in self.labels:
            return self.labels[key][idx]
        if isinstance(value, (DistributionSpec, PredictorSpec)):
            return value.name
        if isinstance(value, Mapping):
            return json.dumps(_jsonable(value), sort_keys=True)
        if isinstance(value, (list, tuple)):
            return "/".join(str(v) for v in value)
        return value

    def _apply(self, spec: ScenarioSpec, key: str, value: Any) -> ScenarioSpec:
        fields = key.split(",")
        if len(fields) == 1:
            return spec.replace(**{key: value})
        if len(value) != len(fields):
            raise ValueError(f"axis {key!r} expects {len(fields)}-tuples, "
                             f"got {value!r}")
        return spec.replace(**dict(zip(fields, value)))

    def cells(self, base: ScenarioSpec) -> Iterator[tuple[dict, ScenarioSpec]]:
        """Yield ``(axis_columns, scenario)`` per sweep cell."""
        if not self.axes:
            yield {}, base
            return
        keys = list(self.axes)
        if self.mode == "zip":
            n = len(self.axes[keys[0]])
            index_sets: Iterator[tuple[int, ...]] = (
                (i,) * len(keys) for i in range(n))
        else:
            # First axis is major, last axis fastest (matches nested loops).
            index_sets = itertools.product(
                *(range(len(self.axes[k])) for k in keys))
        for indices in index_sets:
            cols: dict[str, Any] = {}
            spec = base
            for key, i in zip(keys, indices):
                value = self.axes[key][i]
                cols[self.names.get(key, key)] = \
                    self._axis_column(key, i, value)
                spec = self._apply(spec, key, value)
            yield cols, spec

    def to_dict(self) -> dict:
        return {"axes": {k: _jsonable(v) for k, v in self.axes.items()},
                "mode": self.mode,
                "labels": _jsonable(self.labels),
                "names": dict(self.names)}

    @staticmethod
    def _coerce_axis_value(field: str, value: Any) -> Any:
        if field in ("dist", "false_pred_dist") and value is not None:
            return _coerce_dist(value)
        if field == "predictor" and value is not None:
            return _coerce_pred(value)
        return value

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SweepSpec":
        axes: dict[str, list] = {}
        for key, values in d.get("axes", {}).items():
            fields = key.split(",")
            if len(fields) == 1:
                values = [cls._coerce_axis_value(key, v) for v in values]
            else:
                values = [tuple(cls._coerce_axis_value(f, comp)
                                for f, comp in zip(fields, v))
                          for v in values]
            axes[key] = list(values)
        return cls(axes=axes, mode=d.get("mode", "cartesian"),
                   labels={k: list(v)
                           for k, v in d.get("labels", {}).items()},
                   names=dict(d.get("names", {})))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Scenario x strategies x metrics (optionally swept over axes)."""

    name: str
    scenario: ScenarioSpec = dataclasses.field(default_factory=ScenarioSpec)
    strategies: tuple = ()
    sweep: SweepSpec | None = None
    metrics: tuple = ("makespan", "makespan_days", "waste")
    description: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "strategies",
            tuple(StrategySpec.from_dict(s) if not isinstance(s, StrategySpec)
                  else s for s in self.strategies))
        object.__setattr__(self, "metrics", tuple(self.metrics))
        if self.sweep is not None and not isinstance(self.sweep, SweepSpec):
            object.__setattr__(self, "sweep", SweepSpec.from_dict(self.sweep))

    def cells(self) -> Iterator[tuple[dict, ScenarioSpec]]:
        sweep = self.sweep or SweepSpec()
        yield from sweep.cells(self.scenario)

    def with_overrides(self, overrides: Mapping[str, Any]) -> "ExperimentSpec":
        """Apply ``--set``-style overrides: a sweep-axis name replaces that
        axis's values (dropping its display labels), any other dotted path
        updates the base scenario.  Overriding a scenario field that a sweep
        axis controls raises ``ValueError`` — the axis would silently
        discard the override per cell.  (The CLI and suite files share this
        semantics; see ``benchmarks/run.py --set``.)
        """
        sweep = self.sweep
        scenario = self.scenario

        def _covering_axis(field: str) -> str | None:
            # An axis discards a base-scenario override when one of its
            # swept paths equals the override path or is a prefix of it
            # (the axis replaces the whole subtree per cell).  An axis on a
            # *deeper* path (axis "dist.params.shape" vs override
            # "dist.name") merges instead, so the override survives.
            for axis_key in (sweep.axes if sweep else ()):
                for axis_field in axis_key.split(","):
                    if field == axis_field \
                            or field.startswith(axis_field + "."):
                        return axis_key
            return None

        for key, value in overrides.items():
            if sweep is not None and key in sweep.axes:
                values = list(value) if isinstance(value, (list, tuple)) \
                    else [value]
                axes = dict(sweep.axes)
                axes[key] = values
                labels = {k: v for k, v in sweep.labels.items() if k != key}
                sweep = dataclasses.replace(sweep, axes=axes, labels=labels)
            else:
                covering = next((a for f in key.split(",")
                                 for a in [_covering_axis(f)] if a), None)
                if covering:
                    raise ValueError(
                        f"field {key!r} is controlled by sweep axis "
                        f"{covering!r}; override the axis instead, e.g. "
                        f"--set '{covering}=[...]'")
                scenario = scenario.replace(**{key: value})
        return dataclasses.replace(self, sweep=sweep, scenario=scenario)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "scenario": self.scenario.to_dict(),
            "strategies": [s.to_dict() for s in self.strategies],
            "sweep": self.sweep.to_dict() if self.sweep else None,
            "metrics": list(self.metrics),
            "description": self.description,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentSpec":
        return cls(
            name=d["name"],
            scenario=ScenarioSpec.from_dict(d.get("scenario", {})),
            strategies=tuple(StrategySpec.from_dict(s)
                             for s in d.get("strategies", ())),
            sweep=(SweepSpec.from_dict(d["sweep"])
                   if d.get("sweep") else None),
            metrics=tuple(d.get("metrics",
                                ("makespan", "makespan_days", "waste"))),
            description=d.get("description", ""),
        )

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))
