"""Declarative scenario suites: experiment collections + expected-claim asserts.

The port's own copy of ``repro/store/suite.py``.  Two differences:
:meth:`SuiteSpec.ensure_registered` imports only modules of the port
(``repro_torch.*``; see its docstring), and a ``benchmark:`` item, which
names a script of ``benchmarks/`` that the port does not run, is reported
as an item error by the port's suite runner.  Suite files read the same
in both packages; on a machine without PyYAML write them as JSON
(``suites/quick_torch.json``).

A **suite file** (YAML or JSON) collects runnable items with the claims the
repo's benchmark scripts used to hard-code, lifting them into data::

    suite: quick
    description: pinned CI suite
    register: [benchmarks.run]        # modules whose import registers items
    defaults: {quick: true}
    items:
      - experiment: window_sweep      # a registered ExperimentSpec builder
        n_traces: 4
        claims:
          - {kind: compare, metric: makespan, op: "==",
             lhs: {strategy: WindowStart, window: 0.0, predictor: good},
             rhs: {strategy: OptimalPrediction, window: 0.0, predictor: good}}
          - {kind: monotonic, metric: makespan, over: window,
             where: {strategy: WindowStart, predictor: good},
             direction: increasing}
      - benchmark: fleet_sweep        # a paper-claim benchmark function
        claims:
          - {kind: bound, path: model_vs_sim.llama3-405b, min: 0.9, max: 1.1}

Item forms:

  * ``experiment:`` — a registered experiment name (``build_experiment``)
    or ``spec:`` an inline :class:`ExperimentSpec` dict; optional
    ``args`` (builder kwargs), ``overrides`` (``--set`` semantics via
    :meth:`ExperimentSpec.with_overrides`), ``n_traces`` / ``seed`` /
    ``engine`` execution context.  Claims address the tidy result table by
    ``metric`` + ``where`` (axis-column equality).
  * ``benchmark:`` — a benchmark-suite function from the
    :mod:`benchmarks.run` registry (its internal paper-claim asserts run
    too).  Claims address the returned payload by dotted ``path``.

Claim kinds:

  * ``pinned``     — a value equals ``value`` within ``tol`` (absolute)
    and/or ``rel_tol`` (relative); both omitted = exact;
  * ``bound``      — a value within ``[min, max]``;
  * ``compare``    — ``lhs <op> rhs`` for two looked-up values, with an
    optional ``rel_factor`` scaling the rhs (e.g. "within 3%": op ``<=``,
    rel_factor 1.03);
  * ``monotonic``  — a metric is monotone along a sweep column (sorted by
    that column's numeric value), ``direction`` increasing/decreasing,
    optional ``tol`` slack.

Claims are evaluated on every suite run — including store-resumed ones, so
tightening a claim re-gates cached results without re-simulating.
"""

from __future__ import annotations

import dataclasses
import json
import operator
from pathlib import Path
from typing import Any, Mapping, Sequence

__all__ = [
    "ClaimSpec",
    "SuiteItem",
    "SuiteSpec",
    "evaluate_claims",
    "lookup_path",
]

_OPS = {"<": operator.lt, "<=": operator.le, ">": operator.gt,
        ">=": operator.ge, "==": operator.eq}


def lookup_path(payload: Mapping[str, Any], path: str) -> Any:
    """Dotted-path lookup into a nested payload dict (list indices OK):
    ``lookup_path(p, "engine.speedup")``, ``lookup_path(p, "rows.0.waste")``.
    """
    cur: Any = payload
    for part in path.split("."):
        if isinstance(cur, Mapping):
            if part not in cur:
                raise KeyError(f"payload path {path!r}: no key {part!r} "
                               f"(have {sorted(cur)[:12]})")
            cur = cur[part]
        elif isinstance(cur, Sequence) and not isinstance(cur, str):
            cur = cur[int(part)]
        else:
            raise KeyError(f"payload path {path!r}: cannot descend into "
                           f"{type(cur).__name__} at {part!r}")
    return cur


@dataclasses.dataclass(frozen=True)
class ClaimSpec:
    """One expected-claim assert (see module docstring)."""

    kind: str
    metric: str | None = None          # table claims
    where: dict = dataclasses.field(default_factory=dict)
    path: str | None = None            # payload claims
    value: Any = None                  # pinned
    tol: float | None = None
    rel_tol: float | None = None
    min: float | None = None           # bound
    max: float | None = None
    lhs: dict | None = None            # compare
    rhs: dict | None = None
    op: str = "<"
    rel_factor: float = 1.0
    over: str | None = None            # monotonic
    direction: str = "increasing"
    label: str | None = None

    def __post_init__(self) -> None:
        if self.kind not in ("pinned", "bound", "compare", "monotonic"):
            raise ValueError(f"unknown claim kind {self.kind!r}")
        if self.kind == "compare" and self.op not in _OPS:
            raise ValueError(f"unknown compare op {self.op!r}")
        if self.kind == "monotonic":
            if self.direction not in ("increasing", "decreasing"):
                raise ValueError(
                    f"monotonic direction must be increasing/decreasing, "
                    f"got {self.direction!r}")
            if not self.over:
                raise ValueError("monotonic claim needs 'over' (the column)")

    # -- construction --------------------------------------------------------

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ClaimSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown claim fields: {sorted(unknown)}")
        return cls(**{k: (dict(v) if isinstance(v, Mapping) else v)
                      for k, v in d.items()})

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"kind": self.kind}
        for f in dataclasses.fields(self):
            if f.name == "kind":
                continue
            v = getattr(self, f.name)
            default = (f.default_factory()
                       if f.default is dataclasses.MISSING else f.default)
            if v != default:
                out[f.name] = v
        return out

    @property
    def display(self) -> str:
        if self.label:
            return self.label
        if self.kind == "pinned":
            tgt = self.path or f"{self.metric} @ {self.where}"
            return f"pinned {tgt} == {self.value}"
        if self.kind == "bound":
            tgt = self.path or f"{self.metric} @ {self.where}"
            return f"bound {self.min} <= {tgt} <= {self.max}"
        if self.kind == "compare":
            fac = f" * {self.rel_factor}" if self.rel_factor != 1.0 else ""
            return f"{self.metric or self.path} {self.lhs} {self.op} " \
                   f"{self.rhs}{fac}"
        return f"{self.metric} {self.direction} over {self.over} " \
               f"@ {self.where}"

    # -- evaluation ----------------------------------------------------------

    def _value(self, table, payload: Mapping[str, Any],
               where: Mapping[str, Any] | None = None) -> Any:
        if self.path is not None:
            return lookup_path(payload, self.path)
        if table is None:
            raise KeyError("table claim on a payload-only record "
                           "(set 'path' instead of 'metric'/'where')")
        return table.value(self.metric, **(self.where if where is None
                                           else dict(where)))

    def evaluate(self, table, payload: Mapping[str, Any]) -> dict:
        """-> ``{"claim", "ok", "detail"}`` (never raises on a failed
        comparison — only on a malformed claim/lookup)."""
        try:
            ok, detail = self._check(table, payload)
        except (KeyError, IndexError, TypeError, ValueError) as e:
            ok, detail = False, f"lookup error: {e}"
        return {"claim": self.display, "kind": self.kind, "ok": bool(ok),
                "detail": detail}

    def _check(self, table, payload) -> tuple[bool, str]:
        if self.kind == "pinned":
            got = float(self._value(table, payload))
            want = float(self.value)
            err = abs(got - want)
            lim = max(self.tol or 0.0,
                      (self.rel_tol or 0.0) * abs(want))
            ok = err <= lim if (self.tol is not None
                                or self.rel_tol is not None) \
                else got == want
            return ok, f"got {got!r}, pinned {want!r} (|err| {err:.3g})"
        if self.kind == "bound":
            got = float(self._value(table, payload))
            ok = (self.min is None or got >= self.min) \
                and (self.max is None or got <= self.max)
            return ok, f"got {got!r} in [{self.min}, {self.max}]"
        if self.kind == "compare":
            a = float(self._value(table, payload, where=self.lhs))
            b = float(self._value(table, payload, where=self.rhs)) \
                * self.rel_factor
            return _OPS[self.op](a, b), f"{a!r} {self.op} {b!r}"
        # monotonic
        sub = table.where(**self.where)
        pairs = sorted(((row[self.over], row[self.metric])
                        for row in sub.rows), key=lambda kv: float(kv[0]))
        if len(pairs) < 2:
            return False, f"monotonic needs >= 2 rows, got {len(pairs)}"
        vals = [float(v) for _, v in pairs]
        tol = self.tol or 0.0
        if self.direction == "increasing":
            ok = all(b >= a - tol for a, b in zip(vals, vals[1:]))
        else:
            ok = all(b <= a + tol for a, b in zip(vals, vals[1:]))
        return ok, f"{self.direction} over {self.over}: " \
                   f"{[round(v, 6) for v in vals]}"


@dataclasses.dataclass(frozen=True)
class SuiteItem:
    """One runnable suite entry (experiment or benchmark; see module doc)."""

    experiment: str | None = None
    benchmark: str | None = None
    spec: dict | None = None
    args: dict = dataclasses.field(default_factory=dict)
    overrides: dict = dataclasses.field(default_factory=dict)
    quick: bool = True
    n_traces: int | None = None
    seed: int | None = None
    engine: str | None = None
    batched_traces: bool = False
    claims: tuple = ()
    label: str | None = None

    def __post_init__(self) -> None:
        targets = [t for t in (self.experiment, self.benchmark, self.spec)
                   if t is not None]
        if len(targets) != 1:
            raise ValueError("suite item needs exactly one of "
                             "experiment / benchmark / spec")
        if self.benchmark is not None and (self.overrides or self.args
                                           or self.n_traces is not None
                                           or self.seed is not None):
            raise ValueError(
                f"benchmark item {self.benchmark!r} only takes "
                f"quick/engine/claims (its script owns its parameters)")
        object.__setattr__(
            self, "claims",
            tuple(c if isinstance(c, ClaimSpec) else ClaimSpec.from_dict(c)
                  for c in self.claims))

    @property
    def name(self) -> str:
        if self.label:
            return self.label
        if self.experiment:
            return self.experiment
        if self.benchmark:
            return self.benchmark
        return self.spec.get("name", "inline")

    @property
    def kind(self) -> str:
        return "benchmark" if self.benchmark else "experiment"

    @classmethod
    def from_dict(cls, d: Mapping[str, Any],
                  defaults: Mapping[str, Any] | None = None) -> "SuiteItem":
        merged: dict[str, Any] = dict(defaults or {})
        merged.update(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(merged) - known
        if unknown:
            raise KeyError(f"unknown suite item fields: {sorted(unknown)}")
        if "claims" in merged:
            merged["claims"] = tuple(merged["claims"])
        return cls(**merged)


@dataclasses.dataclass(frozen=True)
class SuiteSpec:
    """A parsed suite file."""

    name: str
    items: tuple = ()
    description: str = ""
    register: tuple = ("benchmarks.run",)
    defaults: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "items",
            tuple(i if isinstance(i, SuiteItem)
                  else SuiteItem.from_dict(i, self.defaults)
                  for i in self.items))
        object.__setattr__(self, "register", tuple(self.register))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SuiteSpec":
        known = {"suite", "name", "items", "experiments", "description",
                 "register", "defaults"}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown suite fields: {sorted(unknown)}")
        name = d.get("suite") or d.get("name")
        if not name:
            raise KeyError("suite file needs a 'suite' (or 'name') field")
        items = d.get("items", d.get("experiments", ()))
        return cls(name=str(name), items=tuple(items),
                   description=str(d.get("description", "")),
                   register=tuple(d.get("register", ("benchmarks.run",))),
                   defaults=dict(d.get("defaults", {})))

    @classmethod
    def from_file(cls, path: str | Path) -> "SuiteSpec":
        path = Path(path)
        text = path.read_text()
        if path.suffix in (".yaml", ".yml"):
            try:
                import yaml
            except ImportError as e:   # pragma: no cover - yaml is baked in
                raise RuntimeError(
                    f"{path}: YAML suite files need PyYAML; rewrite the "
                    f"suite as .json or install pyyaml") from e
            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        if not isinstance(data, Mapping):
            raise ValueError(f"{path}: suite file must be a mapping")
        return cls.from_dict(data)

    def ensure_registered(self) -> None:
        """Import the modules that register the suite's experiments,
        calling their registration hook (``_import_benchmarks`` or
        ``register_all``) when they have one.  Best effort per module; a
        missing registration surfaces loudly at item lookup.

        Only modules of the port (``repro_torch`` and ``repro_torch.*``)
        are imported; every other name is skipped.  The reference's
        default, ``benchmarks.run``, registers the JAX package's
        benchmarks and would import ``repro`` and JAX, which the port
        never does.  The reference skips a module that fails to import,
        so skipping one is the same best effort; an item that needed it
        fails at lookup as an unknown experiment."""
        import importlib
        for name in self.register:
            if name != "repro_torch" and not name.startswith("repro_torch."):
                continue
            try:
                mod = importlib.import_module(name)
            except ImportError:
                continue
            for hook_name in ("_import_benchmarks", "register_all"):
                hook = getattr(mod, hook_name, None)
                if callable(hook):
                    hook()
                    break


def evaluate_claims(item: SuiteItem, table, payload) -> list[dict]:
    """Evaluate every claim of one item -> list of result dicts."""
    return [c.evaluate(table, payload) for c in item.claims]
