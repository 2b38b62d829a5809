"""Immutable, content-addressed run records (the result store's unit).

The port's own copy of ``repro/store/record.py``: the same record layout,
the same canonical JSON bytes and the same record ids, so a port record
and a reference record of one (kind, name, identity) would share an id.
They never do in practice: the port's identities carry its engine
fingerprint (``torch-<version>-<device type>-<device name>|``), the
reference's the empty tag of its numpy engines.

A :class:`RunRecord` captures one execution of an experiment, a benchmark
suite, or a whole scenario suite:

  * an **identity** — everything the results *depend on*: the canonical
    :class:`~repro_torch.experiments.spec.ExperimentSpec` dict (which
    covers the trace-bank seeds/sizes, platform, predictor, cp), the
    execution context (n_traces / seed / engine / overrides), the runner's
    semantics version (``_EVAL_CACHE_VERSION`` — the same version that
    guards the persistent :class:`~repro_torch.experiments.runner.EvalCache`),
    and the engine-identity fingerprint;
  * the **results** — the tidy result-table rows or the benchmark payload;
  * **provenance** — creation time, repo git rev, wall-clock timings,
    interpreter/library versions, and evaluated claim outcomes.

The record id is a content hash of the identity alone, so re-running the
same inputs finds the prior record (store-backed memoization / ``--resume``)
and a changed input can never alias a stale result.  Outputs are *not* part
of the id: two runs of one identity are interchangeable by the determinism
contract of the runner.

Serialization is deterministic — :func:`canonical_json` sorts keys and uses
the shortest round-trip float repr — so git diffs of exported records and
``python -m repro_torch.store diff`` output are meaningful.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform as _platform
import subprocess
import sys
import time
from typing import Any, Mapping

import numpy as np

__all__ = [
    "STORE_SCHEMA_VERSION",
    "canonical_json",
    "content_hash",
    "RunRecord",
]

# Store schema/semantics version.  Bump whenever the record layout or the
# meaning of an identity changes; records of another version are
# *invalidated, never misread* (``ResultStore.get`` refuses to decode them),
# matching the EvalCache v2-v6 precedent.
STORE_SCHEMA_VERSION = 1


def _plain(value: Any) -> Any:
    """Deep-convert to plain JSON types (numpy scalars, tuples, dataclasses
    with to_dict); unknown objects degrade to ``str``."""
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.ndarray):
        return [_plain(v) for v in value.tolist()]
    if dataclasses.is_dataclass(value) and hasattr(value, "to_dict"):
        return _plain(value.to_dict())
    if isinstance(value, Mapping):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return str(value)


def canonical_json(obj: Any, indent: int | None = 1) -> str:
    """Deterministic JSON: sorted keys, plain types, shortest round-trip
    float repr (CPython's ``repr`` — stable across processes and platforms).
    ``indent=None`` gives the compact single-line form used for hashing."""
    separators = (",", ":") if indent is None else (",", ": ")
    return json.dumps(_plain(obj), sort_keys=True, indent=indent,
                      separators=separators)


def content_hash(obj: Any) -> str:
    """sha256 hex digest of the canonical compact JSON form."""
    return hashlib.sha256(canonical_json(obj, indent=None).encode()).hexdigest()


def _git_rev() -> str:
    """Best-effort repo revision for provenance (never raises)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0:
            rev = out.stdout.strip()
            dirty = subprocess.run(["git", "status", "--porcelain"],
                                   capture_output=True, text=True, timeout=5)
            if dirty.returncode == 0 and dirty.stdout.strip():
                rev += "-dirty"
            return rev
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One immutable run record (see module docstring).

    ``kind`` is ``"experiment"`` (a registered/inline
    :class:`ExperimentSpec` run through the batched runner — results in
    ``rows``), ``"benchmark"`` (a paper-claim benchmark script — results in
    ``payload``), or ``"suite"`` (an aggregate referencing member record
    ids in ``payload["items"]``).
    """

    kind: str
    name: str
    identity: dict
    rows: tuple = ()
    payload: dict = dataclasses.field(default_factory=dict)
    claims: tuple = ()
    timings: dict = dataclasses.field(default_factory=dict)
    created: float = 0.0
    git_rev: str = "unknown"
    provenance: dict = dataclasses.field(default_factory=dict)
    schema: int = STORE_SCHEMA_VERSION

    @property
    def record_id(self) -> str:
        """Content hash of the identity (inputs only — see module doc)."""
        return self.id_for(self.kind, self.name, self.identity,
                           schema=self.schema)

    @staticmethod
    def id_for(kind: str, name: str, identity: Mapping[str, Any], *,
               schema: int = STORE_SCHEMA_VERSION) -> str:
        """The record id a (kind, name, identity) run would get — what the
        suite runner probes the store with before executing anything."""
        return "r" + content_hash({
            "schema": schema, "kind": kind, "name": name,
            "identity": _plain(dict(identity))})[:20]

    @classmethod
    def create(cls, kind: str, name: str, identity: Mapping[str, Any], *,
               rows: Any = (), payload: Mapping[str, Any] | None = None,
               claims: Any = (), timings: Mapping[str, Any] | None = None,
               ) -> "RunRecord":
        """Build a record stamped with fresh provenance."""
        return cls(
            kind=kind, name=name, identity=_plain(dict(identity)),
            rows=tuple(_plain(list(rows))), payload=_plain(payload or {}),
            claims=tuple(_plain(list(claims))),
            timings=_plain(timings or {}), created=time.time(),
            git_rev=_git_rev(),
            provenance={
                "python": sys.version.split()[0],
                "numpy": np.__version__,
                "machine": _platform.machine(),
            })

    def with_claims(self, claims: Any) -> "RunRecord":
        return dataclasses.replace(self, claims=tuple(_plain(list(claims))))

    @property
    def ok(self) -> bool:
        """True when every evaluated claim passed (vacuously true)."""
        return all(c.get("ok", False) for c in self.claims)

    def to_dict(self) -> dict:
        return {
            "record_id": self.record_id,
            "schema": self.schema,
            "kind": self.kind,
            "name": self.name,
            "identity": self.identity,
            "rows": list(self.rows),
            "payload": self.payload,
            "claims": list(self.claims),
            "timings": self.timings,
            "created": self.created,
            "git_rev": self.git_rev,
            "provenance": self.provenance,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunRecord":
        if d.get("schema") != STORE_SCHEMA_VERSION:
            raise ValueError(
                f"record schema {d.get('schema')!r} != "
                f"{STORE_SCHEMA_VERSION} (invalidated, never misread)")
        return cls(
            kind=d["kind"], name=d["name"], identity=dict(d["identity"]),
            rows=tuple(d.get("rows", ())), payload=dict(d.get("payload", {})),
            claims=tuple(d.get("claims", ())),
            timings=dict(d.get("timings", {})),
            created=float(d.get("created", 0.0)),
            git_rev=str(d.get("git_rev", "unknown")),
            provenance=dict(d.get("provenance", {})),
            schema=int(d["schema"]))

    def to_json(self, indent: int | None = 1) -> str:
        return canonical_json(self.to_dict(), indent=indent)
