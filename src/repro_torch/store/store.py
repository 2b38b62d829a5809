"""Queryable on-disk result store (the durable tier under the EvalCache).

The port's own copy of ``repro/store/store.py``.  Its default root is the
reference's (``$REPRO_STORE_DIR`` or ``<cache_dir>/store``): the port's
records carry the port's engine fingerprint in their identities, so they
never take a reference record's id.

Layout (``$REPRO_STORE_DIR`` or ``<cache_dir>/store``)::

    <root>/records/<record_id>.json     immutable run records
    <root>/baselines/<name>.json        named baseline bundles

Records are written atomically and read back through a schema-version
check: a record of any other
:data:`~repro_torch.store.record.STORE_SCHEMA_VERSION`
is *invalidated, never misread* (``get`` returns ``None``), matching the
persistent EvalCache v2-v6 precedent.  The store is the durable result
tier — the per-cell ``~/.cache/repro`` EvalCache spill is a derived cache
that :func:`gc_cache` may evict at any time (results regenerate; run-level
records do not).

:func:`diff_records` compares two records **deterministically**: result
content (identity, rows, payload) is compared exactly, while provenance
(timestamps, git revs, wall-clock timings, device names — see
:data:`PROVENANCE_KEYS` / :func:`is_timing_key`) is excluded, or banded
with a relative tolerance when ``timing_rel_tol`` is given.  That is what
makes ``python -m repro_torch.store diff`` empty on an unchanged tree
even though every run re-measures its timings.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Any, Iterable, Iterator

from ..experiments.runner import _gc_cache, default_cache_dir

from .record import STORE_SCHEMA_VERSION, RunRecord, canonical_json

__all__ = [
    "ResultStore",
    "default_store_dir",
    "Diff",
    "diff_records",
    "gc_cache",
    "PROVENANCE_KEYS",
    "is_timing_key",
]

_STORE_DIR_ENV = "REPRO_STORE_DIR"

# Leaf keys that are provenance, not results: excluded from diffs anywhere
# they appear.  ``claims`` are derived from rows/payload (and gated
# separately by the suite runner); ``device`` names the accelerator a
# benchmark happened to run on.
PROVENANCE_KEYS = frozenset({
    "record_id", "created", "git_rev", "timings", "provenance", "claims",
    "device", "host",
})

# Timing-valued leaf keys: wall-clock measurements that legitimately differ
# run to run.  Ignored by default; compared within a relative band when a
# tolerance is given (the "tolerance bands for timing cells" of the CI
# gate).  ``_s`` is the repo-wide convention for seconds cells in benchmark
# payloads, both as a suffix (``batch_s``) and infixed in derived cells
# (``scalar_s_measured``, ``scalar_s_est_full_grid``).
_TIMING_NAMES = frozenset({
    "speedup", "lanes_per_s", "coordination_overhead", "wall_s",
})


def is_timing_key(key: str) -> bool:
    return key in _TIMING_NAMES or key.endswith("_s") \
        or key.endswith("_seconds") or "_s_" in key


def default_store_dir() -> Path:
    """``$REPRO_STORE_DIR``, else ``<eval-cache-dir>/store``."""
    env = os.environ.get(_STORE_DIR_ENV, "").strip()
    if env:
        return Path(env)
    return default_cache_dir() / "store"


def _atomic_write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name,
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ResultStore:
    """The on-disk record store (see module docstring)."""

    def __init__(self, root: str | Path | None = None) -> None:
        self.root = Path(root) if root is not None else default_store_dir()
        self.invalidated = 0   # wrong-schema / unreadable records seen

    # -- paths ---------------------------------------------------------------

    @property
    def records_dir(self) -> Path:
        return self.root / "records"

    @property
    def baselines_dir(self) -> Path:
        return self.root / "baselines"

    def record_path(self, record_id: str) -> Path:
        return self.records_dir / f"{record_id}.json"

    # -- record CRUD ---------------------------------------------------------

    def put(self, record: RunRecord) -> str:
        """Write (or overwrite — same identity, interchangeable results) the
        record; returns its id."""
        rid = record.record_id
        _atomic_write(self.record_path(rid), record.to_json() + "\n")
        return rid

    def get(self, record_id: str) -> RunRecord | None:
        """The record, or ``None`` when absent *or* written by another
        schema version / unreadable (invalidated, never misread)."""
        return self._load(self.record_path(record_id))

    def _load(self, path: Path) -> RunRecord | None:
        try:
            with open(path) as fh:
                d = json.load(fh)
            return RunRecord.from_dict(d)
        except FileNotFoundError:
            return None
        except (OSError, ValueError, TypeError, KeyError):
            self.invalidated += 1
            return None

    def delete(self, record_id: str) -> bool:
        try:
            os.unlink(self.record_path(record_id))
            return True
        except OSError:
            return False

    # -- query API -----------------------------------------------------------

    def __iter__(self) -> Iterator[RunRecord]:
        if not self.records_dir.is_dir():
            return
        for path in sorted(self.records_dir.glob("*.json")):
            rec = self._load(path)
            if rec is not None:
                yield rec

    def find(self, kind: str | None = None, name: str | None = None,
             since: float | None = None) -> list[RunRecord]:
        """Records filtered by kind/name/creation time, newest first."""
        out = [r for r in self
               if (kind is None or r.kind == kind)
               and (name is None or r.name == name)
               and (since is None or r.created >= since)]
        out.sort(key=lambda r: (-r.created, r.record_id))
        return out

    def latest(self, name: str, kind: str | None = None) -> RunRecord | None:
        got = self.find(kind=kind, name=name)
        return got[0] if got else None

    # -- baselines -----------------------------------------------------------

    @staticmethod
    def bundle(suite_record: RunRecord,
               members: Iterable[RunRecord]) -> dict:
        """A self-contained baseline bundle: the suite record plus every
        member record, keyed by id (the committed-to-git form)."""
        return {
            "format": "repro-store-baseline",
            "schema": STORE_SCHEMA_VERSION,
            "suite": suite_record.to_dict(),
            "records": {r.record_id: r.to_dict() for r in members},
        }

    @staticmethod
    def load_bundle(path: str | Path) -> dict:
        with open(path) as fh:
            d = json.load(fh)
        if d.get("format") != "repro-store-baseline" \
                or d.get("schema") != STORE_SCHEMA_VERSION:
            raise ValueError(
                f"{path}: not a schema-v{STORE_SCHEMA_VERSION} baseline "
                f"bundle (invalidated, never misread)")
        return d

    def set_baseline(self, name: str, bundle: dict) -> Path:
        path = self.baselines_dir / f"{name}.json"
        _atomic_write(path, canonical_json(bundle) + "\n")
        return path

    def get_baseline(self, name: str) -> dict | None:
        path = self.baselines_dir / f"{name}.json"
        try:
            return self.load_bundle(path)
        except (OSError, ValueError):
            return None

    # -- gc ------------------------------------------------------------------

    def gc(self, keep_per_name: int = 5, max_bytes: int | None = None,
           dry_run: bool = False) -> list[tuple[str, str]]:
        """Prune store records: keep the newest ``keep_per_name`` per
        (kind, name), then evict LRU (by creation time) past ``max_bytes``.
        Baselines are never touched.  Returns ``(record_id, reason)`` of
        every (would-be) deletion; ``dry_run`` reports without deleting."""
        by_name: dict[tuple[str, str], list[RunRecord]] = {}
        for rec in self:
            by_name.setdefault((rec.kind, rec.name), []).append(rec)
        victims: list[tuple[str, str]] = []
        survivors: list[RunRecord] = []
        for recs in by_name.values():
            recs.sort(key=lambda r: (-r.created, r.record_id))
            for rec in recs[keep_per_name:]:
                victims.append((rec.record_id,
                                f"superseded (keep={keep_per_name})"))
            survivors.extend(recs[:keep_per_name])
        if max_bytes is not None:
            sized = [(r, self.record_path(r.record_id).stat().st_size)
                     for r in survivors
                     if self.record_path(r.record_id).exists()]
            total = sum(s for _, s in sized)
            sized.sort(key=lambda rs: (rs[0].created, rs[0].record_id))
            for rec, size in sized:
                if total <= max_bytes:
                    break
                victims.append((rec.record_id,
                                f"size cap ({size} bytes over budget)"))
                total -= size
        if not dry_run:
            for rid, _ in victims:
                self.delete(rid)
        return victims


# ---------------------------------------------------------------------------
# Deterministic record diff
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Diff:
    """One divergence between two records."""

    path: str
    a: Any
    b: Any
    kind: str = "value"   # value | missing_a | missing_b | timing

    def __str__(self) -> str:
        if self.kind == "missing_a":
            return f"{self.path}: only in B ({self.b!r})"
        if self.kind == "missing_b":
            return f"{self.path}: only in A ({self.a!r})"
        tag = " [timing]" if self.kind == "timing" else ""
        return f"{self.path}: {self.a!r} != {self.b!r}{tag}"


def _leaf_equal(a: Any, b: Any) -> bool:
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def _walk(a: Any, b: Any, path: str, out: list[Diff],
          timing_rel_tol: float | None, in_timing: bool) -> None:
    if isinstance(a, dict) and isinstance(b, dict):
        for key in sorted(set(a) | set(b)):
            sub = f"{path}.{key}" if path else str(key)
            if key in PROVENANCE_KEYS:
                continue
            timing = in_timing or is_timing_key(str(key))
            if key not in a:
                out.append(Diff(sub, None, b[key], "missing_a"))
            elif key not in b:
                out.append(Diff(sub, a[key], None, "missing_b"))
            else:
                _walk(a[key], b[key], sub, out, timing_rel_tol, timing)
        return
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            out.append(Diff(f"{path}.length", len(a), len(b)))
            return
        for i, (av, bv) in enumerate(zip(a, b)):
            _walk(av, bv, f"{path}[{i}]", out, timing_rel_tol, in_timing)
        return
    if in_timing:
        # Timing cells: ignored entirely without a tolerance, banded with one.
        if timing_rel_tol is None:
            return
        if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                and not isinstance(a, bool) and not isinstance(b, bool):
            ref = max(abs(float(a)), abs(float(b)), 1e-12)
            if abs(float(a) - float(b)) / ref > timing_rel_tol:
                out.append(Diff(path, a, b, "timing"))
            return
    if not _leaf_equal(a, b):
        out.append(Diff(path, a, b))


def diff_records(a: RunRecord | dict, b: RunRecord | dict, *,
                 timing_rel_tol: float | None = None) -> list[Diff]:
    """Result-content differences between two records (see module doc).

    Exact on result cells (identity, rows, payload values — the bitwise
    tier), excluding provenance keys; timing cells are skipped, or compared
    within ``timing_rel_tol`` relative when given.
    """
    da = a.to_dict() if isinstance(a, RunRecord) else dict(a)
    db = b.to_dict() if isinstance(b, RunRecord) else dict(b)
    out: list[Diff] = []
    _walk(da, db, "", out, timing_rel_tol, False)
    return out


# ---------------------------------------------------------------------------
# EvalCache spill gc (the unbounded ~/.cache/repro growth fix)
# ---------------------------------------------------------------------------

def gc_cache(cache_dir: str | Path | None = None, *,
             max_bytes: int, dry_run: bool = False,
             now: float | None = None) -> list[tuple[Path, int]]:
    """LRU-evict persistent EvalCache spill files past ``max_bytes``.

    The spill (``<cache_dir>/eval-*.json``) is a derived cache — every entry
    regenerates from its spec — so eviction is always safe, it only costs
    recomputation.  Files are evicted oldest-``mtime`` first (the EvalCache
    touches its file on load, so mtime is an LRU clock) until the total is
    under the cap.  Returns ``(path, size)`` of every (would-be) eviction;
    ``dry_run`` reports without deleting.  The result store itself (the
    durable tier, a subdirectory by default) is never touched.
    """
    root = Path(cache_dir) if cache_dir is not None else default_cache_dir()
    del now  # reserved for age-based policies
    return _gc_cache(root, max_bytes=max_bytes, dry_run=dry_run)
