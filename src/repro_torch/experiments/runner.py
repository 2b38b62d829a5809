"""Batched trace-evaluation runner of the port.

The port's own copy of the JAX package's ``experiments/runner.py``
(``evaluate_strategies``, ``BestPeriodSearch``, ``EvalCache``,
``ResultTable``, ``run_experiment``), with the torch lane engine in the
place of the numpy lanes:

  * one shared **trace bank** per scenario (content-addressed by the
    scenario spec, memoized across strategies and sweeps);
  * every (candidate x trace) pair deduplicated through an
    :class:`EvalCache`, optionally spilled to disk;
  * every candidate with a constant period and a standard trust policy
    runs as a lane of :func:`repro_torch.core.batch.lane_results` (the
    hand-written ``lane_loop_kernel`` on CUDA); the rest (dynamic periods,
    custom trust policies) run through the scalar oracle
    :func:`repro_torch.core.simulator.simulate` on the host, optionally in
    a ``spawn`` process pool (a parent that holds CUDA must not fork);
  * a tidy :class:`ResultTable` (one row per sweep-cell x strategy);
  * :func:`run_suite`, the store-backed, resumable suite runner of
    ``repro/experiments/runner.py:921-1181``, whose records land in
    :class:`repro_torch.store.ResultStore`.

``evaluate_strategies`` takes plain strategies and
:class:`BestPeriodSearch` entries alike, and runs every lane candidate of
the call, each search's whole grid included, in **one lane pass**.  Its
steps are public: ``expand_candidates`` (strategies to deduplicated
candidates), ``candidate_makespans`` (one lane pass, per-trace makespans;
``candidate_results`` gives every ``BatchResult`` field of the same pass)
and ``best_means`` (trace-order means, the best grid point per search).
:func:`run_experiment` makes one such call per sweep cell.

Determinism contract (as in the reference): each (strategy, trace ``i``)
pair draws from ``np.random.default_rng(seed + 7919 * i)`` and makespans
are averaged in trace order, so the means are bitwise the reference's,
whatever the engine, caching, batching or worker count.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import multiprocessing
import os
import pickle
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from ..core.batch import BatchResult, lane_results, supported_trust
from ..core.policies import Strategy
from ..core.simulator import (AlwaysTrust, FixedProbabilityTrust,
                              NeverTrust, ThresholdTrust, TrustPolicy,
                              simulate)
from ..core.traces import EventTrace
from ..core.waste import Platform
from ..device import DeviceSpec, resolve_devices
from .spec import SECONDS_PER_DAY, ExperimentSpec, ScenarioSpec

__all__ = [
    "BestPeriodSearch",
    "EvalCache",
    "ResultTable",
    "default_cache_dir",
    "trace_bank",
    "clear_trace_bank",
    "best_means",
    "best_period_grid",
    "best_period_search",
    "candidate_makespans",
    "candidate_results",
    "evaluate_mean",
    "evaluate_strategies",
    "expand_candidates",
    "run_experiment",
    "run_suite",
    "SuiteItemResult",
    "SuiteRunResult",
]

# Environment knobs (the reference's names and meanings).
_WORKERS_ENV = "REPRO_EXPERIMENT_WORKERS"   # scalar-oracle process pool
_ENGINE_ENV = "REPRO_ENGINE"                # auto (default) | batch | scalar
_PERSIST_ENV = "REPRO_PERSIST_CACHE"        # 1 = spill EvalCache to disk
_CACHE_DIR_ENV = "REPRO_CACHE_DIR"          # default ~/.cache/repro
_BATCHED_TRACES_ENV = "REPRO_BATCHED_TRACES"  # 1 = bank-level trace sampling
_CACHE_MAX_MB_ENV = "REPRO_CACHE_MAX_MB"    # spill size cap (0 = unbounded)
_CACHE_GC_DRY_ENV = "REPRO_CACHE_GC_DRY_RUN"  # 1 = report, don't evict

_ENGINES = ("auto", "batch", "scalar")

# The persistent spill is a derived cache (every entry regenerates from
# its spec), so it gets a default size cap with LRU eviction.
_DEFAULT_CACHE_MAX_MB = 512.0

# Below this many pending scalar simulations a process pool is not worth
# its startup cost; the oracle runs serially regardless of worker count.
_MIN_PARALLEL_SIMS = 16

# Persistent-cache schema version: the reference's v7 (candidate keys with
# the window, adaptive and silent-verification axes).  Port records are
# told apart by the engine tag of :func:`_engine_fingerprint`.
_EVAL_CACHE_VERSION = 7


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes",
                                                        "on")


@dataclasses.dataclass(frozen=True)
class BestPeriodSearch:
    """A strategy whose period is brute-forced over the trace bank
    (the paper's BestPeriod; the reference's 24 points over span 8)."""

    base: Strategy
    n_points: int = 24
    span: float = 8.0

    @property
    def name(self) -> str:
        return f"BestPeriod({self.base.name})"


# ---------------------------------------------------------------------------
# Result cache (per evaluation context: bank x platform x time_base x cp x seed)
# ---------------------------------------------------------------------------

class _IdKey:
    """Hashable identity wrapper for cache keys built from objects without
    value semantics.  Holding the object itself (not its ``id()``) keeps it
    alive for the cache's lifetime, so the key can never alias a freed
    object's recycled id."""

    __slots__ = ("obj",)

    def __init__(self, obj: Any) -> None:
        self.obj = obj

    def __hash__(self) -> int:
        return object.__hash__(self.obj) if isinstance(
            self.obj, collections.abc.Hashable) else id(self.obj)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _IdKey) and self.obj is other.obj


def _trust_key(trust: TrustPolicy) -> tuple:
    if isinstance(trust, NeverTrust):
        return ("never",)
    if isinstance(trust, AlwaysTrust):
        return ("always",)
    if isinstance(trust, FixedProbabilityTrust):
        return ("fixed_q", trust.q)
    if isinstance(trust, ThresholdTrust):
        return ("threshold", trust.threshold)
    return ("opaque", _IdKey(trust))


def _adaptive_key(adaptive) -> tuple | None:
    """Value tuple of an AdaptiveConfig candidate axis (None = static)."""
    if adaptive is None:
        return None
    if hasattr(adaptive, "key"):
        return tuple(adaptive.key())
    return _IdKey(adaptive)  # opaque custom object: identity semantics


def _candidate_key(strategy: Strategy) -> tuple:
    period = strategy.period
    if callable(period) and not isinstance(period, collections.abc.Hashable):
        period = _IdKey(period)
    return (period, _trust_key(strategy.trust), strategy.inexact_window,
            strategy.window_mode, strategy.window_period,
            _adaptive_key(strategy.adaptive), strategy.n_verify,
            strategy.verify_cost, strategy.keep_ckpts)


def _persistable_key(key: tuple) -> str | None:
    """Canonical JSON form of a candidate key, or None if the candidate has
    no value semantics (callable period, opaque trust policy)."""
    (period, trust, window, wmode, wperiod, adaptive,
     n_verify, verify_cost, keep_ckpts) = key
    if not isinstance(period, (int, float)):
        return None
    if any(isinstance(part, _IdKey) for part in trust) \
            or isinstance(adaptive, _IdKey):
        return None
    return json.dumps([period, list(trust), window, wmode, wperiod,
                       None if adaptive is None else list(adaptive),
                       n_verify, verify_cost, keep_ckpts])


def default_cache_dir() -> Path:
    """On-disk result cache root: ``$REPRO_CACHE_DIR`` or ``~/.cache/repro``."""
    env = os.environ.get(_CACHE_DIR_ENV, "").strip()
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro"


def _gc_cache(root: Path, *, max_bytes: int,
              dry_run: bool = False) -> list[tuple[Path, int]]:
    """LRU-evict spill files (``<root>/eval-*.json``) past ``max_bytes``,
    oldest ``mtime`` first; returns ``(path, size)`` of every (would-be)
    eviction.  The port's copy of the reference's ``store.gc_cache``."""
    if not root.is_dir():
        return []
    files = []
    for path in root.glob("eval-*.json"):
        try:
            st = path.stat()
        except OSError:
            continue
        files.append((st.st_mtime, st.st_size, path))
    total = sum(size for _, size, _ in files)
    if total <= max_bytes:
        return []
    files.sort()   # oldest first
    evicted: list[tuple[Path, int]] = []
    for _, size, path in files:
        if total <= max_bytes:
            break
        evicted.append((path, size))
        total -= size
        if not dry_run:
            try:
                os.unlink(path)
            except OSError:
                pass
    return evicted


class EvalCache:
    """Maps (candidate key, trace index) -> makespan.

    Shared across the strategies / period grids of one evaluation context so
    duplicated candidates are simulated exactly once.  With ``persist_key``
    the cache is backed by a JSON file ``<cache_dir>/<persist_key>.json``:
    prior results load on construction and new results of serializable
    candidates are written back by :meth:`flush`.  The caller owns the key
    (see :func:`_cell_persist_key`).
    """

    def __init__(self, persist_key: str | None = None,
                 cache_dir: str | Path | None = None) -> None:
        self._makespans: dict[tuple, float] = {}
        self.hits = 0
        self.misses = 0
        self._path: Path | None = None
        self._new: dict[str, dict[int, float]] = {}
        if persist_key is not None:
            self._path = Path(cache_dir or default_cache_dir()) \
                / f"{persist_key}.json"
            store = self._read_store()
            for ckey_str, per_trace in store.items():
                key = self._decode_key(ckey_str)
                for ti, m in per_trace.items():
                    self._makespans[(key, int(ti))] = float(m)
            if store:
                # mtime is the spill's LRU clock: a read marks it used.
                try:
                    os.utime(self._path)
                except OSError:
                    pass

    @staticmethod
    def _decode_key(ckey_str: str) -> tuple:
        (period, trust, window, wmode, wperiod, adaptive,
         n_verify, verify_cost, keep_ckpts) = json.loads(ckey_str)
        return (period, tuple(trust), window, wmode, wperiod,
                None if adaptive is None else tuple(adaptive),
                n_verify, verify_cost, keep_ckpts)

    def _read_store(self) -> dict:
        """The on-disk makespan map; any unreadable or wrong-shape file
        degrades to an empty store."""
        try:
            with open(self._path) as fh:
                store = json.load(fh).get("makespans", {})
            if not isinstance(store, dict):
                return {}
            for ckey_str, per_trace in store.items():
                self._decode_key(ckey_str)
                dict(per_trace).items()
            return store
        except (FileNotFoundError, OSError, ValueError, TypeError,
                AttributeError, KeyError):
            return {}

    def get(self, strategy: Strategy, trace_idx: int) -> float | None:
        got = self._makespans.get((_candidate_key(strategy), trace_idx))
        if got is not None:
            self.hits += 1
        return got

    def put(self, strategy: Strategy, trace_idx: int, makespan: float) -> None:
        self.misses += 1
        key = _candidate_key(strategy)
        self._makespans[(key, trace_idx)] = makespan
        if self._path is not None:
            ckey_str = _persistable_key(key)
            if ckey_str is not None:
                self._new.setdefault(ckey_str, {})[trace_idx] = makespan

    def flush(self) -> None:
        """Merge new results into the on-disk store (atomic rename)."""
        if self._path is None or not self._new:
            return
        store = self._read_store()
        for ckey_str, per_trace in self._new.items():
            dst = store.setdefault(ckey_str, {})
            for ti, m in per_trace.items():
                dst[str(ti)] = m
        self._path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self._path.parent,
                                   prefix=self._path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump({"makespans": store}, fh)
            os.replace(tmp, self._path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._new.clear()
        self._maybe_gc()

    def _maybe_gc(self) -> None:
        """Keep the spill directory under ``$REPRO_CACHE_MAX_MB`` (default
        512; ``0`` disables) by LRU-evicting other cells' spill files;
        ``REPRO_CACHE_GC_DRY_RUN=1`` only reports."""
        raw = os.environ.get(_CACHE_MAX_MB_ENV, "").strip()
        try:
            max_mb = float(raw) if raw else _DEFAULT_CACHE_MAX_MB
        except ValueError:
            max_mb = _DEFAULT_CACHE_MAX_MB
        if max_mb <= 0:
            return
        dry = _env_flag(_CACHE_GC_DRY_ENV)
        evicted = _gc_cache(self._path.parent,
                            max_bytes=int(max_mb * 1024 * 1024), dry_run=dry)
        for path, size in evicted:
            verb = "would evict" if dry else "evicted"
            print(f"[repro cache gc] {verb} {path} ({size} bytes; "
                  f"cap {max_mb:g} MB, set {_CACHE_MAX_MB_ENV}=0 to disable)",
                  file=sys.stderr, flush=True)

    def __len__(self) -> int:
        return len(self._makespans)


# ---------------------------------------------------------------------------
# Shared trace bank
# ---------------------------------------------------------------------------

_BANK_CACHE: "collections.OrderedDict[str, list[EventTrace]]" = \
    collections.OrderedDict()
_BANK_CACHE_MAX = 8


def trace_bank(scenario: ScenarioSpec,
               batched: bool | None = None) -> list[EventTrace]:
    """The scenario's shared trace bank (content-addressed, memoized).

    ``batched=True`` (or ``REPRO_BATCHED_TRACES=1``) samples the bank in
    shared RNG waves (:meth:`ScenarioSpec.make_traces` with
    ``batched=True``): a different stream than per-trace seeding, hence a
    separate cache entry.
    """
    if batched is None:
        batched = _env_flag(_BATCHED_TRACES_ENV)
    key = ("batched|" if batched else "") + scenario.key()
    if key in _BANK_CACHE:
        _BANK_CACHE.move_to_end(key)
        return _BANK_CACHE[key]
    bank = scenario.make_traces(batched=batched)
    _BANK_CACHE[key] = bank
    while len(_BANK_CACHE) > _BANK_CACHE_MAX:
        _BANK_CACHE.popitem(last=False)
    return bank


def clear_trace_bank() -> None:
    _BANK_CACHE.clear()


# ---------------------------------------------------------------------------
# The scalar oracle's route
# ---------------------------------------------------------------------------

def _simulate_pair(trace: EventTrace, platform: Platform, time_base: float,
                   cp: float, strategy: Strategy, seed: int,
                   trace_idx: int) -> float:
    rng = np.random.default_rng(seed + 7919 * trace_idx)
    res = simulate(trace, platform, time_base, strategy.period, cp=cp,
                   trust=strategy.trust,
                   inexact_window=strategy.inexact_window,
                   window_mode=strategy.window_mode,
                   window_period=strategy.window_period,
                   adaptive=strategy.adaptive,
                   n_verify=strategy.n_verify,
                   verify_cost=strategy.verify_cost,
                   keep_ckpts=strategy.keep_ckpts, rng=rng)
    return res.makespan


def _eval_chunk(trace: EventTrace, platform: Platform, time_base: float,
                cp: float, seed: int, trace_idx: int,
                items: list[tuple[int, Strategy]]) -> list[tuple[int, float]]:
    """Worker task: one trace x several candidate strategies."""
    return [(slot, _simulate_pair(trace, platform, time_base, cp, strat,
                                  seed, trace_idx))
            for slot, strat in items]


def _resolve_workers(workers: int | None) -> int:
    """Worker count for the oracle's pool: explicit argument, then
    ``$REPRO_EXPERIMENT_WORKERS``, then the machine's CPU count."""
    if workers is None:
        env = os.environ.get(_WORKERS_ENV, "").strip()
        workers = int(env) if env else (os.cpu_count() or 1)
    return max(0, workers)


def _resolve_engine(engine: str | None) -> str:
    engine = engine or os.environ.get(_ENGINE_ENV, "").strip() or "auto"
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r} for the port (expected "
                         f"auto, batch or scalar)")
    return engine


def _batchable(strategy: Strategy) -> bool:
    """True if the lane engine can run this candidate (constant period and
    a standard trust policy)."""
    return isinstance(strategy.period, (int, float, np.integer)) \
        and supported_trust(strategy.trust)


def _picklable(strategy: Strategy) -> bool:
    try:
        pickle.dumps(strategy)
        return True
    except Exception:
        return False


def _run_oracle(traces: Sequence[EventTrace], platform: Platform,
                time_base: float, cp: float, seed: int,
                by_trace: dict[int, list[tuple[int, Strategy]]],
                workers: int | None) -> Iterator[tuple[int, int, float]]:
    """``(slot, trace, makespan)`` of every pending oracle pair: in a
    ``spawn`` process pool when ``workers`` > 1 and the work is large
    enough, else serially.  Unpicklable candidates (closures) always run
    serially."""
    workers = _resolve_workers(workers)
    serial_only: dict[int, list[tuple[int, Strategy]]] = {}
    if workers > 1:
        picklable: dict[int, bool] = {}
        for ti, items in list(by_trace.items()):
            for slot, strat in items:
                if slot not in picklable:
                    picklable[slot] = _picklable(strat)
            stuck = [it for it in items if not picklable[it[0]]]
            if stuck:
                serial_only[ti] = stuck
                kept = [it for it in items if picklable[it[0]]]
                if kept:
                    by_trace[ti] = kept
                else:
                    del by_trace[ti]
    n_scalar = sum(len(items) for items in by_trace.values())
    if workers > 1 and n_scalar >= _MIN_PARALLEL_SIMS:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, len(by_trace)),
                                 mp_context=ctx) as pool:
            futures = {
                ti: pool.submit(_eval_chunk, traces[ti], platform, time_base,
                                cp, seed, ti, items)
                for ti, items in by_trace.items()
            }
            for ti, fut in futures.items():
                for slot, m in fut.result():
                    yield slot, ti, m
    else:
        for ti, items in by_trace.items():
            serial_only.setdefault(ti, []).extend(items)
    for ti, items in serial_only.items():
        for slot, m in _eval_chunk(traces[ti], platform, time_base, cp,
                                   seed, ti, items):
            yield slot, ti, m


# ---------------------------------------------------------------------------
# Candidates, the lane pass and the means
# ---------------------------------------------------------------------------

def best_period_grid(t0: float, platform: Platform, n_points: int,
                     span: float) -> np.ndarray:
    """Deduplicated candidate grid around the analytic period ``t0``:
    log-spaced in [t0/span, t0*span] (clamped above C), ``t0`` included."""
    lo = max(platform.c * 1.001, t0 / span)
    hi = max(lo * 1.01, t0 * span)
    return np.unique(np.append(np.geomspace(lo, hi, n_points), t0))


def _expand(item: Strategy | BestPeriodSearch, platform: Platform
            ) -> list[Strategy]:
    if isinstance(item, BestPeriodSearch):
        grid = best_period_grid(item.base.period, platform, item.n_points,
                                item.span)
        return [item.base.with_period(float(t)) for t in grid]
    return [item]


def expand_candidates(strategies: Sequence[Strategy | BestPeriodSearch],
                      platform: Platform
                      ) -> tuple[list[Strategy], list[list[int]]]:
    """The deduplicated candidates of ``strategies`` (a
    :class:`BestPeriodSearch` expands to its grid) and, for each strategy,
    the indices of its candidates in that list."""
    slot: dict[tuple, int] = {}
    unique: list[Strategy] = []
    rows: list[list[int]] = []
    for item in strategies:
        rows.append([])
        for strat in _expand(item, platform):
            key = _candidate_key(strat)
            if key not in slot:
                slot[key] = len(unique)
                unique.append(strat)
            rows[-1].append(slot[key])
    return unique, rows


def _lane_results(traces: Sequence[EventTrace], platform: Platform,
                  time_base: float, cp: float, lane: Sequence[Strategy],
                  tr_idx: np.ndarray, *, seed: int, chunk: int | None,
                  device) -> BatchResult:
    """One lane pass: lane ``j`` runs ``lane[j]`` on trace ``tr_idx[j]``;
    a ``(1, len(lane))`` :class:`BatchResult`."""
    for strat in lane:
        if not _batchable(strat):
            raise ValueError(
                f"the torch lane engine cannot run strategy {strat.name!r} "
                f"(dynamic period or unsupported trust policy)")
    return lane_results(
        traces, platform, time_base, cp=cp, trace_indices=tr_idx,
        periods=[float(s.period) for s in lane],
        trusts=[s.trust for s in lane],
        windows=[s.inexact_window for s in lane],
        window_modes=[s.window_mode for s in lane],
        window_periods=[s.window_period for s in lane],
        adaptives=[s.adaptive for s in lane],
        n_verifies=[s.n_verify for s in lane],
        verify_costs=[s.verify_cost for s in lane],
        keep_ckpts=[s.keep_ckpts for s in lane],
        seeds=seed + 7919 * tr_idx, chunk=chunk, device=device)


def candidate_results(
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    candidates: Sequence[Strategy],
    *,
    seed: int = 0,
    trace_indices: Sequence[int] | None = None,
    chunk: int | None = None,
    device: DeviceSpec = None,
) -> BatchResult:
    """Every candidate on every bank trace in ``trace_indices`` (``None``:
    all), as one lane pass of :func:`lane_results`: a
    ``(len(candidates), len(trace_indices))`` :class:`BatchResult`.

    The lane of trace ``i`` draws from ``default_rng(seed + 7919 * i)``,
    and lanes do not interact, so a subset of traces gives the bits of
    those columns of the whole.  ``device`` is where the lanes run
    (``None``: CUDA).
    """
    idx = (np.arange(len(traces), dtype=np.int64) if trace_indices is None
           else np.asarray(trace_indices, dtype=np.int64))
    lane = [candidates[ci] for ci in np.repeat(np.arange(len(candidates)),
                                               idx.size)]
    res = _lane_results(traces, platform, time_base, cp, lane,
                        np.tile(idx, len(candidates)), seed=seed,
                        chunk=chunk, device=device)
    return res.reshape(len(candidates), idx.size)


def candidate_makespans(
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    candidates: Sequence[Strategy],
    *,
    seed: int = 0,
    trace_indices: Sequence[int] | None = None,
    chunk: int | None = None,
    device: DeviceSpec = None,
) -> np.ndarray:
    """:func:`candidate_results`' makespans,
    ``(len(candidates), len(trace_indices))``."""
    return candidate_results(traces, platform, time_base, cp, candidates,
                             seed=seed, trace_indices=trace_indices,
                             chunk=chunk, device=device).makespan


def _trace_mean(row: np.ndarray) -> float:
    # Sequential accumulation in trace order: bit-for-bit the reference's
    # ``total += makespan; total / max(1, n)``.
    n = row.shape[0]
    total = 0.0
    for ti in range(n):
        total += row[ti]
    return float(total / max(1, n))


def _best(makespans: np.ndarray, rows: Sequence[Sequence[int]]
          ) -> list[tuple[float, int]]:
    """Per strategy, (the smallest trace-order mean over its candidate
    rows, that candidate's index): the first minimum, as ``np.argmin``
    picks it."""
    out = []
    for cand_rows in rows:
        means = [_trace_mean(makespans[j]) for j in cand_rows]
        k = int(np.argmin(means))
        out.append((means[k], cand_rows[k]))
    return out


def best_means(makespans: np.ndarray, rows: Sequence[Sequence[int]]
               ) -> list[float]:
    """Per strategy, the smallest trace-order mean over its candidate
    rows of ``makespans`` (the first minimum, as ``np.argmin`` picks it)."""
    return [m for m, _ in _best(makespans, rows)]


def _evaluate(traces: Sequence[EventTrace], platform: Platform,
              time_base: float, cp: float,
              strategies: Sequence[Strategy | BestPeriodSearch], *,
              seed: int, cache: EvalCache | None, workers: int | None,
              engine: str | None, chunk: int | None, device
              ) -> list[tuple[float, Strategy]]:
    """(mean, resolved strategy) per entry of ``strategies``: the lane
    candidates not in ``cache`` in one lane pass, the others through the
    scalar oracle; a search resolves to its best grid period."""
    cache = cache if cache is not None else EvalCache()
    engine = _resolve_engine(engine)
    unique, rows = expand_candidates(strategies, platform)
    n = len(traces)
    makespans = np.empty((len(unique), n), dtype=np.float64)
    lane_items: list[tuple[int, int]] = []
    by_trace: dict[int, list[tuple[int, Strategy]]] = {}
    for ci, strat in enumerate(unique):
        lanes_ok = engine != "scalar" and _batchable(strat)
        if engine == "batch" and not lanes_ok:
            raise ValueError(
                f"engine='batch' cannot run strategy {strat.name!r} "
                f"(dynamic period or unsupported trust policy); use "
                f"engine='auto' to allow the scalar oracle")
        for ti in range(n):
            got = cache.get(strat, ti)
            if got is not None:
                makespans[ci, ti] = got
            elif lanes_ok:
                lane_items.append((ci, ti))
            else:
                by_trace.setdefault(ti, []).append((ci, strat))

    if lane_items:
        tr_idx = np.fromiter((ti for _, ti in lane_items), np.int64,
                             len(lane_items))
        lane_ms = _lane_results(
            traces, platform, time_base, cp,
            [unique[ci] for ci, _ in lane_items], tr_idx, seed=seed,
            chunk=chunk, device=device).makespan[0]
        for (ci, ti), m in zip(lane_items, lane_ms):
            makespans[ci, ti] = m
            cache.put(unique[ci], ti, float(m))
    for ci, ti, m in _run_oracle(traces, platform, time_base, cp, seed,
                                 by_trace, workers):
        makespans[ci, ti] = m
        cache.put(unique[ci], ti, m)

    out = []
    for item, (mean, ci) in zip(strategies, _best(makespans, rows)):
        if isinstance(item, BestPeriodSearch):
            item = dataclasses.replace(
                item.base, name=item.name, period=float(unique[ci].period))
        out.append((mean, item))
    return out


def evaluate_strategies(
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    strategies: Sequence[Strategy | BestPeriodSearch],
    *,
    seed: int = 0,
    cache: EvalCache | None = None,
    workers: int | None = None,
    engine: str | None = None,
    chunk: int | None = None,
    device: DeviceSpec = None,
) -> list[float]:
    """Mean makespan of each strategy over the shared trace set.

    A :class:`BestPeriodSearch` entry yields the mean of its best grid
    period (the first minimum, as ``np.argmin`` picks it).  Every lane
    candidate, deduplicated through ``cache``, runs in one lane pass on
    ``device`` (``None``: CUDA).  The others (dynamic periods, custom
    trust policies) run through the scalar oracle, in a ``spawn`` process
    pool when ``workers`` > 1 (default ``$REPRO_EXPERIMENT_WORKERS``, else
    the CPU count) and the pending work is large enough.
    ``engine="scalar"`` (or ``REPRO_ENGINE=scalar``) sends every candidate
    to the oracle; ``engine="batch"`` raises on a candidate the lanes
    cannot run.  Results are bitwise independent of the plan.
    """
    return [m for m, _ in _evaluate(
        traces, platform, time_base, cp, strategies, seed=seed, cache=cache,
        workers=workers, engine=engine, chunk=chunk, device=device)]


def evaluate_mean(
    strategy: Strategy,
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    *,
    seed: int = 0,
    cache: EvalCache | None = None,
    workers: int | None = None,
    engine: str | None = None,
    device: DeviceSpec = None,
) -> float:
    """Single-strategy convenience wrapper over :func:`evaluate_strategies`."""
    return evaluate_strategies(traces, platform, time_base, cp, [strategy],
                               seed=seed, cache=cache, workers=workers,
                               engine=engine, device=device)[0]


def best_period_search(
    search: BestPeriodSearch | Strategy,
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    *,
    n_points: int = 24,
    span: float = 8.0,
    seed: int = 0,
    cache: EvalCache | None = None,
    workers: int | None = None,
    engine: str | None = None,
    device: DeviceSpec = None,
) -> tuple[Strategy, float]:
    """Brute-force the best period for a strategy (paper's BestPeriod):
    ``(the strategy at its best grid period, its mean makespan)``, the
    whole grid in one lane pass."""
    if not isinstance(search, BestPeriodSearch):
        search = BestPeriodSearch(base=search, n_points=n_points, span=span)
    (mean, refined), = _evaluate(
        traces, platform, time_base, cp, [search], seed=seed, cache=cache,
        workers=workers, engine=engine, chunk=None, device=device)
    return refined, mean


# ---------------------------------------------------------------------------
# Tidy result table
# ---------------------------------------------------------------------------

class ResultTable:
    """A tidy list of result rows (one per sweep-cell x strategy)."""

    def __init__(self, rows: Iterable[Mapping[str, Any]] = ()) -> None:
        self.rows: list[dict[str, Any]] = [dict(r) for r in rows]

    # -- container protocol --------------------------------------------------

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return iter(self.rows)

    def __repr__(self) -> str:
        return f"ResultTable({len(self.rows)} rows x {len(self.columns)} cols)"

    @property
    def columns(self) -> list[str]:
        cols: dict[str, None] = {}
        for row in self.rows:
            for c in row:
                cols.setdefault(c)
        return list(cols)

    # -- relational helpers --------------------------------------------------

    def where(self, **eq: Any) -> "ResultTable":
        return ResultTable(r for r in self.rows
                           if all(r.get(k) == v for k, v in eq.items()))

    def column(self, name: str) -> list[Any]:
        return [r.get(name) for r in self.rows]

    def value(self, name: str, **eq: Any) -> Any:
        hits = self.where(**eq).rows
        if len(hits) != 1:
            raise KeyError(f"expected exactly one row for {eq}, "
                           f"got {len(hits)}")
        return hits[0][name]

    def strategy_dict(self, metric: str = "makespan_days",
                      **eq: Any) -> dict[str, float]:
        """{strategy name: metric} for the rows matching ``eq``."""
        return {r["strategy"]: r[metric] for r in self.where(**eq).rows}

    def mean(self, name: str, **eq: Any) -> float:
        vals = [v for v in self.where(**eq).column(name) if v is not None]
        return float(np.mean(vals)) if vals else math.nan

    # -- output --------------------------------------------------------------

    def to_json(self, **kw: Any) -> str:
        """Deterministic by default: keys sorted so exported tables diff
        cleanly (pass ``sort_keys=False`` for insertion order)."""
        kw.setdefault("sort_keys", True)
        return json.dumps(self.rows, default=str, **kw)

    def format(self, columns: Sequence[str] | None = None,
               float_fmt: str = "{:.2f}") -> str:
        cols = list(columns) if columns else self.columns
        widths = {c: max(len(str(c)), 8) for c in cols}

        def fmt(v: Any) -> str:
            if isinstance(v, float):
                return float_fmt.format(v)
            return "" if v is None else str(v)
        for row in self.rows:
            for c in cols:
                widths[c] = max(widths[c], len(fmt(row.get(c))))
        head = " | ".join(f"{c:>{widths[c]}s}" for c in cols)
        lines = [head, "-" * len(head)]
        for row in self.rows:
            lines.append(" | ".join(f"{fmt(row.get(c)):>{widths[c]}s}"
                                    for c in cols))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Experiment execution
# ---------------------------------------------------------------------------

def _metric_value(metric: str, makespan: float | None,
                  scenario: ScenarioSpec) -> Any:
    if makespan is None:
        return None
    if metric == "makespan":
        return makespan
    if metric == "makespan_days":
        return makespan / SECONDS_PER_DAY
    if metric == "waste":
        return 1.0 - scenario.time_base / makespan if makespan > 0 else 0.0
    raise KeyError(f"unknown metric {metric!r}")


def _engine_fingerprint(device: DeviceSpec = None) -> str:
    """Cache-identity tag of the port's engines on ``device``:
    ``torch-<version>-<device type>-<device name>|``.  The reference tags
    its numpy engines ``""`` and its jax engine ``jax-...|``, so a port
    record never aliases a reference record.  A device list
    (:func:`repro_torch.device.resolve_devices`) takes its first device's
    tag: a split run has one card's bits, so it shares the unsplit run's
    cache entries and suite records."""
    dev = resolve_devices(device)[0]
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"torch-{torch.__version__}-{dev.type}-{name}|"


def _cell_persist_key(cell: ScenarioSpec, batched_bank: bool,
                      device: DeviceSpec = None) -> str:
    """Content hash of one evaluation context: the scenario spec (which
    covers the trace bank seeds/sizes, platform, cp and the evaluation
    seed), the bank sampling mode and the engine tag
    (:func:`_engine_fingerprint`)."""
    tag = ("batched|" if batched_bank else "") + _engine_fingerprint(device)
    digest = hashlib.sha256(
        (f"eval-v{_EVAL_CACHE_VERSION}|" + tag + cell.key()).encode()
    ).hexdigest()
    return f"eval-{digest[:32]}"


def run_experiment(
    exp: ExperimentSpec,
    *,
    n_traces: int | None = None,
    seed: int | None = None,
    workers: int | None = None,
    verbose: bool = False,
    persist: bool | None = None,
    engine: str | None = None,
    batched_traces: bool | None = None,
    device: DeviceSpec = None,
) -> ResultTable:
    """Run an :class:`ExperimentSpec`; returns the tidy result table.

    Per sweep cell: one shared trace bank, one :class:`EvalCache` and one
    :func:`evaluate_strategies` call, so every lane candidate of the cell
    (each BestPeriod grid included) runs in one lane pass on ``device``
    (``None``: CUDA).  ``n_traces`` / ``seed`` override the scenario spec;
    ``n_traces=0`` skips simulation (analytic experiments still report
    each strategy's period).  ``persist=True`` (or
    ``REPRO_PERSIST_CACHE=1``) backs each cell's cache with the on-disk
    store under :func:`default_cache_dir`.  ``engine`` / ``workers`` /
    ``batched_traces`` select the route, the oracle's pool and the bank
    sampling path (see :func:`evaluate_strategies` / :func:`trace_bank`).
    The rows are bitwise the reference's.
    """
    from ..obs.metrics import get_registry

    if persist is None:
        persist = _env_flag(_PERSIST_ENV)
    if batched_traces is None:
        batched_traces = _env_flag(_BATCHED_TRACES_ENV)
    engine = _resolve_engine(engine)
    reg = get_registry()
    rows: list[dict[str, Any]] = []
    for axis_cols, cell in exp.cells():
        overrides: dict[str, Any] = {}
        if n_traces is not None:
            overrides["n_traces"] = n_traces
        if seed is not None:
            overrides["seed"] = seed
        if overrides:
            cell = cell.replace(**overrides)
        built = [(sspec, sspec.build(cell)) for sspec in exp.strategies]

        traces: list[EventTrace] = []
        if cell.n_traces > 0 and built:
            traces = trace_bank(cell, batched=batched_traces)
        cache = EvalCache(persist_key=_cell_persist_key(
            cell, batched_traces, device) if persist else None)

        means: list[float | None] = [None] * len(built)
        resolved = [s for _, s in built]
        if traces:
            with reg.timer("runner.eval_s"):
                got = _evaluate(traces, cell.platform, cell.time_base,
                                cell.cp, resolved, seed=cell.seed,
                                cache=cache, workers=workers, engine=engine,
                                chunk=None, device=device)
            means = [m for m, _ in got]
            resolved = [s for _, s in got]
        else:
            # Nothing to search against: a search reports its base
            # strategy's analytic period under the search's own name.
            resolved = [dataclasses.replace(s.base, name=s.name)
                        if isinstance(s, BestPeriodSearch) else s
                        for s in resolved]
        cache.flush()
        reg.count("runner.cache_hits", cache.hits)
        reg.count("runner.cache_misses", cache.misses)
        reg.count("runner.cells")

        for (sspec, _), strat, mean in zip(built, resolved, means):
            name = sspec.label if sspec.label is not None else strat.name
            row: dict[str, Any] = dict(axis_cols)
            row["strategy"] = name
            row["period"] = (float(strat.period)
                             if isinstance(strat.period, (int, float))
                             else "dynamic")
            for metric in exp.metrics:
                row[metric] = _metric_value(metric, mean, cell)
            rows.append(row)
        if verbose:
            cellname = ", ".join(f"{k}={v}" for k, v in axis_cols.items())
            print(f"[{exp.name}] {cellname or 'base'}: "
                  f"{len(traces)} traces, cache {cache.misses} sims "
                  f"/ {cache.hits} hits", flush=True)
    return ResultTable(rows)


# ---------------------------------------------------------------------------
# Suite execution (store-backed, resumable)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SuiteItemResult:
    """Outcome of one suite item: the stored record (or the error that
    prevented one), whether the store satisfied it without executing, and
    the evaluated claim results."""

    name: str
    kind: str
    record_id: str
    record: Any = None            # RunRecord | None (None on error)
    cached: bool = False
    claims: list = dataclasses.field(default_factory=list)
    error: str | None = None
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.error is None \
            and all(c.get("ok", False) for c in self.claims)


@dataclasses.dataclass
class SuiteRunResult:
    """Outcome of :func:`run_suite`: the per-item results plus the
    aggregate suite record written to the store."""

    suite: Any                    # SuiteSpec
    record: Any                   # suite-kind RunRecord
    items: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(it.ok for it in self.items)

    @property
    def record_id(self) -> str:
        return self.record.record_id

    @property
    def n_cached(self) -> int:
        return sum(it.cached for it in self.items)

    def failures(self) -> list[str]:
        out = []
        for it in self.items:
            if it.error is not None:
                out.append(f"{it.name}: ERROR {it.error}")
            for c in it.claims:
                if not c.get("ok", False):
                    out.append(f"{it.name}: CLAIM FAILED {c['claim']} "
                               f"({c.get('detail', '')})")
        return out

    def summary(self) -> str:
        lines = [f"suite {self.suite.name}: {len(self.items)} items, "
                 f"{self.n_cached} from store, "
                 f"{'OK' if self.ok else 'FAILED'} "
                 f"[{self.record_id}]"]
        for it in self.items:
            n_claims = len(it.claims)
            n_ok = sum(c.get("ok", False) for c in it.claims)
            tag = "store" if it.cached else f"{it.wall_s:.1f}s"
            state = "error" if it.error else \
                ("ok" if it.ok else f"{n_claims - n_ok} claim(s) failed")
            lines.append(f"  {it.kind:10s} {it.name:24s} {tag:>7s}  "
                         f"claims {n_ok}/{n_claims}  {state}")
        lines += [f"  ! {f}" for f in self.failures()]
        return "\n".join(lines)


def _suite_item_identity(item: Any, device: DeviceSpec
                         ) -> tuple[dict, Any]:
    """(identity dict, built ExperimentSpec | None) of one suite item.

    The reference's identity (the full canonical spec or the benchmark
    name + quick flag, the execution context and the runner semantics
    version) with the port's engine fingerprint on ``device``
    (:func:`_engine_fingerprint`), so a port record never aliases a
    reference record and a CPU record never resumes a CUDA run.
    """
    base = {"eval_version": _EVAL_CACHE_VERSION,
            "engine_fingerprint": _engine_fingerprint(device)}
    if item.kind == "benchmark":
        return dict(base, benchmark=item.benchmark, quick=item.quick), None
    from .registry import build_experiment
    if item.spec is not None:
        exp = ExperimentSpec.from_dict(item.spec)
    else:
        exp = build_experiment(item.experiment, quick=item.quick,
                               **item.args)
    if item.overrides:
        exp = exp.with_overrides(item.overrides)
    identity = dict(base, spec=exp.to_dict(), n_traces=item.n_traces,
                    seed=item.seed, batched_traces=item.batched_traces)
    return identity, exp


# Counters of the lane engine: chunk, iteration, re-plan and kernel-launch
# counts.  They depend on the device (the launches are 0 on the CPU, the
# chunking follows the device) and the reference's numpy engines count
# none of them, so they ride in ``timings`` and the payload keeps what the
# reference's payload holds.
_ENGINE_COUNTER_PREFIXES = ("torch.", "kernels.", "engine.")


def _metrics_outputs(reg: Any) -> tuple[dict, dict]:
    """Split a registry snapshot into (payload counters, timing extras).

    Deterministic counters go into the record payload (exact-diffed);
    anything resume-, device- or environment-dependent — the cache
    hit/miss split, the lane engine's counters and all timers/gauges —
    rides in ``timings``, which diffs exclude as provenance.
    """
    cnt = dict(reg.counters)
    extras = dict(reg.flat_timings())
    hits = cnt.pop("runner.cache_hits", 0)
    misses = cnt.pop("runner.cache_misses", 0)
    if hits or misses:
        cnt["runner.cache_lookups"] = hits + misses
        extras["runner.cache_hits"] = hits
        extras["runner.cache_misses"] = misses
    for name in [n for n in cnt if n.startswith(_ENGINE_COUNTER_PREFIXES)]:
        extras[name] = cnt.pop(name)
    return cnt, extras


def _run_suite_item(item: Any, store: Any, *, resume: bool,
                    engine: str | None, workers: int | None,
                    verbose: bool, device: DeviceSpec
                    ) -> SuiteItemResult:
    from ..obs.metrics import MetricsRegistry, set_registry
    from ..store import RunRecord, evaluate_claims

    eng = _resolve_engine(item.engine or engine)
    try:
        identity, exp = _suite_item_identity(item, device)
    except (KeyError, ValueError, TypeError) as e:
        # Unknown experiment / malformed spec or overrides: no identity,
        # so nothing to probe or store — report the item as failed.
        return SuiteItemResult(name=item.name, kind=item.kind, record_id="",
                               error=f"{type(e).__name__}: {e}")
    rid = RunRecord.id_for(item.kind, item.name, identity)
    res = SuiteItemResult(name=item.name, kind=item.kind, record_id=rid)
    if item.kind == "benchmark":
        # The reference runs these through benchmarks/run.py, which drives
        # the JAX package; the port does not run it (ROADMAP A5).
        res.error = (f"KeyError: benchmark {item.benchmark!r}: benchmark "
                     f"items run the JAX package's benchmarks/ scripts, "
                     f"which the port does not run (ROADMAP A5)")
        return res

    rec = store.get(rid) if resume else None
    if rec is not None:
        res.record, res.cached = rec, True
    else:
        reg = MetricsRegistry()
        prev_reg = set_registry(reg)
        t0 = time.time()
        try:
            table = run_experiment(
                exp, n_traces=item.n_traces, seed=item.seed,
                workers=workers, verbose=verbose, engine=eng,
                batched_traces=item.batched_traces or None, device=device)
            counters, extras = _metrics_outputs(reg)
            rec = RunRecord.create(item.kind, item.name, identity,
                                   rows=table.rows,
                                   payload={"metrics": counters}
                                   if counters else {},
                                   timings={"wall_s": time.time() - t0,
                                            **extras})
        except (AssertionError, KeyError, ValueError, TypeError) as e:
            # A failed run is reported, never stored: the identity must
            # only ever resolve to a completed result.
            res.error = f"{type(e).__name__}: {e}"
            res.wall_s = time.time() - t0
            return res
        finally:
            set_registry(prev_reg)
        res.record, res.wall_s = rec, time.time() - t0

    # Claims are (re-)evaluated on every run, including store-resumed ones,
    # so tightening a suite file re-gates cached results without simulating.
    table = ResultTable(res.record.rows) if res.record.rows else None
    res.claims = evaluate_claims(item, table, res.record.payload)
    res.record = res.record.with_claims(res.claims)
    store.put(res.record)
    return res


def run_suite(
    suite: Any,
    *,
    store: Any = None,
    resume: bool = True,
    engine: str | None = None,
    workers: int | None = None,
    verbose: bool = False,
    device: DeviceSpec = None,
) -> SuiteRunResult:
    """Run a scenario suite through the result store (resumably).

    ``suite`` is a :class:`repro_torch.store.SuiteSpec` or a path to a
    suite file.  Per item the store is probed with the item's identity
    hash first — a hit (``resume=True``, the default) skips execution
    entirely and only re-evaluates the item's claims, so a second
    invocation of an unchanged suite simulates nothing.  Experiment items
    run through :func:`run_experiment` on ``device`` (``None``: CUDA);
    ``benchmark:`` items are reported as errors (the port does not run
    the reference's benchmark scripts) and never stored.  Results land in
    ``store`` (default :func:`repro_torch.store.default_store_dir`) as
    immutable :class:`~repro_torch.store.RunRecord`\\ s plus one aggregate
    suite record whose identity covers every member id.
    """
    from ..store import ResultStore, RunRecord, SuiteSpec

    resolve_devices(device)
    if not isinstance(suite, SuiteSpec):
        suite = SuiteSpec.from_file(suite)
    store = store if store is not None else ResultStore()
    suite.ensure_registered()

    items: list[SuiteItemResult] = []
    for item in suite.items:
        if verbose:
            print(f"[suite {suite.name}] {item.kind} {item.name} ...",
                  flush=True)
        res = _run_suite_item(item, store, resume=resume, engine=engine,
                              workers=workers, verbose=verbose,
                              device=device)
        if verbose:
            src = "store" if res.cached else f"ran in {res.wall_s:.1f}s"
            print(f"[suite {suite.name}] {item.name}: {src}, "
                  f"{'ok' if res.ok else 'FAILED'}", flush=True)
        items.append(res)

    identity = {"suite": suite.name,
                "member_ids": [it.record_id for it in items],
                "eval_version": _EVAL_CACHE_VERSION}
    suite_rec = RunRecord.create(
        "suite", suite.name, identity,
        payload={"items": [{
            "name": it.name, "kind": it.kind, "record_id": it.record_id,
            "cached": it.cached, "ok": it.ok, "error": it.error,
            "claims": it.claims,
        } for it in items]},
        timings={"wall_s": sum(it.wall_s for it in items)})
    store.put(suite_rec)
    return SuiteRunResult(suite=suite, record=suite_rec, items=items)
