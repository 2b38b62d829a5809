"""Strategy evaluation over a shared trace bank, on the torch lane engine.

The port's counterpart of the JAX package's ``experiments/runner.py``
(``evaluate_strategies``, ``BestPeriodSearch``, ``best_period_grid``) for
strategies the lane engine runs: constant periods, the four standard
trust policies and adaptive re-planning.  ``evaluate_strategies`` is three
steps, each public: ``expand_candidates`` (strategies to deduplicated lane
candidates), ``candidate_makespans`` (one lane pass, per-trace makespans)
and ``best_means`` (trace-order means, the best grid point per search).

Determinism contract (as in the reference): each (strategy, trace ``i``)
pair draws from ``np.random.default_rng(seed + 7919 * i)`` and makespans
are averaged in trace order, so the means are bitwise the reference's.
Every candidate of every strategy and search, deduplicated, runs in one
lane pass of :func:`repro_torch.core.batch.simulate_lanes`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.batch import simulate_lanes, supported_trust
from ..core.policies import Strategy
from ..core.simulator import (AlwaysTrust, FixedProbabilityTrust,
                              NeverTrust, ThresholdTrust, TrustPolicy)
from ..core.traces import EventTrace
from ..core.waste import Platform

__all__ = ["BestPeriodSearch", "best_means", "best_period_grid",
           "candidate_makespans", "evaluate_strategies",
           "expand_candidates"]


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


def best_period_grid(t0: float, platform: Platform, n_points: int,
                     span: float) -> np.ndarray:
    """Deduplicated candidate grid around the analytic period ``t0``:
    log-spaced in [t0/span, t0*span] (clamped above C), ``t0`` included."""
    lo = max(platform.c * 1.001, t0 / span)
    hi = max(lo * 1.01, t0 * span)
    return np.unique(np.append(np.geomspace(lo, hi, n_points), t0))


def _trust_key(trust: TrustPolicy) -> tuple:
    if isinstance(trust, NeverTrust):
        return ("never",)
    if isinstance(trust, AlwaysTrust):
        return ("always",)
    if isinstance(trust, FixedProbabilityTrust):
        return ("fixed_q", trust.q)
    if isinstance(trust, ThresholdTrust):
        return ("threshold", trust.threshold)
    raise TypeError(f"unsupported trust policy for the lane engine: "
                    f"{trust!r}")


def _candidate_key(strategy: Strategy) -> tuple:
    adaptive = strategy.adaptive
    return (strategy.period, _trust_key(strategy.trust),
            strategy.inexact_window, strategy.window_mode,
            strategy.window_period,
            None if adaptive is None else tuple(adaptive.key()),
            strategy.n_verify, strategy.verify_cost, strategy.keep_ckpts)


def _check_batchable(strategy: Strategy) -> None:
    if not isinstance(strategy.period, (int, float, np.integer,
                                        np.floating)) \
            or not supported_trust(strategy.trust):
        raise ValueError(
            f"the torch lane engine cannot run strategy {strategy.name!r} "
            f"(dynamic period or unsupported trust policy)")


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
    """The deduplicated lane candidates of ``strategies`` (a
    :class:`BestPeriodSearch` expands to its grid) and, for each strategy,
    the indices of its candidates in that list."""
    slot: dict[tuple, int] = {}
    unique: list[Strategy] = []
    rows: list[list[int]] = []
    for item in strategies:
        rows.append([])
        for strat in _expand(item, platform):
            _check_batchable(strat)
            key = _candidate_key(strat)
            if key not in slot:
                slot[key] = len(unique)
                unique.append(strat)
            rows[-1].append(slot[key])
    return unique, rows


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
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Makespan of every candidate on every bank trace in ``trace_indices``
    (``None``: all), as one lane pass of :func:`simulate_lanes`.

    Returns ``(len(candidates), len(trace_indices))``.  The lane of trace
    ``i`` draws from ``default_rng(seed + 7919 * i)``, and lanes do not
    interact, so a subset of traces gives the bits of those columns of the
    whole.  ``device`` is where the lanes run (``None``: CUDA).
    """
    idx = (np.arange(len(traces), dtype=np.int64) if trace_indices is None
           else np.asarray(trace_indices, dtype=np.int64))
    n = idx.size
    out = np.empty((len(candidates), n), dtype=np.float64)
    if n and len(candidates):
        lane_c = np.repeat(np.arange(len(candidates)), n)
        tr_idx = np.tile(idx, len(candidates))
        lane = [candidates[ci] for ci in lane_c]
        ms = simulate_lanes(
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
        out[:] = ms.reshape(len(candidates), n)
    return out


def best_means(makespans: np.ndarray, rows: Sequence[Sequence[int]]
               ) -> list[float]:
    """Per strategy, the smallest trace-order mean over its candidate
    rows of ``makespans`` (the first minimum, as ``np.argmin`` picks it)."""
    n = makespans.shape[1]

    def mean(row: np.ndarray) -> float:
        # Sequential accumulation in trace order: bit-for-bit the
        # reference's ``total += makespan; total / max(1, n)``.
        total = 0.0
        for ti in range(n):
            total += row[ti]
        return float(total / max(1, n))

    out = []
    for cand_rows in rows:
        means = [mean(makespans[j]) for j in cand_rows]
        out.append(means[int(np.argmin(means))])
    return out


def evaluate_strategies(
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    cp: float,
    strategies: Sequence[Strategy | BestPeriodSearch],
    *,
    seed: int = 0,
    chunk: int | None = None,
    device: str | torch.device | None = None,
) -> list[float]:
    """Mean makespan of each strategy over the shared trace set.

    A :class:`BestPeriodSearch` entry yields the mean of its best grid
    period (the first minimum, as ``np.argmin`` picks it).  Every
    candidate, deduplicated, runs in one lane pass.  ``device`` is where
    the lanes run (``None``: CUDA).
    """
    unique, rows = expand_candidates(strategies, platform)
    return best_means(
        candidate_makespans(traces, platform, time_base, cp, unique,
                            seed=seed, chunk=chunk, device=device), rows)
