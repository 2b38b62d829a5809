"""Lane-parallel batched simulation engine: the port's front end.

:func:`simulate_batch` executes *all traces of a bank x all candidate
periods* simultaneously: one lane per (candidate, trace) pair, the whole
fleet of phase machines advanced together on the device by
:func:`repro_torch.core.batch_torch.run_lanes_torch`.
:func:`lane_results` is its flat sibling for an explicit list of lanes
(:func:`simulate_lanes` its makespans).

The port's own copy of ``repro/core/batch.py`` (bank packing, trust codes,
:class:`BatchResult`, candidate arrays and the two entry points), with
``device=`` (``None`` means CUDA; ``"cpu"`` runs the plain versions; a
list of devices splits each chunk over them, in place of the reference's
``REPRO_JAX_SHARD``) and ``chunk=`` in place of ``backend=``.

Equivalence contract: every lane is **bit-for-bit** the JAX package's
scalar ``simulate(trace, ..., rng=np.random.default_rng(seed))`` and its
numpy lane engine, for constant periods, the trust policies Never /
Always / Threshold / FixedProbability, exact and inexact windows,
per-event windows, both window action modes, the silent-error
verification knobs and adaptive re-planning.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Sequence

import numpy as np
import torch

from ..device import DeviceSpec
from .batch_torch import run_lanes_torch
from .simulator import (WINDOW_MODES, AlwaysTrust, FixedProbabilityTrust,
                        NeverTrust, SimResult, ThresholdTrust, TrustPolicy)
from .traces import EventTrace
from .waste import Platform

__all__ = [
    "BatchResult",
    "lane_results",
    "simulate_batch",
    "simulate_lanes",
    "supported_trust",
    "trust_code",
    "window_mode_code",
]

# Trust-policy codes for the vectorized decision step.
_TRUST_NEVER, _TRUST_ALWAYS, _TRUST_THRESHOLD, _TRUST_FIXED_Q = range(4)

# Window-mode codes (index into simulator.WINDOW_MODES).
_WMODE_INSTANT, _WMODE_WITHIN = range(2)


def supported_trust(trust: TrustPolicy) -> bool:
    """True if the lane engine can evaluate this policy vectorized."""
    return isinstance(trust, (NeverTrust, AlwaysTrust, ThresholdTrust,
                              FixedProbabilityTrust))


def trust_code(trust: TrustPolicy) -> tuple[int, float]:
    """(code, parameter) encoding of a supported trust policy."""
    if isinstance(trust, NeverTrust):
        return _TRUST_NEVER, 0.0
    if isinstance(trust, AlwaysTrust):
        return _TRUST_ALWAYS, 0.0
    if isinstance(trust, ThresholdTrust):
        return _TRUST_THRESHOLD, float(trust.threshold)
    if isinstance(trust, FixedProbabilityTrust):
        return _TRUST_FIXED_Q, float(trust.q)
    raise TypeError(f"unsupported trust policy for the lane engine: {trust!r}")


# ---------------------------------------------------------------------------
# Padded event bank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _EventBank:
    """Traces packed as a padded 2-D event tensor (one row per trace).

    ``windows`` is the per-event prediction-window tensor, present iff any
    trace carries :attr:`EventTrace.windows`; rows of window-less traces
    hold the -1 sentinel meaning "fall back to the lane's inexact_window".
    """

    times: np.ndarray   # (n_traces, max_events) float64, +inf padded
    kinds: np.ndarray   # (n_traces, max_events) int8, -1 padded
    n_events: np.ndarray  # (n_traces,) int64
    windows: np.ndarray | None = None  # (n_traces, max_events) float64


def _pack_bank(traces: Sequence[EventTrace], start: float) -> _EventBank:
    shifted: list[tuple[np.ndarray, np.ndarray, np.ndarray | None]] = []
    for tr in traces:
        sel = tr.times >= start
        shifted.append((np.asarray(tr.times[sel] - start, dtype=np.float64),
                        np.asarray(tr.kinds[sel], dtype=np.int8),
                        None if tr.windows is None
                        else np.asarray(tr.windows[sel], dtype=np.float64)))
    n = len(shifted)
    width = max([t.size for t, _, _ in shifted], default=0)
    times = np.full((n, max(1, width)), np.inf, dtype=np.float64)
    kinds = np.full((n, max(1, width)), -1, dtype=np.int8)
    n_events = np.zeros(n, dtype=np.int64)
    windows: np.ndarray | None = None
    if any(w is not None for _, _, w in shifted):
        windows = np.full((n, max(1, width)), -1.0, dtype=np.float64)
    for i, (t, k, w) in enumerate(shifted):
        times[i, :t.size] = t
        kinds[i, :k.size] = k
        n_events[i] = t.size
        if windows is not None and w is not None:
            windows[i, :w.size] = w
    return _EventBank(times, kinds, n_events, windows)


# ---------------------------------------------------------------------------
# Batch result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchResult:
    """Structure-of-arrays :class:`SimResult` for a (candidate, trace) grid.

    Every field is shaped ``(n_candidates, n_traces)``; ``result(ci, ti)``
    rebuilds the scalar :class:`SimResult` of one lane.
    """

    makespan: np.ndarray
    time_base: float
    n_faults: np.ndarray
    n_faults_hit: np.ndarray
    n_predictions: np.ndarray
    n_trusted: np.ndarray
    n_trusted_true: np.ndarray
    n_ignored_by_necessity: np.ndarray
    n_periodic_ckpts: np.ndarray
    time_ckpt: np.ndarray
    time_prockpt: np.ndarray
    time_down: np.ndarray
    time_lost: np.ndarray
    # Waste-attribution split of time_down + diagnostics; mirror the
    # SimResult fields of the same names.
    time_downtime: np.ndarray | None = None
    time_recovery: np.ndarray | None = None
    n_proactive_ckpts: np.ndarray | None = None
    n_rollbacks: np.ndarray | None = None
    n_replans: np.ndarray | None = None
    # Silent-error / verification counters (arXiv:1310.8486).
    n_silent: np.ndarray | None = None
    n_verifications: np.ndarray | None = None
    n_deep_rollbacks: np.ndarray | None = None
    time_verify: np.ndarray | None = None
    final_period: np.ndarray | None = None
    final_threshold: np.ndarray | None = None
    est_recall: np.ndarray | None = None
    est_precision: np.ndarray | None = None
    est_mu: np.ndarray | None = None

    @classmethod
    def from_lanes(cls, out: dict, time_base: float,
                   shape: tuple[int, ...]) -> "BatchResult":
        """The result of ``run_lanes_torch``'s per-lane dict, every array
        reshaped to ``shape``."""
        return cls(
            makespan=out["makespan"].reshape(shape), time_base=time_base,
            n_faults=out["n_faults"].reshape(shape),
            n_faults_hit=out["n_faults_hit"].reshape(shape),
            n_predictions=out["n_predictions"].reshape(shape),
            n_trusted=out["n_trusted"].reshape(shape),
            n_trusted_true=out["n_trusted_true"].reshape(shape),
            n_ignored_by_necessity=out["n_ignored"].reshape(shape),
            n_periodic_ckpts=out["n_periodic_ckpts"].reshape(shape),
            time_ckpt=out["time_ckpt"].reshape(shape),
            time_prockpt=out["time_prockpt"].reshape(shape),
            time_down=out["time_down"].reshape(shape),
            time_lost=out["time_lost"].reshape(shape),
            time_downtime=out["time_downtime"].reshape(shape),
            time_recovery=out["time_recovery"].reshape(shape),
            n_proactive_ckpts=out["n_proactive_ckpts"].reshape(shape),
            n_rollbacks=out["n_rollbacks"].reshape(shape),
            n_replans=out["n_replans"].reshape(shape),
            n_silent=out["n_silent"].reshape(shape),
            n_verifications=out["n_verifications"].reshape(shape),
            n_deep_rollbacks=out["n_deep_rollbacks"].reshape(shape),
            time_verify=out["time_verify"].reshape(shape),
            final_period=out["final_period"].reshape(shape),
            final_threshold=out["final_threshold"].reshape(shape),
            est_recall=out["est_recall"].reshape(shape),
            est_precision=out["est_precision"].reshape(shape),
            est_mu=out["est_mu"].reshape(shape),
        )

    def reshape(self, *shape: int) -> "BatchResult":
        """The same lanes with every array field reshaped."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).reshape(*shape)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)})

    @property
    def waste(self) -> np.ndarray:
        out = np.zeros_like(self.makespan)
        np.divide(self.time_base, self.makespan, out=out,
                  where=self.makespan > 0)
        return np.where(self.makespan > 0, 1.0 - out, 0.0)

    def result(self, ci: int, ti: int) -> SimResult:
        res = SimResult(
            makespan=float(self.makespan[ci, ti]),
            time_base=self.time_base,
            n_faults=int(self.n_faults[ci, ti]),
            n_faults_hit=int(self.n_faults_hit[ci, ti]),
            n_predictions=int(self.n_predictions[ci, ti]),
            n_trusted=int(self.n_trusted[ci, ti]),
            n_trusted_true=int(self.n_trusted_true[ci, ti]),
            n_ignored_by_necessity=int(self.n_ignored_by_necessity[ci, ti]),
            n_periodic_ckpts=int(self.n_periodic_ckpts[ci, ti]),
            time_ckpt=float(self.time_ckpt[ci, ti]),
            time_prockpt=float(self.time_prockpt[ci, ti]),
            time_down=float(self.time_down[ci, ti]),
            time_lost=float(self.time_lost[ci, ti]),
        )
        if self.time_downtime is not None:
            res.time_downtime = float(self.time_downtime[ci, ti])
        if self.time_recovery is not None:
            res.time_recovery = float(self.time_recovery[ci, ti])
        if self.n_proactive_ckpts is not None:
            res.n_proactive_ckpts = int(self.n_proactive_ckpts[ci, ti])
        if self.n_rollbacks is not None:
            res.n_rollbacks = int(self.n_rollbacks[ci, ti])
        if self.n_replans is not None:
            res.n_replans = int(self.n_replans[ci, ti])
        if self.n_silent is not None:
            res.n_silent = int(self.n_silent[ci, ti])
        if self.n_verifications is not None:
            res.n_verifications = int(self.n_verifications[ci, ti])
        if self.n_deep_rollbacks is not None:
            res.n_deep_rollbacks = int(self.n_deep_rollbacks[ci, ti])
        if self.time_verify is not None:
            res.time_verify = float(self.time_verify[ci, ti])
        if self.final_period is not None:
            res.final_period = float(self.final_period[ci, ti])
        if self.final_threshold is not None:
            res.final_threshold = float(self.final_threshold[ci, ti])
        if self.est_recall is not None:
            res.est_recall = float(self.est_recall[ci, ti])
        if self.est_precision is not None:
            res.est_precision = float(self.est_precision[ci, ti])
        if self.est_mu is not None:
            res.est_mu = float(self.est_mu[ci, ti])
        return res


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def window_mode_code(mode: str) -> int:
    """Engine code of a window action mode name."""
    try:
        return WINDOW_MODES.index(mode)
    except ValueError:
        raise ValueError(f"unknown window_mode {mode!r} "
                         f"(expected one of {WINDOW_MODES})") from None


def _as_candidate_arrays(
    periods, trust, inexact_window, window_mode, window_period, adaptive,
    n_cand: int,
) -> tuple:
    period_arr = np.asarray(periods, dtype=np.float64).reshape(n_cand)
    if trust is None or isinstance(trust, TrustPolicy):
        trust_seq = [trust or NeverTrust()] * n_cand
    else:
        trust_seq = list(trust)
        if len(trust_seq) != n_cand:
            raise ValueError(f"{len(trust_seq)} trust policies for "
                             f"{n_cand} periods")
    codes = [trust_code(t) for t in trust_seq]
    kind_arr = np.array([k for k, _ in codes], dtype=np.int8)
    param_arr = np.array([q for _, q in codes], dtype=np.float64)
    window_arr = np.broadcast_to(
        np.asarray(inexact_window, dtype=np.float64), (n_cand,)).copy()
    if isinstance(window_mode, str):
        window_mode = [window_mode] * n_cand
    wmode_arr = np.array([window_mode_code(m) for m in window_mode],
                         dtype=np.int8).reshape(n_cand)
    wperiod_arr = np.broadcast_to(
        np.asarray(window_period, dtype=np.float64), (n_cand,)).copy()
    if adaptive is None or not isinstance(adaptive, (list, tuple)):
        adaptive_seq = [adaptive] * n_cand
    else:
        adaptive_seq = list(adaptive)
        if len(adaptive_seq) != n_cand:
            raise ValueError(f"{len(adaptive_seq)} adaptive configs for "
                             f"{n_cand} periods")
    return (period_arr, kind_arr, param_arr, window_arr, wmode_arr,
            wperiod_arr, adaptive_seq)


def lane_results(
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    *,
    cp: float,
    trace_indices: Sequence[int],
    periods: Sequence[float],
    trusts: Sequence[TrustPolicy],
    windows: Sequence[float],
    seeds: Sequence[int],
    window_modes: Sequence[str] | None = None,
    window_periods: Sequence[float] | None = None,
    adaptives: Sequence | None = None,
    n_verifies: Sequence[int] | None = None,
    verify_costs: Sequence[float] | None = None,
    keep_ckpts: Sequence[int] | None = None,
    start: float = 0.0,
    chunk: int | None = None,
    device: DeviceSpec = None,
) -> BatchResult:
    """Simulate an explicit list of (trace, candidate) lanes; returns the
    per-lane results as a ``(1, n_lanes)`` :class:`BatchResult`.

    The flat sibling of :func:`simulate_batch` for callers (the experiment
    runner) whose lanes are not a full candidate x trace grid.  Lane ``j``
    is bit-for-bit ``simulate(traces[trace_indices[j]], ..., periods[j],
    trust=trusts[j], inexact_window=windows[j],
    window_mode=window_modes[j], window_period=window_periods[j],
    adaptive=adaptives[j], rng=np.random.default_rng(seeds[j]))``.
    """
    lane_trace = np.asarray(trace_indices, dtype=np.int64)
    lane_period = np.asarray(periods, dtype=np.float64)
    codes = [trust_code(t) for t in trusts]
    lane_kind = np.array([k for k, _ in codes], dtype=np.int8)
    lane_param = np.array([q for _, q in codes], dtype=np.float64)
    lane_window = np.asarray(windows, dtype=np.float64)
    lane_seed = np.asarray(seeds, dtype=np.int64)
    lane_wmode = (np.zeros(lane_trace.size, dtype=np.int8)
                  if window_modes is None else
                  np.array([window_mode_code(m) for m in window_modes],
                           dtype=np.int8))
    lane_wperiod = (np.zeros(lane_trace.size, dtype=np.float64)
                    if window_periods is None else
                    np.asarray(window_periods, dtype=np.float64))
    lane_adaptive = (list(adaptives) if adaptives is not None
                     else [None] * lane_trace.size)
    lane_nv = (np.zeros(lane_trace.size, dtype=np.int64)
               if n_verifies is None else
               np.asarray(n_verifies, dtype=np.int64))
    lane_vc = (np.zeros(lane_trace.size, dtype=np.float64)
               if verify_costs is None else
               np.asarray(verify_costs, dtype=np.float64))
    lane_kc = (np.ones(lane_trace.size, dtype=np.int64)
               if keep_ckpts is None else
               np.asarray(keep_ckpts, dtype=np.int64))
    if not (lane_trace.size == lane_period.size == lane_kind.size
            == lane_window.size == lane_seed.size == lane_wmode.size
            == lane_wperiod.size == len(lane_adaptive) == lane_nv.size
            == lane_vc.size == lane_kc.size):
        raise ValueError("lane array lengths differ")
    if lane_trace.size == 0:
        return BatchResult.from_lanes(defaultdict(lambda: np.empty(0)),
                                      time_base, (1, 0))
    bank = _pack_bank(traces, start)
    out = run_lanes_torch(bank, platform, time_base, lane_trace,
                          lane_period, lane_kind, lane_param, lane_window,
                          lane_seed, cp, lane_wmode=lane_wmode,
                          lane_wperiod=lane_wperiod,
                          lane_adaptive=lane_adaptive,
                          lane_nverify=lane_nv, lane_vcost=lane_vc,
                          lane_keep=lane_kc, chunk=chunk, device=device)
    return BatchResult.from_lanes(out, time_base, (1, lane_trace.size))


def simulate_lanes(traces: Sequence[EventTrace], platform: Platform,
                   time_base: float, **kwargs) -> np.ndarray:
    """:func:`lane_results`' per-lane makespans, ``(n_lanes,)``."""
    return lane_results(traces, platform, time_base, **kwargs).makespan[0]


def simulate_batch(
    traces: Sequence[EventTrace],
    platform: Platform,
    time_base: float,
    periods,
    *,
    cp: float | None = None,
    trust: TrustPolicy | Sequence[TrustPolicy] | None = None,
    inexact_window: float | Sequence[float] = 0.0,
    window_mode: str | Sequence[str] = "instant",
    window_period: float | Sequence[float] = 0.0,
    adaptive=None,
    n_verify: int | Sequence[int] = 0,
    verify_cost: float | Sequence[float] = 0.0,
    keep_ckpts: int | Sequence[int] = 1,
    start: float = 0.0,
    trace_seeds: Sequence[int] | int | None = None,
    chunk: int | None = None,
    device: DeviceSpec = None,
) -> BatchResult:
    """Simulate every (candidate, trace) pair of a grid in lockstep.

    Args:
      traces: the trace bank (lanes share the packed event tensor).
      platform: (mu, C, D, R) parameters.
      time_base: useful work to complete (seconds).
      periods: one period or a sequence of candidate periods (all >= C).
      cp: proactive checkpoint duration C_p (defaults to C).
      trust: one policy for all candidates, or one per candidate.  Must be
        Never/Always/Threshold/FixedProbability — callable periods or other
        policies need the JAX package's scalar engine.
      inexact_window: scalar or per-candidate uncertainty window (fallback
        when the traces carry no per-event window lengths).
      window_mode: scalar or per-candidate window action mode, "instant"
        or "within" (the JAX package's ``simulate`` documents both).
      window_period: scalar or per-candidate in-window proactive period
        T_p (> C_p) for "within" candidates.
      adaptive: one :class:`repro_torch.predictors.AdaptiveConfig` (or one
        per candidate, ``None`` entries static): the lane re-plans its
        period and trust threshold from online (r, p) estimates; its trust
        must be Threshold or Never.
      n_verify: scalar or per-candidate verifications-per-period k
        (arXiv:1310.8486); 0 disables the verification cadence.
      verify_cost: scalar or per-candidate verification duration V.
      keep_ckpts: scalar or per-candidate retained-checkpoint depth.
      start: job start offset into the traces (paper: one year).
      trace_seeds: per-trace RNG seeds; lane (c, t) draws from a fresh
        ``default_rng(trace_seeds[t])`` exactly like the scalar engine does
        per (strategy, trace) pair.  A scalar seeds every trace alike;
        ``None`` means seed 0 (the scalar engine's default rng).
      chunk: lanes run at once (``None``: the whole grid).
      device: where the lanes run (``None``: CUDA, raising if there is
        none, and split over every card when more than one is visible;
        ``"cpu"`` runs the plain versions of the kernels); a list or
        tuple of devices (repeats allowed) splits each chunk over them
        (``run_lanes_torch``).

    Returns:
      :class:`BatchResult` with ``(n_candidates, n_traces)`` arrays.  Each
      lane is bit-for-bit the scalar ``simulate`` result for that
      (period, trust, window, trace, seed) combination.
    """
    cp = platform.c if cp is None else cp
    scalar_period = np.isscalar(periods) or (
        isinstance(periods, np.ndarray) and periods.ndim == 0)
    n_cand = 1 if scalar_period else len(periods)
    (period_arr, kind_arr, param_arr, window_arr, wmode_arr,
     wperiod_arr, adaptive_seq) = _as_candidate_arrays(
        periods, trust, inexact_window, window_mode, window_period,
        adaptive, n_cand)

    n_traces = len(traces)
    if trace_seeds is None:
        seeds = np.zeros(n_traces, dtype=np.int64)
    elif np.isscalar(trace_seeds):
        seeds = np.full(n_traces, int(trace_seeds), dtype=np.int64)
    else:
        seeds = np.asarray(trace_seeds, dtype=np.int64).reshape(n_traces)

    bank = _pack_bank(traces, start)
    # Lane layout: candidate-major, trace-minor -> reshape to the grid.
    lane_trace = np.tile(np.arange(n_traces, dtype=np.int64), n_cand)
    lane_period = np.repeat(period_arr, n_traces)
    lane_kind = np.repeat(kind_arr, n_traces)
    lane_param = np.repeat(param_arr, n_traces)
    lane_window = np.repeat(window_arr, n_traces)
    lane_wmode = np.repeat(wmode_arr, n_traces)
    lane_wperiod = np.repeat(wperiod_arr, n_traces)
    lane_seed = np.tile(seeds, n_cand)
    lane_adaptive = [a for a in adaptive_seq for _ in range(n_traces)]
    nv_arr = np.broadcast_to(
        np.asarray(n_verify, dtype=np.int64), (n_cand,)).copy()
    vc_arr = np.broadcast_to(
        np.asarray(verify_cost, dtype=np.float64), (n_cand,)).copy()
    kc_arr = np.broadcast_to(
        np.asarray(keep_ckpts, dtype=np.int64), (n_cand,)).copy()
    lane_nv = np.repeat(nv_arr, n_traces)
    lane_vc = np.repeat(vc_arr, n_traces)
    lane_kc = np.repeat(kc_arr, n_traces)

    out = run_lanes_torch(bank, platform, time_base, lane_trace,
                          lane_period, lane_kind, lane_param, lane_window,
                          lane_seed, cp, lane_wmode=lane_wmode,
                          lane_wperiod=lane_wperiod,
                          lane_adaptive=lane_adaptive,
                          lane_nverify=lane_nv, lane_vcost=lane_vc,
                          lane_keep=lane_kc, chunk=chunk, device=device)
    return BatchResult.from_lanes(out, time_base, (n_cand, n_traces))
