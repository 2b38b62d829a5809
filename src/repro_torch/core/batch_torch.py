"""Torch backend of the lane-parallel batched simulator.

The counterpart of the JAX package's ``core/batch_jax.py::run_lanes_jax``:
every lane runs the numpy engine's loop body (event pop, deferred-fault
push, event arrivals, ``_ADV_PASSES`` lockstep-schedule steps) until it
finished.  The body and the chunk's state layout are in
:mod:`repro_torch.kernels.lane_loop`; this module builds a chunk's state
(:class:`~repro_torch.kernels.lane_loop.Lanes`), drives it and reads the
results back.

The host loop (``_run_chunk``) calls :func:`lane_loop` with at most
``_LAUNCH_CAP`` iterations a call and reads back one stop flag after
each call, until every lane finished or one overflowed: on the card each
call is one launch of the lane-loop kernel, which keeps a lane's whole
state in registers for all its iterations; on the CPU each call runs the
plain eager loop.

Lane randomness (FixedProbability trust draws, in-window fault offsets) is
pre-drawn per lane on the host with numpy (``_draw_tables``), exactly as
the JAX engine does, and consumed at the scalar engine's draw sites.

Adaptive lanes (the host re-planning round trip) and multi-card sharding
are not part of this engine yet: adaptive lanes raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.event_step import (F_NOW, F_PERIOD, F_PHEND, F_TARGET,
                                  F_TCKPT, F_TDOWN, F_TDOWNT, F_TLOST,
                                  F_TPROC, F_TRECOV, F_TVERIFY, F_VCOST,
                                  F_VREM, F_VWP, F_WINEND, F_WINREM,
                                  F_WPP, F_WREM, F_WWP, I_KEEP, I_NCKPT,
                                  I_NDEEP, I_NPROC, I_NROLL, I_NV, I_NVERIF,
                                  I_PHASE, N_F, N_I, event_step)
from ..kernels.lane_loop import (_BIG_SEQ, _DEF_SLOTS, _PC_POP,
                                 _TRUST_FIXED_Q, COUNTS, LF_DEF, LF_TPARAM,
                                 LF_WINDOW, LI_COUNTS, LI_DEFSEQ, LI_KIND,
                                 LI_NEXT_SEQ, LI_OVERFLOW, LI_PC, LI_WITHIN,
                                 LQ_ITERS, LQ_NEV, LQ_TR, N_LF, N_LI, N_LQ,
                                 LaneBank, Lanes, lane_loop)
from ..obs.metrics import get_registry
from .simulator import _WORK
from .traces import FALSE_PRED, FAULT_PRED
from .waste import Platform

__all__ = ["run_lanes_torch"]

_WMODE_INSTANT, _WMODE_WITHIN = range(2)
# Iterations a lane runs per lane_loop call at most.  Large enough that the
# paper's study (its longest lane about 6,200 iterations) takes one launch;
# it bounds a launch's time so that a lane that never ends cannot hold the
# card.
_LAUNCH_CAP = 8192


def _draw_tables(bank, lane_trace: np.ndarray, lane_kind: np.ndarray,
                 lane_window: np.ndarray,
                 lane_seed: np.ndarray) -> np.ndarray:
    """Per-lane stream-prefix tables of pre-drawn uniforms.

    A lane consumes at most one draw per true prediction whose effective
    window is positive (the in-window fault offset) plus one per
    prediction event (the FixedProbability trust draw, consumed only when
    the decision is actually reached).  Per-event windows make the bound
    per *trace*: true predictions carrying their own positive window
    always draw; sentinel (-1) events draw iff the lane's fallback window
    is positive; explicit zero windows never draw.  The first ``need``
    values of the lane's ``default_rng(seed)`` stream bound every draw
    the scalar engine can make, in consumption order.
    """
    is_true = bank.kinds == FAULT_PRED
    n_pred = (is_true | (bank.kinds == FALSE_PRED)).sum(axis=1)
    if bank.windows is None:
        cnt_own = np.zeros(bank.kinds.shape[0], dtype=np.int64)
        cnt_fb = is_true.sum(axis=1)
    else:
        cnt_own = (is_true & (bank.windows > 0.0)).sum(axis=1)
        cnt_fb = (is_true & (bank.windows < 0.0)).sum(axis=1)
    need = (cnt_own[lane_trace]
            + cnt_fb[lane_trace] * (lane_window > 0.0)
            + n_pred[lane_trace] * (lane_kind == _TRUST_FIXED_Q)
            ).astype(np.int64)
    width = max(1, int(need.max()) if need.size else 1)
    tab = np.zeros((lane_trace.size, width), dtype=np.float64)
    for i in np.nonzero(need)[0]:
        n = int(need[i])
        tab[i, :n] = np.random.default_rng(int(lane_seed[i])).random(n)
    return tab


def _run_chunk(loop, lanes: Lanes, g: LaneBank, cap: int) -> int:
    """The host loop: calls of ``loop`` (:func:`lane_loop` or its plain
    version) of at most ``cap`` iterations, one stop flag read back after
    each, until every lane finished or one overflowed.  Returns the
    number of calls."""
    calls = 0
    while True:
        flag = int(loop(lanes, g, cap=cap))
        calls += 1
        if flag & 2 or not flag & 1:
            return calls


def run_lanes_torch(bank, platform: Platform, time_base: float,
                    lane_trace: np.ndarray, lane_period: np.ndarray,
                    lane_kind: np.ndarray, lane_param: np.ndarray,
                    lane_window: np.ndarray, lane_seed: np.ndarray,
                    cp: float,
                    lane_wmode: np.ndarray | None = None,
                    lane_wperiod: np.ndarray | None = None,
                    lane_adaptive: Sequence | None = None,
                    lane_nverify: np.ndarray | None = None,
                    lane_vcost: np.ndarray | None = None,
                    lane_keep: np.ndarray | None = None,
                    chunk: int | None = None,
                    device: str | torch.device | None = None
                    ) -> dict[str, Any]:
    """Run a lane grid over a packed event bank; returns per-lane results.

    The arguments and the returned 26-key dict are those of the JAX
    package's ``run_lanes_jax``.  ``chunk`` bounds the lanes run at once
    (``None``: all); ``device`` is where the lanes run (``None``: CUDA).
    """
    dev = resolve_device(device)
    if lane_adaptive is not None and any(a is not None
                                         for a in lane_adaptive):
        raise NotImplementedError(
            "adaptive lanes are not ported yet: see ROADMAP.md, Queue A "
            "item 1 (adaptive lanes)")
    if np.any(lane_period < platform.c):
        raise ValueError(f"period below checkpoint {platform.c}")

    L = int(lane_trace.size)
    c, d, r = platform.c, platform.d, platform.r
    lane_period = np.asarray(lane_period, dtype=np.float64)
    lane_kind = np.asarray(lane_kind, dtype=np.int32)
    lane_param = np.asarray(lane_param, dtype=np.float64)
    lane_window = np.asarray(lane_window, dtype=np.float64)
    if lane_wmode is None:
        lane_wmode = np.zeros(L, dtype=np.int8)
    if lane_wperiod is None:
        lane_wperiod = np.zeros(L, dtype=np.float64)
    if lane_nverify is None:
        lane_nverify = np.zeros(L, dtype=np.int32)
    if lane_vcost is None:
        lane_vcost = np.zeros(L, dtype=np.float64)
    if lane_keep is None:
        lane_keep = np.ones(L, dtype=np.int32)
    lane_nverify = np.asarray(lane_nverify).astype(np.int32)
    lane_vcost = np.asarray(lane_vcost, dtype=np.float64)
    lane_keep = np.asarray(lane_keep).astype(np.int32)
    if np.any(lane_nverify < 0):
        raise ValueError("n_verify must be >= 0")
    if np.any(~np.isfinite(lane_vcost)) or np.any(lane_vcost < 0.0):
        raise ValueError("verify_cost must be finite and >= 0")
    if np.any(lane_keep < 1):
        raise ValueError("keep_ckpts must be >= 1")

    within = np.asarray(lane_wmode) == _WMODE_WITHIN
    if np.any(within & (lane_wperiod <= cp)):
        bad = float(np.asarray(lane_wperiod)[within & (lane_wperiod <= cp)][0])
        raise ValueError(f"window_period {bad} <= C_p {cp}: no work fits "
                         f"between in-window checkpoints")
    lane_wwp = np.where(within, lane_wperiod - cp, np.inf)

    reg = get_registry()
    t0 = time.perf_counter()
    tab = _draw_tables(bank, lane_trace, lane_kind, lane_window, lane_seed)
    reg.add_time("torch.tables_s", time.perf_counter() - t0)
    n_ev = bank.n_events[lane_trace]

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t0 = time.perf_counter()
    g = LaneBank(times=up(bank.times),
                 kinds=up(bank.kinds.astype(np.int32)),
                 wins=up(bank.windows if bank.windows is not None
                         else np.full_like(bank.times, -1.0)),
                 slots=torch.arange(_DEF_SLOTS, device=dev),
                 zero=torch.zeros((), dtype=torch.float64, device=dev),
                 c=c, cp=cp, d=d, r=r, time_base=time_base)
    reg.add_time("torch.upload_s", time.perf_counter() - t0)
    CL = L if (chunk is None or chunk <= 0) else min(int(chunk), L)
    CL = max(CL, 1)

    def init_chunk(sl: slice) -> Lanes:
        """A chunk's state at the start (rows not set here start at 0)."""
        n = sl.stop - sl.start
        period = lane_period[sl]
        wpp0 = period - c
        nv = lane_nverify[sl]
        vwp0 = np.where(nv >= 1, wpp0 / np.maximum(nv, 1), np.inf)
        f = np.zeros((N_LF, n), np.float64)
        f[F_PHEND] = np.inf
        f[F_WPP] = wpp0
        f[F_WREM] = np.minimum(wpp0, time_base)
        f[F_WINEND] = -np.inf
        f[F_WINREM] = np.inf
        f[F_TARGET] = -np.inf
        f[F_PERIOD] = period
        f[F_WWP] = lane_wwp[sl]
        f[F_VWP] = vwp0
        f[F_VREM] = vwp0
        f[F_VCOST] = lane_vcost[sl]
        f[LF_TPARAM] = lane_param[sl]
        f[LF_WINDOW] = lane_window[sl]
        f[LF_DEF:] = np.inf
        i = np.zeros((N_LI, n), np.int32)
        i[I_PHASE] = _WORK
        i[I_NV] = nv
        i[I_KEEP] = lane_keep[sl]
        i[LI_PC] = _PC_POP
        i[LI_NEXT_SEQ] = n_ev[sl]
        i[LI_KIND] = lane_kind[sl]
        i[LI_WITHIN] = within[sl]
        i[LI_DEFSEQ:] = _BIG_SEQ
        q = np.zeros((N_LQ, n), np.int64)
        q[LQ_TR] = lane_trace[sl]
        q[LQ_NEV] = n_ev[sl]
        return Lanes(up(f), up(i), up(q), up(tab[sl]))

    fs_all = np.zeros((N_F, L), np.float64)
    is_all = np.zeros((N_I, L), np.int32)
    counts = {key: np.zeros(L, np.int64) for key in COUNTS}
    launches0 = lane_loop.launches, event_step.launches
    wall0 = time.perf_counter()
    for lo in range(0, L, CL):
        sl = slice(lo, min(lo + CL, L))
        t0 = time.perf_counter()
        lanes = init_chunk(sl)
        t1 = time.perf_counter()
        calls = _run_chunk(lane_loop, lanes, g, _LAUNCH_CAP)
        t2 = time.perf_counter()
        f, i, q = (t.cpu().numpy() for t in (lanes.f, lanes.i, lanes.q))
        fs_all[:, sl], is_all[:, sl] = f[:N_F], i[:N_I]
        for n, key in enumerate(COUNTS):
            counts[key][sl] = i[LI_COUNTS + n]
        reg.add_time("torch.upload_s", t1 - t0)
        reg.add_time("torch.run_s", t2 - t1)
        reg.add_time("torch.readback_s", time.perf_counter() - t2)
        reg.count("torch.chunks")
        reg.count("torch.loop_calls", calls)
        reg.count("torch.iterations", int(q[LQ_ITERS].max()))
        if i[LI_OVERFLOW].any():
            reg.count("engine.deferred_overflows")
            raise RuntimeError(
                f"deferred-fault capacity ({_DEF_SLOTS} slots) exceeded in "
                f"the torch backend; rerun with the JAX package's "
                f"backend='numpy'")
    wall = time.perf_counter() - wall0
    reg.count("kernels.lane_loop.launches", lane_loop.launches - launches0[0])
    reg.count("kernels.event_step.launches",
              event_step.launches - launches0[1])
    if wall > 0.0:
        reg.gauge("torch.lanes_per_s", L / wall)

    def icount(row: int) -> np.ndarray:
        return is_all[row].astype(np.int64)

    no_est = np.full(L, -1.0)
    return {
        "makespan": fs_all[F_NOW].copy(),
        "n_faults": counts["n_faults"],
        "n_faults_hit": counts["n_faults_hit"],
        "n_predictions": counts["n_predictions"],
        "n_trusted": counts["n_trusted"],
        "n_trusted_true": counts["n_trusted_true"],
        "n_ignored": counts["n_ignored"],
        "n_periodic_ckpts": icount(I_NCKPT),
        "n_proactive_ckpts": icount(I_NPROC),
        "n_rollbacks": icount(I_NROLL),
        "time_ckpt": fs_all[F_TCKPT].copy(),
        "time_prockpt": fs_all[F_TPROC].copy(),
        "time_down": fs_all[F_TDOWN].copy(),
        "time_lost": fs_all[F_TLOST].copy(),
        "time_downtime": fs_all[F_TDOWNT].copy(),
        "time_recovery": fs_all[F_TRECOV].copy(),
        "n_silent": counts["n_silent"],
        "n_verifications": icount(I_NVERIF),
        "n_deep_rollbacks": icount(I_NDEEP),
        "time_verify": fs_all[F_TVERIFY].copy(),
        "n_replans": np.zeros(L, np.int64),     # no adaptive lanes here
        "final_period": fs_all[F_PERIOD].copy(),
        "final_threshold": no_est.copy(),
        "est_recall": no_est.copy(),
        "est_precision": no_est.copy(),
        "est_mu": no_est.copy(),
    }
