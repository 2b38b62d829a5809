"""Torch backend of the lane-parallel batched simulator.

The counterpart of the JAX package's ``core/batch_jax.py::run_lanes_jax``:
every lane runs the numpy engine's loop body (event pop, deferred-fault
push, event arrivals, ``_ADV_PASSES`` lockstep-schedule steps) until it
finished.  The body and the chunk's state layout are in
:mod:`repro_torch.kernels.lane_loop`; this module builds a chunk's state
(:class:`~repro_torch.kernels.lane_loop.Lanes`), drives it and reads the
results back.

The host loop (``_run_shards``) calls :func:`lane_loop` with at most
``_LAUNCH_CAP`` iterations a call and reads back one stop flag after
each call, until no lane can run on: on the card each call is one launch
of the lane-loop kernel, which keeps a lane's whole state in registers for
all its iterations; on the CPU each call runs the plain eager loop.

Adaptive lanes keep the online estimator's counters inside the loop; a
lane whose gate and hysteresis prefilter fires stops after its pop, and
the host re-plans it through :func:`repro_torch.predictors.maybe_replan`
(``_replan``, one round trip for all the lanes stopped in a call, each in
lane order, as ``batch_jax.py::_host_replan`` does) before the next call
resumes it at its event arrivals.

A chunk runs with ``_DEF_SLOTS`` deferred-fault slots (the kernel's
register route).  The lanes that overflow them are rerun from their
initial state with 16 slots, then 32, and so on until none overflows (the
wide route, its slots in the chunk's rows), and their results replace
the overflowed ones: the pop takes the earliest (date, sequence) wherever
a slot sits, so the bits are those of the numpy engine's growing slots.

Lane randomness (FixedProbability trust draws, in-window fault offsets) is
pre-drawn per lane on the host with numpy (``_draw_tables``), exactly as
the JAX engine does, and consumed at the scalar engine's draw sites.

A chunk can be split over a list of devices (``device=[...]``, the
counterpart of the JAX engine's ``shard_map`` over ``jax.devices()`` under
``REPRO_JAX_SHARD``; :func:`repro_torch.device.resolve_devices`): it is
cut into contiguous shards of ``ceil(n / len(devices))`` lanes, in lane
order, each with its own chunk state on its device, and the bank is
uploaded once per distinct device.  The reference pads a chunk to a
multiple of its shard count because ``shard_map`` needs equal shards;
here results are per lane, so no padded lane runs (a short chunk leaves
the last shards empty, and they run nothing).  In each round the host
loop calls :func:`lane_loop` on every live shard before it reads any
flag, so shards on different cards run together; shards on one card
queue on its stream.  Lanes do not interact, so the bits do not depend
on the split.  Adaptive grids are never split: the reference keeps them
off its ``shard_map`` path (their re-plans are a host callback inside
the loop), and here they run unsplit on the list's first device, counted
as one shard.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_devices
from ..kernels.event_step import (F_NOW, F_PERIOD, F_PHEND, F_TARGET,
                                  F_TCKPT, F_TDOWN, F_TDOWNT, F_TLOST,
                                  F_TPROC, F_TRECOV, F_TVERIFY, F_VCOST,
                                  F_VREM, F_VWP, F_WINEND, F_WINREM,
                                  F_WPP, F_WREM, F_WWP, I_KEEP, I_NCKPT,
                                  I_NDEEP, I_NPROC, I_NROLL, I_NV, I_NVERIF,
                                  I_PHASE, event_step)
from ..kernels.lane_loop import (_BIG_SEQ, _DEF_SLOTS, _PC_POP,
                                 _TRUST_FIXED_Q, _TRUST_NEVER,
                                 _TRUST_THRESHOLD, COUNTS, FLAG_REPLAN,
                                 FLAG_RUN, LF_DEC, LF_DEF, LF_GN, LF_GS,
                                 LF_LASTF, LF_MINF, LF_MINP, LF_NFP, LF_NTP,
                                 LF_NUF, LF_PMU, LF_PP, LF_PR, LF_TOL,
                                 LF_TPARAM, LF_WINDOW, LI_ACT, LI_COUNTS,
                                 LI_DEFSEQ, LI_ESTMU, LI_KIND, LI_NEXT_SEQ,
                                 LI_NREPLANS, LI_OVERFLOW, LI_PC, LI_RESUME,
                                 LI_WITHIN, LQ_ITERS, LQ_NEV, LQ_TR, N_LQ,
                                 LaneBank, Lanes, lane_loop)
from ..obs.metrics import get_registry
from ..predictors.estimator import maybe_replan
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


def _replan(lanes: Lanes, cfgs: Sequence, platform: Platform,
            cp: float) -> int:
    """Re-plan every lane stopped for it (``LI_RESUME``), in lane order, as
    ``batch_jax.py::_host_replan`` does, and write the new plans into the
    chunk; returns the number of lanes re-planned."""
    f, i = lanes.f, lanes.i
    fire = torch.nonzero(i[LI_RESUME] != 0).flatten()
    rows = (LF_NTP, LF_NFP, LF_NUF, LF_GS, LF_GN, LF_PR, LF_PP, LF_PMU,
            F_PERIOD, LF_TPARAM)
    ntp, nfp, nuf, gs, gn, pr, pp, pmu, period, tparam = (
        f[list(rows)][:, fire].cpu().numpy())
    n_replans = i[LI_NREPLANS][fire].cpu().numpy()
    done = 0
    for j, lane in enumerate(fire.cpu().numpy()):
        cfg = cfgs[lane]
        mu_hat = None
        if cfg.estimate_mu and gn[j] > 0.0:
            mu_hat = float(gs[j]) / float(gn[j])
        plan = maybe_replan(cfg, platform, cp, float(ntp[j]), float(nfp[j]),
                            float(nuf[j]), float(pr[j]), float(pp[j]),
                            mu_hat=mu_hat, planned_mu=float(pmu[j]))
        if plan is None:     # the prefilter is maybe_replan's own test
            continue
        pr[j], pp[j], period[j], tparam[j] = plan
        if mu_hat is not None:
            pmu[j] = mu_hat
        n_replans[j] += 1
        done += 1
    new = torch.from_numpy(np.stack([pr, pp, pmu, period, tparam]))
    for row, values in zip((LF_PR, LF_PP, LF_PMU, F_PERIOD, LF_TPARAM),
                           new.to(f.device)):
        f[row, fire] = values
    i[LI_NREPLANS, fire] = torch.from_numpy(n_replans).to(i.device)
    return done


def _cat(rows: list[np.ndarray]) -> np.ndarray:
    """Shards' rows side by side, in lane order."""
    return rows[0] if len(rows) == 1 else np.concatenate(rows, axis=1)


def _run_shards(loop, shards: Sequence[tuple], cap: int) -> int:
    """The host loop over a chunk's shards, each ``(lanes, bank,
    replan)``: rounds of calls of ``loop`` (:func:`lane_loop` or its plain
    version) of at most ``cap`` iterations, one call on every live shard
    before any stop flag is read back, until no lane of any shard can run
    on.  When a shard's lanes stopped for a re-plan, ``replan(lanes)``
    re-plans them before its next call.  Returns the number of calls."""
    reg = get_registry()
    calls = 0
    live = list(shards)
    while live:
        flags = [loop(lanes, g, cap=cap) for lanes, g, _ in live]
        calls += len(live)
        still = []
        for shard, flag in zip(live, flags):
            flag = int(flag)
            if flag & FLAG_REPLAN:
                t0 = time.perf_counter()
                reg.count("engine.replans", shard[2](shard[0]))
                reg.count("torch.replan_rounds")
                reg.add_time("torch.replan_s", time.perf_counter() - t0)
            elif not flag & FLAG_RUN:
                continue
            still.append(shard)
        live = still
    return calls


def _run_chunk(loop, lanes: Lanes, g: LaneBank, cap: int,
               replan=None) -> int:
    """The host loop of one unsplit chunk: :func:`_run_shards` over it
    alone."""
    return _run_shards(loop, [(lanes, g, replan)], cap)


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
    (``None``: all).  ``device`` is where the lanes run: ``None`` is CUDA,
    split over every visible card when there are more than one (the
    reference's ``REPRO_JAX_SHARD=auto``); one device runs each chunk
    unsplit (``=0``); a list or tuple, even of one device and with
    repeats, splits each chunk over its entries (``=1``; module
    docstring).  An adaptive grid runs unsplit on the first device.
    """
    devs = resolve_devices(device)
    if np.any(lane_period < platform.c):
        raise ValueError(f"period below checkpoint {platform.c}")

    L = int(lane_trace.size)
    c, d, r = platform.c, platform.d, platform.r
    lane_period = np.asarray(lane_period, dtype=np.float64)
    lane_kind = np.asarray(lane_kind, dtype=np.int32).copy()
    lane_param = np.asarray(lane_param, dtype=np.float64).copy()
    lane_window = np.asarray(lane_window, dtype=np.float64)
    if lane_wmode is None:
        lane_wmode = np.zeros(L, dtype=np.int8)
    if lane_wperiod is None:
        lane_wperiod = np.zeros(L, dtype=np.float64)
    if lane_adaptive is None:
        lane_adaptive = [None] * L
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

    # Adaptive lanes (the JAX engine's setup, batch_jax.py:192-229): the
    # plan is lane state, and Never-trust adaptive lanes become
    # Threshold(+inf) so that a re-plan only moves the parameter.
    ad_act = np.array([a is not None for a in lane_adaptive], dtype=bool)
    has_adaptive = bool(ad_act.any())
    ad_estmu = np.array([bool(a is not None and a.estimate_mu)
                         for a in lane_adaptive], dtype=bool)
    if has_adaptive:
        if np.any(ad_act & ~np.isin(lane_kind, (_TRUST_NEVER,
                                                _TRUST_THRESHOLD))):
            raise ValueError(
                "adaptive re-planning requires a Threshold or Never trust "
                "policy (the plan sets the threshold)")
        never = ad_act & (lane_kind == _TRUST_NEVER)
        lane_kind[never] = _TRUST_THRESHOLD
        lane_param[never] = np.inf

        def per_lane(attr: str, idle: float) -> np.ndarray:
            return np.array([idle if a is None else float(getattr(a, attr))
                             for a in lane_adaptive], dtype=np.float64)

        ad_rows = {LF_DEC: per_lane("decay", 1.0),
                   LF_MINP: per_lane("min_preds", np.inf),
                   LF_MINF: per_lane("min_faults", np.inf),
                   LF_TOL: per_lane("tol", 0.0),
                   LF_PR: per_lane("prior_recall", 0.0),
                   LF_PP: per_lane("prior_precision", 0.0)}

    if has_adaptive:
        devs = devs[:1]

    reg = get_registry()
    t0 = time.perf_counter()
    tab = _draw_tables(bank, lane_trace, lane_kind, lane_window, lane_seed)
    reg.add_time("torch.tables_s", time.perf_counter() - t0)
    n_ev = bank.n_events[lane_trace]

    def up(a: np.ndarray, dev: torch.device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t0 = time.perf_counter()
    wins = (bank.windows if bank.windows is not None
            else np.full_like(bank.times, -1.0))
    banks = {dev: LaneBank(times=up(bank.times, dev),
                           kinds=up(bank.kinds.astype(np.int32), dev),
                           wins=up(wins, dev),
                           zero=torch.zeros((), dtype=torch.float64,
                                            device=dev),
                           c=c, cp=cp, d=d, r=r, time_base=time_base)
             for dev in dict.fromkeys(devs)}
    reg.add_time("torch.upload_s", time.perf_counter() - t0)
    CL = L if (chunk is None or chunk <= 0) else min(int(chunk), L)
    CL = max(CL, 1)

    def split(idx: np.ndarray) -> list[np.ndarray]:
        """Lanes ``idx`` cut into contiguous shards of ``ceil(n / len(
        devs))`` lanes, in lane order; no shard is empty."""
        size = -(-idx.size // len(devs))
        return [idx[lo:lo + size] for lo in range(0, idx.size, size)]

    def init_chunk(idx: np.ndarray, slots: int, dev: torch.device) -> Lanes:
        """The state at the start of lanes ``idx`` on ``dev`` with
        ``slots`` deferred-fault slots (rows not set here start at 0)."""
        n = idx.size
        period = lane_period[idx]
        wpp0 = period - c
        nv = lane_nverify[idx]
        vwp0 = np.where(nv >= 1, wpp0 / np.maximum(nv, 1), np.inf)
        f = np.zeros((LF_DEF + slots, n), np.float64)
        f[F_PHEND] = np.inf
        f[F_WPP] = wpp0
        f[F_WREM] = np.minimum(wpp0, time_base)
        f[F_WINEND] = -np.inf
        f[F_WINREM] = np.inf
        f[F_TARGET] = -np.inf
        f[F_PERIOD] = period
        f[F_WWP] = lane_wwp[idx]
        f[F_VWP] = vwp0
        f[F_VREM] = vwp0
        f[F_VCOST] = lane_vcost[idx]
        f[LF_TPARAM] = lane_param[idx]
        f[LF_WINDOW] = lane_window[idx]
        f[LF_LASTF] = -np.inf
        f[LF_PMU] = platform.mu
        if has_adaptive:
            for row, values in ad_rows.items():
                f[row] = values[idx]
        f[LF_DEF:] = np.inf
        i = np.zeros((LI_DEFSEQ + slots, n), np.int32)
        i[I_PHASE] = _WORK
        i[I_NV] = nv
        i[I_KEEP] = lane_keep[idx]
        i[LI_PC] = _PC_POP
        i[LI_NEXT_SEQ] = n_ev[idx]
        i[LI_KIND] = lane_kind[idx]
        i[LI_WITHIN] = within[idx]
        i[LI_ACT] = ad_act[idx]
        i[LI_ESTMU] = ad_estmu[idx]
        i[LI_DEFSEQ:] = _BIG_SEQ
        q = np.zeros((N_LQ, n), np.int64)
        q[LQ_TR] = lane_trace[idx]
        q[LQ_NEV] = n_ev[idx]
        return Lanes(up(f, dev), up(i, dev), up(q, dev), up(tab[idx], dev),
                     adaptive=bool(ad_act[idx].any()))

    def replanner(idx: np.ndarray):
        cfgs = [lane_adaptive[j] for j in idx]
        return lambda ln: _replan(ln, cfgs, platform, cp)

    def run(idx: np.ndarray, slots: int) -> tuple[np.ndarray, ...]:
        """Run lanes ``idx`` to their end, split over ``devs``; their f, i,
        q rows read back in lane order."""
        t0 = time.perf_counter()
        shards = [(init_chunk(part, slots, dev), banks[dev], replanner(part))
                  for part, dev in zip(split(idx), devs)]
        t1 = time.perf_counter()
        if len(shards) == 1:     # the unsplit loop, which tests wrap
            calls = _run_chunk(lane_loop, *shards[0][:2], _LAUNCH_CAP,
                               shards[0][2])
        else:
            calls = _run_shards(lane_loop, shards, _LAUNCH_CAP)
        t2 = time.perf_counter()
        out = tuple(_cat([getattr(lanes, part).cpu().numpy()
                          for lanes, _, _ in shards])
                    for part in ("f", "i", "q"))
        reg.add_time("torch.upload_s", t1 - t0)
        reg.add_time("torch.run_s", t2 - t1)
        reg.add_time("torch.readback_s", time.perf_counter() - t2)
        reg.count("torch.loop_calls", calls)
        return out

    # Each lane's rows before its slots, at its end.
    keep_f = np.zeros((LF_DEF, L), np.float64)
    keep_i = np.zeros((LI_DEFSEQ, L), np.int32)
    launches0 = lane_loop.launches, event_step.launches
    wall0 = time.perf_counter()
    for lo in range(0, L, CL):
        idx = np.arange(lo, min(lo + CL, L))
        f, i, q = run(idx, _DEF_SLOTS)
        reg.count("torch.chunks")
        reg.count("torch.shards", len(split(idx)))
        reg.count("torch.iterations", int(q[LQ_ITERS].max()))
        keep_f[:, idx], keep_i[:, idx] = f[:LF_DEF], i[:LI_DEFSEQ]
        over = idx[i[LI_OVERFLOW] != 0]
        if over.size:
            reg.count("engine.deferred_overflows")
        slots = _DEF_SLOTS
        while over.size:
            # The overflowed lanes again from their start, twice the slots.
            slots *= 2
            f, i, _ = run(over, slots)
            keep_f[:, over], keep_i[:, over] = f[:LF_DEF], i[:LI_DEFSEQ]
            over = over[i[LI_OVERFLOW] != 0]
    wall = time.perf_counter() - wall0
    reg.count("kernels.lane_loop.launches", lane_loop.launches - launches0[0])
    reg.count("kernels.event_step.launches",
              event_step.launches - launches0[1])
    if wall > 0.0:
        reg.gauge("torch.lanes_per_s", L / wall)

    def icount(row: int) -> np.ndarray:
        return keep_i[row].astype(np.int64)

    def frow(row: int) -> np.ndarray:
        return keep_f[row].copy()

    # Final-plan and estimator diagnostics (batch_jax.py:754-793).
    ntp, nfp, nuf, gs, gn = (keep_f[row] for row in (LF_NTP, LF_NFP,
                                                       LF_NUF, LF_GS, LF_GN))
    est = {key: np.full(L, -1.0) for key in ("recall", "precision", "mu")}
    denom_f, denom_p = ntp + nuf, ntp + nfp
    np.divide(ntp, denom_f, out=est["recall"], where=ad_act & (denom_f > 0))
    np.divide(ntp, denom_p, out=est["precision"],
              where=ad_act & (denom_p > 0))
    np.divide(gs, gn, out=est["mu"], where=ad_estmu & (gn > 0))
    return {
        "makespan": frow(F_NOW),
        **{key: icount(LI_COUNTS + n) for n, key in enumerate(COUNTS)
           if key != "n_silent"},
        "n_periodic_ckpts": icount(I_NCKPT),
        "n_proactive_ckpts": icount(I_NPROC),
        "n_rollbacks": icount(I_NROLL),
        "time_ckpt": frow(F_TCKPT),
        "time_prockpt": frow(F_TPROC),
        "time_down": frow(F_TDOWN),
        "time_lost": frow(F_TLOST),
        "time_downtime": frow(F_TDOWNT),
        "time_recovery": frow(F_TRECOV),
        "n_silent": icount(LI_COUNTS + COUNTS.index("n_silent")),
        "n_verifications": icount(I_NVERIF),
        "n_deep_rollbacks": icount(I_NDEEP),
        "time_verify": frow(F_TVERIFY),
        "n_replans": icount(LI_NREPLANS),
        "final_period": frow(F_PERIOD),
        "final_threshold": np.where(ad_act, keep_f[LF_TPARAM], -1.0),
        "est_recall": est["recall"],
        "est_precision": est["precision"],
        "est_mu": est["mu"],
    }
