"""Torch backend of the lane-parallel batched simulator.

The counterpart of the JAX package's ``core/batch_jax.py::run_lanes_jax``:
the lane fleet advances in a loop whose body is the same pop / arrival /
lockstep-schedule step as the numpy engine, written out over the lane axis
as plain torch operations on float64 / int tensors:

  * the **event pop** (``_pop``) and **event arrival** (``_arrive``)
    sections, the JAX package's vmapped per-lane steps with the lane axis
    written out, plus the deferred-fault slot pushes (``_push``);
  * the **event-advance step** (:mod:`repro_torch.kernels.event_step`),
    applied ``_ADV_PASSES`` times per iteration in one call: the
    hand-written CUDA kernel on the card, its plain version on the CPU.

The schedule state lives for the whole loop in the kernel's two state
matrices, ``fs`` ``(N_F, lanes)`` float64 and ``is_`` ``(N_I, lanes)``
int32 (rows ``F_*`` / ``I_*``): the pop and the arrivals write their rows
in place, and each ``event_step`` call returns the next pair.  The rest of
a lane (pop cursor, pending prediction, deferred-fault slots, event
counters) is a dict of per-lane tensors.

Lane randomness (FixedProbability trust draws, in-window fault offsets) is
pre-drawn per lane on the host with numpy (``_draw_tables``), exactly as
the JAX engine does, and consumed at the scalar engine's draw sites.

Bitwise contract: every operation is an IEEE float64 add, subtract,
multiply, divide, compare or select done in the reference's order.  Eager
torch runs ``t + w*u`` as two kernels, so the product is rounded before
the add; nothing here may become a fused op (``addcmul``, ``lerp``) or run
under ``torch.compile``.

Adaptive lanes (the host re-planning round trip) and multi-card sharding
are not part of this engine yet: adaptive lanes raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.event_step import (F_DONE, F_NOW, F_PERIOD, F_PHEND,
                                  F_PSTART, F_SAVED, F_SVCLEAN, F_TARGET,
                                  F_TCKPT, F_TDOWN, F_TDOWNT, F_TLOST,
                                  F_TPROC, F_TRECOV, F_TVERIFY, F_VCOST,
                                  F_VREM, F_VWP, F_WINEND, F_WINREM,
                                  F_WPP, F_WREM, F_WWP, I_CORR, I_FIN,
                                  I_KEEP, I_NCKPT, I_NDEEP, I_NDIRTY,
                                  I_NPROC, I_NROLL, I_NV, I_NVERIF,
                                  I_PHASE, N_F, N_I, event_step)
from ..obs.metrics import get_registry
from .simulator import _CKPT, _DOWN, _PROCKPT, _RECOVER, _VERIFY, _WORK
from .traces import FALSE_PRED, FAULT_PRED, FAULT_UNPRED, SILENT
from .waste import Platform

__all__ = ["run_lanes_torch"]

_TRUST_NEVER, _TRUST_ALWAYS, _TRUST_THRESHOLD, _TRUST_FIXED_Q = range(4)
_WMODE_INSTANT, _WMODE_WITHIN = range(2)
_PC_POP, _PC_FAULT, _PC_PRED, _PC_FINAL, _PC_SILENT = range(5)
_DEF_SLOTS = 8          # deferred-fault capacity; overflow is detected
_BIG_SEQ = np.iinfo(np.int32).max
_ADV_PASSES = 4         # schedule steps per loop iteration (cf. numpy's 6)
# Iterations between stop tests.  The test reads two flags back to the
# host (a device sync), so it runs every _STOP_EVERY iterations, not every
# one; the body leaves finished lanes untouched, so the extra iterations
# change no bit.
_STOP_EVERY = 16

_INF = math.inf


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


@dataclasses.dataclass(frozen=True)
class _Bank:
    """The event bank and platform constants on the device."""

    times: torch.Tensor     # (n_traces, width) float64, +inf padded
    kinds: torch.Tensor     # (n_traces, width) int32, -1 padded
    wins: torch.Tensor      # (n_traces, width) float64, -1 = lane window
    slots: torch.Tensor     # arange(_DEF_SLOTS)
    zero: torch.Tensor      # 0-dim float64 zero
    c: float
    cp: float
    d: float
    r: float
    time_base: float


def _gather_row(tab: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``tab[lane, min(col, width - 1)]`` for every lane."""
    idx = torch.clamp_max(col, tab.shape[1] - 1)
    return tab.gather(1, idx[:, None])[:, 0]


def _put(row: torch.Tensor, mask: torch.Tensor, value: torch.Tensor
         ) -> None:
    """``row = where(mask, value, row)``, written into the row in place."""
    torch.where(mask, value, row, out=row)


def _push(s: dict, push: torch.Tensor, date: torch.Tensor, g: _Bank
          ) -> dict:
    """Deferred-fault insert into the first empty slot of pushing lanes."""
    empty = torch.isinf(s["def_time"])
    overflow = s["overflow"] | (push & ~empty.any(dim=1))
    slot = empty.to(torch.int32).argmax(dim=1)   # first empty slot
    onehot = (g.slots[None, :] == slot[:, None]) & push[:, None]
    return dict(s,
                def_time=torch.where(onehot, date[:, None], s["def_time"]),
                def_seq=torch.where(onehot, s["next_seq"][:, None],
                                    s["def_seq"]),
                next_seq=torch.where(push, s["next_seq"] + 1,
                                     s["next_seq"]),
                overflow=overflow)


def _pop(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict, g: _Bank
         ) -> tuple[dict, dict]:
    """Event pop (``batch_jax.py::_pop_one`` over the lane axis).  Writes
    the target row of ``fs`` in place."""
    now, target = fs[F_NOW], fs[F_TARGET]
    pop = (is_[I_FIN] == 0) & (s["pc"] == _PC_POP)
    width = g.times.shape[1]
    col = torch.clamp_max(s["cursor"], width - 1)
    have = s["cursor"] < k["n_ev"]
    t_tr = torch.where(have, g.times[k["tr"], col], _INF)
    k_tr = torch.where(have, g.kinds[k["tr"], col], -1)
    w_ev = torch.where(have, g.wins[k["tr"], col], -1.0)
    min_t = s["def_time"].amin(dim=1)
    tie = s["def_time"] == min_t[:, None]
    seqm = torch.where(tie, s["def_seq"], _BIG_SEQ)
    slot = seqm.argmin(dim=1)        # first minimum: (date, seq) order

    none_left = pop & torch.isinf(t_tr) & torch.isinf(min_t)
    pc = torch.where(none_left, _PC_FINAL, s["pc"])
    target.masked_fill_(none_left, _INF)

    take_trace = pop & ~none_left & (t_tr <= min_t)
    cursor = s["cursor"] + take_trace
    take_def = pop & ~none_left & ~take_trace
    clear = (g.slots[None, :] == slot[:, None]) & take_def[:, None]
    def_time = torch.where(clear, _INF, s["def_time"])
    def_seq = torch.where(clear, _BIG_SEQ, s["def_seq"])

    # Deferred pops were already counted at announcement; only trace
    # faults count here (mirrors the scalar engine's counting).
    uf = take_trace & (k_tr == FAULT_UNPRED)
    is_fault = take_def | uf
    n_faults = s["n_faults"] + uf
    f_t = torch.where(take_def, min_t, t_tr)
    _put(target, is_fault, f_t)
    pc = torch.where(is_fault, _PC_FAULT, pc)

    # Silent-error strikes route to their own arrival state.
    is_sil = take_trace & (k_tr == SILENT)
    _put(target, is_sil, t_tr)
    pc = torch.where(is_sil, _PC_SILENT, pc)

    is_pred = take_trace & (k_tr != FAULT_UNPRED) & (k_tr != SILENT)
    n_predictions = s["n_predictions"] + is_pred
    is_true = is_pred & (k_tr == FAULT_PRED)
    n_faults = n_faults + is_true      # counted at announcement

    # Prediction announced for date t: draw the in-window fault offset
    # (per-event window, falling back to the lane window) from the
    # pre-drawn stream and decide honourability.  The fault date itself
    # is computed in `_body`.
    w_eff = torch.where(w_ev < 0.0, k["window"], w_ev)
    draw_win = is_true & (w_eff > 0.0)
    u = _gather_row(k["tab"], s["cur"])
    cur = s["cur"] + draw_win
    ckpt_start = t_tr - g.cp
    honour = is_pred & (ckpt_start >= now)
    pc = torch.where(honour, _PC_PRED, pc)
    _put(target, honour, ckpt_start)
    ignored = is_pred & ~honour
    out = dict(s, pc=pc, cursor=cursor, def_time=def_time,
               def_seq=def_seq, n_faults=n_faults,
               n_predictions=n_predictions,
               pred_t=torch.where(honour, t_tr, s["pred_t"]),
               pred_true=torch.where(honour, is_true, s["pred_true"]),
               pred_win=torch.where(honour, w_eff, s["pred_win"]),
               cur=cur, n_ignored=s["n_ignored"] + ignored)
    tmp = {"t_tr": t_tr, "w_eff": w_eff, "u": u, "draw": draw_win,
           "honour": honour, "push": ignored & is_true}
    return out, tmp


def _arrive(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict,
            g: _Bank) -> dict:
    """Event arrivals (``batch_jax.py::_arrive_one`` over the lane axis).
    Writes the rows of ``fs`` and ``is_`` it changes in place."""
    active = is_[I_FIN] == 0
    now, target = fs[F_NOW], fs[F_TARGET]
    phase, phase_end = is_[I_PHASE], fs[F_PHEND]
    done, saved, saved_clean = fs[F_DONE], fs[F_SAVED], fs[F_SVCLEAN]
    win_end, win_rem = fs[F_WINEND], fs[F_WINREM]
    n_dirty, corrupted = is_[I_NDIRTY], is_[I_CORR]

    # Fault arrival.  A lane whose retained ring holds dirty snapshots
    # rolls back past them to the newest clean state (deep rollback).
    arr_f = active & (s["pc"] == _PC_FAULT) & (now >= target)
    deep = n_dirty > 0
    base = torch.where(deep, saved_clean, saved)
    lost = done - base
    in_phase = (phase != _WORK) & ~torch.isinf(phase_end)
    dur = torch.where(
        phase == _CKPT, g.c, torch.where(
            phase == _PROCKPT, g.cp, torch.where(
                phase == _DOWN, g.d, torch.where(
                    phase == _RECOVER, g.r, torch.where(
                        phase == _VERIFY, fs[F_VCOST], g.zero)))))
    elapsed = dur - (phase_end - now)
    pos = torch.maximum(g.zero, elapsed)
    ckpt_like = in_phase & ((phase == _CKPT) | (phase == _PROCKPT)
                            | (phase == _VERIFY))
    lost = lost + torch.where(ckpt_like, pos, 0.0)
    fs[F_TDOWN].add_(torch.where(arr_f & in_phase & ~ckpt_like, pos, 0.0))
    fs[F_TDOWNT].add_(torch.where(arr_f & in_phase & (phase == _DOWN),
                                  pos, 0.0))
    fs[F_TRECOV].add_(torch.where(arr_f & in_phase & (phase == _RECOVER),
                                  pos, 0.0))
    fs[F_TLOST].add_(torch.where(arr_f, lost, 0.0))
    n_faults_hit = s["n_faults_hit"] + arr_f
    is_[I_NROLL].add_(arr_f & (lost > 0.0))
    is_[I_NDEEP].add_(arr_f & deep)
    _put(saved, arr_f & deep, saved_clean)
    n_dirty.masked_fill_(arr_f, 0)
    corrupted.masked_fill_(arr_f, 0)
    _put(done, arr_f, saved)
    _put(phase_end, arr_f, target + g.d)
    phase.masked_fill_(arr_f, _DOWN)
    # A fault ends any active prediction window.
    win_end.masked_fill_(arr_f, -_INF)
    win_rem.masked_fill_(arr_f, _INF)
    pc = torch.where(arr_f, _PC_POP, s["pc"])
    target.masked_fill_(arr_f, -_INF)

    # Silent-error strike: flip the latent-corruption flag if the lane is
    # computing or saving (strikes during downtime/recovery hit no
    # application state, as in the scalar engine).
    arr_s = active & (pc == _PC_SILENT) & (now >= target)
    hit = arr_s & ((phase == _WORK) | (phase == _CKPT)
                   | (phase == _PROCKPT) | (phase == _VERIFY))
    n_silent = s["n_silent"] + hit
    corrupted.masked_fill_(hit, 1)
    pc = torch.where(arr_s, _PC_POP, pc)
    target.masked_fill_(arr_s, -_INF)

    # Prediction arrival: the trust decision at the checkpoint-start date.
    # FixedProbability lanes draw only when the decision is reached
    # (phase == WORK), so the cursor advances exactly there.
    arr_p = active & (pc == _PC_PRED) & (now >= target)
    working = arr_p & (phase == _WORK)
    offset = s["pred_t"] - fs[F_PSTART]
    draw_q = working & (k["kind"] == _TRUST_FIXED_Q)
    u2 = _gather_row(k["tab"], s["cur"])
    cur = s["cur"] + draw_q
    trusted = working & ((k["kind"] == _TRUST_ALWAYS)
                         | ((k["kind"] == _TRUST_THRESHOLD)
                            & (offset >= k["tparam"]))
                         | (draw_q & (u2 < k["tparam"])))
    phase.masked_fill_(trusted, _PROCKPT)
    _put(phase_end, trusted, s["pred_t"])
    n_trusted = s["n_trusted"] + trusted
    n_trusted_true = s["n_trusted_true"] + (trusted & s["pred_true"])
    # Arm the prediction window on trusting "within" lanes.
    arm = trusted & k["within"] & (s["pred_win"] > 0.0)
    _put(win_end, arm, s["pred_t"] + s["pred_win"])
    n_ignored = s["n_ignored"] + (arr_p & ~working)
    s = _push(s, arr_p & s["pred_true"], s["pred_fd"], g)
    pc = torch.where(arr_p, _PC_POP, pc)
    target.masked_fill_(arr_p, -_INF)

    return dict(s, pc=pc, cur=cur, n_faults_hit=n_faults_hit,
                n_silent=n_silent, n_trusted=n_trusted,
                n_trusted_true=n_trusted_true, n_ignored=n_ignored)


def _body(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict, g: _Bank
          ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    s, tmp = _pop(fs, is_, s, k, g)
    # In-window fault date t + w*u: eager torch rounds the product in its
    # own kernel before the add, as numpy's `t + uniform(0, w)` does; the
    # runtime zero is the JAX engine's contraction guard, kept so the
    # operation sequence is the reference's.
    zero = fs[F_NOW] - fs[F_NOW]
    off = tmp["w_eff"] * tmp["u"] + zero
    fd = torch.where(tmp["draw"], tmp["t_tr"] + off, tmp["t_tr"])
    s = dict(s, pred_fd=torch.where(tmp["honour"], fd, s["pred_fd"]))
    s = _push(s, tmp["push"], fd, g)
    s = _arrive(fs, is_, s, k, g)
    # `_ADV_PASSES` schedule steps in one event_step call.
    fs, is_ = event_step(fs, is_, c=g.c, cp=g.cp, d=g.d, r=g.r,
                         time_base=g.time_base, passes=_ADV_PASSES)
    return fs, is_, s


def _run_chunk(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict,
               g: _Bank) -> tuple[torch.Tensor, torch.Tensor, dict, int]:
    """The lockstep loop: until every lane finished or one overflowed.
    Returns the final state and the number of iterations run."""
    iters = 0
    while not bool((is_[I_FIN] != 0).all() | s["overflow"].any()):
        for _ in range(_STOP_EVERY):
            fs, is_, s = _body(fs, is_, s, k, g)
        iters += _STOP_EVERY
    return fs, is_, s, iters


# Counters the pop and arrival keep outside the kernel's state matrices.
_S_COUNTS = ("n_faults", "n_faults_hit", "n_predictions", "n_trusted",
             "n_trusted_true", "n_ignored", "n_silent")


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

    tab = _draw_tables(bank, lane_trace, lane_kind, lane_window, lane_seed)
    n_ev = bank.n_events[lane_trace]

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    g = _Bank(times=up(bank.times),
              kinds=up(bank.kinds.astype(np.int32)),
              wins=up(bank.windows if bank.windows is not None
                      else np.full_like(bank.times, -1.0)),
              slots=torch.arange(_DEF_SLOTS, device=dev),
              zero=torch.zeros((), dtype=torch.float64, device=dev),
              c=c, cp=cp, d=d, r=r, time_base=time_base)
    CL = L if (chunk is None or chunk <= 0) else min(int(chunk), L)
    CL = max(CL, 1)

    def init_chunk(sl: slice) -> tuple[torch.Tensor, torch.Tensor, dict,
                                       dict]:
        """The kernel's state matrices (every other row starts at 0), the
        pop/arrival state and the lane constants of one chunk."""
        f8, i4, i8 = np.float64, np.int32, np.int64
        n = sl.stop - sl.start
        period = lane_period[sl]
        wpp0 = period - c
        nv = lane_nverify[sl]
        vwp0 = np.where(nv >= 1, wpp0 / np.maximum(nv, 1), np.inf)
        fs = np.zeros((N_F, n), f8)
        fs[F_PHEND] = np.inf
        fs[F_WPP] = wpp0
        fs[F_WREM] = np.minimum(wpp0, time_base)
        fs[F_WINEND] = -np.inf
        fs[F_WINREM] = np.inf
        fs[F_TARGET] = -np.inf
        fs[F_PERIOD] = period
        fs[F_WWP] = lane_wwp[sl]
        fs[F_VWP] = vwp0
        fs[F_VREM] = vwp0
        fs[F_VCOST] = lane_vcost[sl]
        is_ = np.zeros((N_I, n), i4)
        is_[I_PHASE] = _WORK
        is_[I_NV] = nv
        is_[I_KEEP] = lane_keep[sl]
        state = {
            "pc": np.full(n, _PC_POP, i4),
            "cursor": np.zeros(n, i8), "cur": np.zeros(n, i8),
            "pred_t": np.zeros(n, f8), "pred_fd": np.zeros(n, f8),
            "pred_true": np.zeros(n, bool), "pred_win": np.zeros(n, f8),
            "def_time": np.full((n, _DEF_SLOTS), np.inf, f8),
            "def_seq": np.full((n, _DEF_SLOTS), _BIG_SEQ, i4),
            "next_seq": n_ev[sl].astype(i4),
            "overflow": np.zeros(n, bool),
            **{key: np.zeros(n, i4) for key in _S_COUNTS},
        }
        kc = {
            "tr": lane_trace[sl].astype(i8), "n_ev": n_ev[sl].astype(i8),
            "kind": lane_kind[sl], "tparam": lane_param[sl],
            "window": lane_window[sl], "within": within[sl],
            "tab": tab[sl],
        }
        return (up(fs), up(is_), {key: up(v) for key, v in state.items()},
                {key: up(v) for key, v in kc.items()})

    fs_all = np.zeros((N_F, L), np.float64)
    is_all = np.zeros((N_I, L), np.int32)
    counts = {key: np.zeros(L, np.int64) for key in _S_COUNTS}
    reg = get_registry()
    launches0 = event_step.launches
    wall0 = time.perf_counter()
    for lo in range(0, L, CL):
        sl = slice(lo, min(lo + CL, L))
        fs, is_, s, kc = init_chunk(sl)
        t0 = time.perf_counter()
        fs, is_, s, iters = _run_chunk(fs, is_, s, kc, g)
        overflow = bool(s["overflow"].any())
        fs_all[:, sl] = fs.cpu().numpy()
        is_all[:, sl] = is_.cpu().numpy()
        for key in _S_COUNTS:
            counts[key][sl] = s[key].cpu().numpy()
        reg.add_time("torch.run_s", time.perf_counter() - t0)
        reg.count("torch.chunks")
        reg.count("torch.iterations", iters)
        if overflow:
            reg.count("engine.deferred_overflows")
            raise RuntimeError(
                f"deferred-fault capacity ({_DEF_SLOTS} slots) exceeded in "
                f"the torch backend; rerun with the JAX package's "
                f"backend='numpy'")
    wall = time.perf_counter() - wall0
    reg.count("kernels.event_step.launches", event_step.launches - launches0)
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
