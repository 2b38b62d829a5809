"""The lane engine's loop body: plain torch and the CUDA lane-loop kernel.

One iteration of a lane is the JAX package's ``batch_jax.py::_body``: the
event pop (``_pop``), the in-window fault date and its deferred-fault push
(``_push``), the event arrivals (``_arrive``) and ``_ADV_PASSES``
schedule-advance steps (:mod:`.event_step`).  Lanes never interact, and the
body leaves a finished lane untouched, so a lane may be run to its own end
independently of the others: that gives the bits of the lockstep loop.

A chunk of lanes is stored as :class:`Lanes`, three row-major matrices
by type plus the draw table:

* ``f`` ``(LF_DEF + K, L)`` float64: the ``F_*`` rows of event_step's
  ``fs``, then the ``LF_*`` rows (pending prediction, trust parameter,
  lane window, the estimator state and constants of adaptive lanes), then
  the K deferred fault dates;
* ``i`` ``(LI_DEFSEQ + K, L)`` int32: the ``I_*`` rows of ``is_``, then
  the ``LI_*`` rows (pop state, overflow, trust kind, window mode, the
  seven event counters, the adaptive flags, replan count and resume
  point), then the K deferred faults' sequence numbers;
* ``q`` ``(N_LQ, L)`` int64: trace row, event count, pop cursor, draw
  cursor and the iterations the lane has run;
* ``tab`` ``(L, width)`` float64: the lane's pre-drawn uniforms.

``f[:N_F]`` and ``i[:N_I]`` are event_step's two state matrices as they
are.  Neighbouring lanes are neighbouring addresses of every row.  K, the
deferred-fault slots, is the chunk's own (:attr:`Lanes.slots`): the study
runs with ``_DEF_SLOTS`` = 8, held in registers by the kernel; a lane that
overflows them is rerun from its start with more slots (the engine's wide
route, slots kept in the chunk's rows).

Adaptive lanes (``Lanes.adaptive``) keep the online estimator's counters
at the pop, as ``batch_jax.py:308-346`` does, and after the pop's push run
the gate and hysteresis prefilter of ``maybe_replan``.  A lane whose
prefilter fires sets its resume row and stops for this call; the host
re-plans it (``core/batch_torch.py``), and the next call resumes it at its
event arrivals, where the reference applies the re-plan.

* :func:`lane_loop_ref` is the plain version: the eager lockstep loop,
  ``_body`` over the whole lane axis with a stop test every
  ``_STOP_EVERY`` iterations.  Its advance is the :func:`event_step`
  wrapper (the kernel on the card).
* :func:`lane_loop` is the wrapper: a CPU chunk goes to the plain
  version, a CUDA chunk to ``lane_loop_kernel`` in ``csrc/event_step.cu``
  (one thread per lane, the whole body in registers, the state written
  back once a launch), instantiated for the 8 register slots or the wide
  route and for static or adaptive lanes.  A CUDA call launches the
  kernel or raises.

Both update the chunk in place.  Each first completes the iteration of
every lane stopped for a re-plan (its arrivals and advance, not counted
again), then runs every lane until it finished, overflowed its
deferred-fault slots, stopped for a re-plan or ran ``cap`` iterations in
this call, adds the iterations it ran to the lane's ``LQ_ITERS``, and
returns a 0-dim int32 flag: ``FLAG_RUN`` (bit 0) while some lane can run
on (unfinished, not overflowed), ``FLAG_OVERFLOW`` (bit 1) once some lane
overflowed, ``FLAG_REPLAN`` (bit 2) while some lane awaits a re-plan.

Bitwise contract: every operation is an IEEE float64 add, subtract,
multiply, divide, compare or select done in the reference's order.  Eager
torch runs ``t + w*u`` as two kernels, so the product is rounded before
the add; nothing here may become a fused op (``addcmul``, ``lerp``) or run
under ``torch.compile``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..core.simulator import _CKPT, _DOWN, _PROCKPT, _RECOVER, _VERIFY, _WORK
from ..core.traces import FAULT_PRED, FAULT_UNPRED, SILENT
from ..predictors.estimator import P_HAT_MIN
from ._build import device_of, entry
from .event_step import (F_DONE, F_NOW, F_PERIOD, F_PHEND, F_PSTART,
                         F_SAVED, F_SVCLEAN, F_TARGET, F_TDOWN, F_TDOWNT,
                         F_TLOST, F_TRECOV, F_VCOST, F_WINEND, F_WINREM,
                         F_WWP, FLOPS_PER_LANE_PASS, I_CORR, I_FIN, I_KEEP,
                         I_NDEEP, I_NDIRTY, I_NROLL, I_NV, I_PHASE, N_F,
                         N_I, event_step)

__all__ = ["COUNTS", "FLAG_OVERFLOW", "FLAG_REPLAN", "FLAG_RUN",
           "FLOPS_PER_LANE_ITER", "LaneBank", "Lanes", "bytes_per_lane",
           "lane_loop", "lane_loop_ref"]

_TRUST_NEVER, _TRUST_ALWAYS, _TRUST_THRESHOLD, _TRUST_FIXED_Q = range(4)
_PC_POP, _PC_FAULT, _PC_PRED, _PC_FINAL, _PC_SILENT = range(5)
_DEF_SLOTS = 8          # the register route's deferred-fault slots
_BIG_SEQ = 2 ** 31 - 1  # int32 max: the sequence number of an empty slot
_ADV_PASSES = 4         # schedule steps per loop iteration (cf. numpy's 6)
# Iterations of the plain loop between stop tests.  The test reads a flag
# back to the host (a device sync), so it runs every _STOP_EVERY
# iterations, not every one; the body leaves stopped lanes untouched, so
# the extra iterations change no bit.
_STOP_EVERY = 16

# Event counters kept beside the schedule state, in row order.
COUNTS = ("n_faults", "n_faults_hit", "n_predictions", "n_trusted",
          "n_trusted_true", "n_ignored", "n_silent")

# Bits of the stop flag.
FLAG_RUN, FLAG_OVERFLOW, FLAG_REPLAN = 1, 2, 4

# Rows of `Lanes.f` after event_step's N_F rows: the pending prediction,
# the trust parameter and lane window; the estimator state of adaptive
# lanes (true, false and unpredicted counts; MTBF gap sum and count, last
# fault date; the recall, precision and MTBF last planned on) and their
# constants (decay, gate, tolerance); then the deferred fault dates.
(LF_PRED_T, LF_PRED_FD, LF_PRED_WIN, LF_TPARAM, LF_WINDOW,
 LF_NTP, LF_NFP, LF_NUF, LF_GS, LF_GN, LF_LASTF, LF_PR, LF_PP, LF_PMU,
 LF_DEC, LF_MINP, LF_MINF, LF_TOL, LF_DEF) = range(N_F, N_F + 19)
# Rows of `Lanes.i` after event_step's N_I rows, then the deferred faults'
# sequence numbers.  LI_RESUME is 1 while the lane, stopped after its pop
# for a re-plan, waits to resume at its event arrivals.
(LI_PC, LI_PRED_TRUE, LI_NEXT_SEQ, LI_OVERFLOW, LI_KIND,
 LI_WITHIN) = range(N_I, N_I + 6)
LI_COUNTS = LI_WITHIN + 1
(LI_ACT, LI_ESTMU, LI_NREPLANS,
 LI_RESUME) = range(LI_COUNTS + len(COUNTS), LI_COUNTS + len(COUNTS) + 4)
LI_DEFSEQ = LI_RESUME + 1
# Rows of `Lanes.q`.
LQ_TR, LQ_NEV, LQ_CURSOR, LQ_CUR, LQ_ITERS = range(5)
N_LQ = 5

# Rows a launch reads, by type, for static and for adaptive lanes.
_STATIC_ROWS = (LF_WINDOW + 1, LI_COUNTS + len(COUNTS))
_ADAPTIVE_ROWS = ((LF_NTP, LF_NFP, LF_NUF, LF_GS, LF_GN, LF_LASTF, LF_PR,
                   LF_PP, LF_PMU, LF_DEC, LF_MINP, LF_MINF, LF_TOL),
                  (LI_ACT, LI_ESTMU, LI_RESUME))
# Rows a launch only reads (the lane's constants).
_CONST_ROWS = ((8, (F_PERIOD, F_WWP, F_VCOST, LF_TPARAM, LF_WINDOW)),
               (4, (I_NV, I_KEEP, LI_KIND, LI_WITHIN)),
               (8, (LQ_TR, LQ_NEV)))
_ADAPTIVE_CONST_ROWS = ((8, (LF_PR, LF_PP, LF_PMU, LF_DEC, LF_MINP,
                             LF_MINF, LF_TOL)),
                        (4, (LI_ACT, LI_ESTMU)))


def bytes_per_lane(adaptive: bool = False) -> tuple[int, int]:
    """(constant bytes, state bytes) of one lane's rows that a register-
    route launch reads: the constants it only reads and the state it reads
    and writes back."""
    const = sum(size * len(rows) for size, rows in _CONST_ROWS)
    rows = 8 * (_STATIC_ROWS[0] + _DEF_SLOTS) \
        + 4 * (_STATIC_ROWS[1] + _DEF_SLOTS) + 8 * N_LQ
    if adaptive:
        const += sum(size * len(r) for size, r in _ADAPTIVE_CONST_ROWS)
        rows += 8 * len(_ADAPTIVE_ROWS[0]) + 4 * len(_ADAPTIVE_ROWS[1])
    return const, rows - const
# Float64 arithmetic of one iteration of one lane: its advances, and the
# pop's 7 minima and 5 adds, subtracts and multiplies and the arrivals' 11
# adds and subtracts and 1 maximum.  Compares and selects are not counted.
# An adaptive lane adds the estimator's 16 at the pop (the runtime zero,
# five decays with their zero adds, the gap and three increments) and the
# prefilter's 10 (two sums, three divides, one maximum, three differences
# and the tolerance's product).
FLOPS_PER_LANE_ITER = _ADV_PASSES * FLOPS_PER_LANE_PASS + 24
FLOPS_PER_ADAPTIVE_LANE_ITER = FLOPS_PER_LANE_ITER + 26

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class Lanes:
    """One chunk of lanes (rows as in the module docstring); ``adaptive``
    says whether its lanes run the estimator (some lane re-plans)."""

    f: torch.Tensor
    i: torch.Tensor
    q: torch.Tensor
    tab: torch.Tensor
    adaptive: bool = False

    @property
    def slots(self) -> int:
        """K, the chunk's deferred-fault slots."""
        return self.f.shape[0] - LF_DEF

    def clone(self) -> "Lanes":
        return self.to(self.f.device)

    def to(self, device) -> "Lanes":
        """A copy of the chunk on ``device``."""
        return Lanes(*(t.to(device, copy=True)
                       for t in (self.f, self.i, self.q, self.tab)),
                     adaptive=self.adaptive)


@dataclasses.dataclass(frozen=True)
class LaneBank:
    """The event bank and platform constants on the device."""

    times: torch.Tensor     # (n_traces, width) float64, +inf padded
    kinds: torch.Tensor     # (n_traces, width) int32, -1 padded
    wins: torch.Tensor      # (n_traces, width) float64, -1 = lane window
    zero: torch.Tensor      # 0-dim float64 zero, for the plain version
    c: float
    cp: float
    d: float
    r: float
    time_base: float

    def to(self, device) -> "LaneBank":
        """The bank on ``device``."""
        return dataclasses.replace(
            self, times=self.times.to(device), kinds=self.kinds.to(device),
            wins=self.wins.to(device), zero=self.zero.to(device))


# -- the plain version ---------------------------------------------------------

def _gather_row(tab: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``tab[lane, min(col, width - 1)]`` for every lane."""
    idx = torch.clamp_max(col, tab.shape[1] - 1)
    return tab.gather(1, idx[:, None])[:, 0]


def _put(row: torch.Tensor, mask: torch.Tensor, value: torch.Tensor
         ) -> None:
    """``row = where(mask, value, row)``, written into the row in place."""
    torch.where(mask, value, row, out=row)


def _push(s: dict, push: torch.Tensor, date: torch.Tensor, k: dict
          ) -> dict:
    """Deferred-fault insert into the first empty slot of pushing lanes."""
    empty = torch.isinf(s["def_time"])
    overflow = s["overflow"] | (push & ~empty.any(dim=1))
    slot = empty.to(torch.int32).argmax(dim=1)   # first empty slot
    onehot = (k["slots"][None, :] == slot[:, None]) & push[:, None]
    return dict(s,
                def_time=torch.where(onehot, date[:, None], s["def_time"]),
                def_seq=torch.where(onehot, s["next_seq"][:, None],
                                    s["def_seq"]),
                next_seq=torch.where(push, s["next_seq"] + 1,
                                     s["next_seq"]),
                overflow=overflow)


def _observe(s: dict, k: dict, zero: torch.Tensor, f_t: torch.Tensor,
             is_fault: torch.Tensor, take_def: torch.Tensor,
             uf: torch.Tensor, is_pred: torch.Tensor,
             is_true: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """The estimator's counters at the pop (``batch_jax.py:308-346``);
    returns the state and the lanes that reached a re-plan site.

    Decay-then-increment rounds each product before its add: eager torch
    runs ``x * dec + zero`` as two kernels, as the reference's runtime
    zero guard forces."""
    act, dec = k["act"], k["dec"]
    # Every actual fault is an MTBF observation for estimate_mu lanes.
    mu_site = act & k["estmu"] & is_fault
    obs = mu_site & (s["lastf"] > -_INF)
    gs_d = s["gs"] * dec + zero
    gn_d = s["gn"] * dec + zero
    gs = torch.where(obs, gs_d + (f_t - s["lastf"]), s["gs"])
    gn = torch.where(obs, gn_d + 1.0, s["gn"])
    lastf = torch.where(mu_site, f_t, s["lastf"])
    # (r, p) counters: unpredicted faults and announced predictions
    # age-then-increment.
    upd_uf = uf & act
    upd_p = is_pred & act
    upd = upd_uf | upd_p
    ntp = torch.where(upd, s["ntp"] * dec + zero, s["ntp"])
    nfp = torch.where(upd, s["nfp"] * dec + zero, s["nfp"])
    nuf = torch.where(upd, s["nuf"] * dec + zero, s["nuf"])
    nuf = torch.where(upd_uf, nuf + 1.0, nuf)
    ntp = torch.where(upd_p & is_true, ntp + 1.0, ntp)
    nfp = torch.where(upd_p & ~is_true, nfp + 1.0, nfp)
    # Re-plan sites: every counter-updating pop, and deferred strikes that
    # moved mu-hat.
    site = act & (is_pred | uf | (take_def & obs))
    return dict(s, ntp=ntp, nfp=nfp, nuf=nuf, gs=gs, gn=gn,
                lastf=lastf), site


def _prefilter(s: dict, k: dict, site: torch.Tensor) -> torch.Tensor:
    """Lanes whose re-plan fires: the gate and hysteresis of
    ``maybe_replan`` with its float operations (``batch_jax.py:401-416``)."""
    ntp, nfp, nuf = s["ntp"], s["nfp"], s["nuf"]
    npred, nflt = ntp + nfp, ntp + nuf
    gate = (npred >= k["minp"]) & (nflt >= k["minf"])
    one = torch.ones_like(ntp)
    r_hat = ntp / torch.where(gate, nflt, one)
    p_hat = torch.maximum(ntp / torch.where(gate, npred, one),
                          torch.full_like(ntp, P_HAT_MIN))
    has_mu = k["estmu"] & (s["gn"] > 0.0)
    mu_hat = s["gs"] / torch.where(s["gn"] > 0.0, s["gn"], one)
    moved = ((r_hat - k["pr"]).abs() > k["tol"]) \
        | ((p_hat - k["pp"]).abs() > k["tol"]) \
        | (has_mu & ((mu_hat - k["pmu"]).abs() > k["tol"] * k["pmu"]))
    return site & gate & moved


def _pop(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict,
         g: LaneBank) -> tuple[dict, dict]:
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
    clear = (k["slots"][None, :] == slot[:, None]) & take_def[:, None]
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
    site = None
    if k["adaptive"]:
        s, site = _observe(s, k, now - now, f_t, is_fault, take_def, uf,
                           is_pred, is_true)

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
           "honour": honour, "push": ignored & is_true, "site": site}
    return out, tmp


def _arrive(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict,
            g: LaneBank) -> dict:
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
    s = _push(s, arr_p & s["pred_true"], s["pred_fd"], k)
    pc = torch.where(arr_p, _PC_POP, pc)
    target.masked_fill_(arr_p, -_INF)

    return dict(s, pc=pc, cur=cur, n_faults_hit=n_faults_hit,
                n_silent=n_silent, n_trusted=n_trusted,
                n_trusted_true=n_trusted_true, n_ignored=n_ignored)


def _advance(fs: torch.Tensor, is_: torch.Tensor, g: LaneBank
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """`_ADV_PASSES` schedule steps in one event_step call."""
    return event_step(fs, is_, c=g.c, cp=g.cp, d=g.d, r=g.r,
                      time_base=g.time_base, passes=_ADV_PASSES)


def _body(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict,
          g: LaneBank) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """One iteration of every lane (``batch_jax.py::_body``).  An adaptive
    lane whose re-plan fires stops after the pop's push: it sets its resume
    row and its arrivals and advance wait for the next call."""
    s, tmp = _pop(fs, is_, s, k, g)
    # In-window fault date t + w*u: eager torch rounds the product in its
    # own kernel before the add, as numpy's `t + uniform(0, w)` does; the
    # runtime zero is the JAX engine's contraction guard, kept so the
    # operation sequence is the reference's.
    zero = fs[F_NOW] - fs[F_NOW]
    off = tmp["w_eff"] * tmp["u"] + zero
    fd = torch.where(tmp["draw"], tmp["t_tr"] + off, tmp["t_tr"])
    s = dict(s, pred_fd=torch.where(tmp["honour"], fd, s["pred_fd"]))
    s = _push(s, tmp["push"], fd, k)
    fire = None
    if k["adaptive"]:
        # An overflowed lane is rerun from its start: it does not stop.
        fire = _prefilter(s, k, tmp["site"]) & ~s["overflow"]
        s = dict(s, resume=s["resume"] | fire)
        is_[I_FIN].masked_fill_(fire, 1)         # held past the arrivals
    s = _arrive(fs, is_, s, k, g)
    fs, is_ = _advance(fs, is_, g)
    if fire is not None:
        is_[I_FIN].masked_fill_(fire, 0)
    return fs, is_, s


def _resume(fs: torch.Tensor, is_: torch.Tensor, s: dict, k: dict,
            g: LaneBank) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The second half (arrivals, advance) of the iteration of every lane
    stopped for a re-plan; the other lanes are held."""
    res = s["resume"]
    if not bool(res.any()):
        return fs, is_, s
    fin = is_[I_FIN].clone()
    is_[I_FIN].masked_fill_(~res, 1)
    s = _arrive(fs, is_, s, k, g)
    fs, is_ = _advance(fs, is_, g)
    is_[I_FIN] = torch.where(res, is_[I_FIN], fin)
    return fs, is_, dict(s, resume=torch.zeros_like(res))


_ESTIMATOR = (("ntp", LF_NTP), ("nfp", LF_NFP), ("nuf", LF_NUF),
              ("gs", LF_GS), ("gn", LF_GN), ("lastf", LF_LASTF))


def _unpack(lanes: Lanes) -> tuple[dict, dict]:
    """The body's state and lane-constant dicts, as views of ``lanes``."""
    f, i, q = lanes.f, lanes.i, lanes.q
    K = lanes.slots
    s = {"pc": i[LI_PC], "cursor": q[LQ_CURSOR], "cur": q[LQ_CUR],
         "pred_t": f[LF_PRED_T], "pred_fd": f[LF_PRED_FD],
         "pred_true": i[LI_PRED_TRUE] != 0, "pred_win": f[LF_PRED_WIN],
         "def_time": f[LF_DEF:].T, "def_seq": i[LI_DEFSEQ:].T,
         "next_seq": i[LI_NEXT_SEQ], "overflow": i[LI_OVERFLOW] != 0,
         "resume": i[LI_RESUME] != 0,
         **{key: i[LI_COUNTS + n] for n, key in enumerate(COUNTS)}}
    k = {"tr": q[LQ_TR], "n_ev": q[LQ_NEV], "kind": i[LI_KIND],
         "tparam": f[LF_TPARAM], "window": f[LF_WINDOW],
         "within": i[LI_WITHIN] != 0, "tab": lanes.tab,
         "slots": torch.arange(K, device=f.device),
         "adaptive": lanes.adaptive}
    if lanes.adaptive:
        s.update({key: f[row] for key, row in _ESTIMATOR})
        k.update(act=i[LI_ACT] != 0, estmu=i[LI_ESTMU] != 0, dec=f[LF_DEC],
                 minp=f[LF_MINP], minf=f[LF_MINF], tol=f[LF_TOL],
                 pr=f[LF_PR], pp=f[LF_PP], pmu=f[LF_PMU])
    return s, k


def _pack(lanes: Lanes, fs: torch.Tensor, is_: torch.Tensor, s: dict
          ) -> None:
    """Write the body's final state back into ``lanes``."""
    f, i, q = lanes.f, lanes.i, lanes.q
    f[:N_F] = fs
    i[:N_I] = is_
    f[LF_PRED_T], f[LF_PRED_FD], f[LF_PRED_WIN] = (
        s["pred_t"], s["pred_fd"], s["pred_win"])
    f[LF_DEF:] = s["def_time"].T
    i[LI_DEFSEQ:] = s["def_seq"].T
    i[LI_PC], i[LI_PRED_TRUE] = s["pc"], s["pred_true"]
    i[LI_NEXT_SEQ], i[LI_OVERFLOW] = s["next_seq"], s["overflow"]
    i[LI_RESUME] = s["resume"]
    for n, key in enumerate(COUNTS):
        i[LI_COUNTS + n] = s[key]
    if lanes.adaptive:
        for key, row in _ESTIMATOR:
            f[row] = s[key]
    q[LQ_CURSOR], q[LQ_CUR] = s["cursor"], s["cur"]


def _flag(is_: torch.Tensor, s: dict) -> torch.Tensor:
    """The stop flag: FLAG_RUN, FLAG_OVERFLOW and FLAG_REPLAN."""
    run = (is_[I_FIN] == 0) & ~s["overflow"]
    return (run.any().to(torch.int32) * FLAG_RUN
            | s["overflow"].any().to(torch.int32) * FLAG_OVERFLOW
            | s["resume"].any().to(torch.int32) * FLAG_REPLAN)


def lane_loop_ref(lanes: Lanes, g: LaneBank, *, cap: int) -> torch.Tensor:
    """The plain version (any device): the eager lockstep loop.

    First the lanes stopped for a re-plan complete their iteration
    (``_resume``).  Then every iteration runs ``_body`` over all lanes.  A
    lane that has overflowed, or stopped for a re-plan, but not finished is
    held: its ``I_FIN`` reads 1 for the body, which then leaves it
    untouched, so each lane runs exactly the iterations that the kernel
    runs it.  The loop ends after ``cap`` iterations or at the first stop
    test that finds no lane running.
    """
    fs, is_ = lanes.f[:N_F].clone(), lanes.i[:N_I].clone()
    s, k = _unpack(lanes)
    iters = lanes.q[LQ_ITERS]
    if lanes.adaptive:
        fs, is_, s = _resume(fs, is_, s, k, g)
    done = 0
    while done < cap and bool(((is_[I_FIN] == 0) & ~s["overflow"]
                               & ~s["resume"]).any()):
        n = min(_STOP_EVERY, cap - done)
        for _ in range(n):
            unfinished = is_[I_FIN] == 0
            held = unfinished & (s["overflow"] | s["resume"])
            iters.add_(unfinished & ~held)
            is_[I_FIN].masked_fill_(held, 1)
            fs, is_, s = _body(fs, is_, s, k, g)
            is_[I_FIN].masked_fill_(held, 0)
        done += n
    _pack(lanes, fs, is_, s)
    return _flag(is_, s)


# -- the kernel ----------------------------------------------------------------

def _check(lanes: Lanes, g: LaneBank) -> str:
    """The one device of a call's tensors; raises on what the kernel does
    not take."""
    L = lanes.f.shape[1]
    K = lanes.slots
    if K < 1:
        raise ValueError(f"lane_loop takes at least one deferred-fault "
                         f"slot, got {K}")
    want = ((lanes.f, torch.float64, (LF_DEF + K, L)),
            (lanes.i, torch.int32, (LI_DEFSEQ + K, L)),
            (lanes.q, torch.int64, (N_LQ, L)),
            (lanes.tab, torch.float64, (L, lanes.tab.shape[1])),
            (g.times, torch.float64, tuple(g.times.shape)),
            (g.kinds, torch.int32, tuple(g.times.shape)),
            (g.wins, torch.float64, tuple(g.times.shape)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape or t.dim() != 2:
            raise ValueError(f"lane_loop takes {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("lane_loop takes contiguous tensors")
    if lanes.tab.shape[1] < 1 or g.times.shape[1] < 1:
        raise ValueError("lane_loop takes a draw table and a bank of width "
                         ">= 1")
    return device_of("lane_loop", *(t for t, _, _ in want))


# C signature of csrc/event_step.cu's lane_loop_launch: pointers and the
# stream as c_void_p, sizes as c_longlong, so ctypes never cuts them to
# 32 bits.
_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_longlong]
                    + [ctypes.c_int] * 3
                    + [ctypes.c_double] * 5 + [ctypes.c_void_p] * 2)


def lane_loop(lanes: Lanes, g: LaneBank, *, cap: int) -> torch.Tensor:
    """Run every lane of the chunk up to ``cap`` iterations, in place;
    returns the stop flag (module docstring).

    CPU tensors take the plain version.  CUDA tensors take the kernel, one
    launch per call: its register route for ``_DEF_SLOTS`` slots and its
    wide route (slots in the chunk's rows) for any other count, each for
    static or adaptive lanes; a failed build or launch raises.  Each kernel
    launch adds one to ``lane_loop.launches``.
    """
    dev = _check(lanes, g)
    if not 1 <= cap < 2 ** 31:
        raise ValueError(f"cap must be in [1, 2**31), got {cap}")
    if dev == "cpu":
        return lane_loop_ref(lanes, g, cap=cap)
    launch = entry("event_step", "lane_loop_launch", _LAUNCH_ARGTYPES)
    flag = torch.zeros((), dtype=torch.int32, device=lanes.f.device)
    with torch.cuda.device(lanes.f.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(lanes.f.data_ptr(), lanes.i.data_ptr(),
                     lanes.q.data_ptr(), lanes.tab.data_ptr(),
                     lanes.tab.shape[1], g.times.data_ptr(),
                     g.kinds.data_ptr(), g.wins.data_ptr(),
                     g.times.shape[1], lanes.f.shape[1], cap, lanes.slots,
                     int(lanes.adaptive), g.c, g.cp, g.d, g.r, g.time_base,
                     flag.data_ptr(), stream)
    lane_loop.launches += 1
    if err != 0:
        raise RuntimeError(f"lane_loop kernel launch failed: CUDA error "
                           f"{err}")
    return flag


lane_loop.launches = 0
