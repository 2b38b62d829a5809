"""The event-advance step of the lane engine: plain torch and the CUDA kernel.

One call moves every lane of :mod:`repro_torch.core.batch_torch` up to
``passes`` schedule steps toward its event target: work chunks stop at the
target, the in-period verification cadence and the window end; completed
phases (ckpt, proactive ckpt, verify, down, recover) run their transitions,
then the retained-checkpoint ring update, the end-of-job acceptance check
and the late-detection rollback.  Finished lanes and lanes with
``now >= target`` are left untouched, so padding columns are inert.

The state is stacked into two dense matrices, ``fs`` ``(N_F, lanes)``
float64 and ``is_`` ``(N_I, lanes)`` int32, rows indexed by the ``F_*`` /
``I_*`` constants (the same layout as the JAX package's kernel).

* :func:`event_step_ref` is the plain version, expression for expression
  the JAX package's ``_advance_math``.  Every operation is an IEEE float64
  add, subtract, divide, compare or select, so it is bitwise the numpy
  engine's advance section.
* :func:`event_step` is the wrapper: a CPU tensor goes to the plain
  version, a CUDA tensor to the hand-written kernel in
  ``csrc/event_step.cu`` (built on first use by :mod:`._build`).  A CUDA
  call launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

__all__ = ["BYTES_PER_LANE", "FLOPS_PER_LANE_PASS", "F_FIELDS",
           "I_FIELDS", "N_F", "N_I", "event_step", "event_step_ref",
           "random_state"]

# Phase codes (repro_torch.core.simulator's constants, frozen here so the
# kernel module has no engine import).
_WORK, _CKPT, _PROCKPT, _DOWN, _RECOVER, _VERIFY = range(6)

F_FIELDS = ("now", "done", "saved", "period_start", "phase_end", "wpp",
            "w_rem", "win_end", "win_rem", "target", "time_ckpt",
            "time_prockpt", "time_down", "period", "lane_wwp",
            "time_downtime", "time_recovery", "time_lost", "time_verify",
            "v_wp", "v_rem", "vcost", "saved_clean")
(F_NOW, F_DONE, F_SAVED, F_PSTART, F_PHEND, F_WPP, F_WREM, F_WINEND,
 F_WINREM, F_TARGET, F_TCKPT, F_TPROC, F_TDOWN, F_PERIOD, F_WWP,
 F_TDOWNT, F_TRECOV, F_TLOST, F_TVERIFY, F_VWP, F_VREM, F_VCOST,
 F_SVCLEAN) = range(23)
N_F = len(F_FIELDS)

I_FIELDS = ("phase", "finished", "n_periodic_ckpts", "n_proactive_ckpts",
            "n_rollbacks", "n_verifications", "n_deep_rollbacks",
            "n_dirty", "corrupted", "verify_then_ckpt", "n_verify",
            "keep_ckpts")
(I_PHASE, I_FIN, I_NCKPT, I_NPROC, I_NROLL, I_NVERIF, I_NDEEP, I_NDIRTY,
 I_CORR, I_VTC, I_NV, I_KEEP) = range(12)
N_I = len(I_FIELDS)

# Bytes one launch must move per lane: every row read once, written once.
BYTES_PER_LANE = 2 * (N_F * 8 + N_I * 4)
# Float64 arithmetic one pass does per lane, whatever the lane's phase (the
# step is branch-free): 25 adds/subtracts, 1 divide, 6 min/max.  Compares
# and selects are not counted.
FLOPS_PER_LANE_PASS = 32


def _advance_math(fs, is_, *, c: float, cp: float, d: float, r: float,
                  time_base: float):
    """One schedule step over stacked lane state (JAX ``_advance_math``).

    Scalars enter the selects as 0-dim float64 tensors: a select between
    two Python floats would come back in torch's default float32.
    """
    f64 = fs.dtype
    zero = fs.new_zeros(())
    cs, cps, ds, rs = (torch.tensor(v, dtype=f64, device=fs.device)
                       for v in (c, cp, d, r))
    inf = math.inf
    fin_thresh = time_base - 1e-9
    now = fs[F_NOW]
    target = fs[F_TARGET]
    phase = is_[I_PHASE]
    finished = is_[I_FIN] != 0
    phase_end = fs[F_PHEND]
    win_end = fs[F_WINEND]
    win_rem = fs[F_WINREM]
    vcost = fs[F_VCOST]
    v_wp = fs[F_VWP]
    v_rem = fs[F_VREM]
    saved_clean = fs[F_SVCLEAN]
    nv = is_[I_NV]
    keep = is_[I_KEEP]
    verify_on = nv >= 1
    corrupted = is_[I_CORR] != 0
    vtc = is_[I_VTC] != 0
    n_dirty = is_[I_NDIRTY]

    adv = ~finished & (now < target)
    in_work = adv & (phase == _WORK)
    wz = in_work & (fs[F_WREM] <= 0.0)       # degenerate: straight to save
    wz_v = wz & verify_on
    phase = torch.where(wz_v, _VERIFY, torch.where(wz, _CKPT, phase))
    phase_end = torch.where(wz, now + torch.where(verify_on, vcost, cs),
                            phase_end)
    vtc = torch.where(wz_v, True, vtc)

    ww = in_work & ~wz
    in_win = ww & (now < win_end)
    dt = torch.minimum(fs[F_WREM], target - now)
    dt = torch.minimum(dt, v_rem)
    cap = torch.where(in_win, torch.minimum(win_rem, win_end - now), inf)
    dt = torch.minimum(dt, cap)
    now = torch.where(ww, now + dt, now)
    done = torch.where(ww, fs[F_DONE] + dt, fs[F_DONE])
    w_rem = torch.where(ww, fs[F_WREM] - dt, fs[F_WREM])
    v_rem = torch.where(ww, v_rem - dt, v_rem)
    win_rem = torch.where(in_win, win_rem - dt, win_rem)
    fin_work = ww & (w_rem <= 0.0)
    fw_v = fin_work & verify_on
    phase = torch.where(fw_v, _VERIFY, torch.where(fin_work, _CKPT, phase))
    phase_end = torch.where(fin_work,
                            now + torch.where(verify_on, vcost, cs),
                            phase_end)
    vtc = torch.where(fw_v, True, vtc)
    # Intermediate verification due before the period's work is done.
    vdue = ww & (w_rem > 0.0) & (v_rem <= 0.0)
    phase = torch.where(vdue, _VERIFY, phase)
    phase_end = torch.where(vdue, now + vcost, phase_end)
    vtc = torch.where(vdue, False, vtc)
    live = ww & (w_rem > 0.0) & (v_rem > 0.0) & in_win
    # In-window proactive checkpoint due.
    pro = live & (win_rem <= 0.0) & (now < win_end)
    phase = torch.where(pro, _PROCKPT, phase)
    phase_end = torch.where(pro, now + cp, phase_end)
    # Window elapsed without a fault: back to the periodic schedule.
    closed = live & (now >= win_end)
    win_end = torch.where(closed, -inf, win_end)
    win_rem = torch.where(closed, inf, win_rem)

    in_ph = adv & (phase != _WORK) & ~wz & ~ww   # just-started ckpts wait
    complete = in_ph & (phase_end <= target)
    now = torch.where(complete, phase_end, now)
    ph0 = phase
    ck = complete & (ph0 == _CKPT)
    n_ckpts = is_[I_NCKPT] + ck
    time_ckpt = fs[F_TCKPT] + torch.where(ck, cs, zero)
    saved = torch.where(ck, done, fs[F_SAVED])

    pk = complete & (ph0 == _PROCKPT)
    n_prockpts = is_[I_NPROC] + pk
    time_prockpt = fs[F_TPROC] + torch.where(pk, cps, zero)
    saved = torch.where(pk, done, saved)

    # Retained-checkpoint ring update (periodic + proactive saves): a
    # corrupted save is dirty; once the ring holds only dirty snapshots
    # the newest clean state is the job start.
    sv = ck | pk
    dirty_save = sv & corrupted
    n_dirty = n_dirty + dirty_save
    saved_clean = torch.where(dirty_save & (n_dirty >= keep), zero,
                              saved_clean)
    clean_save = sv & ~corrupted
    saved_clean = torch.where(clean_save, done, saved_clean)
    n_dirty = torch.where(clean_save, 0, n_dirty)

    # Final-checkpoint acceptance check: a corrupted lane at the end of
    # the job detects instead of finishing.
    at_end = ck & (saved >= fin_thresh)
    det_ck = at_end & corrupted
    fin = at_end & ~corrupted
    finished = finished | fin
    act = ck & (now < win_end)
    win_rem = torch.where(act, fs[F_WWP], win_rem)

    period_start = torch.where(pk, now, fs[F_PSTART])
    phase = torch.where(pk, _WORK, phase)
    phase_end = torch.where(pk, inf, phase_end)
    v_rem = torch.where(pk, v_wp, v_rem)
    act = pk & (now < win_end)
    win_rem = torch.where(act, fs[F_WWP], win_rem)

    vf = complete & (ph0 == _VERIFY)
    time_verify = fs[F_TVERIFY] + torch.where(vf, vcost, zero)
    n_verifs = is_[I_NVERIF] + vf
    det_vf = vf & corrupted
    ok = vf & ~corrupted
    v_rem = torch.where(ok, v_wp, v_rem)
    tc = ok & vtc
    phase = torch.where(tc, _CKPT, phase)
    phase_end = torch.where(tc, now + c, phase_end)
    wk = ok & ~vtc
    phase = torch.where(wk, _WORK, phase)
    phase_end = torch.where(wk, inf, phase_end)

    dn = complete & (ph0 == _DOWN)
    time_down = fs[F_TDOWN] + torch.where(dn, ds, zero)
    time_downtime = fs[F_TDOWNT] + torch.where(dn, ds, zero)
    phase = torch.where(dn, _RECOVER, phase)
    phase_end = torch.where(dn, now + r, phase_end)
    rc = complete & (ph0 == _RECOVER)
    time_down = time_down + torch.where(rc, rs, zero)
    time_recovery = fs[F_TRECOV] + torch.where(rc, rs, zero)

    renew = (ck & ~at_end) | rc
    phase = torch.where(renew, _WORK, phase)
    phase_end = torch.where(renew, inf, phase_end)
    period_start = torch.where(renew, now, period_start)
    wpp = torch.where(renew,
                      torch.maximum(torch.full_like(now, 1e-9),
                                    fs[F_PERIOD] - c),
                      fs[F_WPP])
    w_rem = torch.where(renew, torch.minimum(wpp, time_base - saved), w_rem)
    v_wp = torch.where(renew & verify_on,
                       wpp / torch.clamp_min(nv, 1).to(f64), v_wp)
    v_rem = torch.where(renew, v_wp, v_rem)

    # Late detection (verify completion, or the final acceptance check,
    # while corrupted): roll back past every dirty snapshot to the newest
    # clean one, paying R only.
    det = det_ck | det_vf
    lost = done - saved_clean
    time_lost = fs[F_TLOST] + torch.where(det, lost, zero)
    n_rolls = is_[I_NROLL] + (det & (lost > 0.0))
    n_deep = is_[I_NDEEP] + (det & (n_dirty > 0))
    done = torch.where(det, saved_clean, done)
    saved = torch.where(det, saved_clean, saved)
    n_dirty = torch.where(det, 0, n_dirty)
    corrupted = corrupted & ~det
    phase = torch.where(det, _RECOVER, phase)
    phase_end = torch.where(det, now + r, phase_end)
    win_end = torch.where(det, -inf, win_end)
    win_rem = torch.where(det, inf, win_rem)

    stall = in_ph & ~complete
    now = torch.where(stall, target, now)

    fs_out = torch.stack([now, done, saved, period_start, phase_end, wpp,
                          w_rem, win_end, win_rem, target, time_ckpt,
                          time_prockpt, time_down, fs[F_PERIOD], fs[F_WWP],
                          time_downtime, time_recovery, time_lost,
                          time_verify, v_wp, v_rem, vcost, saved_clean])
    i32 = torch.int32
    is_out = torch.stack([phase.to(i32), finished.to(i32), n_ckpts.to(i32),
                          n_prockpts.to(i32), n_rolls.to(i32),
                          n_verifs.to(i32), n_deep.to(i32),
                          n_dirty.to(i32), corrupted.to(i32), vtc.to(i32),
                          nv, keep])
    return fs_out, is_out


def event_step_ref(fs: torch.Tensor, is_: torch.Tensor, *, c: float,
                   cp: float, d: float, r: float, time_base: float,
                   passes: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch event step, ``passes`` times (any device)."""
    for _ in range(passes):
        fs, is_ = _advance_math(fs, is_, c=c, cp=cp, d=d, r=r,
                                time_base=time_base)
    return fs, is_


def _check(fs: torch.Tensor, is_: torch.Tensor) -> None:
    if fs.dtype != torch.float64 or is_.dtype != torch.int32:
        raise TypeError(f"event_step takes float64 fs and int32 is_, got "
                        f"{fs.dtype} and {is_.dtype}")
    if fs.dim() != 2 or is_.dim() != 2 or fs.shape[0] != N_F \
            or is_.shape[0] != N_I or fs.shape[1] != is_.shape[1]:
        raise ValueError(f"event_step takes ({N_F}, L) and ({N_I}, L) "
                         f"state, got {tuple(fs.shape)} and "
                         f"{tuple(is_.shape)}")
    if fs.device != is_.device:
        raise ValueError(f"fs on {fs.device}, is_ on {is_.device}")


# C signature of csrc/event_step.cu's entry point: pointers and the stream
# as c_void_p and the lane count as c_longlong, so ctypes never cuts them
# to 32 bits.
_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
                    + [ctypes.c_double] * 5 + [ctypes.c_void_p])


def _launcher():
    """The kernel's C entry point, built and loaded on first use."""
    from ._build import load

    fn = load("event_step").event_step_launch
    fn.argtypes, fn.restype = _LAUNCH_ARGTYPES, ctypes.c_int
    return fn


def event_step(fs: torch.Tensor, is_: torch.Tensor, *, c: float, cp: float,
               d: float, r: float, time_base: float, passes: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``passes`` event-advance steps; returns new ``(fs, is_)`` tensors.

    CPU tensors take the plain version.  CUDA tensors take the kernel,
    which runs all ``passes`` in registers in one launch (bitwise the same
    as ``passes`` single steps); a failed build or launch raises.  Each
    kernel launch adds one to ``event_step.launches``.
    """
    _check(fs, is_)
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    if fs.device.type == "cpu":
        return event_step_ref(fs, is_, c=c, cp=cp, d=d, r=r,
                              time_base=time_base, passes=passes)
    if fs.device.type != "cuda":
        raise ValueError(f"event_step runs on cpu or cuda, not {fs.device}")
    launch = _launcher()
    fs = fs.contiguous()
    is_ = is_.contiguous()
    fs_out = torch.empty_like(fs)
    is_out = torch.empty_like(is_)
    n = fs.shape[1]
    if n == 0:
        return fs_out, is_out
    with torch.cuda.device(fs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            fs.data_ptr(), is_.data_ptr(), fs_out.data_ptr(),
            is_out.data_ptr(), n, passes, c, cp, d, r, time_base, stream)
    event_step.launches += 1
    if err != 0:
        raise RuntimeError(f"event_step kernel launch failed: CUDA error "
                           f"{err}")
    return fs_out, is_out


event_step.launches = 0


def random_state(n: int, seed: int, *, time_base: float = 4000.0
                 ) -> tuple[np.ndarray, np.ndarray]:
    """A random full ``(fs, is_)`` state for holding implementations equal.

    Drawn with numpy from ``default_rng(seed)`` so any framework can take
    the same bits.  It covers every phase, verification on and off, open
    and closed windows, the +-inf sentinels, finished lanes, lanes past
    their target, zero-work periods, dirty rings and corrupted lanes, and
    ``done`` straddling ``time_base`` so the acceptance check fires.
    """
    g = np.random.default_rng(seed)
    fs = np.zeros((N_F, n), dtype=np.float64)
    is_ = np.zeros((N_I, n), dtype=np.int32)
    now = g.uniform(0.0, 5000.0, n)
    phase = g.integers(0, 6, n)
    nv = g.choice([0, 0, 1, 2, 3], n)
    fs[F_NOW] = now
    fs[F_DONE] = g.uniform(0.0, 1.2 * time_base, n)
    fs[F_SAVED] = fs[F_DONE] - g.uniform(0.0, 800.0, n)
    fs[F_PSTART] = now - g.uniform(0.0, 2000.0, n)
    fs[F_PHEND] = np.where(phase == _WORK, np.inf,
                           now + g.uniform(0.0, 400.0, n))
    fs[F_PERIOD] = g.uniform(60.0, 3000.0, n)
    fs[F_WPP] = fs[F_PERIOD] - 60.0
    fs[F_WREM] = np.where(g.random(n) < 0.1, 0.0,
                          g.uniform(-50.0, 2500.0, n))
    open_win = g.random(n) < 0.5
    fs[F_WINEND] = np.where(open_win, now + g.uniform(-200.0, 1500.0, n),
                            -np.inf)
    fs[F_WINREM] = np.where(open_win, g.uniform(-20.0, 400.0, n), np.inf)
    fs[F_TARGET] = np.where(g.random(n) < 0.15, np.inf,
                            now + g.uniform(-500.0, 3000.0, n))
    for row in (F_TCKPT, F_TPROC, F_TDOWN, F_TDOWNT, F_TRECOV, F_TLOST,
                F_TVERIFY):
        fs[row] = g.uniform(0.0, 1e4, n)
    fs[F_WWP] = np.where(g.random(n) < 0.5, g.uniform(10.0, 500.0, n),
                         np.inf)
    fs[F_VWP] = np.where(nv >= 1, fs[F_WPP] / np.maximum(nv, 1), np.inf)
    fs[F_VREM] = np.where(nv >= 1, g.uniform(-30.0, 1500.0, n), np.inf)
    fs[F_VCOST] = np.where(nv >= 1, g.uniform(0.0, 200.0, n), 0.0)
    fs[F_SVCLEAN] = fs[F_SAVED] - g.uniform(0.0, 500.0, n)
    is_[I_PHASE] = phase
    is_[I_FIN] = g.random(n) < 0.1
    for row in (I_NCKPT, I_NPROC, I_NROLL, I_NVERIF, I_NDEEP):
        is_[row] = g.integers(0, 50, n)
    is_[I_NDIRTY] = g.integers(0, 4, n)
    is_[I_CORR] = g.random(n) < 0.4
    is_[I_VTC] = g.random(n) < 0.5
    is_[I_NV] = nv
    is_[I_KEEP] = g.integers(1, 4, n)
    return fs, is_
