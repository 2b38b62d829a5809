// The lane engine's kernels, hand-written for Hopper (sm_90a).
//
// event_step_kernel: one event-advance step.  Replaces the Pallas TPU
// kernel src/repro/kernels/event_step.py::event_step_pallas (body
// _event_kernel -> _advance_math, event_step.py:75-255).  Its plain version
// is repro_torch/kernels/event_step.py::event_step_ref.
//
// lane_loop_kernel: the whole loop of the lane engine.  Replaces the
// reference's compiled loop, src/repro/core/batch_jax.py:584-605 (a
// lax.while_loop over _pop_one, _push_all, _arrive_one and four calls of
// event_step_pallas, event_step.py:275, which XLA fuses on the TPU).  Its
// plain version is repro_torch/kernels/lane_loop.py::lane_loop_ref, the
// eager lockstep loop; every expression below mirrors that module's _pop,
// _observe, _push, _prefilter, _arrive and _body statement for statement,
// and both kernels call the same advance() (event_step_ref's
// _advance_math).  Four instantiations: the deferred-fault slots in
// registers (8, the study's route) or in the chunk's rows (any K, the wide
// route that reruns the lanes that overflowed 8), each for static lanes or
// for adaptive lanes, which keep the online estimator's counters at the pop
// (batch_jax.py:308-346) and stop after the pop when their re-plan
// prefilter fires (batch_jax.py:401-416); the host re-plans them and the
// next launch resumes them at their arrivals.
//
// Layout: fs is (23, L) float64 and is_ is (12, L) int32, row-major, rows
// in the F_* / I_* order; the lane loop's F (41 + K, L), I (29 + K, L) and
// Q (5, L) extend them (lane_loop.py), and tab is (L, width).  One thread
// owns one lane (a column): neighbouring threads read neighbouring
// addresses of each row, so every state load and store coalesces.
//
// Bound.  event_step_kernel: 464 bytes per lane per launch (232 read, 232
// written), whatever `passes` is; per pass about 30 float64 adds and at
// most one divide, the rest compares and selects: bound by bytes and, at
// a few thousand lanes, by launch latency.  lane_loop_kernel: the bytes are
// the state in and out once a launch (under 1 KB a lane) plus the bank and
// the draw table, microseconds at the study's 5,200 lanes; what bounds it
// is each lane's serial chain, a few hundred dependent float64 selects,
// compares and adds an iteration, over thousands of iterations.  So its
// design keeps a lane's whole state in registers (the 8 deferred-fault slots
// in fully unrolled loops, never an indexed local array), runs every
// iteration of the lane in one launch (the host relaunches only past a
// per-launch cap, or for adaptive lanes after a re-plan round), and
// launches blocks of 32 threads so that a few thousand lanes spread over
// all 132 SMs.  The adaptive instantiation is separate so that the
// estimator's thirteen float64 values add no registers to the study's
// lanes.  There is no tensor-core work.
//
// Bitwise contract with the numpy engine:
//   * built with --fmad=false (no multiply-add contraction: the in-window
//     fault date t + (w*u + 0) and the estimator's decays x*dec + 0 round
//     the product first, as the plain version's separate kernels do; the
//     divide is IEEE div.rn.f64);
//   * min/max propagate NaN like jnp.minimum / torch.minimum / amin;
//   * every `x + (cond ? c : 0.0)` is kept as written: x + 0.0 is not x
//     when x is -0.0;
//   * ties take the first index, as torch's argmin / argmax do; the pop
//     takes the earliest (date, sequence) wherever its slot sits, so the
//     bits do not depend on K.

#include <cuda_runtime.h>

namespace {

enum Phase { WORK = 0, CKPT = 1, PROCKPT = 2, DOWN = 3, RECOVER = 4,
             VERIFY = 5 };

enum FRow { F_NOW, F_DONE, F_SAVED, F_PSTART, F_PHEND, F_WPP, F_WREM,
            F_WINEND, F_WINREM, F_TARGET, F_TCKPT, F_TPROC, F_TDOWN,
            F_PERIOD, F_WWP, F_TDOWNT, F_TRECOV, F_TLOST, F_TVERIFY, F_VWP,
            F_VREM, F_VCOST, F_SVCLEAN, N_F };

enum IRow { I_PHASE, I_FIN, I_NCKPT, I_NPROC, I_NROLL, I_NVERIF, I_NDEEP,
            I_NDIRTY, I_CORR, I_VTC, I_NV, I_KEEP, N_I };

// torch.minimum / jnp.minimum: NaN if either operand is NaN, else
// std::min's choice.
__device__ __forceinline__ double dmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return (b < a) ? b : a;
}

__device__ __forceinline__ double dmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return (a < b) ? b : a;
}

struct Consts {
  double c, cp, d, r, time_base;
};

// One schedule step of one lane (event_step_ref's _advance_math).
__device__ __forceinline__ void advance(double* f, int* s, const Consts& k) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const double c = k.c, cp = k.cp, d = k.d, r = k.r;
  const double time_base = k.time_base;
  const double fin_thresh = time_base - 1e-9;
  double now = f[F_NOW];
  const double target = f[F_TARGET];
  int phase = s[I_PHASE];
  bool finished = s[I_FIN] != 0;
  double phase_end = f[F_PHEND];
  double win_end = f[F_WINEND];
  double win_rem = f[F_WINREM];
  const double vcost = f[F_VCOST];
  double v_wp = f[F_VWP];
  double v_rem = f[F_VREM];
  double saved_clean = f[F_SVCLEAN];
  const int nv = s[I_NV];
  const int keep = s[I_KEEP];
  const bool verify_on = nv >= 1;
  bool corrupted = s[I_CORR] != 0;
  bool vtc = s[I_VTC] != 0;
  int n_dirty = s[I_NDIRTY];

  const bool adv = !finished && (now < target);
  const bool in_work = adv && (phase == WORK);
  const bool wz = in_work && (f[F_WREM] <= 0.0);
  const bool wz_v = wz && verify_on;
  phase = wz_v ? VERIFY : (wz ? CKPT : phase);
  phase_end = wz ? now + (verify_on ? vcost : c) : phase_end;
  vtc = wz_v ? true : vtc;

  const bool ww = in_work && !wz;
  const bool in_win = ww && (now < win_end);
  double dt = dmin(f[F_WREM], target - now);
  dt = dmin(dt, v_rem);
  const double cap = in_win ? dmin(win_rem, win_end - now) : inf;
  dt = dmin(dt, cap);
  now = ww ? now + dt : now;
  double done = ww ? f[F_DONE] + dt : f[F_DONE];
  double w_rem = ww ? f[F_WREM] - dt : f[F_WREM];
  v_rem = ww ? v_rem - dt : v_rem;
  win_rem = in_win ? win_rem - dt : win_rem;
  const bool fin_work = ww && (w_rem <= 0.0);
  const bool fw_v = fin_work && verify_on;
  phase = fw_v ? VERIFY : (fin_work ? CKPT : phase);
  phase_end = fin_work ? now + (verify_on ? vcost : c) : phase_end;
  vtc = fw_v ? true : vtc;
  // Intermediate verification due before the period's work is done.
  const bool vdue = ww && (w_rem > 0.0) && (v_rem <= 0.0);
  phase = vdue ? VERIFY : phase;
  phase_end = vdue ? now + vcost : phase_end;
  vtc = vdue ? false : vtc;
  const bool live = ww && (w_rem > 0.0) && (v_rem > 0.0) && in_win;
  // In-window proactive checkpoint due.
  const bool pro = live && (win_rem <= 0.0) && (now < win_end);
  phase = pro ? PROCKPT : phase;
  phase_end = pro ? now + cp : phase_end;
  // Window elapsed without a fault: back to the periodic schedule.
  const bool closed = live && (now >= win_end);
  win_end = closed ? -inf : win_end;
  win_rem = closed ? inf : win_rem;

  const bool in_ph = adv && (phase != WORK) && !wz && !ww;
  const bool complete = in_ph && (phase_end <= target);
  now = complete ? phase_end : now;
  const int ph0 = phase;
  const bool ck = complete && (ph0 == CKPT);
  const int n_ckpts = s[I_NCKPT] + (ck ? 1 : 0);
  const double time_ckpt = f[F_TCKPT] + (ck ? c : 0.0);
  double saved = ck ? done : f[F_SAVED];

  const bool pk = complete && (ph0 == PROCKPT);
  const int n_prockpts = s[I_NPROC] + (pk ? 1 : 0);
  const double time_prockpt = f[F_TPROC] + (pk ? cp : 0.0);
  saved = pk ? done : saved;

  // Retained-checkpoint ring update.
  const bool sv = ck || pk;
  const bool dirty_save = sv && corrupted;
  n_dirty = n_dirty + (dirty_save ? 1 : 0);
  saved_clean = (dirty_save && (n_dirty >= keep)) ? 0.0 : saved_clean;
  const bool clean_save = sv && !corrupted;
  saved_clean = clean_save ? done : saved_clean;
  n_dirty = clean_save ? 0 : n_dirty;

  // Final-checkpoint acceptance check.
  const bool at_end = ck && (saved >= fin_thresh);
  const bool det_ck = at_end && corrupted;
  const bool fin = at_end && !corrupted;
  finished = finished || fin;
  bool act = ck && (now < win_end);
  win_rem = act ? f[F_WWP] : win_rem;

  double period_start = pk ? now : f[F_PSTART];
  phase = pk ? WORK : phase;
  phase_end = pk ? inf : phase_end;
  v_rem = pk ? v_wp : v_rem;
  act = pk && (now < win_end);
  win_rem = act ? f[F_WWP] : win_rem;

  const bool vf = complete && (ph0 == VERIFY);
  const double time_verify = f[F_TVERIFY] + (vf ? vcost : 0.0);
  const int n_verifs = s[I_NVERIF] + (vf ? 1 : 0);
  const bool det_vf = vf && corrupted;
  const bool ok = vf && !corrupted;
  v_rem = ok ? v_wp : v_rem;
  const bool tc = ok && vtc;
  phase = tc ? CKPT : phase;
  phase_end = tc ? now + c : phase_end;
  const bool wk = ok && !vtc;
  phase = wk ? WORK : phase;
  phase_end = wk ? inf : phase_end;

  const bool dn = complete && (ph0 == DOWN);
  double time_down = f[F_TDOWN] + (dn ? d : 0.0);
  const double time_downtime = f[F_TDOWNT] + (dn ? d : 0.0);
  phase = dn ? RECOVER : phase;
  phase_end = dn ? now + r : phase_end;
  const bool rc = complete && (ph0 == RECOVER);
  time_down = time_down + (rc ? r : 0.0);
  const double time_recovery = f[F_TRECOV] + (rc ? r : 0.0);

  const bool renew = (ck && !at_end) || rc;
  phase = renew ? WORK : phase;
  phase_end = renew ? inf : phase_end;
  period_start = renew ? now : period_start;
  const double wpp = renew ? dmax(1e-9, f[F_PERIOD] - c) : f[F_WPP];
  w_rem = renew ? dmin(wpp, time_base - saved) : w_rem;
  v_wp = (renew && verify_on) ? wpp / (double)(nv > 1 ? nv : 1) : v_wp;
  v_rem = renew ? v_wp : v_rem;

  // Late detection: roll back past every dirty snapshot to the newest
  // clean one, paying R only.
  const bool det = det_ck || det_vf;
  const double lost = done - saved_clean;
  const double time_lost = f[F_TLOST] + (det ? lost : 0.0);
  const int n_rolls = s[I_NROLL] + ((det && (lost > 0.0)) ? 1 : 0);
  const int n_deep = s[I_NDEEP] + ((det && (n_dirty > 0)) ? 1 : 0);
  done = det ? saved_clean : done;
  saved = det ? saved_clean : saved;
  n_dirty = det ? 0 : n_dirty;
  corrupted = corrupted && !det;
  phase = det ? RECOVER : phase;
  phase_end = det ? now + r : phase_end;
  win_end = det ? -inf : win_end;
  win_rem = det ? inf : win_rem;

  const bool stall = in_ph && !complete;
  now = stall ? target : now;

  f[F_NOW] = now;
  f[F_DONE] = done;
  f[F_SAVED] = saved;
  f[F_PSTART] = period_start;
  f[F_PHEND] = phase_end;
  f[F_WPP] = wpp;
  f[F_WREM] = w_rem;
  f[F_WINEND] = win_end;
  f[F_WINREM] = win_rem;
  f[F_TCKPT] = time_ckpt;
  f[F_TPROC] = time_prockpt;
  f[F_TDOWN] = time_down;
  f[F_TDOWNT] = time_downtime;
  f[F_TRECOV] = time_recovery;
  f[F_TLOST] = time_lost;
  f[F_TVERIFY] = time_verify;
  f[F_VWP] = v_wp;
  f[F_VREM] = v_rem;
  f[F_SVCLEAN] = saved_clean;
  s[I_PHASE] = phase;
  s[I_FIN] = finished ? 1 : 0;
  s[I_NCKPT] = n_ckpts;
  s[I_NPROC] = n_prockpts;
  s[I_NROLL] = n_rolls;
  s[I_NVERIF] = n_verifs;
  s[I_NDEEP] = n_deep;
  s[I_NDIRTY] = n_dirty;
  s[I_CORR] = corrupted ? 1 : 0;
  s[I_VTC] = vtc ? 1 : 0;
}

__global__ void event_step_kernel(const double* fs_in, const int* is_in,
                                  double* fs_out, int* is_out,
                                  long long lanes, int passes, Consts k) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < lanes; j += stride) {
    double f[N_F];
    int s[N_I];
#pragma unroll
    for (int row = 0; row < N_F; ++row) f[row] = fs_in[row * lanes + j];
#pragma unroll
    for (int row = 0; row < N_I; ++row) s[row] = is_in[row * lanes + j];
    for (int p = 0; p < passes; ++p) advance(f, s, k);
#pragma unroll
    for (int row = 0; row < N_F; ++row) fs_out[row * lanes + j] = f[row];
#pragma unroll
    for (int row = 0; row < N_I; ++row) is_out[row * lanes + j] = s[row];
  }
}


// ---- the lane loop ---------------------------------------------------------

constexpr int DEF_SLOTS = 8;
constexpr int BIG_SEQ = 2147483647;
constexpr int ADV_PASSES = 4;
constexpr int LOOP_THREADS = 32;
// The precision estimate's floor (predictors/estimator.py's P_HAT_MIN).
constexpr double P_HAT_MIN = 1e-3;

// Rows of the lane loop's matrices after the F_* / I_* rows (lane_loop.py).
// The deferred-fault slots come last: K rows from LF_DEF and from LI_DEFSEQ.
enum LFRow { LF_PRED_T = 23, LF_PRED_FD = 24, LF_PRED_WIN = 25,
             LF_TPARAM = 26, LF_WINDOW = 27, LF_NTP = 28, LF_NFP = 29,
             LF_NUF = 30, LF_GS = 31, LF_GN = 32, LF_LASTF = 33, LF_PR = 34,
             LF_PP = 35, LF_PMU = 36, LF_DEC = 37, LF_MINP = 38,
             LF_MINF = 39, LF_TOL = 40, LF_DEF = 41 };
enum LIRow { LI_PC = 12, LI_PRED_TRUE = 13, LI_NEXT_SEQ = 14,
             LI_OVERFLOW = 15, LI_KIND = 16, LI_WITHIN = 17,
             LI_COUNTS = 18, LI_ACT = 25, LI_ESTMU = 26, LI_NREPLANS = 27,
             LI_RESUME = 28, LI_DEFSEQ = 29 };
enum LQRow { LQ_TR, LQ_NEV, LQ_CURSOR, LQ_CUR, LQ_ITERS, N_LQ };
// The event counters, rows LI_COUNTS + c.
enum Count { C_FAULTS, C_FAULTS_HIT, C_PREDICTIONS, C_TRUSTED,
             C_TRUSTED_TRUE, C_IGNORED, C_SILENT, N_COUNTS };
enum PC { PC_POP, PC_FAULT, PC_PRED, PC_FINAL, PC_SILENT };
enum Trust { TRUST_NEVER, TRUST_ALWAYS, TRUST_THRESHOLD, TRUST_FIXED_Q };
enum Kind { FAULT_UNPRED = 0, FAULT_PRED = 1, FALSE_PRED = 2, SILENT = 3 };
// Bits of the stop flag.
enum Flag { FLAG_RUN = 1, FLAG_OVERFLOW = 2, FLAG_REPLAN = 4 };

// The register route's deferred-fault slots: DEF_SLOTS of them, every
// access in a fully unrolled loop, so they stay registers (never an
// indexed local array).
struct RegSlots {
  double t[DEF_SLOTS];
  int s[DEF_SLOTS];

  __device__ static constexpr int size() { return DEF_SLOTS; }
  __device__ __forceinline__ double time(int q) const { return t[q]; }
  __device__ __forceinline__ int seq(int q) const { return s[q]; }
  // (date, sequence) into slot `slot` where `on`: a select on every slot.
  __device__ __forceinline__ void put(int slot, bool on, double date,
                                      int sq) {
#pragma unroll
    for (int q = 0; q < DEF_SLOTS; ++q) {
      const bool hot = (q == slot) && on;
      t[q] = hot ? date : t[q];
      s[q] = hot ? sq : s[q];
    }
  }
  __device__ __forceinline__ void load(double* F, int* I, long long lanes,
                                       long long j, int) {
#pragma unroll
    for (int q = 0; q < DEF_SLOTS; ++q) {
      t[q] = F[(LF_DEF + q) * lanes + j];
      s[q] = I[(LI_DEFSEQ + q) * lanes + j];
    }
  }
  __device__ __forceinline__ void store(double* F, int* I, long long lanes,
                                        long long j) const {
#pragma unroll
    for (int q = 0; q < DEF_SLOTS; ++q) {
      F[(LF_DEF + q) * lanes + j] = t[q];
      I[(LI_DEFSEQ + q) * lanes + j] = s[q];
    }
  }
};

// The wide route's slots: K of them (a runtime count), read and written
// in place in the chunk's rows.  It runs only the lanes that overflowed
// the register route, rerun from their start, so its speed does not
// matter; K is unbounded, as the numpy engine's growing slots are.
struct RowSlots {
  double* t;
  int* s;
  long long stride;
  int k;

  __device__ __forceinline__ int size() const { return k; }
  __device__ __forceinline__ double time(int q) const {
    return t[q * stride];
  }
  __device__ __forceinline__ int seq(int q) const { return s[q * stride]; }
  __device__ __forceinline__ void put(int slot, bool on, double date,
                                      int sq) {
    if (on) {
      t[slot * stride] = date;
      s[slot * stride] = sq;
    }
  }
  __device__ __forceinline__ void load(double* F, int* I, long long lanes,
                                       long long j, int slots) {
    t = F + LF_DEF * lanes + j;
    s = I + LI_DEFSEQ * lanes + j;
    stride = lanes;
    k = slots;
  }
  __device__ __forceinline__ void store(double*, int*, long long,
                                        long long) const {}
};

// A lane's pop / arrival state (the plain version's dict `s`).
template <class Slots>
struct Lane {
  int pc;
  bool pred_true;
  int next_seq;
  bool overflow;
  long long cursor, cur;
  double pred_t, pred_fd, pred_win;
  Slots def;
  int count[N_COUNTS];
};

// An adaptive lane's estimator: the counters it updates at its pops and
// the constants of this launch (the plan last made, the gate, the decay).
struct Est {
  double ntp, nfp, nuf, gs, gn, lastf;
  double pr, pp, pmu, dec, minp, minf, tol;
  bool act, estmu;
};

// A lane's constants (the plain version's dict `k`) and the bank.
struct LaneConst {
  long long tr, n_ev;
  int kind;
  bool within;
  double tparam, window;
  const double* tab;      // this lane's row of the draw table
  long long tab_width;
};

struct Bank {
  const double* times;
  const int* kinds;
  const double* wins;
  long long width;
};

__device__ __forceinline__ bool is_inf(double x) {
  return fabs(x) == __longlong_as_double(0x7ff0000000000000LL);
}

// _gather_row: tab[lane, min(col, width - 1)].
__device__ __forceinline__ double draw_at(const LaneConst& k, long long col) {
  return k.tab[col < k.tab_width - 1 ? col : k.tab_width - 1];
}

// _push: deferred-fault insert into the first empty slot.  With no empty
// slot the lane overflows and slot 0 is written, as argmax of an all-zero
// row picks 0.
template <class Slots>
__device__ __forceinline__ void push_fault(Lane<Slots>& s, bool push,
                                           double date) {
  bool any_empty = false;
  int slot = 0;
#pragma unroll
  for (int q = s.def.size() - 1; q >= 0; --q) {
    const bool empty = is_inf(s.def.time(q));
    slot = empty ? q : slot;
    any_empty = any_empty || empty;
  }
  s.overflow = s.overflow || (push && !any_empty);
  s.def.put(slot, push, date, s.next_seq);
  s.next_seq = push ? s.next_seq + 1 : s.next_seq;
}

// The first half of one iteration of one lane: lane_loop.py's _pop (with
// _observe for adaptive lanes), the fault date and its _push, and for
// adaptive lanes the re-plan prefilter (_prefilter).  Returns true when
// the lane's re-plan fires: the lane then stops before its arrivals.
template <bool ADAPTIVE, class Slots>
__device__ __forceinline__ bool pop_push(double* f, const int* st,
                                         Lane<Slots>& s, Est& e,
                                         const LaneConst& k, const Bank& b,
                                         const Consts& kc) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);

  // ---- _pop
  const double now = f[F_NOW];
  double target = f[F_TARGET];
  const bool pop = (st[I_FIN] == 0) && (s.pc == PC_POP);
  const long long col = s.cursor < b.width - 1 ? s.cursor : b.width - 1;
  const bool have = s.cursor < k.n_ev;
  // The bank is read only where a pop uses it; elsewhere no result
  // depends on these three values.
  const bool read = pop && have;
  const long long at = k.tr * b.width + col;
  const double t_tr = read ? b.times[at] : inf;
  const int k_tr = read ? b.kinds[at] : -1;
  const double w_ev = read ? b.wins[at] : -1.0;
  double min_t = s.def.time(0);
#pragma unroll
  for (int q = 1; q < s.def.size(); ++q) min_t = dmin(min_t, s.def.time(q));
  // First minimum of the sequence numbers among the slots at min_t.
  int slot = 0;
  int best = (s.def.time(0) == min_t) ? s.def.seq(0) : BIG_SEQ;
#pragma unroll
  for (int q = 1; q < s.def.size(); ++q) {
    const int v = (s.def.time(q) == min_t) ? s.def.seq(q) : BIG_SEQ;
    slot = (v < best) ? q : slot;
    best = (v < best) ? v : best;
  }

  const bool none_left = pop && is_inf(t_tr) && is_inf(min_t);
  s.pc = none_left ? PC_FINAL : s.pc;
  target = none_left ? inf : target;

  const bool take_trace = pop && !none_left && (t_tr <= min_t);
  s.cursor = s.cursor + (take_trace ? 1 : 0);
  const bool take_def = pop && !none_left && !take_trace;
  s.def.put(slot, take_def, inf, BIG_SEQ);

  const bool uf = take_trace && (k_tr == FAULT_UNPRED);
  const bool is_fault = take_def || uf;
  s.count[C_FAULTS] += uf ? 1 : 0;
  const double f_t = take_def ? min_t : t_tr;
  target = is_fault ? f_t : target;
  s.pc = is_fault ? PC_FAULT : s.pc;

  const bool is_sil = take_trace && (k_tr == SILENT);
  target = is_sil ? t_tr : target;
  s.pc = is_sil ? PC_SILENT : s.pc;

  const bool is_pred = take_trace && (k_tr != FAULT_UNPRED) &&
                       (k_tr != SILENT);
  s.count[C_PREDICTIONS] += is_pred ? 1 : 0;
  const bool is_true = is_pred && (k_tr == FAULT_PRED);
  s.count[C_FAULTS] += is_true ? 1 : 0;
  // The runtime zero of the reference's contraction guards.
  const double zero = __dsub_rn(now, now);

  // ---- _observe: the estimator's counters, decay-then-increment with
  // each product rounded before its add.
  bool site = false;
  if constexpr (ADAPTIVE) {
    const bool mu_site = e.act && e.estmu && is_fault;
    const bool obs = mu_site && (e.lastf > -inf);
    const double gs_d = __dadd_rn(__dmul_rn(e.gs, e.dec), zero);
    const double gn_d = __dadd_rn(__dmul_rn(e.gn, e.dec), zero);
    e.gs = obs ? __dadd_rn(gs_d, __dsub_rn(f_t, e.lastf)) : e.gs;
    e.gn = obs ? __dadd_rn(gn_d, 1.0) : e.gn;
    e.lastf = mu_site ? f_t : e.lastf;
    const bool upd_uf = uf && e.act;
    const bool upd_p = is_pred && e.act;
    const bool upd = upd_uf || upd_p;
    double ntp = upd ? __dadd_rn(__dmul_rn(e.ntp, e.dec), zero) : e.ntp;
    double nfp = upd ? __dadd_rn(__dmul_rn(e.nfp, e.dec), zero) : e.nfp;
    double nuf = upd ? __dadd_rn(__dmul_rn(e.nuf, e.dec), zero) : e.nuf;
    nuf = upd_uf ? __dadd_rn(nuf, 1.0) : nuf;
    ntp = (upd_p && is_true) ? __dadd_rn(ntp, 1.0) : ntp;
    nfp = (upd_p && !is_true) ? __dadd_rn(nfp, 1.0) : nfp;
    e.ntp = ntp;
    e.nfp = nfp;
    e.nuf = nuf;
    site = e.act && (is_pred || uf || (take_def && obs));
  }

  const double w_eff = (w_ev < 0.0) ? k.window : w_ev;
  const bool draw_win = is_true && (w_eff > 0.0);
  // The draw is read only where it is used (draw_win).
  const double u = draw_win ? draw_at(k, s.cur) : 0.0;
  s.cur = s.cur + (draw_win ? 1 : 0);
  const double ckpt_start = t_tr - kc.cp;
  const bool honour = is_pred && (ckpt_start >= now);
  s.pc = honour ? PC_PRED : s.pc;
  target = honour ? ckpt_start : target;
  const bool ignored = is_pred && !honour;
  s.pred_t = honour ? t_tr : s.pred_t;
  s.pred_true = honour ? is_true : s.pred_true;
  s.pred_win = honour ? w_eff : s.pred_win;
  s.count[C_IGNORED] += ignored ? 1 : 0;

  // ---- _body: the in-window fault date t + (w*u + zero), product rounded
  // first, then its deferred-fault push.
  const double off = __dadd_rn(__dmul_rn(w_eff, u), zero);
  const double fd = draw_win ? __dadd_rn(t_tr, off) : t_tr;
  s.pred_fd = honour ? fd : s.pred_fd;
  push_fault(s, ignored && is_true, fd);
  f[F_TARGET] = target;

  // ---- _prefilter: maybe_replan's gate and hysteresis.  An overflowed
  // lane is rerun from its start, so it does not stop here.
  bool fire = false;
  if constexpr (ADAPTIVE) {
    const double npred = __dadd_rn(e.ntp, e.nfp);
    const double nflt = __dadd_rn(e.ntp, e.nuf);
    const bool gate = (npred >= e.minp) && (nflt >= e.minf);
    const double r_hat = e.ntp / (gate ? nflt : 1.0);
    const double p_hat = dmax(e.ntp / (gate ? npred : 1.0), P_HAT_MIN);
    const bool has_mu = e.estmu && (e.gn > 0.0);
    const double mu_hat = e.gs / (e.gn > 0.0 ? e.gn : 1.0);
    const bool moved =
        (fabs(__dsub_rn(r_hat, e.pr)) > e.tol) ||
        (fabs(__dsub_rn(p_hat, e.pp)) > e.tol) ||
        (has_mu && (fabs(__dsub_rn(mu_hat, e.pmu)) > __dmul_rn(e.tol, e.pmu)));
    fire = site && gate && moved && !s.overflow;
  }
  return fire;
}

// The second half of one iteration of one lane: lane_loop.py's _arrive
// and ADV_PASSES advances.
template <class Slots>
__device__ __forceinline__ void arrive_advance(double* f, int* st,
                                               Lane<Slots>& s,
                                               const LaneConst& k,
                                               const Consts& kc) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const double now = f[F_NOW];
  double target = f[F_TARGET];

  // ---- _arrive
  const bool active = st[I_FIN] == 0;
  int phase = st[I_PHASE];
  double phase_end = f[F_PHEND];
  double done = f[F_DONE];
  double saved = f[F_SAVED];
  const double saved_clean = f[F_SVCLEAN];
  double win_end = f[F_WINEND];
  double win_rem = f[F_WINREM];
  int n_dirty = st[I_NDIRTY];
  int corrupted = st[I_CORR];
  // Fault arrival, with the deep rollback past dirty snapshots.
  const bool arr_f = active && (s.pc == PC_FAULT) && (now >= target);
  const bool deep = n_dirty > 0;
  const double base = deep ? saved_clean : saved;
  double lost = done - base;
  const bool in_phase = (phase != WORK) && !is_inf(phase_end);
  const double dur =
      phase == CKPT ? kc.c
      : phase == PROCKPT ? kc.cp
      : phase == DOWN ? kc.d
      : phase == RECOVER ? kc.r
      : phase == VERIFY ? f[F_VCOST] : 0.0;
  const double elapsed = dur - (phase_end - now);
  const double pos = dmax(0.0, elapsed);
  const bool ckpt_like = in_phase && ((phase == CKPT) || (phase == PROCKPT) ||
                                      (phase == VERIFY));
  lost = lost + (ckpt_like ? pos : 0.0);
  f[F_TDOWN] = f[F_TDOWN] + ((arr_f && in_phase && !ckpt_like) ? pos : 0.0);
  f[F_TDOWNT] = f[F_TDOWNT] + ((arr_f && in_phase && (phase == DOWN))
                               ? pos : 0.0);
  f[F_TRECOV] = f[F_TRECOV] + ((arr_f && in_phase && (phase == RECOVER))
                               ? pos : 0.0);
  f[F_TLOST] = f[F_TLOST] + (arr_f ? lost : 0.0);
  s.count[C_FAULTS_HIT] += arr_f ? 1 : 0;
  st[I_NROLL] += (arr_f && (lost > 0.0)) ? 1 : 0;
  st[I_NDEEP] += (arr_f && deep) ? 1 : 0;
  saved = (arr_f && deep) ? saved_clean : saved;
  n_dirty = arr_f ? 0 : n_dirty;
  corrupted = arr_f ? 0 : corrupted;
  done = arr_f ? saved : done;
  phase_end = arr_f ? target + kc.d : phase_end;
  phase = arr_f ? DOWN : phase;
  win_end = arr_f ? -inf : win_end;
  win_rem = arr_f ? inf : win_rem;
  s.pc = arr_f ? PC_POP : s.pc;
  target = arr_f ? -inf : target;

  // Silent-error strike.
  const bool arr_s = active && (s.pc == PC_SILENT) && (now >= target);
  const bool hit = arr_s && ((phase == WORK) || (phase == CKPT) ||
                             (phase == PROCKPT) || (phase == VERIFY));
  s.count[C_SILENT] += hit ? 1 : 0;
  corrupted = hit ? 1 : corrupted;
  s.pc = arr_s ? PC_POP : s.pc;
  target = arr_s ? -inf : target;

  // Prediction arrival: the trust decision.
  const bool arr_p = active && (s.pc == PC_PRED) && (now >= target);
  const bool working = arr_p && (phase == WORK);
  const double offset = s.pred_t - f[F_PSTART];
  const bool draw_q = working && (k.kind == TRUST_FIXED_Q);
  const double u2 = draw_q ? draw_at(k, s.cur) : 0.0;
  s.cur = s.cur + (draw_q ? 1 : 0);
  const bool trusted =
      working && ((k.kind == TRUST_ALWAYS) ||
                  ((k.kind == TRUST_THRESHOLD) && (offset >= k.tparam)) ||
                  (draw_q && (u2 < k.tparam)));
  phase = trusted ? PROCKPT : phase;
  phase_end = trusted ? s.pred_t : phase_end;
  s.count[C_TRUSTED] += trusted ? 1 : 0;
  s.count[C_TRUSTED_TRUE] += (trusted && s.pred_true) ? 1 : 0;
  const bool arm = trusted && k.within && (s.pred_win > 0.0);
  win_end = arm ? s.pred_t + s.pred_win : win_end;
  s.count[C_IGNORED] += (arr_p && !working) ? 1 : 0;
  push_fault(s, arr_p && s.pred_true, s.pred_fd);
  s.pc = arr_p ? PC_POP : s.pc;
  target = arr_p ? -inf : target;

  f[F_TARGET] = target;
  f[F_PHEND] = phase_end;
  f[F_DONE] = done;
  f[F_SAVED] = saved;
  f[F_WINEND] = win_end;
  f[F_WINREM] = win_rem;
  st[I_PHASE] = phase;
  st[I_NDIRTY] = n_dirty;
  st[I_CORR] = corrupted;

  // ---- the schedule steps
#pragma unroll 1
  for (int p = 0; p < ADV_PASSES; ++p) advance(f, st, kc);
}


template <bool WIDE>
struct SlotsOf {
  using type = RegSlots;
};
template <>
struct SlotsOf<true> {
  using type = RowSlots;
};

// One thread per lane: load the lane's state, first complete an iteration
// stopped for a re-plan (its arrivals and advance, counted when it began),
// then run its iterations until it finished, overflowed, stopped for a
// re-plan or ran `cap` of them, and write the state back once.  WIDE keeps
// the deferred-fault slots in the chunk's rows (RowSlots) instead of
// registers; ADAPTIVE runs the estimator.  The flag collects FLAG_RUN (a
// lane can run on), FLAG_OVERFLOW and FLAG_REPLAN (a lane awaits a
// re-plan).
template <bool WIDE, bool ADAPTIVE>
__global__ void __launch_bounds__(LOOP_THREADS)
lane_loop_kernel(double* F, int* I, long long* Q, const double* tab,
                 long long tab_width, Bank b, long long lanes, int cap,
                 int slots, Consts kc, int* flag) {
  using Slots = typename SlotsOf<WIDE>::type;
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= lanes) return;
  double f[N_F];
  int st[N_I];
  Lane<Slots> s;
#pragma unroll
  for (int row = 0; row < N_F; ++row) f[row] = F[row * lanes + j];
#pragma unroll
  for (int row = 0; row < N_I; ++row) st[row] = I[row * lanes + j];
  s.pred_t = F[LF_PRED_T * lanes + j];
  s.pred_fd = F[LF_PRED_FD * lanes + j];
  s.pred_win = F[LF_PRED_WIN * lanes + j];
  s.def.load(F, I, lanes, j, slots);
  s.pc = I[LI_PC * lanes + j];
  s.pred_true = I[LI_PRED_TRUE * lanes + j] != 0;
  s.next_seq = I[LI_NEXT_SEQ * lanes + j];
  s.overflow = I[LI_OVERFLOW * lanes + j] != 0;
#pragma unroll
  for (int c = 0; c < N_COUNTS; ++c) s.count[c] = I[(LI_COUNTS + c) * lanes + j];
  s.cursor = Q[LQ_CURSOR * lanes + j];
  s.cur = Q[LQ_CUR * lanes + j];
  LaneConst k;
  k.tr = Q[LQ_TR * lanes + j];
  k.n_ev = Q[LQ_NEV * lanes + j];
  k.kind = I[LI_KIND * lanes + j];
  k.within = I[LI_WITHIN * lanes + j] != 0;
  k.tparam = F[LF_TPARAM * lanes + j];
  k.window = F[LF_WINDOW * lanes + j];
  k.tab = tab + j * tab_width;
  k.tab_width = tab_width;
  Est e;
  bool resume = false;
  if constexpr (ADAPTIVE) {
    e.ntp = F[LF_NTP * lanes + j];
    e.nfp = F[LF_NFP * lanes + j];
    e.nuf = F[LF_NUF * lanes + j];
    e.gs = F[LF_GS * lanes + j];
    e.gn = F[LF_GN * lanes + j];
    e.lastf = F[LF_LASTF * lanes + j];
    e.pr = F[LF_PR * lanes + j];
    e.pp = F[LF_PP * lanes + j];
    e.pmu = F[LF_PMU * lanes + j];
    e.dec = F[LF_DEC * lanes + j];
    e.minp = F[LF_MINP * lanes + j];
    e.minf = F[LF_MINF * lanes + j];
    e.tol = F[LF_TOL * lanes + j];
    e.act = I[LI_ACT * lanes + j] != 0;
    e.estmu = I[LI_ESTMU * lanes + j] != 0;
    resume = I[LI_RESUME * lanes + j] != 0;
    if (resume) {
      arrive_advance(f, st, s, k, kc);
      resume = false;
    }
  }

  int it = 0;
  while (it < cap && st[I_FIN] == 0 && !s.overflow) {
    ++it;
    if (pop_push<ADAPTIVE>(f, st, s, e, k, b, kc)) {
      resume = true;
      break;
    }
    arrive_advance(f, st, s, k, kc);
  }

#pragma unroll
  for (int row = 0; row < N_F; ++row) F[row * lanes + j] = f[row];
#pragma unroll
  for (int row = 0; row < N_I; ++row) I[row * lanes + j] = st[row];
  F[LF_PRED_T * lanes + j] = s.pred_t;
  F[LF_PRED_FD * lanes + j] = s.pred_fd;
  F[LF_PRED_WIN * lanes + j] = s.pred_win;
  s.def.store(F, I, lanes, j);
  I[LI_PC * lanes + j] = s.pc;
  I[LI_PRED_TRUE * lanes + j] = s.pred_true ? 1 : 0;
  I[LI_NEXT_SEQ * lanes + j] = s.next_seq;
  I[LI_OVERFLOW * lanes + j] = s.overflow ? 1 : 0;
#pragma unroll
  for (int c = 0; c < N_COUNTS; ++c) I[(LI_COUNTS + c) * lanes + j] = s.count[c];
  Q[LQ_CURSOR * lanes + j] = s.cursor;
  Q[LQ_CUR * lanes + j] = s.cur;
  Q[LQ_ITERS * lanes + j] += it;
  if constexpr (ADAPTIVE) {
    F[LF_NTP * lanes + j] = e.ntp;
    F[LF_NFP * lanes + j] = e.nfp;
    F[LF_NUF * lanes + j] = e.nuf;
    F[LF_GS * lanes + j] = e.gs;
    F[LF_GN * lanes + j] = e.gn;
    F[LF_LASTF * lanes + j] = e.lastf;
    I[LI_RESUME * lanes + j] = resume ? 1 : 0;
  }
  const int bits = ((st[I_FIN] == 0 && !s.overflow) ? FLAG_RUN : 0) |
                   (s.overflow ? FLAG_OVERFLOW : 0) |
                   (resume ? FLAG_REPLAN : 0);
  if (bits) atomicOr(flag, bits);
}

template <bool WIDE, bool ADAPTIVE>
int launch_loop(double* F, int* I, long long* Q, const double* tab,
                long long tab_width, const Bank& b, long long lanes, int cap,
                int slots, const Consts& k, int* flag, cudaStream_t stream) {
  const long long blocks = (lanes + LOOP_THREADS - 1) / LOOP_THREADS;
  lane_loop_kernel<WIDE, ADAPTIVE><<<(unsigned)blocks, LOOP_THREADS, 0,
                                     stream>>>(F, I, Q, tab, tab_width, b,
                                               lanes, cap, slots, k, flag);
  return (int)cudaGetLastError();
}

}  // namespace


// C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int event_step_launch(const void* fs_in, const void* is_in,
                                 void* fs_out, void* is_out,
                                 long long lanes, int passes, double c,
                                 double cp, double d, double r,
                                 double time_base, void* stream) {
  if (lanes <= 0) return 0;
  const int threads = 256;
  long long blocks = (lanes + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
  const Consts k{c, cp, d, r, time_base};
  event_step_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(fs_in), static_cast<const int*>(is_in),
      static_cast<double*>(fs_out), static_cast<int*>(is_out), lanes,
      passes, k);
  return (int)cudaGetLastError();
}

// C entry point of the lane loop, loaded with ctypes: F, I, Q are updated
// in place and `flag` (one int, zeroed by the caller) collects the stop
// bits.  `slots` is K, the chunk's deferred-fault slots: DEF_SLOTS takes
// the register route, any other count the wide route; `adaptive` (0 or 1)
// whether the chunk's lanes run the estimator.  Launches on `stream`,
// returns cudaGetLastError(), does not synchronise.
extern "C" int lane_loop_launch(void* F, void* I, void* Q, const void* tab,
                                long long tab_width, const void* times,
                                const void* kinds, const void* wins,
                                long long bank_width, long long lanes,
                                int cap, int slots, int adaptive, double c,
                                double cp, double d, double r,
                                double time_base, void* flag,
                                void* stream) {
  if (lanes <= 0) return 0;
  const Consts k{c, cp, d, r, time_base};
  const Bank b{static_cast<const double*>(times),
               static_cast<const int*>(kinds),
               static_cast<const double*>(wins), bank_width};
  double* f = static_cast<double*>(F);
  int* i = static_cast<int*>(I);
  long long* q = static_cast<long long*>(Q);
  const double* t = static_cast<const double*>(tab);
  int* fl = static_cast<int*>(flag);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = slots != DEF_SLOTS;
  if (!wide && !adaptive)
    return launch_loop<false, false>(f, i, q, t, tab_width, b, lanes, cap,
                                     slots, k, fl, s);
  if (!wide)
    return launch_loop<false, true>(f, i, q, t, tab_width, b, lanes, cap,
                                    slots, k, fl, s);
  if (!adaptive)
    return launch_loop<true, false>(f, i, q, t, tab_width, b, lanes, cap,
                                    slots, k, fl, s);
  return launch_loop<true, true>(f, i, q, t, tab_width, b, lanes, cap,
                                 slots, k, fl, s);
}
