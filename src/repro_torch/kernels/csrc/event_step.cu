// Event-advance step of the lane engine, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/event_step.py::event_step_pallas
//   (body _event_kernel -> _advance_math, event_step.py:75-255).
// The plain version is repro_torch/kernels/event_step.py::event_step_ref;
// every expression below mirrors it statement for statement.
//
// Layout: fs is (23, L) float64 and is_ is (12, L) int32, row-major, rows
// in the F_* / I_* order.  One thread owns one lane (a column) and walks
// the lanes with a grid-stride loop; neighbouring threads read
// neighbouring addresses of each row, so every load and store coalesces.
// The thread runs `passes` schedule steps in registers and writes back
// once, which is bitwise the same as `passes` separate launches.
//
// Bound: 464 bytes per lane per launch (232 read, 232 written), whatever
// `passes` is; per pass a lane does about 30 float64 adds and at most one
// divide, the rest compares and selects.  So a launch is bound by memory
// bytes and, at the engine's lane counts (a few thousand), by launch
// latency.  There is no tensor-core work.
//
// Bitwise contract with the numpy engine:
//   * built with --fmad=false (no multiply-add contraction; the step has
//     no products anyway, and the divide is IEEE div.rn.f64);
//   * min/max propagate NaN like jnp.minimum / torch.minimum;
//   * every `x + (cond ? c : 0.0)` is kept as written: x + 0.0 is not x
//     when x is -0.0.

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
