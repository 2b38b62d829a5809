// Forward flash attention (online softmax, GQA, causal / sliding window,
// q_offset), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_pallas (_kernel)
// The plain version is repro_torch/kernels/flash_attention.py::
// flash_attention_ref, a copy of the JAX package's ref.flash_attention_ref.
//
// Contract: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), contiguous, fp32 or
// bf16, H a multiple of KV; query head h reads kv head h / (H / KV).  For
// query row i (absolute position qp = q_offset + i) and key j:
//   s = (f32(q) * scale) . f32(k_j), masked to NEG_INF = -1e30 unless
//   (!causal || qp >= j) && (!window || qp - j < window);
//   out = softmax(s) @ f32(v), cast to the input dtype.
// As in the Pallas body, m, l and acc are f32 and the output is
// acc / max(l, 1e-30).
//
// Layout: one block of 4 warps per (q tile, head, batch); a q tile is BQ =
// 4 * R rows, each warp owning R rows.  A block serves one query head, so
// with g = H / KV > 1 (attn_layout="grouped") each k/v tile is staged once
// for each of its g query heads: there is no GQA reuse yet.  The block walks its key range in
// tiles of 32 keys staged in shared memory as f32 (k rows padded to hd + 1
// floats so that lane j reading k[j][d] hits bank (j + d) % 32).  For the
// scores a lane owns one key (q rows are broadcast reads); for p @ v a
// lane owns hd / 32 output dims.  The TPU kernel's sequential kv grid axis
// with (m, l, acc) in VMEM scratch becomes this loop with (m, l, acc) in
// registers; the TPU's 128 x 128 MXU tiles become 32-key tiles for CUDA
// cores.  The ragged last tile (Skv not a multiple of 32, the seq-96 case)
// is masked here instead of shrinking the tile as the TPU kernel does:
// keys past Skv score -inf and add exactly 0.
//
// Why -1e30 and not -inf for masked keys: a row whose keys so far are all
// masked has m = -1e30 and takes p = exp(0) = 1 for them; the first valid
// key then gives corr = exp(-1e30 - m) = 0, which wipes them, exactly as in
// the Pallas kernel.  With -inf, exp(-inf + inf) would be NaN.  The same
// argument makes it exact to skip key tiles that are masked for every row
// of the block (above the causal diagonal, before the window), as long as
// every row has a valid key somewhere: a skipped tile would have added
// exactly 0 or been wiped exactly.  A block holding a row with no valid key
// at all walks every key, so such a row gets the reference's uniform
// average.
//
// Bound: operations.  Scores and p @ v are 4 * hd flops per (row, key)
// pair; the kernel does them as separate fp32 multiplies and adds on the
// CUDA cores (built with --fmad=false, expf not __expf), which keeps fp32
// inputs within 2e-6 of the plain version; TF32 tensor cores would not.
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 32;             // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
             int h, int kv, int causal, int window, int q_offset,
             float scale) {
  constexpr int BQ = kWarps * R;
  constexpr int DPL = HD / 32;      // output dims per lane
  __shared__ float qs[BQ][HD];
  __shared__ float ks[kBK][HD + 1];
  __shared__ float vs[kBK][HD];
  __shared__ float ps[kWarps][R][kBK];

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The q tile, times scale, in f32 (as the Pallas body); rows past Sq
  // read as 0 and are never stored.
  for (int i = threadIdx.x; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    float x = 0.0f;
    if (qi < sq)
      x = to_f32(q[(((long long)b * sq + qi) * h + head) * HD + d]) * scale;
    qs[r][d] = x;
  }

  // The key range.  When every real row of the tile has a valid key, keys
  // masked for all rows are skipped (exact, see the header).
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + BQ, sq) - 1;
  const bool all_rows_valid = (!causal || qp_lo >= 0) &&
                              (!window || qp_hi - window + 1 <= skv - 1);
  int k_lo = 0, k_hi = skv;
  if (all_rows_valid) {
    if (causal) k_hi = min(skv, qp_hi + 1);
    if (window) k_lo = max(0, qp_lo - window + 1);
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.0f;
  }
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int i = threadIdx.x; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < skv) {
        const long long off = (((long long)b * skv + key) * kv + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    // Scores: this lane's key against the warp's R rows.
    const int key = k0 + lane;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = s[r] + qs[warp * R + r][d] * kd;
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qp = qp_lo + warp * R + r;
      float x = -INFINITY;              // past Skv: adds exactly 0
      if (key < skv) {
        const bool ok = (!causal || qp >= key) && (!window || qp - key < window);
        x = ok ? s[r] : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] = acc[r][c] * corr;
      m[r] = m_new;
      ps[warp][r][lane] = p;
    }
    __syncwarp();

    // acc += p @ v: this lane's output dims over the tile's keys.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = ps[warp][r][j];
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = acc[r][c] + pj * vv[c];
      }
    }
    __syncthreads();                    // before the next tile is staged
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* dst = out + (((long long)b * sq + qi) * h + head) * HD;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      dst[lane + 32 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int sq, int skv, int h, int kv, int causal,
                   int window, int q_offset, float scale,
                   cudaStream_t stream) {
  // R rows per warp: 8 keeps shared memory under the 48 KB static limit
  // up to hd 64; hd 128 takes 4.
  constexpr int R = HD <= 64 ? 8 : 4;
  constexpr int BQ = kWarps * R;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_kernel<T, HD, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, h, kv, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int b, int sq, int skv, int h, int kv,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, sq, skv, h, kv, causal, window,
                           q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, skv, h, kv, causal, window,
                           q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, skv, h, kv, causal, window,
                            q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16; hd 32, 64 or 128; the wrapper checks shapes and contiguity.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int b, int sq, int skv, int h, int kv,
                                   int hd, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || kv <= 0 || h % kv) return cudaErrorInvalidValue;
  if (dtype == F32)
    return dispatch_hd<float>(hd, q, k, v, out, b, sq, skv, h, kv, causal,
                              window, q_offset, scale, s);
  if (dtype == BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, b, sq, skv, h, kv,
                                      causal, window, q_offset, scale, s);
  return cudaErrorInvalidValue;
}
