// One-token GQA attention against a KV cache (split-KV flash decoding),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention.py::decode_attention_pallas (_kernel)
// The plain version is repro_torch/kernels/decode_attention.py::
// decode_attention_ref, a copy of the JAX package's ref.decode_attention_ref.
//
// Contract: q (B, 1, H, hd), caches (B, S, KV, hd), contiguous, fp32 or
// bf16; length (B,) int32 on the device.  The g = H / KV query heads
// kv * g .. kv * g + g - 1 share kv head kv.  Cache entry j of row b is
// valid iff j < lim = (window ? min(length[b], window) : length[b]); the
// others score NEG_INF = -1e30.  s = (f32(q) * scale) . f32(k_j),
// out = softmax(s) @ f32(v), cast to q's dtype.
//
// Layout, pass 1 (decode_split_kernel): the cache axis is cut into splits
// of kSplit = 64 keys; one warp per (split, kv head, batch row), 4 warps a
// block, the block's g query rows (times scale, f32) in shared memory.  The
// warp walks its split in tiles of 32 keys.  For the scores a lane owns one
// key: it reads the key's whole row in 16-byte loads and dots it with the g
// q rows (broadcast reads), so each k row is read once for its g heads (the
// GQA saving the TPU kernel gets from its (g, hd) q block) and no
// cross-lane sum is needed.  For p @ v a lane owns hd / 32 consecutive
// dims, key j's p comes from lane j by shuffle, and each v row is read once
// in one coalesced sweep.  Lanes past the split's end read its last row and
// take p = 0, so the loops have no branch and their loads can be issued
// together.  Per tile the warp keeps an online softmax (m, l, acc) per row
// and writes it to f32 scratch at the end.  Pass 2 (decode_combine_kernel)
// merges the splits of each (batch, kv head): M = max m_i,
// out = sum(acc_i * exp(m_i - M)) / max(sum(l_i * exp(m_i - M)), 1e-30).
// The TPU kernel's sequential cache axis becomes splits that run in
// parallel: at B * KV = 32 (tinyllama-1.1b, batch 8) a block per
// (batch, kv head) would fill 32 of the card's 132 SMs.
//
// Lengths: the grid covers all of S (the lengths live on the device and
// are not read by the host).  With lim > 0, keys at or past lim are not
// read: a split that lies wholly past lim writes m = -1e30, l = 0, acc = 0,
// and adds exactly 0 in pass 2 (weight exp(-1e30 - M) = 0); a key past lim
// inside a split scores -inf and takes p = 0.  Both are what NEG_INF gives
// in the reference once a valid key has set the max.  With lim = 0 every
// key is read and scores -1e30, which gives the reference's uniform
// average over all S entries.  lim > S (a full cache) reads all S.
//
// Bound: bytes.  The valid k and v prefix of every (batch, kv head) is read
// once (2 * lim * KV * hd * itemsize per batch row), plus q, length and the
// output; the scratch adds (hd + 2) floats per (split, row) each way.
// Arithmetic is fp32 on the CUDA cores (--fmad=false, expf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 64;          // keys per split (one warp)
constexpr int kCombineThreads = 256;
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

// Eight consecutive elements of a row, as f32, in 16-byte loads (the
// wrapper passes a k cache aligned to 16 bytes; HD is a multiple of 8).
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 w = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

// DPL consecutive elements of a row, as f32.
template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* p, float out[DPL]) {
#pragma unroll
  for (int e = 0; e < DPL; ++e) out[e] = to_f32(p[e]);
}

// G is the largest g this instantiation takes; rows r >= g are idle.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ length,
                    int s, int h, int kv, int g, int window, float scale,
                    int n_splits, float* __restrict__ part_m,
                    float* __restrict__ part_l,
                    float* __restrict__ part_acc) {
  constexpr int DPL = HD / 32;
  __shared__ __align__(16) float qs[G][HD];   // q rows times scale, in f32
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int split = blockIdx.x * kWarps + warp;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[r][d] = r < g
        ? to_f32(q[((long long)b * h + kvh * g + r) * HD + d]) * scale
        : 0.0f;
  }
  __syncthreads();
  if (split >= n_splits) return;       // whole warp; no barrier below

  const int len = length[b];
  const int lim = window ? min(len, window) : len;
  const int hi = lim > 0 ? min(lim, s) : s;   // keys this row reads
  const int k0 = split * kSplit;
  const int k1 = min(k0 + kSplit, hi);
  const long long stride = (long long)kv * HD;          // between keys
  const T* kbase = kc + ((long long)b * s * kv + kvh) * HD;
  const T* vbase = vc + ((long long)b * s * kv + kvh) * HD;

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  }

  for (int t0 = k0; t0 < k1; t0 += 32) {
    // Scores: lane j owns key t0 + j and reads its whole row.  A lane past
    // k1 reads row k1 - 1 (in bounds) and scores -inf, so p = 0 exactly.
    const int key = t0 + lane;
    const T* krow = kbase + min(key, k1 - 1) * stride;
    float sc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) sc[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < HD; c += 8) {
      float kx[8];
      load8(krow + c, kx);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r >= g) break;
#pragma unroll
        for (int i = 0; i < 8; ++i) sc[r] = sc[r] + qs[r][c + i] * kx[i];
      }
    }

    float p[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      p[r] = 0.0f;
      if (r >= g) continue;
      const float mine = key < k1 ? (key < lim ? sc[r] : kNegInf) : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(mine));
      p[r] = expf(mine - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = acc[r][e] * corr;
      m[r] = m_new;
    }

    // acc += p @ v: lane owns DPL dims; key j's p comes from lane j.
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      float vx[DPL];
      load_row<T, DPL>(vbase + min(t0 + j, k1 - 1) * stride + lane * DPL,
                       vx);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r >= g) break;
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = acc[r][e] + pj * vx[e];
      }
    }
  }

  const long long row0 = (((long long)b * kv + kvh) * n_splits + split) * g;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= g) break;
    if (lane == 0) {
      part_m[row0 + r] = m[r];
      part_l[row0 + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      part_acc[(row0 + r) * HD + lane * DPL + e] = acc[r][e];
  }
}

// One block per (batch, kv head); a thread per (query row, dim).  The
// split loops are unrolled so that their loads are in flight together.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, int hd, int g,
                      int n_splits, T* __restrict__ out) {
  const long long bk = blockIdx.x;                     // b * KV + kv head
  for (int i = threadIdx.x; i < g * hd; i += kCombineThreads) {
    const int r = i / hd, d = i % hd;
    const float* pm = part_m + bk * n_splits * g + r;
    const float* pl = part_l + bk * n_splits * g + r;
    const float* pa = part_acc + (bk * n_splits * g + r) * hd + d;
    float big = kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp) big = fmaxf(big, pm[sp * g]);
    float den = 0.0f, num = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < n_splits; ++sp) {
      const float w = expf(pm[sp * g] - big);
      den = den + pl[sp * g] * w;
      num = num + pa[(long long)sp * g * hd] * w;
    }
    out[(bk * g + r) * hd + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* length, int b, int s, int h, int kv, int window,
                   float scale, float* part_m, float* part_l,
                   float* part_acc, int n_splits, void* out,
                   cudaStream_t stream) {
  const int g = h / kv;
  dim3 grid((n_splits + kWarps - 1) / kWarps, kv, b);
  decode_split_kernel<T, HD, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), length, s, h, kv, g, window, scale,
      n_splits, part_m, part_l, part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<b * kv, kCombineThreads, 0, stream>>>(
      part_m, part_l, part_acc, HD, g, n_splits, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const void* q, const void* kc, const void* vc,
                       const int* length, int b, int s, int h, int kv,
                       int window, float scale, float* part_m, float* part_l,
                       float* part_acc, int n_splits, void* out,
                       cudaStream_t stream) {
  const int g = h / kv;
  if (g <= 4)
    return launch<T, HD, 4>(q, kc, vc, length, b, s, h, kv, window, scale,
                            part_m, part_l, part_acc, n_splits, out, stream);
  if (g <= 8)
    return launch<T, HD, 8>(q, kc, vc, length, b, s, h, kv, window, scale,
                            part_m, part_l, part_acc, n_splits, out, stream);
  if (g <= 16)
    return launch<T, HD, 16>(q, kc, vc, length, b, s, h, kv, window, scale,
                             part_m, part_l, part_acc, n_splits, out, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kc,
                        const void* vc, const int* length, int b, int s,
                        int h, int kv, int window, float scale, float* part_m,
                        float* part_l, float* part_acc, int n_splits,
                        void* out, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return dispatch_g<T, 32>(q, kc, vc, length, b, s, h, kv, window, scale,
                               part_m, part_l, part_acc, n_splits, out,
                               stream);
    case 64:
      return dispatch_g<T, 64>(q, kc, vc, length, b, s, h, kv, window, scale,
                               part_m, part_l, part_acc, n_splits, out,
                               stream);
    case 128:
      return dispatch_g<T, 128>(q, kc, vc, length, b, s, h, kv, window,
                                scale, part_m, part_l, part_acc, n_splits,
                                out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the two launches (0 on success).  dtype: 0
// fp32, 1 bf16; hd 32, 64 or 128; H / KV at most 16.  The scratch holds
// B * KV * n_splits * g floats (m, l) and that times hd (acc), with
// n_splits = ceil(S / 64); the wrapper allocates it and checks shapes.
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const int* length,
                                    int dtype, int b, int s, int h, int kv,
                                    int hd, int window, float scale,
                                    float* part_m, float* part_l,
                                    float* part_acc, int n_splits, void* out,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h <= 0 || kv <= 0 || h % kv || n_splits != (s + kSplit - 1) / kSplit)
    return cudaErrorInvalidValue;
  if (dtype == F32)
    return dispatch_hd<float>(hd, q, kc, vc, length, b, s, h, kv, window,
                              scale, part_m, part_l, part_acc, n_splits, out,
                              st);
  if (dtype == BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, kc, vc, length, b, s, h, kv,
                                      window, scale, part_m, part_l,
                                      part_acc, n_splits, out, st);
  return cudaErrorInvalidValue;
}
