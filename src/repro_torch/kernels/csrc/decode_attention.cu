// One-token GQA attention against a KV cache (flash decoding in one
// clustered launch), hand-written for Hopper (sm_90a).
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
// Bound: bytes.  The valid k and v prefix of every (batch, kv head) is read
// once (2 * lim * KV * hd * itemsize per batch row), plus q, length and the
// output; the arithmetic (~1.4e8 flops a call at the serving cell) is
// nothing beside it.  The design it replaced (split-KV: a warp per 64
// entries reading k and v straight from device memory, about 1 KB in
// flight a warp in p @ v, and a second launch of 32 blocks to merge the
// splits, with three scratch tensors) took 0.080 ms a call over the 22
// layers' last-step inputs on the H100, 0.067 of its bound (PERF.md's
// kernel table, the earlier design).
//
// Design: one launch.  A cluster of kCluster = 8 blocks serves one (batch,
// kv head): 256 blocks at B 8, KV 4 on the card's 132 SMs.  Block rank c
// takes the c-th contiguous eighth of the keys that are read and streams
// their k and v rows through a ring of shared-memory stages of 64 keys by
// cp.async 16-byte copies (16 KB a stage at hd 64 bf16).  The ring holds
// as many stages as fit the block's 227 KB beside the rest, at most 3 (two
// tiles in flight while one is used): 3 up to hd 128, 2 at hd 256 bf16 (64
// KB a stage) and 1 at hd 256 fp32 (128 KB a stage, the next tile loaded
// only once the block is done with this one).  Rows are stored with their
// 16-byte chunks swizzled by the row so that lanes on different rows hit
// different banks.  A block has 8 warps.  Per tile, a thread per (key, quarter of the
// heads) computes the scores, each k row read once for its g heads (the
// GQA saving the TPU kernel gets from its (g, hd) q block); a warp per head
// keeps the block's online softmax (m, l) in f32; and a thread per (4 dims,
// heads, 16 of the 64 keys) accumulates p @ v, each v row read once.  At
// the end the four key quarters' sums are added (in order) into the
// block's partial (m, l, acc[g][hd]) in its shared memory; after a cluster
// barrier, block c merges head c (and c + 8, ...) over the cluster's
// blocks through distributed shared memory (map_shared_rank):
// M = max m_i, out = sum(acc_i * exp(m_i - M)) / max(sum(l_i exp(m_i - M)),
// 1e-30); a second cluster barrier keeps every block's shared memory alive
// until the merges have read it.  No scratch in device memory.
//
// Lengths: the grid covers all of S (the lengths live on the device and are
// not read by the host).  hi = (lim > 0 ? min(lim, S) : S) keys are read:
// with lim = 0 every key scores -1e30, which gives the reference's uniform
// average over all S entries, and lim > S (a full cache) reads all S.  A
// block whose eighth is empty (hi < 8) leaves m = -1e30, l = 0, acc = 0 and
// adds exactly 0 (weight exp(-1e30 - M) = 0, or l = 0 when M = -1e30); rows
// of a tile past the block's range are zero-filled and score -inf, p = 0.
// Arithmetic is fp32 on the CUDA cores for both dtypes (dot products and
// p @ v as fused fp32 multiply-adds, expf, an IEEE divide), so fp32 inputs
// stay within 2e-6 of the plain version.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCluster = 8;         // blocks per (batch, kv head)
constexpr int kTile = 64;           // keys per stage
constexpr int kMaxStages = 3;
constexpr int kSmemMax = 227 * 1024;    // dynamic shared memory of a block
constexpr int kQuarters = 4;        // p @ v: each thread takes 16 of 64 keys
constexpr unsigned kFull = 0xffffffffu;

enum DType { F32 = 0, BF16 = 1 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// 16 bytes global -> shared, zero-filled when !valid (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// A 16-byte chunk of a row in shared memory, as f32.
__device__ __forceinline__ void chunk_f32(const float* p, float out[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p,
                                          float out[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
}

// Four consecutive elements of a row in shared memory, as f32.
__device__ __forceinline__ void four_f32(const float* p, float out[4]) {
  chunk_f32(p, out);
}
__device__ __forceinline__ void four_f32(const __nv_bfloat16* p,
                                         float out[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(e[i]);
}

// G is the largest g this instantiation takes; heads r >= g are idle.
template <typename T, int HD, int G>
struct Layout {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kChunks = kRowBytes / 16;          // per row
  static constexpr int kElems = 16 / (int)sizeof(T);      // per chunk
  static constexpr int kSwz = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kScW = kTile + 1;                  // score row
  // Shared memory, in bytes from the base: the k/v ring (after the loop,
  // the p @ v quarters' sums), q rows (f32, times scale), scores / p,
  // per-head corr, and the block's partial (m, l, acc).  The ring takes
  // the stages that fit beside the rest (kRest), at most kMaxStages.
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;
  static constexpr int kRest = G * HD * 4 + G * kScW * 4 + 3 * G * 4 +
                               G * HD * 4;
  static constexpr int kFit = (kSmemMax - kRest) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static_assert(kStages >= 1, "one k/v stage fits shared memory");
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kQ = kRing;
  static constexpr int kSc = kQ + G * HD * 4;
  static constexpr int kCorr = kSc + G * kScW * 4;
  static constexpr int kM = kCorr + G * 4;
  static constexpr int kL = kM + G * 4;
  static constexpr int kAcc = kL + G * 4;
  static constexpr int kBytes = kAcc + G * HD * 4;
  static_assert(kBytes <= kSmemMax, "a block's shared memory fits 227 KB");
  static_assert(kQuarters * G * HD * 4 <= kRing, "quarter sums fit the ring");
  // Byte offset of chunk c of row r of k (kv = 0) or v (kv = 1) in stage st.
  static __device__ __forceinline__ int at(int st, int kv, int r, int c) {
    return ((st * 2 + kv) * kTile + r) * kRowBytes + ((c ^ (r & kSwz)) << 4);
  }
};

template <typename T, int HD, int G>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ length,
              T* __restrict__ out, int s, int h, int kv, int g, int window,
              float scale) {
  using L = Layout<T, HD, G>;
  constexpr int NQ = (G + 3) / 4;         // heads a thread scores
  constexpr int NH = (G + kWarps - 1) / kWarps;   // heads a warp keeps
  constexpr int DC = HD / 4;              // 4-dim groups of a head
  constexpr int HS = kThreads / (DC * kQuarters);  // head slots in p @ v
  constexpr int NR = (G + HS - 1) / HS;   // heads a thread accumulates
  constexpr int KQ = kTile / kQuarters;   // keys a thread accumulates
  extern __shared__ __align__(16) uint8_t smem[];
  float* const qs = reinterpret_cast<float*>(smem + L::kQ);
  float* const sc = reinterpret_cast<float*>(smem + L::kSc);
  float* const corr_s = reinterpret_cast<float*>(smem + L::kCorr);
  float* const part_m = reinterpret_cast<float*>(smem + L::kM);
  float* const part_l = reinterpret_cast<float*>(smem + L::kL);
  float* const part_acc = reinterpret_cast<float*>(smem + L::kAcc);
  float* const quarter = reinterpret_cast<float*>(smem);   // after the loop
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int len = length[b];
  const int lim = window ? min(len, window) : len;
  const int hi = lim > 0 ? min(lim, s) : s;   // keys this row reads
  const int per = (hi + kCluster - 1) / kCluster;
  const int k0 = min(rank * per, hi);
  const int k1 = min(k0 + per, hi);
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;
  const long long stride = (long long)kv * HD;          // between keys
  const T* kbase = kc + ((long long)b * s * kv + kvh) * HD;
  const T* vbase = vc + ((long long)b * s * kv + kvh) * HD;

  constexpr int S = L::kStages;
  // Stage tile t (keys k0 + 64 t ..) into ring slot t % S.
  auto load = [&](int t) {
    const int st = t % S;
#pragma unroll
    for (int it = 0; it < 2 * kTile * L::kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int kvsel = i / (kTile * L::kChunks);
      const int r = (i / L::kChunks) % kTile, c = i % L::kChunks;
      const int key = k0 + t * kTile + r;
      const bool valid = key < k1;
      const T* src = (kvsel ? vbase : kbase) +
                     (valid ? key : 0) * stride + c * L::kElems;
      cp_async16(ring + L::at(st, kvsel, r, c), src, valid);
    }
  };
  // S - 1 tiles ahead (one stage: tile 0, the next after each tile).
#pragma unroll
  for (int t = 0; t < (S > 1 ? S - 1 : 1); ++t) {
    if (t < n_tiles) load(t);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // The q rows while the first tiles are in flight.
  for (int i = tid; i < G * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    qs[i] = r < g
        ? to_f32(q[((long long)b * h + kvh * g + r) * HD + d]) * scale
        : 0.0f;
  }

  // Softmax state of the heads this warp keeps (warp + 8 i); p @ v sums of
  // this thread's heads (hs + HS i), dims 4 dg .. 4 dg + 3 and keys
  // 16 kq .. 16 kq + 15 of each tile.
  float m[NH], l[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  const int dg = tid % DC, kq = (tid / DC) % kQuarters;
  const int hs = tid / (DC * kQuarters);
  float acc[NR][4];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S > 1 ? S - 2 : 0)
                 : "memory");
    __syncthreads();              // tile t is in; tile t - 1 is done with
    if constexpr (S > 1) {
      if (t + S - 1 < n_tiles) load(t + S - 1);
      asm volatile("cp.async.commit_group;\n" ::);
    }

    // Scores: key j against heads (tid / 64) + 4 i; the k row is read once
    // for them, a 16-byte chunk at a time.
    {
      const int j = tid % kTile, h0 = tid / kTile;
      float sco[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i) sco[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c) {
        float kx[L::kElems];
        chunk_f32(reinterpret_cast<const T*>(smem + L::at(st, 0, j, c)), kx);
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          const int r = h0 + 4 * i;
          if (r >= g) break;
          const float4* qr = reinterpret_cast<const float4*>(
              qs + r * HD + c * L::kElems);
#pragma unroll
          for (int e4 = 0; e4 < L::kElems / 4; ++e4) {
            const float4 qv = qr[e4];
            sco[i] = fmaf(qv.x, kx[4 * e4], sco[i]);
            sco[i] = fmaf(qv.y, kx[4 * e4 + 1], sco[i]);
            sco[i] = fmaf(qv.z, kx[4 * e4 + 2], sco[i]);
            sco[i] = fmaf(qv.w, kx[4 * e4 + 3], sco[i]);
          }
        }
      }
      const int key = k0 + t * kTile + j;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int r = h0 + 4 * i;
        if (r >= g) break;
        sc[r * L::kScW + j] =
            key < k1 ? (key < lim ? sco[i] : kNegInf) : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax of head warp + 8 i over the tile; lane owns keys lane
    // and lane + 32.
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int r = warp + kWarps * i;
      if (r >= g) break;
      float* row = sc + r * L::kScW;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_new = fmaxf(m[i], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p0 + p1);
      m[i] = m_new;
      row[lane] = p0;
      row[lane + 32] = p1;
      if (lane == 0) corr_s[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p @ v over this thread's 16 keys of the tile.
    constexpr int boff = (int)sizeof(T) * 4;        // bytes of 4 dims
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = hs + HS * i;
      if (r >= g) break;
      const float cr = corr_s[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = acc[i][e] * cr;
    }
#pragma unroll
    for (int jj = 0; jj < KQ; ++jj) {
      const int j = kq * KQ + jj;
      const int byte = dg * boff;
      float vx[4];
      four_f32(reinterpret_cast<const T*>(
                   smem + L::at(st, 1, j, byte >> 4) + (byte & 15)), vx);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = hs + HS * i;
        if (r >= g) break;
        const float p = sc[r * L::kScW + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p, vx[e], acc[i][e]);
      }
    }
    if constexpr (S == 1) {       // the one stage is free again
      __syncthreads();
      if (t + 1 < n_tiles) load(t + 1);
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

  // This block's partial: (m, l) from the softmax warps, acc as the sum of
  // the four key quarters (in the ring, free now), then the merge across
  // the cluster.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int r = warp + kWarps * i;
    if (r < g && lane == 0) {
      part_m[r] = m[i];
      part_l[r] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = hs + HS * i;
    if (r >= g) break;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      quarter[(kq * G + r) * HD + 4 * dg + e] = acc[i][e];
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    float x = quarter[i];
#pragma unroll
    for (int k4 = 1; k4 < kQuarters; ++k4) x = x + quarter[k4 * G * HD + i];
    part_acc[i] = x;
  }
  cluster.sync();

  for (int r = rank; r < g; r += kCluster) {
    for (int d = tid; d < HD; d += kThreads) {
      float big = kNegInf;
#pragma unroll
      for (int c = 0; c < kCluster; ++c)
        big = fmaxf(big, cluster.map_shared_rank(part_m, c)[r]);
      float den = 0.0f, num = 0.0f;
#pragma unroll
      for (int c = 0; c < kCluster; ++c) {
        const float w = expf(cluster.map_shared_rank(part_m, c)[r] - big);
        den = den + cluster.map_shared_rank(part_l, c)[r] * w;
        num = num + cluster.map_shared_rank(part_acc, c)[r * HD + d] * w;
      }
      out[((long long)b * h + kvh * g + r) * HD + d] =
          from_f32<T>(num / fmaxf(den, 1e-30f));
    }
  }
  cluster.sync();                 // the partials are read; blocks may exit
}

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* length, void* out, int b, int s, int h, int kv,
                   int window, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<T, HD, G>::kBytes;
  auto kernel = decode_kernel<T, HD, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(kCluster, kv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), length, static_cast<T*>(out), s, h, kv,
      h / kv, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(const void* q, const void* kc, const void* vc,
                       const int* length, void* out, int b, int s, int h,
                       int kv, int window, float scale, cudaStream_t stream) {
  const int g = h / kv;
  if (g <= 4)
    return launch<T, HD, 4>(q, kc, vc, length, out, b, s, h, kv, window,
                            scale, stream);
  if (g <= 8)
    return launch<T, HD, 8>(q, kc, vc, length, out, b, s, h, kv, window,
                            scale, stream);
  if (g <= 16)
    return launch<T, HD, 16>(q, kc, vc, length, out, b, s, h, kv, window,
                             scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* kc,
                        const void* vc, const int* length, void* out, int b,
                        int s, int h, int kv, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return dispatch_g<T, 32>(q, kc, vc, length, out, b, s, h, kv, window,
                               scale, stream);
    case 64:
      return dispatch_g<T, 64>(q, kc, vc, length, out, b, s, h, kv, window,
                               scale, stream);
    case 128:
      return dispatch_g<T, 128>(q, kc, vc, length, out, b, s, h, kv, window,
                                scale, stream);
    case 256:
      return dispatch_g<T, 256>(q, kc, vc, length, out, b, s, h, kv, window,
                                scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16; hd 32, 64, 128 or 256; H / KV at most 16.  The wrapper checks shapes
// and that both caches start on a 16-byte boundary (cp.async).
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const int* length,
                                    void* out, int dtype, int b, int s,
                                    int h, int kv, int hd, int window,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h <= 0 || kv <= 0 || h % kv) return cudaErrorInvalidValue;
  if (dtype == F32)
    return dispatch_hd<float>(hd, q, kc, vc, length, out, b, s, h, kv,
                              window, scale, st);
  if (dtype == BF16)
    return dispatch_hd<__nv_bfloat16>(hd, q, kc, vc, length, out, b, s, h,
                                      kv, window, scale, st);
  return cudaErrorInvalidValue;
}
