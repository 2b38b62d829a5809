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
// acc / max(l, 1e-30).  The entry point routes by dtype: bf16 to the
// tensor-core kernel (flash_wgmma_kernel), fp32 to the CUDA-core kernel
// (flash_f32_kernel), which keeps fp32 inputs within 2e-6 of the plain
// version where TF32 tensor cores would not.
//
// Masking, both kernels.  Masked keys score -1e30, not -inf: a row whose
// keys so far are all masked has m = -1e30 and takes p = exp(0) = 1 for
// them; the first valid key then gives corr = exp(-1e30 - m) = 0, which
// wipes them, exactly as in the Pallas kernel (with -inf, exp(-inf + inf)
// would be NaN).  Keys past Skv (the ragged last tile, the seq-96 case)
// score -inf and add exactly 0.  The same argument makes it exact to skip
// key tiles that are masked for every row of the block (above the causal
// diagonal, before the window), as long as every row has a valid key
// somewhere; a block holding a row with no valid key at all walks every
// key, so such a row gets the reference's uniform average.
//
// bf16: bound by operations.  4 * hd flops per valid (row, key) pair at
// the tensor cores' 989 TFLOP/s; the design it replaced (fp32 products on
// the CUDA cores, 32 x 32 tiles, two shared-memory loads per operation)
// took 9.29-9.35 ms at (8, 2048, 32, 64) causal on the H100, 67x its
// bound (PERF.md's kernel table, the earlier design).  Design: one
// warpgroup (4 warps) per 64 query rows of one (batch, head); the q tile
// stays in shared memory, and k/v tiles of 64 keys go through a ring of 2
// shared-memory stages by cp.async 16-byte copies (rows past Sq or Skv
// zero-filled), each tile stored in the 128-byte swizzle that wgmma's
// shared-memory descriptors read, as 64-column atoms: hd 32 is zero-padded
// to one atom, hd 80 (hubert-xlarge) to two (a 160-byte row is ten 16-byte
// copies, chunks 10-15 stay zero), hd 128 is two atoms, hd 256 four (161
// KB of shared memory a block, one block an SM).
//   S = Q K^T: wgmma m64n64k16, bf16 operands from shared memory, f32
//     accumulators, hd / 16 k-steps (the padding is never read); the scale
//     is applied to the f32 scores after the product (the plain version's
//     f32(q) * scale at hd 64, where scale = 1/8 is exact; within f32
//     rounding at hd 32, 80, 128 and 256, where 1/sqrt(hd) is not).
//   Online softmax on the accumulator registers: a row lives in the 4
//     lanes of a quad, reduced with two shuffles; expf, m/l/acc in f32.
//   O += P V: wgmma m64n{padded hd}k16 with P from registers and V from
//     shared memory (transposed operand), f32 accumulators; at hd 80 the
//     m64n128k16 of hd 128, whose 48 padded output columns hold zeros and
//     are not stored; at hd 256 two m64n128k16 halves, O taking 128
//     registers a thread.  P is f32 and the
//     tensor cores take bf16, so P goes in three bf16 parts, p1 = bf16(p),
//     p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), each against the same V
//     tile: v is bf16 and exact, the parts carry p to about 2^-24, and the
//     result stays within one bf16 ulp of the plain version, also near
//     zero outputs (atol 1e-6).  One bf16 rounding of p, or two parts,
//     breaks that check (tests/test_torch_attention_numerics.py emulates
//     all three).  Three parts make 4 products where the plain design has
//     2: twice its tensor work.
// A software pipeline in FA3's order (S of the next tile issued with P V of
// this one, the softmax between them) was no faster on the H100 than this
// plain order: four blocks of this kernel share an SM, so one block's
// softmax already overlaps another's wgmma, and the CUDA-core work of the
// softmax and the split (about 20 instructions per score) bounds it.
// Blocks walk the heaviest causal q tiles first.  Each query head's
// arithmetic is the same whatever the layout, so attn_layout="grouped"
// (g > 1) gives repeat_kv's bits; the g heads of a kv head each stage its
// k/v tiles (no GQA reuse yet).
//
// fp32: bound by operations at the fp32 CUDA-core rate.  One block of 4
// warps per (q tile, head, batch), a q tile of 4 * R rows; 32-key tiles
// staged in shared memory (k rows padded to hd + 1 floats, an odd count,
// so that lane j reading k[j][d] hits bank (j * (hd + 1) + d) % 32, a
// different bank for each lane).  For the scores a lane owns one key; for
// p @ v a lane owns the output dims lane, lane + 32, ... below hd
// (ceil(hd / 32) slots, the last one idle past hd at hd 80).  Separate
// fp32 multiplies and adds (built with --fmad=false, expf not __expf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

enum DType { F32 = 0, BF16 = 1 };

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

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBK = 32;             // keys per tile: one per lane

// The fp32 kernel's shared memory (dynamic: 84 KB at hd 256), in floats
// from the base: the q tile, the k tile (rows padded to hd + 1), the v
// tile and each warp's p rows.
template <int HD, int R>
struct F32Smem {
  static constexpr int kBQ = kWarps * R;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * HD;
  static constexpr int kV = kK + kBK * (HD + 1);
  static constexpr int kP = kV + kBK * HD;
  static constexpr int kBytes = (kP + kWarps * R * kBK) * 4;
};

template <int HD, int R>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int sq, int skv, int h, int kv, int causal, int window,
                 int q_offset, float scale) {
  using L = F32Smem<HD, R>;
  constexpr int BQ = L::kBQ;
  constexpr int DPL = (HD + 31) / 32;   // output dim slots per lane
  extern __shared__ __align__(16) float f32_smem[];
  float (*qs)[HD] = reinterpret_cast<float (*)[HD]>(f32_smem + L::kQ);
  float (*ks)[HD + 1] = reinterpret_cast<float (*)[HD + 1]>(f32_smem + L::kK);
  float (*vs)[HD] = reinterpret_cast<float (*)[HD]>(f32_smem + L::kV);
  float (*ps)[R][kBK] = reinterpret_cast<float (*)[R][kBK]>(f32_smem + L::kP);

  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Slot c holds output dim lane + 32 c, if that is below HD.
  auto dim_ok = [&](int c) { return HD % 32 == 0 || lane + 32 * c < HD; };

  // The q tile, times scale, in f32 (as the Pallas body); rows past Sq
  // read as 0 and are never stored.
  for (int i = threadIdx.x; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qi = q0 + r;
    float x = 0.0f;
    if (qi < sq) x = q[(((long long)b * sq + qi) * h + head) * HD + d] * scale;
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
        kx = k[off];
        vx = v[off];
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
      for (int c = 0; c < DPL; ++c)
        vv[c] = dim_ok(c) ? vs[j][lane + 32 * c] : 0.0f;
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
    float* dst = out + (((long long)b * sq + qi) * h + head) * HD;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (dim_ok(c)) dst[lane + 32 * c] = acc[r][c] / denom;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, int b, int sq, int skv, int h, int kv,
                       int causal, int window, int q_offset, float scale,
                       cudaStream_t stream) {
  // R rows per warp: 8 up to hd 64, 4 above (27 KB of shared memory at hd
  // 80, 43 KB at hd 128, 84 KB at hd 256).
  constexpr int R = HD <= 64 ? 8 : 4;
  constexpr int BQ = kWarps * R;
  constexpr int smem = F32Smem<HD, R>::kBytes;
  auto kernel = flash_f32_kernel<HD, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, skv, h, kv,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kBM = 64;             // query rows per block (one warpgroup)
constexpr int kBN = 64;             // keys per tile
constexpr int kAtom = 64 * 128;     // one 128-byte swizzle atom of 64 rows
constexpr int kParts = 3;           // bf16 parts of P

// Byte offset of 16-byte chunk c of row r in a 64-row tile stored as
// 128-byte swizzle atoms (64 bf16 columns each, one after the other): the
// layout wgmma's SWIZZLE_128B descriptors read.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kAtom + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving register accesses across a wgmma.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) = [d +] A (64 x 16, K-major smem) * B (64 x 16, K-major
// smem)^T.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major
// smem).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major
// smem).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Copy one 64-row tile (rows row0.., HD bf16 columns) into a swizzled
// tile at `dst`; rows at or past `nrows` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int CPR = HD / 8;                 // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < kBN * CPR / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / CPR, c = i % CPR;
    const int row = row0 + r;
    const bool valid = row < nrows;
    const __nv_bfloat16* src = base + (long long)(valid ? row : 0) * row_stride
                               + c * 8;
    cp_async16(dst + swz(r, c), src, valid);
  }
}

// O (64 x 256, f32: o[128] per thread) += P V at hd 256, P (the
// accumulator layout's s[32], overwritten) in kParts bf16 parts.  O is two
// n128 halves (V's atoms 0-1 and 2-3); the parts go one at a time, each
// waited for before the next is split, so that one part's fragments (16
// registers) live beside O instead of all three (48).
__device__ __forceinline__ void pv_parts_hd256(float* o, float* s,
                                               uint32_t vtile) {
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_reg(o[i]);
#pragma unroll
  for (int x = 0; x < kParts; ++x) {
    uint32_t a[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int c = 2 * kk + f / 2, i = f % 2;
        float& r0 = s[4 * c + 2 * i];
        float& r1 = s[4 * c + 2 * i + 1];
        const uint32_t w = pack_bf16(r0, r1);
        a[kk][f] = w;
        const __nv_bfloat162 pb = *reinterpret_cast<const __nv_bfloat162*>(&w);
        r0 = r0 - __low2float(pb);
        r1 = r1 - __high2float(pb);
        fence_reg(a[kk][f]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t at = vtile + kk * 2048;
      wgmma_rs_n128(o, a[kk], gmma_desc(at, kAtom, 1024));
      wgmma_rs_n128(o + 64, a[kk], gmma_desc(at + 2 * kAtom, kAtom, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_reg(o[i]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int sq, int skv, int h,
                   int kv, int causal, int window, int q_offset,
                   float scale) {
  static_assert(HD % 16 == 0, "rows are copied and multiplied in 16s");
  constexpr int HDP = (HD + 63) / 64 * 64;    // columns as stored (padded)
  constexpr int TILE = kBM * HDP * 2;         // bytes of one tile
  constexpr int NO = HDP / 2;                 // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // Tiles: q, then 2 stages of (k, v), each on a 1024-byte boundary (the
  // swizzle's period).
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t qs = base;
  auto ks = [&](int st) { return base + TILE * (1 + 2 * st); };
  auto vs = [&](int st) { return base + TILE * (2 + 2 * st); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * kBM;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (HD < HDP) {                             // zero the padding columns
    for (int i = threadIdx.x; i < 5 * TILE / 16; i += kThreads)
      reinterpret_cast<uint4*>(base_ptr)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + min(q0 + kBM, sq) - 1;
  const bool all_rows_valid = (!causal || qp_lo >= 0) &&
                              (!window || qp_hi - window + 1 <= skv - 1);
  int k_lo = 0, k_hi = skv;
  if (all_rows_valid) {
    if (causal) k_hi = min(skv, qp_hi + 1);
    if (window) k_lo = max(0, qp_lo - window + 1);
  }
  const int n_tiles = (k_hi - k_lo + kBN - 1) / kBN;

  const long long kv_stride = (long long)kv * HD;
  const __nv_bfloat16* kb = k + ((long long)b * skv * kv + kvh) * HD;
  const __nv_bfloat16* vb = v + ((long long)b * skv * kv + kvh) * HD;
  load_tile<HD>(qs, q + (((long long)b * sq + q0) * h + head) * HD,
                (long long)h * HD, 0, sq - q0);
  load_tile<HD>(ks(0), kb, kv_stride, k_lo, skv);
  load_tile<HD>(vs(0), vb, kv_stride, k_lo, skv);
  cp_async_commit();

  // This thread's rows of the 64-row tile (the wgmma accumulator layout):
  // row0 and row0 + 8; its columns within each 8-column group: 2 * (lane %
  // 4) and that + 1.
  const int row0 = warp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int k0 = k_lo + t * kBN;
    if (t + 1 < n_tiles) {
      load_tile<HD>(ks(st ^ 1), kb, kv_stride, k0 + kBN, skv);
      load_tile<HD>(vs(st ^ 1), vb, kv_stride, k0 + kBN, skv);
    }
    cp_async_commit();
    cp_async_wait1();                         // tile t (and q) have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T over hd in k-steps of 16 (not over the padding).
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = 0.0f;
      fence_reg(s[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
      wgmma_ss_n64(s, gmma_desc(qs + off, 16, 1024),
                   gmma_desc(ks(st) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(s[i]);

    // Online softmax on the scores, row by row (i: row0 or row0 + 8).
    const bool edge = k0 + kBN > skv ||
                      (causal && k0 + kBN - 1 > qp_lo) ||
                      (window && qp_hi - k0 >= window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = qp_lo + row0 + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[4 * c + 2 * i + j] * scale;
          if (edge) {
            const int key = k0 + 8 * c + col0 + j;
            const bool ok = (!causal || qp >= key) &&
                            (!window || qp - key < window);
            x = key < skv ? (ok ? x : kNegInf) : -INFINITY;
          }
          s[4 * c + 2 * i + j] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = expf(s[4 * c + 2 * i + j] - m_new);
          s[4 * c + 2 * i + j] = p;
          sum = sum + p;
        }
      }
      sum = sum + __shfl_xor_sync(kFull, sum, 1);
      sum = sum + __shfl_xor_sync(kFull, sum, 2);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HDP / 8; ++c) {
        o[4 * c + 2 * i] = o[4 * c + 2 * i] * corr;
        o[4 * c + 2 * i + 1] = o[4 * c + 2 * i + 1] * corr;
      }
    }

    if constexpr (HDP == 256) {
      pv_parts_hd256(o, s, vs(st));
    } else {
    // P in kParts bf16 parts, as wgmma A fragments: part x, k-step kk
    // (keys 16 kk ..), registers a[x][kk][0..3].
    uint32_t a[kParts][kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        // f: 0 row0 keys +0, 1 row0+8 keys +0, 2 row0 keys +8, 3 row0+8 +8
        const int c = 2 * kk + f / 2, i = f % 2;
        float r0 = s[4 * c + 2 * i], r1 = s[4 * c + 2 * i + 1];
#pragma unroll
        for (int x = 0; x < kParts; ++x) {
          const uint32_t w = pack_bf16(r0, r1);
          a[x][kk][f] = w;
          const __nv_bfloat162 pb =
              *reinterpret_cast<const __nv_bfloat162*>(&w);
          r0 = r0 - __low2float(pb);
          r1 = r1 - __high2float(pb);
        }
      }
    }

    // O += P V, each part against the tile.
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
#pragma unroll
    for (int x = 0; x < kParts; ++x)
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) fence_reg(a[x][kk][f]);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < kParts; ++x) {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        // V tile, keys 16 kk ..: 8-key groups 1024 bytes apart, 64-column
        // atoms kAtom apart.
        const uint64_t dv = gmma_desc(vs(st) + kk * 2048, kAtom, 1024);
        if constexpr (HDP == 64) wgmma_rs_n64(o, a[x][kk], dv);
        else wgmma_rs_n128(o, a[x][kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(o[i]);
    }
    __syncthreads();                          // stage st is free again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + row0 + 8 * i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst = out + (((long long)b * sq + qi) * h + head) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float x0 = o[4 * c + 2 * i] / denom;
      const float x1 = o[4 * c + 2 * i + 1] / denom;
      *reinterpret_cast<uint32_t*>(dst + 8 * c + col0) = pack_bf16(x0, x1);
    }
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int b, int sq, int skv, int h, int kv,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  constexpr int HDP = (HD + 63) / 64 * 64;
  constexpr int smem = 5 * kBM * HDP * 2 + 1024;   // q + 2 x (k, v) + align
  auto kernel = flash_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBM - 1) / kBM, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), sq, skv, h, kv, causal, window,
      q_offset, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, int b, int sq, int skv, int h, int kv,
                   int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  if (dtype == F32)
    return launch_f32<HD>(q, k, v, out, b, sq, skv, h, kv, causal, window,
                          q_offset, scale, stream);
  if (dtype == BF16)
    return launch_bf16<HD>(q, k, v, out, b, sq, skv, h, kv, causal, window,
                           q_offset, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success).  dtype: 0 fp32,
// 1 bf16; hd 32, 64, 80, 128 or 256; the wrapper checks shapes, contiguity and (for
// bf16's 16-byte copies) that q, k and v start on a 16-byte boundary.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int b, int sq, int skv, int h, int kv,
                                   int hd, int causal, int window,
                                   int q_offset, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || kv <= 0 || h % kv) return cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, out, b, sq, skv, h, kv, causal,
                        window, q_offset, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, b, sq, skv, h, kv, causal,
                        window, q_offset, scale, s);
    case 80:
      return launch<80>(dtype, q, k, v, out, b, sq, skv, h, kv, causal,
                        window, q_offset, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, b, sq, skv, h, kv, causal,
                         window, q_offset, scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, b, sq, skv, h, kv, causal,
                         window, q_offset, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
