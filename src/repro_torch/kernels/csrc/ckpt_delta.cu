// Blockwise int8 delta quantization of a checkpoint leaf, and its inverse,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/ckpt_delta.py::quantize_delta_pallas  (_quant_kernel)
//   src/repro/kernels/ckpt_delta.py::_dequant_blocks_pallas (_dequant_kernel)
// The plain versions are repro_torch/kernels/ckpt_delta.py::
// quantize_delta_ref / dequantize_delta_ref, copies of the JAX package's
// ref.quantize_delta_ref / dequantize_delta_ref.
//
// quantize: delta = f32(cur) - f32(base), flattened and cut into blocks of
//   256 (a missing tail counts as delta 0, like the reference's zero
//   padding); per block scale = absmax > 0 ? absmax / 127 : 1, and
//   q = clip(round_half_even(delta / scale), -127, 127) as int8.
// dequantize: out = T(f32(base) + f32(q) * scale[block]), padding dropped.
//
// Layout: one warp owns one 256-element block; each lane loads 8
// consecutive elements (one 16-byte load for 2-byte types, two for fp32),
// so a warp reads its block in one coalesced sweep.  The block's absmax is
// a butterfly of warp shuffles; no shared memory.  The dequantize pass is
// elementwise, 8 elements per thread.  The TPU kernel's (8, 256) VMEM
// tiles on a sequential grid become independent warps: there is nothing
// to carry between blocks.  Inputs are read in their own dtype (fp32 or
// bf16, the dtypes of the port's train states); the kernel makes no padded
// fp32 copy first.
//
// Bound: bytes.  Per element quantize reads cur and base and writes one
// int8: 9 bytes for fp32, 5 for bf16, plus 4 bytes of scale per block;
// dequantize reads q and base and writes out: the same counts.  A few
// float ops per element, no tensor-core work.
//
// Bitwise contract with the plain versions (and the reference):
//   * IEEE division (__fdiv_rn) for absmax / 127 and delta / scale, never
//     a multiply by a reciprocal;
//   * rintf rounds half to even, as jnp.round and torch.round do (roundf
//     would round half away from zero);
//   * absmax propagates NaN as jnp.max does (fmaxf would drop it); a NaN
//     absmax fails `> 0`, so that block's scale is 1;
//   * built with --fmad=false and written with __fmul_rn / __fadd_rn, so
//     base + q * scale is two roundings, as in eager torch;
//   * a NaN quotient becomes q = 0, the float-to-int conversion's result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;       // quantization block (elements)
constexpr int kPerThread = 8;     // elements per lane
constexpr int kWarpsPerCta = 8;   // blocks per CTA in quantize
constexpr int kThreads = 256;

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

// max that returns NaN if either operand is NaN (jnp.max / torch.amax).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Elements i0 .. i0+7 of p as float; past n they read as 0.  The 16-byte
// vector path is taken when the pointer is aligned (vec) and all 8 are in
// range; the last, partial group of a leaf is read element by element.
template <typename T>
__device__ __forceinline__ void load8(const T* p, long long i0, long long n,
                                      bool vec, float out[kPerThread]) {
  if (vec && i0 + kPerThread <= n) {
    constexpr int kWords = kPerThread * sizeof(T) / 16;
    uint4 w[kWords];
    const uint4* src = reinterpret_cast<const uint4*>(p + i0);
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = src[k];
    const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) out[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      out[j] = (i0 + j < n) ? to_f32(p[i0 + j]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, long long i0, long long n,
                                       bool vec,
                                       const float v[kPerThread]) {
  if (vec && i0 + kPerThread <= n) {
    constexpr int kWords = kPerThread * sizeof(T) / 16;
    uint4 w[kWords];
    T* e = reinterpret_cast<T*>(w);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) e[j] = from_f32<T>(v[j]);
    uint4* dst = reinterpret_cast<uint4*>(p + i0);
#pragma unroll
    for (int k = 0; k < kWords; ++k) dst[k] = w[k];
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (i0 + j < n) p[i0 + j] = from_f32<T>(v[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ cur, const T* __restrict__ base,
                long long n, long long n_blocks, bool vec,
                int8_t* __restrict__ q, float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // the whole warp leaves together
  const long long i0 = blk * kBlock + lane * kPerThread;

  float c[kPerThread], b[kPerThread], d[kPerThread];
  load8(cur, i0, n, vec, c);
  load8(base, i0, n, vec, b);
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    d[j] = __fsub_rn(c[j], b[j]);
    amax = nan_max(amax, fabsf(d[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float scale = (amax > 0.0f) ? __fdiv_rn(amax, 127.0f) : 1.0f;
  union {
    int8_t v[kPerThread];
    uint2 word;
  } out;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    float r = rintf(__fdiv_rn(d[j], scale));
    r = (r != r) ? 0.0f : fminf(fmaxf(r, -127.0f), 127.0f);
    out.v[j] = static_cast<int8_t>(static_cast<int>(r));
  }
  // q holds n_blocks * 256 entries, so every lane's 8 are in range.
  *reinterpret_cast<uint2*>(q + i0) = out.word;
  if (lane == 0) scales[blk] = scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales,
                  const T* __restrict__ base, long long n, bool vec,
                  T* __restrict__ out) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) *
      kPerThread;
  if (i0 >= n) return;
  const float s = scales[i0 / kBlock];  // 8 | 256: one block per thread
  union {
    int8_t v[kPerThread];
    uint2 word;
  } qv;
  qv.word = *reinterpret_cast<const uint2*>(q + i0);
  float b[kPerThread], r[kPerThread];
  load8(base, i0, n, vec, b);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    r[j] = __fadd_rn(b[j], __fmul_rn(static_cast<float>(qv.v[j]), s));
  store8(out, i0, n, vec, r);
}

template <typename T>
void launch_quantize(const void* cur, const void* base, long long n,
                     bool vec, void* q, void* scales, cudaStream_t stream) {
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  const long long ctas = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  quantize_kernel<T><<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(
      static_cast<const T*>(cur), static_cast<const T*>(base), n, n_blocks,
      vec, static_cast<int8_t*>(q), static_cast<float*>(scales));
}

template <typename T>
void launch_dequantize(const void* q, const void* scales, const void* base,
                       long long n, bool vec, void* out,
                       cudaStream_t stream) {
  const long long groups = (n + kPerThread - 1) / kPerThread;
  const long long ctas = (groups + kThreads - 1) / kThreads;
  dequantize_kernel<T><<<static_cast<unsigned>(ctas), kThreads, 0,
                         stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<const T*>(base), n, vec, static_cast<T*>(out));
}

}  // namespace

// C entry points, loaded with ctypes.  dtype: 0 fp32, 1 bf16.  vec != 0
// allows 16-byte vector access (every pointer 16-byte aligned).  q is
// (ceil(n/256), 256) int8 and scales (ceil(n/256),) fp32.  Each launches
// on `stream` and returns cudaGetLastError() (0 on success); neither
// synchronises.
extern "C" int ckpt_quantize_delta(const void* cur, const void* base,
                                   int dtype, long long n, int vec, void* q,
                                   void* scales, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: launch_quantize<float>(cur, base, n, vec, q, scales, s); break;
    case BF16:
      launch_quantize<__nv_bfloat16>(cur, base, n, vec, q, scales, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ckpt_dequantize_delta(const void* q, const void* scales,
                                     const void* base, int dtype,
                                     long long n, int vec, void* out,
                                     void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      launch_dequantize<float>(q, scales, base, n, vec, out, s);
      break;
    case BF16:
      launch_dequantize<__nv_bfloat16>(q, scales, base, n, vec, out, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
