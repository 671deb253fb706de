// RMSNorm for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm/kernel.py:25
// (rmsnorm_tpu, body _rmsnorm_kernel at :18): per row of x (rows, d),
//     y = x * rsqrt(mean(x^2) + eps) [* w]
// with the statistics and the scaling in float32 and y cast back to x's
// dtype (float32 or bfloat16).  w may be absent (the plain rms_norm with
// w=None) and may be float32 or bfloat16 independently of x.
//
// Bound: device memory bandwidth.  The kernel must read each x element
// once and write each y element once (plus d weights, cached); it does
// ~4 flops an element.  The TPU kernel holds a (block_rows, d) tile in
// VMEM; here one warp owns one row: 16-byte vector loads (4 float32 or 8
// bfloat16 a lane, neighbouring lanes on neighbouring addresses), a
// float32 sum of squares per lane, a warp-shuffle reduction, then a
// second sweep of the same row (an L1/L2 hit at these row sizes: 2.3 KB
// for gemma3's d = 1152) that scales and stores.  No shared memory, no
// block-level sync.  Rows or weights that are not 16-byte aligned, and
// the tail of a row that is not a multiple of the vector, go through
// scalar loads, so any d and any row count are taken.
//
// Numerics match the plain version: float32 sum of squares (in another
// order: per-lane partial sums, then a tree), mean = sum / d, rsqrtf,
// then x * r * w.  Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// elements of T in one 16-byte vector
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the weight as float; W is float or __nv_bfloat16 (read through the
// read-only cache: every row of the launch reads the same d weights)
template <typename W>
__device__ __forceinline__ float weight_at(const W* w, int64_t j) {
  return to_f(__ldg(w + j));
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ y, int64_t rows, int64_t d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  constexpr int N = Vec<T>::N;
  const bool vec = aligned16(xr) && aligned16(yr);
  const int64_t nv = vec ? d / N : 0;     // whole vectors in the row
  const int64_t tail = nv * N;            // first scalar element

  // pass 1: float32 sum of squares
  float ss = 0.f;
  for (int64_t g = lane; g < nv; g += 32) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[g];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float f = to_f(e[i]);
      ss += f * f;
    }
  }
  for (int64_t j = tail + lane; j < d; j += 32) {
    const float f = to_f(xr[j]);
    ss += f * f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / float(d) + eps);

  // pass 2: scale (and weight) and store
  for (int64_t g = lane; g < nv; g += 32) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr)[g];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 outv;
    T* o = reinterpret_cast<T*>(&outv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float v = to_f(e[i]) * r;
      if (w != nullptr) v *= weight_at(w, g * N + i);
      o[i] = from_f<T>(v);
    }
    reinterpret_cast<uint4*>(yr)[g] = outv;
  }
  for (int64_t j = tail + lane; j < d; j += 32) {
    float v = to_f(xr[j]) * r;
    if (w != nullptr) v *= weight_at(w, j);
    yr[j] = from_f<T>(v);
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int64_t rows, int64_t d,
           float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  rmsnorm_kernel<T, W><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      rows, d, eps);
  return int(cudaGetLastError());
}

template <typename T>
int launch_w(const void* x, const void* w, void* y, int64_t rows,
             int64_t d, int w_kind, float eps, cudaStream_t stream) {
  switch (w_kind) {
    case 0:   // no weight: the float instantiation with a null pointer
    case 1:
      return launch<T, float>(x, w_kind ? w : nullptr, y, rows, d, eps,
                              stream);
    case 2:
      return launch<T, __nv_bfloat16>(x, w, y, rows, d, eps, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// y = rmsnorm(x) [* w] over the last dim of a contiguous (rows, d) x.
// x_bf16: x and y are bfloat16 (else float32).  w_kind: 0 = no weight,
// 1 = float32 w, 2 = bfloat16 w.  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int repro_rmsnorm(const void* x, const void* w, void* y,
                             int64_t rows, int64_t d, int x_bf16,
                             int w_kind, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_w<__nv_bfloat16>(x, w, y, rows, d, w_kind, eps, s);
  return launch_w<float>(x, w, y, rows, d, w_kind, eps, s);
}
