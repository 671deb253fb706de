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
// once and write each y element once (plus d weights); it does ~4 flops
// an element.  The TPU kernel holds a (block_rows, d) tile in VMEM.  Here
// the row kernel (rmsnorm_row_kernel) holds a row in registers from its
// load to its store, so x is read once:
//   * a row belongs to kLanes lanes of a warp (32, or 16 / 8 for rows of
//     at most 512 / 256 bytes, so that each lane still has 2 vectors);
//     each lane holds kVecs 16-byte vectors of the row (4 float32 or 8
//     bfloat16 each), neighbouring lanes on neighbouring vectors;
//   * kVecs is a template argument: the loads are unrolled and all issued
//     before the float32 sum of squares and the shuffle reduction; the
//     last, partial round of vectors is predicated;
//   * the weight is copied once per block into shared memory, as raw
//     16-byte vectors, and read there as one (bf16 w, bf16 x) or two
//     (f32 w) 16-byte vectors per vector of x;
//   * the grid is at most one wave of resident blocks and strides over the
//     rows, so that the weight is copied once per resident block.
// The rows of the served paths, bf16: gemma3 d 1152 (5 vectors a lane)
// and its q/k norms d 256 (16 lanes a row, 2 vectors), mamba2 d 1024 (4)
// and its gated norm d 2048 (8), hymba d 1600 (7) and its gated norm over
// d_inner 3200 (13: one warp a row still keeps 13 loads of 16 bytes in
// flight a lane, and the reduction stays in shuffles, with no block sync),
// olmoe d 2048 and its q/k norms d 128 (8 lanes a row, 2 vectors).
//
// Any other row (rows that are not 16-byte aligned, wider rows) takes the
// generic kernel (rmsnorm_kernel): one warp a row, a sum of squares over
// 16-byte vector loads, then a second sweep of the row that scales and
// stores.
//
// Numerics match the plain version: float32 sum of squares (in another
// order: per-lane partial sums, then a tree), mean = sum / d, rsqrtf,
// then x * r * w.  Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block
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

// the N weights of one vector of x, read from shared memory in one piece
// (8, 16 or 32 bytes)
template <typename W, int N> struct alignas(N * sizeof(W)) WVec {
  W e[N];
};

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// the row kernel: one read of x, the row in registers
// ---------------------------------------------------------------------------

// row `row` of x (d wide, nv vectors) into v: lane `sub` of the row's
// kLanes takes vectors sub, sub + kLanes, ...; zeros past the row or the
// last row.  Every load is issued before anything waits on one.
template <typename T, int kLanes, int kVecs>
__device__ __forceinline__ void load_row(uint4 (&v)[kVecs],
                                         const T* __restrict__ x, int64_t row,
                                         int64_t rows, int d, int nv,
                                         int sub) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int g = sub + i * kLanes;
    v[i] = (row < rows && g < nv) ? __ldg(xr + g) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, typename W, int kLanes, int kVecs>
__global__ void __launch_bounds__(kThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ y, int64_t rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
  constexpr int kPadded = kLanes * kVecs * N;      // weights held in smem
  __shared__ uint4 w_raw[kPadded * sizeof(W) / 16];
  const WVec<W, N>* w_s = reinterpret_cast<const WVec<W, N>*>(w_raw);

  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;                   // lane within its row
  const int nv = d / N;                            // vectors a row
  const int64_t step = int64_t(gridDim.x) * kRowsPerBlock;
  int64_t base = int64_t(blockIdx.x) * kRowsPerBlock +
                 (threadIdx.x >> 5) * kRowsPerWarp;   // warp-uniform
  uint4 v[kVecs];

  // x of this warp's first rows, in flight while the weight is copied
  if (base < rows)
    load_row<T, kLanes, kVecs>(v, x, base + lane / kLanes, rows, d, nv, sub);

  // the weight, once a block: 16-byte vectors where whole and aligned,
  // zeros past d
  if (w != nullptr) {
    uint4* ws = w_raw;
    const int wbytes = d * int(sizeof(W));
    const bool wvec = aligned16(w);
    for (int j = threadIdx.x; j < kPadded * int(sizeof(W)) / 16;
         j += kThreads) {
      if (wvec && (j + 1) * 16 <= wbytes) {
        ws[j] = __ldg(reinterpret_cast<const uint4*>(w) + j);
      } else {
        W* we = reinterpret_cast<W*>(ws + j);
        constexpr int M = 16 / sizeof(W);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const int e = j * M + i;
          we[i] = e < d ? w[e] : from_f<W>(0.f);
        }
      }
    }
  }
  __syncthreads();

  while (base < rows) {                            // warp-uniform
    const int64_t row = base + lane / kLanes;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float f = to_f(e[k]);
        ss += f * f;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / float(d) + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int g = sub + i * kLanes;
      const T* e = reinterpret_cast<const T*>(&v[i]);
      uint4 outv;
      T* o = reinterpret_cast<T*>(&outv);
      if (w != nullptr) {
        const WVec<W, N> wv = w_s[g];
#pragma unroll
        for (int k = 0; k < N; ++k) o[k] = from_f<T>(to_f(e[k]) * r *
                                                     to_f(wv.e[k]));
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) o[k] = from_f<T>(to_f(e[k]) * r);
      }
      if (row < rows && g < nv) yr[g] = outv;
    }
    base += step;
    if (base < rows)
      load_row<T, kLanes, kVecs>(v, x, base + lane / kLanes, rows, d, nv,
                                 sub);
  }
}

// ---------------------------------------------------------------------------
// the generic kernel: any d, any alignment
// ---------------------------------------------------------------------------

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
      if (w != nullptr) v *= to_f(__ldg(w + g * N + i));
      o[i] = from_f<T>(v);
    }
    reinterpret_cast<uint4*>(yr)[g] = outv;
  }
  for (int64_t j = tail + lane; j < d; j += 32) {
    float v = to_f(xr[j]) * r;
    if (w != nullptr) v *= to_f(__ldg(w + j));
    yr[j] = from_f<T>(v);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename W, int kLanes, int kVecs>
int launch_rows(const void* x, const void* w, void* y, int64_t rows, int d,
                float eps, cudaStream_t stream) {
  // one wave: the blocks the card holds at once (asked once for each
  // instantiation), or fewer when the rows need fewer
  static const int resident = [] {
    int dev = 0, sms = 132, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_row_kernel<T, W, kLanes, kVecs>, kThreads, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  constexpr int kRowsPerBlock = kWarps * (32 / kLanes);
  const int64_t need = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int grid = int(need < resident ? need : resident);
  rmsnorm_row_kernel<T, W, kLanes, kVecs><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(y),
      rows, d, eps);
  return int(cudaGetLastError());
}

// the row kernel for d (whole 16-byte vectors, 16-byte aligned rows), by
// the lanes and vectors a row needs; -1 if no instantiation holds the row
template <typename T, typename W>
int dispatch_rows(const void* x, const void* w, void* y, int64_t rows,
                  int64_t d, float eps, cudaStream_t s) {
  const int64_t nv = d / Vec<T>::N;
  if (nv <= 16) return launch_rows<T, W, 8, 2>(x, w, y, rows, d, eps, s);
  if (nv <= 32) return launch_rows<T, W, 16, 2>(x, w, y, rows, d, eps, s);
  if (nv <= 64) return launch_rows<T, W, 32, 2>(x, w, y, rows, d, eps, s);
  if (nv <= 128) return launch_rows<T, W, 32, 4>(x, w, y, rows, d, eps, s);
  if (nv <= 160) return launch_rows<T, W, 32, 5>(x, w, y, rows, d, eps, s);
  if (nv <= 224) return launch_rows<T, W, 32, 7>(x, w, y, rows, d, eps, s);
  if (nv <= 256) return launch_rows<T, W, 32, 8>(x, w, y, rows, d, eps, s);
  if (nv <= 416) return launch_rows<T, W, 32, 13>(x, w, y, rows, d, eps, s);
  return -1;
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int64_t rows, int64_t d,
           float eps, cudaStream_t stream) {
  const bool whole = d % Vec<T>::N == 0 && aligned16(x) && aligned16(y);
  if (whole) {
    const int rc = dispatch_rows<T, W>(x, w, y, rows, d, eps, stream);
    if (rc >= 0) return rc;
  }
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
// 1 = float32 w, 2 = bfloat16 w.  Launches one kernel on `stream` without
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
