// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py:68
// (ssd_scan_tpu, body _ssd_kernel at :23).  Per (batch, head), with
// A = -exp(a_log[h]) and the state H (N, P) in float32:
//     H_t = exp(dt_t A) H_{t-1} + dt_t B_t x_t^T,   y_t = C_t . H_t + D x_t
// computed chunk by chunk: with cum the in-chunk prefix sum of dt A,
//     y_l   = sum_{j<=l} (C_l . B_j) e^{cum_l - cum_j} dt_j x_j      (intra)
//           + e^{cum_l} C_l . H_in                                  (state)
//           + D x_l                                                 (skip)
//     H_out = e^{cum_last} H_in + sum_j e^{cum_last - cum_j} dt_j B_j x_j^T.
// Head h reads B/C group h / (heads / groups).  x, B, C and y are float32
// or bfloat16 (one type for all four), dt, a_log, d_skip, h0 and h_final
// float32; all arithmetic is float32.
//
// What it computes, not how the TPU does it.  The Pallas kernel runs a
// sequential grid axis over chunks with the state in VMEM and does each
// chunk's products on the MXU.  Here one block owns a (batch, head, 32
// state columns of P) and loops over the chunks itself, the state slice
// (N x 32 floats) staying in shared memory; the columns of the state are
// independent, so splitting P multiplies the blocks (mamba2's prefill,
// 4 x 32 heads x P 64: 256 blocks; one prompt: 64) at the price of each
// block recomputing its chunk's C.B^T.  The chunk length is the kernel's
// own, L = 64 (the reference's chunk argument only changes the rounding):
// the 64 x 64 score tile (16 KB) and C and B of a chunk in float32
// (2 x 64 x N) fit in shared memory up to N = 256 (~112 KB at N = 128,
// two blocks an SM).  A block of 256 threads does, per chunk:
//   1. the masked, decayed score tile S[l][j] = (C_l . B_j)
//      e^{cum_l - cum_j} dt_j for j <= l, one 4 x 4 register tile a thread
//      (tiles above the diagonal are skipped).  The causal mask is applied
//      BEFORE the exp: for l < j the exponent is positive and may reach
//      inf, and inf * 0 is NaN.
//   2. y for its 32 columns (2 x 4 a thread): S @ x, plus e^{cum_l} C_l.H,
//      plus D x;
//   3. the state update (4 x 4 a thread, rows 32 apart so that a small N
//      still spreads over many threads; every thread owns its elements).
// e^{cum} may underflow to 0 for a long chunk with large dt; that is the
// correct limit and stays finite.  A ragged last chunk is zero-filled (dt
// = 0 there, so it adds nothing to the state).
//
// Layout.  Every tensor is read and written through the element strides
// the caller passes, so the model's seq-major (s, b, h, p) tensors and
// strided views of a fused projection go in without a transposing copy.
//
// Bound.  mamba2-370m's prefill (x (4, 32, 2048, 64) bf16, N 128): ~72 MB
// in and out (22 us at 3.35 TB/s) against ~10 GFLOP of the chunked
// algorithm's useful work at L = 64 (10 us at the bf16 tensor-core peak),
// so bytes.
// This first kernel does its products on the CUDA cores in float32 and
// recomputes C.B^T in every (head, column tile); tensor-core tiles, and a
// chunk-parallel form that shares C.B^T across the heads of a group, are
// later work.
//
// Build without --use_fast_math (expf, not its approximation).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;         // chunk length
constexpr int kLP = kL + 4;    // row stride of the transposed C and B
constexpr int kSS = kL + 1;    // row stride of the score tile
constexpr int kPS = 32;        // state columns a block owns
constexpr int kThreads = 256;
constexpr int kMaxN = 256;

struct Strides {               // element strides, outermost first
  int64_t x[4], dt[3], b[4], c[4], y[4];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t smem_bytes(int N) {
  return sizeof(float) * (size_t(2) * N * kLP + kL * kSS + kL * kPS +
                          size_t(N) * kPS + 3 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ d_skip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_final, int H, int64_t S, int P, int G,
                int N, Strides st) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                      // (N, kLP)  C of the chunk, C^T
  float* bt = ct + N * kLP;              // (N, kLP)  B^T
  float* sc = bt + N * kLP;              // (kL, kSS) masked decayed scores
  float* xs = sc + kL * kSS;             // (kL, kPS) x columns
  float* hs = xs + kL * kPS;             // (N, kPS)  the state columns
  float* cum = hs + N * kPS;             // (kL)      prefix sum of dt A
  float* dts = cum + kL;                 // (kL)      dt
  float* wst = dts + kL;                 // (kL)      e^{cum_last-cum_j} dt_j

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPS;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / (H / G);
  const int pw = min(kPS, P - p0);       // valid columns of this block
  const float A = -expf(a_log[hi]);
  const float D = d_skip[hi];
  const T* xb = x + bi * st.x[0] + hi * st.x[1];
  const float* dtb = dt + bi * st.dt[0] + hi * st.dt[1];
  const T* bb = bm + bi * st.b[0] + gi * st.b[1];
  const T* cb = cm + bi * st.c[0] + gi * st.c[1];
  T* yb = y + bi * st.y[0] + hi * st.y[1];
  const int64_t hbase = ((int64_t)bi * H + hi) * N * (int64_t)P;

  for (int e = tid; e < N * kPS; e += kThreads) {
    const int n = e / kPS, pp = e % kPS;
    hs[e] = (h0 != nullptr && pp < pw) ? h0[hbase + (int64_t)n * P + p0 + pp]
                                       : 0.f;
  }

  for (int64_t t0 = 0; t0 < S; t0 += kL) {
    const int lc = S - t0 < kL ? int(S - t0) : kL;
    __syncthreads();                     // the last chunk is done with smem
    if (tid < kL)
      dts[tid] = tid < lc ? dtb[(t0 + tid) * st.dt[2]] : 0.f;
    for (int e = tid; e < kL * N; e += kThreads) {
      const int l = e / N, n = e % N;    // consecutive threads: along n
      float bv = 0.f, cv = 0.f;
      if (l < lc) {
        bv = to_f(bb[(t0 + l) * st.b[2] + n * st.b[3]]);
        cv = to_f(cb[(t0 + l) * st.c[2] + n * st.c[3]]);
      }
      bt[n * kLP + l] = bv;
      ct[n * kLP + l] = cv;
    }
    for (int e = tid; e < kL * kPS; e += kThreads) {
      const int l = e / kPS, pp = e % kPS;
      xs[e] = (l < lc && pp < pw)
                  ? to_f(xb[(t0 + l) * st.x[2] + (p0 + pp) * st.x[3]])
                  : 0.f;
    }
    __syncthreads();
    if (tid < 32) {                      // inclusive scan of dt A, 2 a lane
      const float a0 = dts[2 * tid] * A, a1 = dts[2 * tid + 1] * A;
      float s = a0 + a1;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      cum[2 * tid] = s - a1;
      cum[2 * tid + 1] = s;
    }
    __syncthreads();
    if (tid < kL) wst[tid] = expf(cum[kL - 1] - cum[tid]) * dts[tid];

    // 1. scores: thread (ti, tj) owns rows 4ti.., columns 4tj..
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4] = {};
      if (tj <= ti) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              ct + n * kLP + 4 * ti);
          const float4 bv = *reinterpret_cast<const float4*>(
              bt + n * kLP + 4 * tj);
          const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] += c4[a] * b4[q];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int l = 4 * ti + a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * tj + q;
          // mask first: exp of cum_l - cum_j for l < j may overflow
          sc[l * kSS + j] =
              j <= l ? acc[a][q] * expf(cum[l] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // 2. outputs: thread (ty, tx) owns rows 2ty, 2ty+1, columns 4tx..
    {
      const int ty = tid / 8, tx = tid % 8;
      const int l0 = 2 * ty;
      float acc[2][4] = {}, off[2][4] = {};
      for (int j = 0; j <= l0 + 1; ++j) {
        const float s0 = sc[l0 * kSS + j], s1 = sc[(l0 + 1) * kSS + j];
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + j * kPS + 4 * tx);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[0][q] += s0 * x4[q];
          acc[1][q] += s1 * x4[q];
        }
      }
      for (int n = 0; n < N; ++n) {
        const float c0 = ct[n * kLP + l0], c1 = ct[n * kLP + l0 + 1];
        const float4 hv =
            *reinterpret_cast<const float4*>(hs + n * kPS + 4 * tx);
        const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          off[0][q] += c0 * h4[q];
          off[1][q] += c1 * h4[q];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = l0 + r;
        if (l >= lc) continue;
        const float el = expf(cum[l]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int pp = 4 * tx + q;
          if (pp < pw)
            yb[(t0 + l) * st.y[2] + (p0 + pp) * st.y[3]] = from_f<T>(
                acc[r][q] + off[r][q] * el + D * xs[l * kPS + pp]);
        }
      }
    }
    __syncthreads();                     // every read of the state is done

    // 3. state update: thread (tn, tx) owns rows tn + 32a (a < 4, then
    //    the next 128 rows), columns 4tx..; a small N still spreads its
    //    rows over N * 8 threads
    {
      const int tn = tid / 8, tx = tid % 8;
      constexpr int kRows = kThreads / 8;          // 32 row groups
      const float da = expf(cum[kL - 1]);
      for (int n0 = tn; n0 < N; n0 += 4 * kRows) {
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = min(n0 + a * kRows, N - 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = da * hs[n * kPS + 4 * tx + q];
        }
        for (int j = 0; j < lc; ++j) {
          const float w = wst[j];
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + j * kPS + 4 * tx);
          const float x4[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float bv = bt[min(n0 + a * kRows, N - 1) * kLP + j];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[a][q] += bv * x4[q];
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = n0 + a * kRows;
          if (n >= N) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) hs[n * kPS + 4 * tx + q] = acc[a][q];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * kPS; e += kThreads) {
    const int n = e / kPS, pp = e % kPS;
    if (pp < pw) h_final[hbase + (int64_t)n * P + p0 + pp] = hs[e];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* d_skip, const void* h0, void* y,
           void* h_final, int64_t bs, int64_t h, int64_t s, int64_t p,
           int64_t g, int64_t n, const Strides& st, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  const size_t smem = smem_bytes(int(n));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned((p + kPS - 1) / kPS), unsigned(h), unsigned(bs));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_final), int(h), s, int(p), int(g), int(n), st);
  return int(cudaGetLastError());
}

}  // namespace

// y and h_final of the SSD scan.  x and y are (bs, h, s, p), dt (bs, h,
// s), b and c (bs, g, s, n), each addressed through its element strides in
// `strides` (19 values: x's 4, dt's 3, b's 4, c's 4, y's 4, outermost
// first).  a_log and d_skip are contiguous (h,) float32; h0 (may be null:
// a zero state) and h_final are contiguous (bs, h, n, p) float32.  bf16:
// x, b, c and y are bfloat16 (else float32).  One launch on `stream`, no
// synchronisation; returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for n outside 1..256, h not a multiple of g, or a
// grid too large.
extern "C" int repro_ssd_scan(const void* x, const void* dt,
                              const void* a_log, const void* b, const void* c,
                              const void* d_skip, const void* h0, void* y,
                              void* h_final, int64_t bs, int64_t h, int64_t s,
                              int64_t p, int64_t g, int64_t n,
                              const int64_t* strides, int bf16,
                              void* stream) {
  if (bs <= 0 || h <= 0 || p <= 0) return 0;
  if (n <= 0 || n > kMaxN || g <= 0 || h % g || s < 0 ||
      h > 65535 || bs > 65535 || p > int64_t(kPS) * 65535)
    return int(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 4; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.dt[i] = strides[4 + i];
  for (int i = 0; i < 4; ++i) st.b[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.c[i] = strides[11 + i];
  for (int i = 0; i < 4; ++i) st.y[i] = strides[15 + i];
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, d_skip, h0, y, h_final,
                                 bs, h, s, p, g, n, st, stream_);
  return launch<float>(x, dt, a_log, b, c, d_skip, h0, y, h_final, bs, h, s,
                       p, g, n, st, stream_);
}
