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
// Head h reads B/C group h / (heads / groups).  dt, a_log, d_skip, h0 and
// h_final are float32.  Two variants, picked by the wrapper
// (kernels/ssd_scan/ops.py::variant); either raises, neither falls back.
//
// Bound.  mamba2-370m's prefill (x (4, 32, 2048, 64) bf16, N 128): ~72 MB
// in and out (22 us at 3.35 TB/s) against ~10 GFLOP of the chunked
// algorithm's useful work at L = 64 (10 us at the bf16 tensor-core peak),
// so bytes.
//
// "simt" (repro_ssd_scan: float32, and bf16 the tensor-core variant does
// not take).  What it computes, not how the TPU does it.  The Pallas
// kernel runs a sequential grid axis over chunks with the state in VMEM
// and does each chunk's products on the MXU.  Here one block owns a
// (batch, head, 32 state columns of P) and loops over the chunks itself,
// the state slice (N x 32 floats) staying in shared memory; the columns
// of the state are independent, so splitting P multiplies the blocks at
// the price of each block recomputing its chunk's C.B^T.  Its chunk
// length is L = 64: the 64 x 64 score tile (16 KB) and C and B of a chunk
// in float32 (2 x 64 x N) fit in shared memory up to N = 256.  A block of
// 256 threads does, per chunk, on the CUDA cores in float32:
//   1. the masked, decayed score tile S[l][j] = (C_l . B_j)
//      e^{cum_l - cum_j} dt_j for j <= l, one 4 x 4 register tile a thread
//      (tiles above the diagonal are skipped).  The causal mask is applied
//      BEFORE the exp: for l < j the exponent is positive and may reach
//      inf, and inf * 0 is NaN.
//   2. y for its 32 columns (2 x 4 a thread): S @ x, plus e^{cum_l} C_l.H,
//      plus D x;
//   3. the state update (4 x 4 a thread, rows 32 apart so that a small N
//      still spreads over many threads; every thread owns its elements).
// A serial chain: at mamba2's shape one wave of 256 blocks walks 32
// chunks, four __syncthreads stages each.
//
// "tc" (repro_ssd_scan_tc: bf16 with P and N multiples of 16, P <= 128,
// N <= 256): the chunk-parallel form on the tensor cores, L = 128, three
// launches on one stream:
//   1. chunk states, grid (chunks, heads, batch): each block scans dt A
//      over its chunk (one warp), forms w_j x_j with w_j = e^{cum_last -
//      cum_j} dt_j as a bf16 pair hi + lo (w x is not a bf16 number; one
//      rounding, 2^-9 a term over thousands of steps, would not keep the
//      final state's 5e-4, the pair keeps ~2^-17) and computes S_c = B^T
//      (hi + lo) (N x P, float32) into a scratch tensor, plus cum_last.
//      The block of a group's first head also computes the chunk's C.B^T
//      (L x L, float32, the 36 tiles on and below the diagonal) once for
//      every head of the group: 32 heads share it in mamba2, 50 in hymba.
//   2. the carry, grid (N P / 1024, heads, batch): each thread walks the
//      chunks in order for 4 state elements, H_in[c] = H, H = e^{cum_last}
//      H + S_c in float32 (h0 is the first H, the last H is h_final), with
//      eight chunks' loads in flight; it writes H_in rounded to bf16 (it
//      feeds y alone) to a buffer of its own, half the bytes of S_c.
//   3. chunk outputs, grid (chunks, heads, batch): the block loads x, C
//      and H_in by cp.async and, while dt is scanned, the shared C.B^T's
//      36 tiles (9 float4 a thread); every thread then forms its part of
//      M = mask(C.B^T) e^{cum_l - cum_j} dt_j (masked before the exp, as
//      above), rounded to bf16 (as B2's tensor-core variant rounds P),
//      into shared memory.  Warp w owns rows 16w..16w+15 and all P
//      columns: C H_in, scaled by e^{cum_l} in registers, then M x over
//      the column tiles up to the diagonal, plus D x; the y tile goes
//      through shared memory (M's place) to 16-byte stores through y's
//      strides.
// The products are mma.sync m16n8k16 (bf16 in, float32 accumulators) on
// tiles that cp.async brought into shared memory; rows are padded by 16
// bytes, so the 8 rows an ldmatrix reads fall on 8 distinct bank groups.
// Blocks of stages 1 and 3 hold one chunk each: loads of one chunk
// overlap another resident block's products.  What the design adds in
// bytes is the scratch states (bs h chunks N P 4 bytes: 67 MB at mamba2's
// shape, written once and read once), H_in in bf16 (34 MB, written once
// and read once) and C.B^T (4.2 MB, read from L2 by every head).  Rounding: M and H_in to bf16 for their products,
// w x as the bf16 pair; ref.py::ssd_scan_tc_ref is the plain version of
// exactly that arithmetic.
//
// e^{cum} may underflow to 0 for a long chunk with large dt; that is the
// correct limit and stays finite.  A ragged last chunk is zero-filled (dt
// = 0 there, so it adds nothing to the state).
//
// Layout.  Every tensor is read and written through the element strides
// the caller passes, so the model's seq-major (s, b, h, p) tensors and
// strided views of a fused projection go in without a transposing copy;
// "tc" reads rows of x, B and C with 16-byte cp.async, so their rows must
// be contiguous and 16-byte aligned (the wrapper copies a view that is
// not), and writes y's rows the same way from a tile in shared memory
// (the wrapper allocates y).
//
// Build without --use_fast_math (expf, not its approximation).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_common.cuh"

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


// ---------------------------------------------------------------------------
// the "tc" variant: chunk-parallel stages on the tensor cores (bf16)
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kL = 128;                // chunk length
constexpr int kWarps = kL / 16;        // stage 3: a warp for 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;                // bf16 a row: 16 bytes off 128
constexpr int kMaxP = 128;
constexpr int kMaxN = 256;
constexpr int kCarryThreads = 256;     // stage 2: 4 state elements each
constexpr int kAhead = 8;              // stage 2: chunks of loads in flight
constexpr int kTiles = kWarps * (kWarps + 1) / 2;  // 16 x 16, j <= l
constexpr int kQuads = kTiles * 64 / kThreads;     // stage 3: float4s
static_assert(kTiles * 64 % kThreads == 0, "C.B^T quads spread evenly");

__host__ __device__ constexpr int ld(int cols) { return cols + kPad; }

size_t smem_chunk(int P, int N) {      // stage 1
  const size_t u = std::max(2 * kL * ld(P), kL * ld(N));
  return 3 * kL * sizeof(float) + (size_t(kL) * ld(N) + u) * sizeof(bf16);
}
size_t smem_out(int P, int N) {        // stage 3
  return 2 * kL * sizeof(float) +
         (size_t(kL) * ld(P) + size_t(kL) * ld(N) + size_t(N) * ld(P) +
          size_t(kL) * ld(kL)) *
             sizeof(bf16);
}

// A row of `cols` bf16 (a multiple of 8, at most 256) as 16-byte chunks
// spread over a power-of-two group of lanes: lane k of the group takes
// chunk k (k < chunks), the block covers `step` rows at a time.  Shifts
// and masks only: a division by a runtime value costs ~20 operations.
struct RowSplit {
  int chunks, shift, k, r0, step;
  __device__ __forceinline__ explicit RowSplit(int cols) {
    chunks = cols / 8;
    shift = chunks > 1 ? 32 - __clz(chunks - 1) : 0;
    k = threadIdx.x & ((1 << shift) - 1);
    r0 = threadIdx.x >> shift;
    step = kThreads >> shift;
  }
};

// Rows [t0, t0 + rows) of a matrix of `cols` contiguous bf16 a row, rows
// `rs` elements apart, into a [rows][ld(cols)] tile at dst by cp.async;
// rows at or past lc are zero-filled.
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, int cols,
                                          const bf16* src, int64_t rs,
                                          int64_t t0, int lc) {
  const RowSplit rw(cols);
  if (rw.k >= rw.chunks) return;
  for (int r = rw.r0; r < rows; r += rw.step) {
    const bool ok = r < lc;
    cp_async16(dst + uint32_t(r * ld(cols) + rw.k * 8) * 2,
               ok ? src + (t0 + r) * rs + rw.k * 8 : src, ok);
  }
}

// dt of the chunk into dts (zeros past lc) and cum, the inclusive prefix
// sum of dt A: one warp, four rows a lane.  Stages 1 and 3 run the same
// code, so both see the same bits.
__device__ __forceinline__ void chunk_cum(const float* dtb, int64_t sdt,
                                          int64_t t0, int lc, float A,
                                          float* dts, float* cum) {
  const int tid = threadIdx.x;
  if (tid < kL) dts[tid] = tid < lc ? dtb[(t0 + tid) * sdt] : 0.f;
  __syncthreads();
  if (tid < 32) {
    float v[4], run = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      run += dts[4 * tid + q] * A;
      v[q] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += u;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) cum[4 * tid + q] = incl - run + v[q];
  }
  __syncthreads();
}

// mma.sync operands from padded shared-memory tiles (row stride ld
// elements).  A (16 x 16) at (m0, k0) of a tile stored [m][k]:
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t base,
                                       int ldt, int m0, int k0, int lane) {
  const int r = m0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = k0 + ((lane >> 4) & 1) * 8;
  ldsm_x4(a, base + uint32_t(r * ldt + c) * 2);
}
// A from a tile stored transposed, [k][m]:
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], uint32_t base,
                                         int ldt, int m0, int k0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int c = m0 + ((lane >> 3) & 1) * 8;
  ldsm_x4_t(a, base + uint32_t(r * ldt + c) * 2);
}
// B of two n8 tiles (columns n0.. and n0 + 8..) by k16 from a tile stored
// [n][k]: b[0], b[1] the first tile's, b[2], b[3] the second's
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], uint32_t base,
                                       int ldt, int n0, int k0, int lane) {
  const int r = n0 + (lane & 7) + ((lane >> 4) & 1) * 8;
  const int c = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, base + uint32_t(r * ldt + c) * 2);
}
// the same from a tile stored [k][n]
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], uint32_t base,
                                         int ldt, int n0, int k0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + ((lane >> 4) & 1) * 8;
  ldsm_x4_t(b, base + uint32_t(r * ldt + c) * 2);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 16 x 16 tiles on and below the diagonal, row by row: tile u's row
// tile mt[u] and column tile jt[u] <= mt[u]
struct TileTable {
  unsigned char mt[kTiles], jt[kTiles];
};
constexpr TileTable make_tiles() {
  TileTable t{};
  int u = 0;
  for (int m = 0; m < kWarps; ++m)
    for (int j = 0; j <= m; ++j, ++u) {
      t.mt[u] = static_cast<unsigned char>(m);
      t.jt[u] = static_cast<unsigned char>(j);
    }
  return t;
}
__constant__ TileTable kTileTab = make_tiles();

// Stage 1.  NT: the n8 tiles of P the accumulators hold, at most.
template <int NT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a_log,
                      const bf16* __restrict__ bm,
                      const bf16* __restrict__ cm,
                      float* __restrict__ states, float* __restrict__ cbt,
                      float* __restrict__ dA, int H, int64_t S, int P,
                      int G, int N, int nc, int split, Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = reinterpret_cast<float*>(smem);
  float* dts = cum + kL;
  float* wts = dts + kL;                           // w_j
  bf16* bsm = reinterpret_cast<bf16*>(wts + kL);   // [kL][ld(N)] B
  bf16* hsm = bsm + kL * ld(N);                    // [kL][ld(P)] x, then hi
  bf16* lsm = hsm + kL * ld(P);                    // [kL][ld(P)] lo
  const uint32_t sB = smem_u32(bsm), sHi = smem_u32(hsm),
                 sLo = smem_u32(lsm);
  const uint32_t sC = sHi;                         // [kL][ld(N)] C, later

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int r = H / G, gi = hi / r;
  const int64_t t0 = int64_t(c) * kL;
  const int lc = int(S - t0 < kL ? S - t0 : kL);
  const int64_t bh = int64_t(bi) * H + hi;
  const float A = -expf(a_log[hi]);

  load_tile(sHi, kL, P, x + bi * st.x[0] + hi * st.x[1], st.x[2], t0, lc);
  load_tile(sB, kL, N, bm + bi * st.b[0] + gi * st.b[1], st.b[2], t0, lc);
  cp_async_commit();
  chunk_cum(dt + bi * st.dt[0] + hi * st.dt[1], st.dt[2], t0, lc, A, dts,
            cum);
  if (tid < kL) wts[tid] = expf(cum[kL - 1] - cum[tid]) * dts[tid];
  if (tid == 0) dA[bh * nc + c] = cum[kL - 1];
  cp_async_wait<0>();
  __syncthreads();

  // w x as the bf16 pair hi + lo, in place of x, 8 elements a step
  const RowSplit rw(P);
  for (int j = rw.r0; j < kL && rw.k < rw.chunks; j += rw.step) {
    const int q = rw.k * 8;
    uint4* ph = reinterpret_cast<uint4*>(hsm + j * ld(P) + q);
    const uint4 raw = *ph;
    const float w = wts[j];
    uint32_t hv[4] = {raw.x, raw.y, raw.z, raw.w}, lv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(&hv[k]));
      const float f0 = w * xv.x, f1 = w * xv.y;
      hv[k] = pack(f0, f1);
      const float2 r =
          __bfloat1622float2(*reinterpret_cast<const bf162*>(&hv[k]));
      lv[k] = pack(f0 - r.x, f1 - r.y);
    }
    *ph = make_uint4(hv[0], hv[1], hv[2], hv[3]);
    *reinterpret_cast<uint4*>(lsm + j * ld(P) + q) =
        make_uint4(lv[0], lv[1], lv[2], lv[3]);
  }
  __syncthreads();

  // S_c (N x P) = B^T (N x kL) . (hi + lo) (kL x P): a unit is 16 rows of
  // S by P / split columns (split spreads a small N over the warps)
  const int g = lane >> 2, t4 = lane & 3;
  const int np = P / 16 / split;                   // n16 pairs a unit
  float* sb = states + (bh * nc + c) * int64_t(N) * P;
  for (int u = warp; u < (N / 16) * split; u += kWarps) {
    const int m0 = (u / split) * 16, n0 = (u % split) * np * 16;
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kL / 16; ++kk) {
      uint32_t a[4];
      frag_a_t(a, sB, ld(N), m0, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (j < np) {
          uint32_t bh4[4], bl4[4];
          frag_b_t(bh4, sHi, ld(P), n0 + j * 16, kk * 16, lane);
          frag_b_t(bl4, sLo, ld(P), n0 + j * 16, kk * 16, lane);
          mma16816(acc[2 * j], a, bh4[0], bh4[1]);
          mma16816(acc[2 * j + 1], a, bh4[2], bh4[3]);
          mma16816(acc[2 * j], a, bl4[0], bl4[1]);
          mma16816(acc[2 * j + 1], a, bl4[2], bl4[3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < 2 * np) {
        const int col = n0 + j * 8 + 2 * t4, row = m0 + g;
        *reinterpret_cast<float2*>(sb + int64_t(row) * P + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(sb + int64_t(row + 8) * P + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }

  // C.B^T of the chunk, once a group: its first head's block
  if (hi % r != 0) return;
  __syncthreads();                                 // hi and lo are done
  load_tile(sC, kL, N, cm + bi * st.c[0] + gi * st.c[1], st.c[2], t0, lc);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* cbb = cbt + ((int64_t(bi) * G + gi) * nc + c) * kL * kL;
  for (int u = warp; u < kTiles; u += kWarps) {
    const int mt = kTileTab.mt[u], jt = kTileTab.jt[u];
    float acc[2][4] = {};
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t a[4], b[4];
      frag_a(a, sC, ld(N), mt * 16, kk * 16, lane);
      frag_b(b, sB, ld(N), jt * 16, kk * 16, lane);
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = jt * 16 + j * 8 + 2 * t4, row = mt * 16 + g;
      *reinterpret_cast<float2*>(cbb + row * kL + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(cbb + (row + 8) * kL + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// Stage 2.  states: (bs, h, nc, N P) float32 S_c; hin: the same shape in
// bf16, H_in rounded for stage 3 (it feeds y alone).
__global__ void __launch_bounds__(kCarryThreads)
ssd_scan_carry_kernel(const float* __restrict__ states,
                      const float* __restrict__ dA,
                      const float* __restrict__ h0, bf16* __restrict__ hin,
                      float* __restrict__ h_final, int H, int nc,
                      int64_t n4) {
  const int64_t e = int64_t(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (e >= n4) return;
  const int64_t bh = int64_t(blockIdx.z) * H + blockIdx.y;
  const float4* sp = reinterpret_cast<const float4*>(states) + bh * nc * n4 + e;
  uint2* hp = reinterpret_cast<uint2*>(hin) + bh * nc * n4 + e;
  const float* da = dA + bh * nc;
  float4 h = h0 != nullptr ? reinterpret_cast<const float4*>(h0)[bh * n4 + e]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 s[kAhead];
    float a[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        s[i] = sp[int64_t(c0 + i) * n4];
        a[i] = expf(da[c0 + i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (c0 + i < nc) {
        hp[int64_t(c0 + i) * n4] = make_uint2(pack(h.x, h.y), pack(h.z, h.w));
        h.x = a[i] * h.x + s[i].x;
        h.y = a[i] * h.y + s[i].y;
        h.z = a[i] * h.z + s[i].z;
        h.w = a[i] * h.w + s[i].w;
      }
    }
  }
  reinterpret_cast<float4*>(h_final)[bh * n4 + e] = h;
}

// Stage 3.  NT: the n8 tiles of P the accumulators hold, at most.
template <int NT>
__global__ void __launch_bounds__(kThreads)
ssd_scan_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const bf16* __restrict__ cm,
                    const float* __restrict__ d_skip,
                    const bf16* __restrict__ hin,
                    const float* __restrict__ cbt, bf16* __restrict__ y,
                    int H, int64_t S, int P, int G, int N, int nc,
                    Strides st) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cum = reinterpret_cast<float*>(smem);
  float* dts = cum + kL;
  bf16* xsm = reinterpret_cast<bf16*>(dts + kL);   // [kL][ld(P)]  x
  bf16* csm = xsm + kL * ld(P);                    // [kL][ld(N)]  C
  bf16* hsm = csm + kL * ld(N);                    // [N][ld(P)]   H_in
  bf16* msm = hsm + N * ld(P);                     // [kL][ld(kL)] M
  const uint32_t sX = smem_u32(xsm), sC = smem_u32(csm),
                 sH = smem_u32(hsm), sM = smem_u32(msm);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int gi = hi / (H / G);
  const int64_t t0 = int64_t(c) * kL;
  const int lc = int(S - t0 < kL ? S - t0 : kL);
  const int64_t bh = int64_t(bi) * H + hi;
  const float A = -expf(a_log[hi]);

  load_tile(sX, kL, P, x + bi * st.x[0] + hi * st.x[1], st.x[2], t0, lc);
  load_tile(sC, kL, N, cm + bi * st.c[0] + gi * st.c[1], st.c[2], t0, lc);
  load_tile(sH, N, P, hin + (bh * nc + c) * int64_t(N) * P, P, 0, N);
  cp_async_commit();
  // the shared C.B^T of the chunk's tiles on and below the diagonal, kQuads
  // float4s a thread, in flight while dt is scanned
  const float* cbb = cbt + ((int64_t(bi) * G + gi) * nc + c) * kL * kL;
  float4 cbv[kQuads];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int idx = tid + i * kThreads, q = idx & 63;
    const int mt = kTileTab.mt[idx >> 6], jt = kTileTab.jt[idx >> 6];
    cbv[i] = __ldg(reinterpret_cast<const float4*>(
        cbb + (mt * 16 + (q >> 2)) * kL + jt * 16 + (q & 3) * 4));
  }
  chunk_cum(dt + bi * st.dt[0] + hi * st.dt[1], st.dt[2], t0, lc, A, dts,
            cum);
  // M = C.B^T e^{cum_l - cum_j} dt_j where j <= l (masked before the
  // exp), else 0, to bf16
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int idx = tid + i * kThreads, q = idx & 63;
    const int mt = kTileTab.mt[idx >> 6], jt = kTileTab.jt[idx >> 6];
    const int l = mt * 16 + (q >> 2), j = jt * 16 + (q & 3) * 4;
    const float cl = cum[l];
    const float v[4] = {cbv[i].x, cbv[i].y, cbv[i].z, cbv[i].w};
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = j + k <= l ? v[k] * expf(cl - cum[j + k]) * dts[j + k] : 0.f;
    *reinterpret_cast<uint2*>(msm + l * ld(kL) + j) =
        make_uint2(pack(m[0], m[1]), pack(m[2], m[3]));
  }
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = warp * 16, l0 = m0 + g, l1 = l0 + 8;
  const int nt = P / 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  // C . H_in, then e^{cum_l} by row
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, sC, ld(N), m0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (2 * j < nt) {
        uint32_t b[4];
        frag_b_t(b, sH, ld(P), j * 16, kk * 16, lane);
        mma16816(acc[2 * j], a, b[0], b[1]);
        mma16816(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
  const float e0 = expf(cum[l0]), e1 = expf(cum[l1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= e0;
    acc[j][1] *= e0;
    acc[j][2] *= e1;
    acc[j][3] *= e1;
  }

  // M . x over the column tiles up to the diagonal
  for (int kk = 0; kk <= warp; ++kk) {
    uint32_t a[4];
    frag_a(a, sM, ld(kL), m0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (2 * j < nt) {
        uint32_t b[4];
        frag_b_t(b, sX, ld(P), j * 16, kk * 16, lane);
        mma16816(acc[2 * j], a, b[0], b[1]);
        mma16816(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
  }

  // + D x, to bf16 in the M tile's place, then stored a 16-byte chunk of
  // a row at a time through y's strides
  const float D = d_skip[hi];
  bf16* ysm = msm;                                 // [kL][ld(P)] y
  __syncthreads();                                 // every M . x is done
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      const int p = j * 8 + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int l = half ? l1 : l0;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(xsm + l * ld(P) + p));
        *reinterpret_cast<uint32_t*>(ysm + l * ld(P) + p) =
            pack(acc[j][2 * half] + D * xv.x, acc[j][2 * half + 1] + D * xv.y);
      }
    }
  }
  __syncthreads();
  bf16* yb = y + bi * st.y[0] + hi * st.y[1];
  const RowSplit rw(P);
  for (int l = rw.r0; l < lc && rw.k < rw.chunks; l += rw.step)
    *reinterpret_cast<uint4*>(yb + (t0 + l) * st.y[2] + rw.k * 8) =
        *reinterpret_cast<const uint4*>(ysm + l * ld(P) + rw.k * 8);
}

template <int NT>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* d_skip, const void* h0, void* y,
           void* h_final, void* states, void* hin, void* cbt, void* dA,
           int64_t bs, int64_t h, int64_t s, int64_t p, int64_t g,
           int64_t n, const Strides& st, cudaStream_t stream) {
  const int nc = int((s + kL - 1) / kL);
  const int P = int(p), N = int(n), H = int(h), G = int(g);
  const dim3 chunks{unsigned(nc), unsigned(h), unsigned(bs)};
  cudaError_t err;
  if (nc > 0) {
    // split: the largest divisor of P / 16 that keeps (N / 16) * split
    // units within the 8 warps (at least 1)
    int split = 1;
    for (int d = P / 16; d > 1; --d)
      if ((P / 16) % d == 0 && (N / 16) * d <= kWarps) {
        split = d;
        break;
      }
    auto k1 = ssd_scan_chunk_kernel<NT>;
    const size_t sm1 = smem_chunk(P, N);
    err = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize, int(sm1));
    if (err != cudaSuccess) return int(err);
    k1<<<chunks, kThreads, sm1, stream>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_log), static_cast<const bf16*>(b),
        static_cast<const bf16*>(c), static_cast<float*>(states),
        static_cast<float*>(cbt), static_cast<float*>(dA), H, s, P, G, N, nc,
        split, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  const int64_t n4 = int64_t(N) * P / 4;
  ssd_scan_carry_kernel<<<dim3(unsigned((n4 + kCarryThreads - 1) /
                                        kCarryThreads),
                               unsigned(h), unsigned(bs)),
                          kCarryThreads, 0, stream>>>(
      static_cast<const float*>(states), static_cast<const float*>(dA),
      static_cast<const float*>(h0), static_cast<bf16*>(hin),
      static_cast<float*>(h_final), H, nc, n4);
  err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return int(err);
  auto k3 = ssd_scan_out_kernel<NT>;
  const size_t sm3 = smem_out(P, N);
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(sm3));
  if (err != cudaSuccess) return int(err);
  k3<<<chunks, kThreads, sm3, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const bf16*>(c),
      static_cast<const float*>(d_skip), static_cast<const bf16*>(hin),
      static_cast<const float*>(cbt), static_cast<bf16*>(y), H, s, P, G, N,
      nc, st);
  return int(cudaGetLastError());
}

}  // namespace tc

Strides unpack(const int64_t* strides) {
  Strides st;
  for (int i = 0; i < 4; ++i) st.x[i] = strides[i];
  for (int i = 0; i < 3; ++i) st.dt[i] = strides[4 + i];
  for (int i = 0; i < 4; ++i) st.b[i] = strides[7 + i];
  for (int i = 0; i < 4; ++i) st.c[i] = strides[11 + i];
  for (int i = 0; i < 4; ++i) st.y[i] = strides[15 + i];
  return st;
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
  const Strides st = unpack(strides);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a_log, b, c, d_skip, h0, y, h_final,
                                 bs, h, s, p, g, n, st, stream_);
  return launch<float>(x, dt, a_log, b, c, d_skip, h0, y, h_final, bs, h, s,
                       p, g, n, st, stream_);
}

// The "tc" variant (see the header): x, b, c and y bfloat16, with p and n
// multiples of 16 (p <= 128, n <= 256); the rows of x, b, c and y
// contiguous and 16-byte aligned (base and every stride but the last a
// multiple of 8 elements).  Scratch the caller allocates: states
// (bs, h, nc, n, p) float32, hin (the same) bf16, cbt (bs, g, nc, chunk,
// chunk) and dA (bs, h, nc) float32, with nc = ceil(s / chunk), all
// 16-byte aligned; `chunk` must equal the kernel's own
// (128).  Arguments otherwise as repro_ssd_scan's.  Three launches (two
// when s = 0) on `stream`, no synchronisation; returns the first CUDA
// error, or cudaErrorInvalidValue for what it does not take.
extern "C" int repro_ssd_scan_tc(const void* x, const void* dt,
                                 const void* a_log, const void* b,
                                 const void* c, const void* d_skip,
                                 const void* h0, void* y, void* h_final,
                                 void* states, void* hin, void* cbt,
                                 void* dA,
                                 int64_t bs, int64_t h, int64_t s, int64_t p,
                                 int64_t g, int64_t n, int64_t chunk,
                                 const int64_t* strides, void* stream) {
  if (bs <= 0 || h <= 0) return 0;
  const bool rows16 = strides[3] == 1 && strides[10] == 1 &&
                      strides[14] == 1 && strides[18] == 1 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // x's, b's, c's and y's outer strides
  const int outer[] = {0, 1, 2, 7, 8, 9, 11, 12, 13, 15, 16, 17};
  bool strides8 = true;
  for (int i : outer) strides8 = strides8 && strides[i] % 8 == 0;
  if (chunk != tc::kL || p <= 0 || p > tc::kMaxP || p % 16 || n <= 0 ||
      n > tc::kMaxN || n % 16 || g <= 0 || h % g || s < 0 || h > 65535 ||
      bs > 65535 || (s + tc::kL - 1) / tc::kL > 0x7fffffff || !rows16 ||
      !strides8)
    return int(cudaErrorInvalidValue);
  const Strides st = unpack(strides);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (p <= 32)
    return tc::launch<4>(x, dt, a_log, b, c, d_skip, h0, y, h_final, states,
                         hin, cbt, dA, bs, h, s, p, g, n, st, st_);
  if (p <= 64)
    return tc::launch<8>(x, dt, a_log, b, c, d_skip, h0, y, h_final, states,
                         hin, cbt, dA, bs, h, s, p, g, n, st, st_);
  return tc::launch<16>(x, dt, a_log, b, c, d_skip, h0, y, h_final, states,
                        hin, cbt, dA, bs, h, s, p, g, n, st, st_);
}
