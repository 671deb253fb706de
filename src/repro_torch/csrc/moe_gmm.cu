// MoE grouped matmul (the fused expert FFN) for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm/kernel.py:42
// (moe_gmm_tpu, body _gmm_kernel at :21): for every expert e of
// x (E, C, d), w1 (E, d, m*f), w2 (E, f, d),
//     out[e] = act(x[e] @ w1[e]) @ w2[e]
// with both products accumulated in float32, h kept in float32 between
// them, the activation in float32 and out cast to x's dtype (float32 or
// bfloat16; x, w1 and w2 share it).  act is swiglu or geglu (w1's output
// dim is [gate | up], m = 2), tanh-GELU or squared ReLU (m = 1).
//
// What it computes, not how the TPU does it: the Pallas kernel holds a
// (block_c, d) token tile and the expert's whole w1 and w2 in VMEM and
// runs both products on the MXU in one grid step.  At olmoe's width
// (d = 2048, m*f = 2048) neither h (block_c x 2048 f32) nor the (block_c,
// d) accumulator fits in a Hopper block's registers, and one expert's
// weights (12.6 MB bf16) are far beyond its 227 KB of shared memory.  So
// the call is two launches on one stream, each a batched tiled product:
//   1. h = act(x @ w1) into a float32 scratch (E, C, f) that the wrapper
//      allocates; a block owns a (BM, BN) tile of h and, for the gated
//      kinds, accumulates the gate and the up columns of that tile side by
//      side, so the activation is applied in the epilogue;
//   2. out = h @ w2, cast to x's dtype.
// h costs one float32 round trip through device memory (C*f*8 bytes an
// expert, 2.7% of the weight bytes at olmoe's decode shape).  Each block
// walks its K range in BK slices staged in shared memory as float32 (A
// transposed), and each thread keeps a TM x TN register tile (two for the
// gated kinds).  Rows past C and columns past N are zero-filled on load
// and never stored, so any E, C and d are taken (f a multiple of 8 keeps
// the gate/up split 16-byte aligned); an expert whose rows are all zero
// gives zero rows, since act(0) = 0 for all four kinds.
//
// Bound.  Decode (C = 8 at olmoe's 8 slots): the weights dominate, 805 MB
// of bf16 an MoE layer against 4 MB of x and out, so the bound is the
// bytes (0.24 ms at 3.35 TB/s); a small tile (BM = 8) keeps every weight
// byte read once and gives 512 and 1024 blocks for 132 SMs.  Prefill
// (C = 640): 515 GFLOP an MoE layer, bound by operations (0.52 ms at the
// tensor cores' 989 TFLOP/s bf16).  This first kernel does the products
// on the CUDA cores in float32 (67 TFLOP/s peak), so it sits far above
// that bound; mma.sync/wgmma tiles with TMA loads, and skipping the
// capacity tiles that hold no token, are later work.
//
// Build without --use_fast_math (expf and tanhf, not their approximations).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu2 = 3, kNone = 4 };

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

// jax.nn.gelu(approximate=True) / torch's gelu(approximate="tanh")
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;        // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + expf(-x));
}

// Rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major (rows, cols)
// matrix with leading dim ld, as float32, into shared memory:
// dst[r * ds + c], or dst[c * ds + r] when TRANS.  Elements outside the
// matrix become 0.  With vec (cols and ld multiples of the 16-byte vector,
// src 16-byte aligned), 16-byte loads, neighbouring threads on
// neighbouring addresses; else scalar loads.
template <typename T, int ROWS, int COLS, bool TRANS, int THREADS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t ld, int64_t r0, int64_t c0,
                                          int64_t rows, int64_t cols,
                                          bool vec, float* dst, int ds) {
  constexpr int V = 16 / sizeof(T);
  static_assert(COLS % V == 0, "tile width must hold whole vectors");
  if (vec) {
    constexpr int PER_ROW = COLS / V;
    for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW;
      const int c = (i % PER_ROW) * V;
      const int64_t gr = r0 + r, gc = c0 + c;
      float v[V];
      if (gr < rows && gc < cols) {            // the whole vector is in
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + gr * ld + gc);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = to_f(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = 0.f;
      }
      if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < V; ++j) dst[(c + j) * ds + r] = v[j];
      } else {                                 // ds and c: multiples of 4
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(dst + r * ds + c + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS;
      const int64_t gr = r0 + r, gc = c0 + c;
      const float v = (gr < rows && gc < cols) ? to_f(src[gr * ld + gc])
                                               : 0.f;
      if (TRANS)
        dst[c * ds + r] = v;
      else
        dst[r * ds + c] = v;
    }
  }
}

// N consecutive floats of shared memory (16-byte loads when N % 4 == 0;
// the caller keeps p 16-byte aligned then)
template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
};
// decode: C <= 8 (one capacity tile an expert; every weight byte read once)
using SmallTile = TileCfg<8, 128, 32, 1, 4>;
// prefill and everything else
using LargeTile = TileCfg<64, 64, 32, 4, 4>;

// o[e] (M, N) = epilogue(a[e] (M, K) @ b[e] (K, N)), b with leading dim
// ldb.  Gated kinds also accumulate b[e][:, N:2N] (the up columns) and
// store act(gate) * up.  One block: a (BM, BN) tile of one expert.
template <typename TA, typename TB, typename TO, int ACT, class Tile>
__global__ void __launch_bounds__(Tile::THREADS)
gmm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
           TO* __restrict__ o, int64_t M, int64_t N, int64_t K, int64_t ldb,
           int vec_a, int vec_b) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  constexpr int TM = Tile::TM, TN = Tile::TN, THREADS = Tile::THREADS;
  constexpr bool GATED = ACT == kSwiglu || ACT == kGeglu;
  constexpr int AS = BM + 4;                 // As row stride: 16-byte rows
  static_assert(BM % TM == 0 && BN % TN == 0, "tile shape");
  __shared__ __align__(16) float As[BK * AS];           // A^T slice
  __shared__ __align__(16) float Bs[BK * BN];           // B (gate) slice
  __shared__ __align__(16) float Us[GATED ? BK * BN : 4];  // up slice

  const int64_t e = blockIdx.z;
  const int64_t m0 = int64_t(blockIdx.y) * BM;
  const int64_t n0 = int64_t(blockIdx.x) * BN;
  const TA* ae = a + e * M * K;
  const TB* be = b + e * K * ldb;
  TO* oe = o + e * M * N;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  float acc[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = accu[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    load_tile<TA, BM, BK, true, THREADS>(ae, K, m0, k0, M, K, vec_a, As, AS);
    load_tile<TB, BK, BN, false, THREADS>(be, ldb, k0, n0, K, N, vec_b, Bs,
                                          BN);
    if constexpr (GATED)
      load_tile<TB, BK, BN, false, THREADS>(be + N, ldb, k0, n0, K, N,
                                            vec_b, Us, BN);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      lds(av, As + kk * AS + ty * TM);
      lds(bv, Bs + kk * BN + tx * TN);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      if constexpr (GATED) {
        float uv[TN];
        lds(uv, Us + kk * BN + tx * TN);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            accu[i][j] = fmaf(av[i], uv[j], accu[i][j]);
      }
    }
    __syncthreads();                         // As, Bs, Us are reused
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = m0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = n0 + tx * TN + j;
      if (c >= N) continue;
      float v = acc[i][j];
      if (ACT == kSwiglu) v = silu(v) * accu[i][j];
      if (ACT == kGeglu) v = gelu_tanh(v) * accu[i][j];
      if (ACT == kGelu) v = gelu_tanh(v);
      if (ACT == kRelu2) v = v > 0.f ? v * v : 0.f;
      oe[r * N + c] = from_f<TO>(v);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TA, typename TB, typename TO, int ACT, class Tile>
int launch_gmm(const void* a, const void* b, void* o, int64_t E, int64_t M,
               int64_t N, int64_t K, int64_t ldb, cudaStream_t stream) {
  const int64_t gx = (N + Tile::BN - 1) / Tile::BN;
  const int64_t gy = (M + Tile::BM - 1) / Tile::BM;
  if (gx > 0x7fffffffLL || gy > 65535 || E > 65535)
    return int(cudaErrorInvalidValue);
  constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
  const int vec_a = K % VA == 0 && aligned16(a);
  // the up columns start N past the gate columns: N % VB keeps them aligned
  const int vec_b = ldb % VB == 0 && N % VB == 0 && aligned16(b);
  const dim3 grid{unsigned(gx), unsigned(gy), unsigned(E)};
  gmm_kernel<TA, TB, TO, ACT, Tile><<<grid, Tile::THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TO*>(o), M, N, K, ldb, vec_a, vec_b);
  return int(cudaGetLastError());
}

// h = act(x @ w1) (float32), then out = h @ w2 (T)
template <typename T, int ACT, class Tile>
int launch_ffn(const void* x, const void* w1, const void* w2, void* h,
               void* out, int64_t E, int64_t C, int64_t d, int64_t f,
               cudaStream_t s) {
  constexpr int mult = (ACT == kSwiglu || ACT == kGeglu) ? 2 : 1;
  int rc = launch_gmm<T, T, float, ACT, Tile>(x, w1, h, E, C, f, d,
                                              mult * f, s);
  if (rc != 0) return rc;
  return launch_gmm<float, T, T, kNone, Tile>(h, w2, out, E, C, d, f, d, s);
}

template <typename T, class Tile>
int launch_act(int act, const void* x, const void* w1, const void* w2,
               void* h, void* out, int64_t E, int64_t C, int64_t d,
               int64_t f, cudaStream_t s) {
  switch (act) {
    case kSwiglu:
      return launch_ffn<T, kSwiglu, Tile>(x, w1, w2, h, out, E, C, d, f, s);
    case kGeglu:
      return launch_ffn<T, kGeglu, Tile>(x, w1, w2, h, out, E, C, d, f, s);
    case kGelu:
      return launch_ffn<T, kGelu, Tile>(x, w1, w2, h, out, E, C, d, f, s);
    case kRelu2:
      return launch_ffn<T, kRelu2, Tile>(x, w1, w2, h, out, E, C, d, f, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_tile(int act, const void* x, const void* w1, const void* w2,
                void* h, void* out, int64_t E, int64_t C, int64_t d,
                int64_t f, cudaStream_t s) {
  if (C <= SmallTile::BM)
    return launch_act<T, SmallTile>(act, x, w1, w2, h, out, E, C, d, f, s);
  return launch_act<T, LargeTile>(act, x, w1, w2, h, out, E, C, d, f, s);
}

}  // namespace

// out = act(x @ w1) @ w2 per expert over contiguous x (E, C, d), w1
// (E, d, m*f), w2 (E, f, d) and out (E, C, d); h is a float32 (E, C, f)
// scratch the caller allocates.  act: 0 swiglu, 1 geglu, 2 tanh-GELU,
// 3 squared ReLU.  bf16: x, w1, w2 and out are bfloat16 (else float32).
// Two launches on `stream`, no synchronisation; returns the first non-zero
// cudaGetLastError() (or cudaErrorInvalidValue for a bad act, an f that is
// not a multiple of 8, or a grid too large).  f = 0 zero-fills out.
extern "C" int repro_moe_gmm(const void* x, const void* w1, const void* w2,
                             void* h, void* out, int64_t E, int64_t C,
                             int64_t d, int64_t f, int act, int bf16,
                             void* stream) {
  if (E <= 0 || C <= 0 || d <= 0) return 0;
  if (f < 0 || f % 8) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 0)                                  // no hidden units: out = 0
    return int(cudaMemsetAsync(out, 0, size_t(E * C * d) * (bf16 ? 2 : 4),
                               s));
  if (bf16)
    return launch_tile<__nv_bfloat16>(act, x, w1, w2, h, out, E, C, d, f, s);
  return launch_tile<float>(act, x, w1, w2, h, out, E, C, d, f, s);
}
