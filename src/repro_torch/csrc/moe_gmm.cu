// MoE grouped matmul (the fused expert FFN) for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm/kernel.py:42
// (moe_gmm_tpu, body _gmm_kernel at :21): for every expert e of
// x (E, C, d), w1 (E, d, m*f), w2 (E, f, d),
//     out[e] = act(x[e] @ w1[e]) @ w2[e]
// with both products accumulated in float32, the activation in float32
// and out cast to x's dtype (float32 or bfloat16; x, w1 and w2 share it).
// act is swiglu or geglu (w1's output dim is [gate | up], m = 2),
// tanh-GELU or squared ReLU (m = 1).  An optional `rows` (int32, (E,), on
// the card) gives each expert's filled capacity rows: rows at or past
// rows[e] come out as zero rows, which they are anyway when the caller's
// payload rows past the fill are zero, as the MoE dispatch leaves them
// (act(0) = 0 for all four kinds).
//
// What it computes, not how the TPU does it: the Pallas kernel holds a
// (block_c, d) token tile and the expert's whole w1 and w2 in VMEM and
// runs both products on the MXU in one grid step.  At olmoe's width
// (d = 2048, m*f = 2048) one expert's h is 640 x 1024 and its weights are
// 12.6 MB of bf16, far beyond a Hopper block's 227 KB of shared memory; a
// block that kept h on chip would re-read the expert's weights for every
// row tile.  So the call is two launches on one stream, each a batched
// tiled product: 1. h = act(x @ w1) into an (E, C, f) scratch that the
// wrapper allocates, a block accumulating the gate and the up columns of
// its tile of h side by side so the activation is applied in the
// epilogue; 2. out = h @ w2.
//
// Two variants, chosen by the caller (the wrapper) from dtype and shape:
//
// * "tc", bf16 with d and f multiples of 8 (16-byte rows, which TMA and
//   cp.async need) and 16-byte-aligned tensors: the products run on the
//   tensor cores with float32 accumulators, and the loads of the next K
//   slices are in flight while the current one multiplies.  h is stored
//   in bf16 (the tensor cores' operand type; it is the rounding the JAX
//   model does between its two einsums).  The weights stay in their
//   stored (K, N) row-major layout, read as the MMAs' MN-major operand,
//   with no transposing copy.
//   - Prefill (C > 16) is bound by operations: 515 GFLOP an MoE layer at
//     olmoe's C = 640 (0.52 ms at 989 TFLOP/s bf16), which only wgmma
//     approaches.  A block owns 128 rows x 256 columns of b (128 h columns
//     for the gated kinds: the gate and up slices side by side): two
//     warpgroups each accumulate 64 x 256 in registers with m64n256k16
//     wgmmas, reading both operands straight from shared memory, while a
//     loader warp keeps a 4-slot ring of 48 KB K slices filled by TMA
//     (128-byte swizzle, one mbarrier a slot for "landed" and one for
//     "used").  Ragged C and K come back as zeros from the tensor map.
//   - Decode (C <= 16) is bound by the weight bytes: 805 MB of bf16 an MoE
//     layer at olmoe against 4 MB of x and out (0.24 ms at 3.35 TB/s).
//     The product is computed transposed, out^T = w^T . x^T, with
//     mma.sync m16n8k16: the weight's output columns fill the MMA's 16-row
//     M side and the <= 16 tokens its n = 8 side, so no tensor-core work
//     is padding (a 64-row wgmma tile would be 4-8x padding here).  A
//     block of 4 warps streams a 128-column weight strip (64 gate + 64 up
//     columns for the gated kinds) through a cp.async ring in 64-row
//     slices (16 KB, 3 in flight a block, 3 blocks a SM; XOR-swizzled so
//     every ldmatrix reads 8 distinct banks), reading every weight byte
//     once.  An expert with rows[e] == 0 reads no weight byte: its blocks
//     write zeros.
// * "simt", float32 and unaligned bf16: the products on the CUDA cores in
//   float32, h kept in float32, a (BM, BN) register-tiled block over K
//   slices staged in shared memory (8 x 128 tiles for C <= 8, 64 x 64
//   otherwise).  The float32 checks hold it to 1e-4, which TF32 would
//   break.  Any E, C and d; f a multiple of 8.
//
// In all of them, rows past C and columns past N are zeros on load and
// never stored, a row tile at or past rows[e] writes zeros and returns,
// and rows at or past rows[e] inside a tile come out as zeros.  Build
// without --use_fast_math (expf and tanhf, not their approximations).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu2 = 3, kNone = 4 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
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

// the epilogue: g is the (gate) accumulator, u the up one (gated kinds)
template <int ACT>
__device__ __forceinline__ float apply_act(float g, float u) {
  if (ACT == kSwiglu) return silu(g) * u;
  if (ACT == kGeglu) return gelu_tanh(g) * u;
  if (ACT == kGelu) return gelu_tanh(g);
  if (ACT == kRelu2) return g > 0.f ? g * g : 0.f;
  return g;
}

// expert e's filled rows: min(rows[e], M), or M without `rows`
__device__ __forceinline__ int64_t filled_rows(const int* rows, int64_t e,
                                               int64_t M) {
  if (rows == nullptr) return M;
  const int64_t r = rows[e];
  return r < 0 ? 0 : (r < M ? r : M);
}

// rows [r0, r1) x cols [c0, c1) of a row-major matrix with leading dim ld
// set to zero by the block's threads
template <typename T, int THREADS>
__device__ void zero_tile(T* o, int64_t ld, int64_t r0, int64_t r1,
                          int64_t c0, int64_t c1) {
  const int64_t w = c1 - c0;
  const T z = from_f<T>(0.f);
  for (int64_t i = threadIdx.x; i < (r1 - r0) * w; i += THREADS)
    o[(r0 + i / w) * ld + c0 + i % w] = z;
}

// ---------------------------------------------------------------------------
// the "simt" variant: float32 products on the CUDA cores
// ---------------------------------------------------------------------------

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
// ldb, a's rows at or past rows[e] read as zeros.  Gated kinds also
// accumulate b[e][:, N:2N] (the up columns) and store act(gate) * up.
// One block: a (BM, BN) tile of one expert.
template <typename TA, typename TB, typename TO, int ACT, class Tile>
__global__ void __launch_bounds__(Tile::THREADS)
gmm_simt_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                TO* __restrict__ o, const int* __restrict__ rows, int64_t M,
                int64_t N, int64_t K, int64_t ldb, int vec_a, int vec_b) {
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
  TO* oe = o + e * M * N;
  const int64_t Me = filled_rows(rows, e, M);
  if (m0 >= Me) {                            // no token in this row tile
    zero_tile<TO, THREADS>(oe, N, m0, m0 + BM < M ? m0 + BM : M, n0,
                           n0 + BN < N ? n0 + BN : N);
    return;
  }
  const TA* ae = a + e * M * K;
  const TB* be = b + e * K * ldb;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  float acc[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = accu[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    load_tile<TA, BM, BK, true, THREADS>(ae, K, m0, k0, Me, K, vec_a, As,
                                         AS);
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
      oe[r * N + c] = from_f<TO>(apply_act<ACT>(acc[i][j], accu[i][j]));
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename TA, typename TB, typename TO, int ACT, class Tile>
int launch_simt(const void* a, const void* b, void* o, const int* rows,
                int64_t E, int64_t M, int64_t N, int64_t K, int64_t ldb,
                cudaStream_t stream) {
  const int64_t gx = (N + Tile::BN - 1) / Tile::BN;
  const int64_t gy = (M + Tile::BM - 1) / Tile::BM;
  if (gx > 0x7fffffffLL || gy > 65535 || E > 65535)
    return int(cudaErrorInvalidValue);
  constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
  const int vec_a = K % VA == 0 && aligned16(a);
  // the up columns start N past the gate columns: N % VB keeps them aligned
  const int vec_b = ldb % VB == 0 && N % VB == 0 && aligned16(b);
  const dim3 grid{unsigned(gx), unsigned(gy), unsigned(E)};
  gmm_simt_kernel<TA, TB, TO, ACT, Tile><<<grid, Tile::THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TO*>(o), rows, M, N, K, ldb, vec_a, vec_b);
  return int(cudaGetLastError());
}

// h = act(x @ w1) (float32), then out = h @ w2 (T)
template <typename T, int ACT, class Tile>
int simt_ffn(const void* x, const void* w1, const void* w2, void* h,
             void* out, const int* rows, int64_t E, int64_t C, int64_t d,
             int64_t f, cudaStream_t s) {
  constexpr int mult = (ACT == kSwiglu || ACT == kGeglu) ? 2 : 1;
  int rc = launch_simt<T, T, float, ACT, Tile>(x, w1, h, rows, E, C, f, d,
                                               mult * f, s);
  if (rc != 0) return rc;
  return launch_simt<float, T, T, kNone, Tile>(h, w2, out, rows, E, C, d, f,
                                               d, s);
}

template <typename T, int ACT>
int simt_tile(const void* x, const void* w1, const void* w2, void* h,
              void* out, const int* rows, int64_t E, int64_t C, int64_t d,
              int64_t f, cudaStream_t s) {
  if (C <= SmallTile::BM)
    return simt_ffn<T, ACT, SmallTile>(x, w1, w2, h, out, rows, E, C, d, f,
                                       s);
  return simt_ffn<T, ACT, LargeTile>(x, w1, w2, h, out, rows, E, C, d, f, s);
}

// ---------------------------------------------------------------------------
// the "tc" variant: bf16 on the tensor cores (decode: a cp.async ring and
// mma.sync; prefill: TMA, mbarriers and wgmma)
// ---------------------------------------------------------------------------

// Byte offset of 16-byte chunk c of row r in a tile whose rows hold CHUNKS
// (8 or 16) chunks, XOR-swizzled so that the 8 rows an ldmatrix reads at
// one logical chunk land on 8 distinct bank groups.
template <int CHUNKS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(CHUNKS == 8 || CHUNKS == 16, "rows of 128 or 256 bytes");
  return uint32_t(r * CHUNKS * 16 + ((c ^ (r & 7)) << 4));
}

// Weight columns a block's strip starts at, for smem chunk c of a B/W tile
// of 16 chunks (128 columns): gated kinds take 64 gate columns [n0, n0 +
// 64) then the matching 64 up columns [N + n0, N + n0 + 64); the others
// 128 columns [n0, n0 + 128).  Returns the weight column and whether it
// lies inside N.
template <bool GATED>
__device__ __forceinline__ bool strip_col(int c, int64_t n0, int64_t N,
                                          int64_t& col) {
  if constexpr (GATED) {
    const int64_t hc = n0 + (c & 7) * 8;
    col = (c < 8 ? 0 : N) + hc;
    return hc < N;
  } else {
    col = n0 + c * 8;
    return col < N;
  }
}

// -- prefill (C > 16): wgmma tiles fed by TMA through an mbarrier ring ------

// d (64 x 256 float32: 128 registers a thread) += a (64 x 16, K-major)
// . b (16 x 256, MN-major: tnspB = 1), both read from shared memory
// through their descriptors
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2 * 128;               // two MMA warpgroups
constexpr int THREADS = CONSUMERS + 32;          // and one loader warp
constexpr int A_BYTES = BM * BK * 2;             // 16 KB: 128 rows of 128 B
constexpr int PANEL = BK * 64 * 2;               // 8 KB: 64 K-rows x 64 cols
constexpr int B_BYTES = 4 * PANEL;               // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // 48 KB
// the ring, 1 KB to align it for the 128-byte swizzle, the barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;
}  // namespace wg

// One block: rows [m0, m0 + 128) of expert e against 256 columns of b
// (128 gate + the matching 128 up columns for the gated kinds), in four
// 64-column panels.  Warpgroups 0 and 1 own rows 0-63 and 64-127, each
// accumulating 64 x 256 in registers with m64n256k16 wgmmas; warp 8
// issues the TMA loads, running up to 4 K slices of 64 ahead.  A slot is
// reloaded once both warpgroups' MMAs on it have completed (the "empty"
// barrier, 256 arrivals); a slot's MMAs start when its bytes have landed
// (the "full" barrier).  Rows of a past M and K past the end are zeros
// from the tensor map; rows at or past rows[e] are stored as zeros.
template <int ACT>
__global__ void __launch_bounds__(wg::THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 bf16* __restrict__ o, const int* __restrict__ rows,
                 int64_t M, int64_t N, int K) {
  using namespace wg;
  constexpr bool GATED = ACT == kSwiglu || ACT == kGeglu;
  constexpr int HN = GATED ? BN / 2 : BN;        // output columns a block
  extern __shared__ __align__(128) unsigned char smem[];

  const int e = blockIdx.z;
  const int64_t m0 = int64_t(blockIdx.y) * BM;
  const int64_t n0 = int64_t(blockIdx.x) * HN;
  bf16* oe = o + e * M * N;
  const int64_t Me = filled_rows(rows, e, M);
  if (m0 >= Me) {                                // no token in this tile
    zero_tile<bf16, THREADS>(oe, N, m0, m0 + BM < M ? m0 + BM : M, n0,
                             n0 + HN < N ? n0 + HN : N);
    return;
  }
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // + 8 s
  const uint32_t empty = full + STAGES * 8;           // + 8 s
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int KT = (K + BK - 1) / BK;

  if (warp == CONSUMERS / 32) {                  // the loader warp
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES)                        // its MMAs are done
          mbar_wait(empty + 8 * s, (kt / STAGES - 1) & 1);
        const uint32_t sa = ring + s * STAGE_BYTES, sb = sa + A_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_3d(sa, &map_a, full + 8 * s, kt * BK, int(m0), e);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int col = GATED ? (p < 2 ? 0 : int(N)) + int(n0) + (p & 1) * 64
                                : int(n0) + p * 64;
          tma_load_3d(sb + p * PANEL, &map_b, full + 8 * s, col, kt * BK, e);
        }
      }
    }
    return;
  }

  const int wgi = warp >> 2;                     // rows wgi * 64 + [0, 64)
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t sa = ring + s * STAGE_BYTES + wgi * 64 * 128;
    const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: K-major rows of 128 B, 8-row atoms 1 KB apart, k16 = 32 B;
      // B: MN-major panels, 8-row K groups 1 KB apart, panels 8 KB apart,
      // k16 = 16 rows = 2 KB
      wgmma_m64n256k16(acc, smem_desc(sa + kk * 32, 16, 1024),
                       smem_desc(sb + kk * 2048, PANEL, 1024));
    wgmma_commit();
    if (kt > 0) {                                // slice kt - 1 is used
      wgmma_wait<1>();
      mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: accumulator 4j + q holds row (warp % 4) * 16 + lane / 4
  // (+ 8 for q >= 2), column 8j + 2 (lane % 4) (+ 1 for odd q)
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int64_t r = m0 + wgi * 64 + (warp & 3) * 16 + g + hr * 8;
    if (r >= M) continue;
    const bool live = r < Me;
#pragma unroll
    for (int j = 0; j < HN / 8; ++j) {
      const int64_t c = n0 + j * 8 + t4 * 2;     // N % 8 == 0: c + 1 < N
      if (c >= N) continue;
      constexpr int U = GATED ? HN / 8 : 0;      // the up tile's offset
      const float v0 = apply_act<ACT>(acc[4 * j + 2 * hr],
                                      acc[4 * (j + U) + 2 * hr]);
      const float v1 = apply_act<ACT>(acc[4 * j + 2 * hr + 1],
                                      acc[4 * (j + U) + 2 * hr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(oe + r * N + c) =
          live ? __floats2bfloat162_rn(v0, v1) : __floats2bfloat162_rn(0, 0);
    }
  }
}

// -- decode: o[e] (M <= 16, N) = epilogue(a[e] (M, K) @ b[e] (K, ldb)),
//    computed as o^T = b^T . a^T ---------------------------------------------
namespace coltile {
constexpr int BW = 128, BK = 64, TOK = 16, STAGES = 4, THREADS = 128;
constexpr int W_BYTES = BK * BW * 2;             // 16 KB: 64 rows x 16 chunks
constexpr int X_BYTES = TOK * BK * 2;            // 2 KB: 16 rows x 8 chunks
constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES;       // 72 KB
}  // namespace coltile

// One block: a 128-column strip of expert e's b (64 gate + 64 up columns
// for the gated kinds) against all of its <= 16 rows of a.  4 warps: warp
// w owns two m16 tiles of strip columns (gated: gate columns w*16 + [0,
// 16) and the matching up columns; else columns w*32 + [0, 32)) and NT n8
// tiles of tokens.
template <int ACT, int NT>
__global__ void __launch_bounds__(coltile::THREADS)
gmm_mma_t_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                 bf16* __restrict__ o, const int* __restrict__ rows,
                 int64_t M, int64_t N, int64_t K, int64_t ldb) {
  using namespace coltile;
  constexpr bool GATED = ACT == kSwiglu || ACT == kGeglu;
  constexpr int HN = GATED ? BW / 2 : BW;
  extern __shared__ __align__(128) unsigned char smem[];

  const int64_t e = blockIdx.y;
  const int64_t n0 = int64_t(blockIdx.x) * HN;
  bf16* oe = o + e * M * N;
  const int64_t Me = filled_rows(rows, e, M);
  if (Me == 0) {                                 // no token: no weight read
    zero_tile<bf16, THREADS>(oe, N, 0, M, n0, n0 + HN < N ? n0 + HN : N);
    return;
  }
  const bf16* ae = a + e * M * K;
  const bf16* be = b + e * K * ldb;
  const uint32_t sbase = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto load_stage = [&](int stage, int64_t k0) {
    const uint32_t sw = sbase + stage * STAGE_BYTES;
    const uint32_t sx = sw + W_BYTES;
#pragma unroll
    for (int i = 0; i < 8; ++i) {                // W: 1024 chunks
      const int idx = tid + i * THREADS;
      const int r = idx >> 4, c = idx & 15;
      const int64_t gk = k0 + r;
      int64_t col;
      const bool ok = strip_col<GATED>(c, n0, N, col) && gk < K;
      cp_async16(sw + swz<16>(r, c), ok ? be + gk * ldb + col : be, ok);
    }
    {                                            // x: 128 chunks
      const int r = tid >> 3, c = tid & 7;
      const int64_t gk = k0 + c * 8;
      const bool ok = r < Me && gk < K;
      cp_async16(sx + swz<8>(r, c), ok ? ae + r * K + gk : ae, ok);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int KT = int((K + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, int64_t(s) * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) load_stage(nk % STAGES, int64_t(nk) * BK);
      cp_async_commit();
    }
    const uint32_t sw = sbase + (kt % STAGES) * STAGE_BYTES;
    const uint32_t sx = sw + W_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A = the weight slice transposed: matrices (k 0-7, n 0-7), (k 0-7,
      // n 8-15), (k 8-15, n 0-7), (k 8-15, n 8-15)
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int col = GATED ? mt * 64 + warp * 16 : warp * 32 + mt * 16;
        const int r = kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        ldsm_x4_t(af[mt], sw + swz<16>(r, (col >> 3) + ((lane >> 3) & 1)));
      }
      // B = the token slice: matrices (tokens 0-7, k 0-7), (0-7, k 8-15),
      // then tokens 8-15
      uint32_t bfr[NT][2];
      const int c = kk * 2 + ((lane >> 3) & 1);
      if constexpr (NT == 2) {
        const int r = (lane & 7) + (lane >> 4) * 8;
        uint32_t t[4];
        ldsm_x4(t, sx + swz<8>(r, c));
        bfr[0][0] = t[0];
        bfr[0][1] = t[1];
        bfr[1][0] = t[2];
        bfr[1][1] = t[3];
      } else {
        uint32_t t[2];
        ldsm_x2(t, sx + swz<8>(lane & 7, c));
        bfr[0][0] = t[0];
        bfr[0][1] = t[1];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: lane holds strip columns g, g + 8 and tokens 2t, 2t + 1
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < (GATED ? 1 : 2); ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t tok = nt * 8 + t4 * 2 + (q & 1);
        const int64_t col = n0 + (GATED ? warp * 16 : warp * 32 + mt * 16) +
                            (q >> 1) * 8 + g;
        if (tok >= M || col >= N) continue;
        const float v = apply_act<ACT>(acc[mt][nt][q],
                                       acc[GATED ? 1 : mt][nt][q]);
        oe[tok * N + col] = __float2bfloat16_rn(v);
      }
}

template <typename Kernel>
int opt_in(Kernel kern, int bytes, bool& done) {   // once per process
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return int(err);
}

// a bf16 (E, rows, cols) row-major tensor as a 3-D tensor map whose box is
// (box_cols, box_rows, 1), 128-byte swizzled; out-of-range elements read
// as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t E, int64_t rows,
                int64_t cols, int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(E)};
  const cuuint64_t strides[2] = {cuuint64_t(cols * 2),
                                 cuuint64_t(rows * cols * 2)};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ACT>
int launch_wgmma(const void* a, const void* b, void* o, const int* rows,
                 int64_t E, int64_t M, int64_t N, int64_t K, int64_t ldb,
                 cudaStream_t s) {
  constexpr bool GATED = ACT == kSwiglu || ACT == kGeglu;
  constexpr int HN = GATED ? wg::BN / 2 : wg::BN;
  static bool opted = false;
  auto kern = gmm_wgmma_kernel<ACT>;
  if (int rc = opt_in(kern, wg::SMEM, opted)) return rc;
  const int64_t gx = (N + HN - 1) / HN, gy = (M + wg::BM - 1) / wg::BM;
  if (gx > 0x7fffffffLL || gy > 65535 || E > 65535 || K > 0x7fffffffLL ||
      ldb > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, E, M, K, 64, wg::BM) ||
      !tensor_map(&map_b, b, E, K, ldb, 64, wg::BK))
    return int(cudaErrorInvalidValue);
  const dim3 grid{unsigned(gx), unsigned(gy), unsigned(E)};
  kern<<<grid, wg::THREADS, wg::SMEM, s>>>(map_a, map_b,
                                           static_cast<bf16*>(o), rows, M,
                                           N, int(K));
  return int(cudaGetLastError());
}

template <int ACT, int NT>
int launch_coltile(const void* a, const void* b, void* o, const int* rows,
                   int64_t E, int64_t M, int64_t N, int64_t K, int64_t ldb,
                   cudaStream_t s) {
  constexpr bool GATED = ACT == kSwiglu || ACT == kGeglu;
  constexpr int HN = GATED ? coltile::BW / 2 : coltile::BW;
  static bool opted = false;
  auto kern = gmm_mma_t_kernel<ACT, NT>;
  if (int rc = opt_in(kern, coltile::SMEM, opted)) return rc;
  const int64_t gx = (N + HN - 1) / HN;
  if (gx > 0x7fffffffLL || E > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid{unsigned(gx), unsigned(E)};
  kern<<<grid, coltile::THREADS, coltile::SMEM, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(o), rows, M, N, K, ldb);
  return int(cudaGetLastError());
}

// h = act(x @ w1) (bf16), then out = h @ w2 (bf16)
template <int ACT>
int tc_ffn(const void* x, const void* w1, const void* w2, void* h,
           void* out, const int* rows, int64_t E, int64_t C, int64_t d,
           int64_t f, cudaStream_t s) {
  constexpr int mult = (ACT == kSwiglu || ACT == kGeglu) ? 2 : 1;
  int rc;
  if (C <= 8) {
    rc = launch_coltile<ACT, 1>(x, w1, h, rows, E, C, f, d, mult * f, s);
    if (rc == 0)
      rc = launch_coltile<kNone, 1>(h, w2, out, rows, E, C, d, f, d, s);
  } else if (C <= coltile::TOK) {
    rc = launch_coltile<ACT, 2>(x, w1, h, rows, E, C, f, d, mult * f, s);
    if (rc == 0)
      rc = launch_coltile<kNone, 2>(h, w2, out, rows, E, C, d, f, d, s);
  } else {
    rc = launch_wgmma<ACT>(x, w1, h, rows, E, C, f, d, mult * f, s);
    if (rc == 0)
      rc = launch_wgmma<kNone>(h, w2, out, rows, E, C, d, f, d, s);
  }
  return rc;
}

}  // namespace

// out = act(x @ w1) @ w2 per expert over contiguous x (E, C, d), w1
// (E, d, m*f), w2 (E, f, d) and out (E, C, d).  act: 0 swiglu, 1 geglu,
// 2 tanh-GELU, 3 squared ReLU.  bf16: x, w1, w2 and out are bfloat16 (else
// float32).  rows: null, or an int32 (E,) array on the card, each
// expert's filled rows.  variant 1 ("tc", the tensor cores) needs bf16,
// d % 8 == 0 and 16-byte-aligned x, w1, w2, h and out, and takes h as a
// bfloat16 (E, C, f) scratch; variant 0 ("simt") takes h as float32.  Two
// launches on `stream`, no synchronisation; returns the first non-zero
// cudaGetLastError() (or cudaErrorInvalidValue for a bad act or variant,
// an f that is not a multiple of 8, or a grid too large).  f = 0
// zero-fills out.
extern "C" int repro_moe_gmm(const void* x, const void* w1, const void* w2,
                             void* h, void* out, const int* rows, int64_t E,
                             int64_t C, int64_t d, int64_t f, int act,
                             int bf16_io, int variant, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0) return 0;
  if (f < 0 || f % 8 || act < 0 || act > kRelu2)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 0)                                  // no hidden units: out = 0
    return int(cudaMemsetAsync(out, 0,
                               size_t(E * C * d) * (bf16_io ? 2 : 4), s));
  if (variant == 1) {
    if (!bf16_io || d % 8 || !aligned16(x) || !aligned16(w1) ||
        !aligned16(w2) || !aligned16(h) || !aligned16(out))
      return int(cudaErrorInvalidValue);
    switch (act) {
      case kSwiglu: return tc_ffn<kSwiglu>(x, w1, w2, h, out, rows, E, C, d,
                                           f, s);
      case kGeglu: return tc_ffn<kGeglu>(x, w1, w2, h, out, rows, E, C, d,
                                         f, s);
      case kGelu: return tc_ffn<kGelu>(x, w1, w2, h, out, rows, E, C, d, f,
                                       s);
      default: return tc_ffn<kRelu2>(x, w1, w2, h, out, rows, E, C, d, f, s);
    }
  }
  if (variant != 0) return int(cudaErrorInvalidValue);
  if (bf16_io) {
    switch (act) {
      case kSwiglu: return simt_tile<bf16, kSwiglu>(x, w1, w2, h, out, rows,
                                                    E, C, d, f, s);
      case kGeglu: return simt_tile<bf16, kGeglu>(x, w1, w2, h, out, rows,
                                                  E, C, d, f, s);
      case kGelu: return simt_tile<bf16, kGelu>(x, w1, w2, h, out, rows, E,
                                                C, d, f, s);
      default: return simt_tile<bf16, kRelu2>(x, w1, w2, h, out, rows, E,
                                              C, d, f, s);
    }
  }
  switch (act) {
    case kSwiglu: return simt_tile<float, kSwiglu>(x, w1, w2, h, out, rows,
                                                   E, C, d, f, s);
    case kGeglu: return simt_tile<float, kGeglu>(x, w1, w2, h, out, rows, E,
                                                 C, d, f, s);
    case kGelu: return simt_tile<float, kGelu>(x, w1, w2, h, out, rows, E,
                                               C, d, f, s);
    default: return simt_tile<float, kRelu2>(x, w1, w2, h, out, rows, E, C,
                                             d, f, s);
  }
}
