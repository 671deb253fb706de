// Flash attention (forward) for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py:85 (flash_attention_tpu, body
// _attn_kernel at :38): q (b, hq, sq, dh), k/v (b, hkv, skv, dh), float32
// or bfloat16, output in q's dtype.  GQA maps q head h to kv head
// h / (hq / hkv).  Masks come from global positions, q_pos = q_offset +
// row: causal keeps k_pos <= q_pos, a window > 0 keeps k_pos > q_pos -
// window.  Masked scores are -1e30 (never -inf), so a row that sees no
// key averages all keys uniformly, as the reference does; the output is
// acc / max(l, 1e-37).  All statistics (running max m, exp-sum l,
// accumulator) are float32.  The kernel is instantiated for dh
// 16/32/64/128/256; the wrapper zero-pads any other dh up to the next of
// these (zero columns add nothing to q.k, and the padded output columns
// are dropped), which is why the scale is an argument.
//
// What it computes, not how the TPU grid does it: the Pallas kernel walks
// KV blocks along a sequential "arbitrary" grid axis and carries (m, l,
// acc) in VMEM scratch between grid steps.  Blocks on this card run in no
// order, so one block owns one (batch, q head, q tile) and loops over KV
// tiles itself, staging each K and V tile in shared memory.  Any sq and
// skv are taken: the ragged last q tile is not written past sq, and key
// columns past skv get -inf (weight exactly 0, they are not keys), where
// the Pallas wrapper halves its blocks until they divide.
//
// Bound: at the prefill shapes (s = 2048, dh = 256) the work is 4*dh flops
// per visible (q, k) pair against a few MB of q/k/v/o, so the bound is
// the tensor cores' rate (989 TFLOP/s bf16); at short sequences it is the
// bytes.  Both variants do only the visible work: a q tile visits just
// the KV tiles inside the union of its rows' visible ranges [q_pos -
// window + 1, q_pos] (the causal triangle, the sliding-window band),
// which keeps a 512-wide window at 1/4 of the causal cost at s = 2048.
// Skipping is exact: a skipped tile is masked for every row, and a row's
// masked scores get weight exp(-1e30 - m) = 0 once the row has seen a
// key.  Only when some row of the tile sees no key at all does the tile
// visit every KV tile, so that row comes out as the uniform average over
// all skv keys.
//
// Two variants, chosen by the caller (the wrapper) from dtype and head
// dim; either raises on failure, neither gives way to the other:
//
// * "simt" (repro_flash_attention), float32 and the padded head dims 16
//   and 32, over contiguous (b, h, s, dh) tensors: the dots on the CUDA
//   cores in float32 (67 TFLOP/s peak), q scaled by `scale` before the
//   dot.  Each thread keeps a register tile of scores (S = Q K^T) and of
//   the output accumulator, reading Q, K, V and P from shared memory
//   (rows padded by one float, so the lanes of a warp fall on distinct
//   banks); the softmax goes through shared memory, one warp a row.
//   Shared memory: 30 KB (dh 16) to 103 KB (dh 256).
// * "tc" (repro_flash_attention_tc), bf16 at the padded head dims 64, 128
//   and 256, over (b, h, s, dh) views with any strides whose head dim is
//   contiguous (the seq-major (s, b, h, dh) layout of the model path is
//   read and written in place): both products on the tensor cores with
//   wgmma, float32 accumulators.  A block owns 128 q rows of one (batch,
//   q head): two consumer warpgroups of 64 rows and a loader warpgroup,
//   which hands its registers to them (setmaxnreg 24 / 240: at dh 256 the
//   O accumulator alone is 128 f32 registers a thread).  One loader thread
//   brings the Q tile once and the K and V tiles through a ring of 2
//   stages by TMA (128-byte swizzle, dh in 64-column panels; "landed" and
//   "used" mbarriers for K and for V of each stage).  S = Q K^T is
//   m64n{BK}k16 with both operands in shared memory (K read K-major); the
//   scale multiplies S in float32 after the dot (q stays bf16), with
//   log2(e) folded in after masking so the softmax runs on ex2.  Masks are
//   applied in registers from global positions, and skipped for a tile
//   wholly inside every row's visible band.  The online softmax stays in
//   registers: a row's max and sum go over the 4-thread quad that holds it
//   (__shfl_xor_sync 1, 2), and O is rescaled in place.  P is rounded to
//   bf16 in registers and fed as the register A operand of O += P V
//   (m64n{dh}k16): the f32 S fragment of a k16 column slice is, pair by
//   pair, the A fragment of that slice.  V is read MN-major (tnspB = 1)
//   where TMA put it, with no transposing copy.  Overlap: a warpgroup
//   issues S_i = Q K_i^T together with O += P_{i-1} V_{i-1} and runs the
//   softmax of S_i while the second product runs; the two warpgroups take
//   turns to issue (named barriers), so one's softmax also runs under the
//   other's products; K is released as soon as S is computed, which keeps
//   the next K a tile ahead.  l is summed from the float32 p, and O /
//   max(l, 1e-37) is stored as bf16 pairs straight from registers,
//   clipped at sq.  Tiles: BK = 128 keys at dh 64 and 128, 64 at dh 256;
//   shared memory 80 KB (dh 64), 160 KB (128), 192 KB (256).  The tensor
//   maps give s a dimension of its own, (dh, s, h, b), so a ragged tile's
//   loads read zeros past s (forced to -inf as keys), never the next
//   head's rows.  q tiles are launched heaviest first (the last causal
//   tile sees the most keys), which shortens the tail wave.
//
// Build without --use_fast_math: the simt variant keeps expf, not __expf
// (the tc variant's ex2.approx is written out where it is meant).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kMasked = -1e30f;        // the reference's NEG_INF

// q rows (BQ) and kv rows (BK) of a tile, by head dim: the accumulator
// (BQ x dh / 128 threads) stays at or under 64 registers a thread
template <int DH> struct Tile { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

// scores: SY x SX threads, each (BQ / SY) x (BK / SX) scores
constexpr int SX = 16;
constexpr int SY = kThreads / SX;

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

// rows [r0, r0 + nrows) of a (rows_total, DH) matrix -> float smem rows of
// `stride` floats, times `mul`; rows at or past rows_total become zeros.
// 16-byte vector loads (4 float32 / 8 bfloat16), neighbouring threads on
// neighbouring addresses.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t r0, int nrows,
                                          int64_t rows_total, float* dst,
                                          int stride, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = DH / VEC;
  for (int idx = threadIdx.x; idx < nrows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    float* out = dst + r * stride + c;
    if (r0 + r < rows_total) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (r0 + r) * DH + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]) * mul;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = 0.f;
    }
  }
}

__device__ __forceinline__ int64_t visible_lo(int64_t p, int64_t window) {
  if (window <= 0) return 0;
  const int64_t lo = p - window + 1;
  return lo > 0 ? lo : 0;
}

__device__ __forceinline__ int64_t visible_hi(int64_t p, int64_t skv,
                                              int causal) {
  return (causal && p < skv - 1) ? p : skv - 1;
}

template <int DH, int BQ, int BK>
struct Smem {
  static constexpr int QS = DH + 1;      // padded row strides (floats)
  static constexpr int KS = DH + 1;
  static constexpr int PS = BK + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * QS;
  static constexpr int V = K + BK * KS;
  static constexpr int P = V + BK * DH;
  static constexpr int M = P + BQ * PS;  // running max
  static constexpr int L = M + BQ;       // running exp-sum
  static constexpr int A = L + BQ;       // this tile's rescale factor
  static constexpr int FLOATS = A + BQ;
  static constexpr size_t BYTES = size_t(FLOATS) * sizeof(float);
};

template <typename T, int DH, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int hq,
                 int hkv, int64_t sq, int64_t skv, int causal,
                 int64_t window, int64_t q_offset, float scale) {
  using S = Smem<DH, BQ, BK>;
  constexpr int AX = DH < 32 ? DH : 32;  // accumulator: lanes across dh
  constexpr int AY = kThreads / AX;      //   and row groups
  constexpr int RA = BQ / AY;            // accumulator rows a thread owns
  constexpr int CA = DH / AX;            //   and columns
  constexpr int RS = BQ / SY;            // score rows a thread owns
  constexpr int CS = BK / SX;            //   and columns
  constexpr int NPL = BK / 32;           // softmax columns a lane owns
  static_assert(BQ % SY == 0 && BK % SX == 0 && BQ % AY == 0 &&
                DH % AX == 0 && BK % 32 == 0, "tile shape");

  extern __shared__ float smem[];
  float* Qs = smem + S::Q;
  float* Ks = smem + S::K;
  float* Vs = smem + S::V;
  float* Ps = smem + S::P;
  float* m_s = smem + S::M;
  float* l_s = smem + S::L;
  float* a_s = smem + S::A;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int64_t q0 = int64_t(blockIdx.x) * BQ;
  const int nq = int(sq - q0 < BQ ? sq - q0 : BQ);   // valid q rows
  const T* qp = q + ((bi * hq + h) * sq) * DH;
  const T* kp = k + ((bi * hkv + hk) * skv) * DH;
  const T* vp = v + ((bi * hkv + hk) * skv) * DH;
  T* op = o + ((bi * hq + h) * sq) * DH;

  load_tile<T, DH>(qp, q0, BQ, sq, Qs, S::QS, scale);
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }

  // the KV range this tile visits (see the header)
  const int64_t pos0 = q_offset + q0;
  bool empty = false;
  for (int r = tid; r < nq; r += kThreads)
    empty |= visible_lo(pos0 + r, window) >
             visible_hi(pos0 + r, skv, causal);
  const bool any_empty = __syncthreads_or(empty);
  int64_t k_lo = 0, k_hi = skv - 1;
  if (!any_empty) {
    k_lo = visible_lo(pos0, window);
    k_hi = visible_hi(pos0 + nq - 1, skv, causal);
  }

  float acc[RA][CA];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < CA; ++j) acc[i][j] = 0.f;

  const int ty = tid / SX, tx = tid % SX;
  const int ay = tid / AX, ax = tid % AX;
  const int warp = tid >> 5, lane = tid & 31;

  for (int64_t kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int64_t k0 = kt * BK;
    load_tile<T, DH>(kp, k0, BK, skv, Ks, S::KS, 1.f);
    load_tile<T, DH>(vp, k0, BK, skv, Vs, DH, 1.f);
    __syncthreads();

    // S = (scale q) K^T, masked, into Ps
    float s[RS][CS];
#pragma unroll
    for (int i = 0; i < RS; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RS], kv[CS];
#pragma unroll
      for (int i = 0; i < RS; ++i) qv[i] = Qs[(ty + i * SY) * S::QS + d];
#pragma unroll
      for (int j = 0; j < CS; ++j) kv[j] = Ks[(tx + j * SX) * S::KS + d];
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int r = ty + i * SY;
      const int64_t qpos = pos0 + r;
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        const int c = tx + j * SX;
        const int64_t kpos = k0 + c;
        float val = s[i][j];
        if (kpos >= skv)
          val = -INFINITY;                 // not a key: weight 0
        else if ((causal && qpos < kpos) ||
                 (window > 0 && kpos <= qpos - window))
          val = kMasked;
        Ps[r * S::PS + c] = val;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float x[NPL];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        x[t] = Ps[r * S::PS + lane + 32 * t];
        mx = fmaxf(mx, x[t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NPL; ++t) {
        const float p = expf(x[t] - m_new);
        Ps[r * S::PS + lane + 32 * t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        a_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * a + P V
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const float a = a_s[ay + i * AY];
#pragma unroll
      for (int j = 0; j < CA; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RA], vv[CA];
#pragma unroll
      for (int i = 0; i < RA; ++i) pv[i] = Ps[(ay + i * AY) * S::PS + c];
#pragma unroll
      for (int j = 0; j < CA; ++j) vv[j] = Vs[c * DH + ax + j * AX];
#pragma unroll
      for (int i = 0; i < RA; ++i)
#pragma unroll
        for (int j = 0; j < CA; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();                       // Ks, Vs, Ps, a_s are reused
  }

#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = ay + i * AY;
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-37f);
#pragma unroll
    for (int j = 0; j < CA; ++j)
      op[(q0 + r) * DH + ax + j * AX] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t hq, int64_t hkv, int64_t sq, int64_t skv, int causal,
           int64_t window, int64_t q_offset, float scale,
           cudaStream_t stream) {
  constexpr int BQ = Tile<DH>::BQ, BK = Tile<DH>::BK;
  constexpr size_t smem = Smem<DH, BQ, BK>::BYTES;
  auto kern = flash_fwd_kernel<T, DH, BQ, BK>;
  static bool opted_in = false;            // once per process (one card)
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    opted_in = true;
  }
  const int64_t n_qt = (sq + BQ - 1) / BQ;
  if (n_qt > 0x7fffffffLL || hq > 65535 || b > 65535)
    return int(cudaErrorInvalidValue);
  const dim3 grid{static_cast<unsigned>(n_qt), static_cast<unsigned>(hq),
                  static_cast<unsigned>(b)};
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), int(hq), int(hkv), sq,
      skv, causal, window, q_offset, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_dh(int64_t dh, const void* q, const void* k, const void* v,
              void* o, int64_t b, int64_t hq, int64_t hkv, int64_t sq,
              int64_t skv, int causal, int64_t window, int64_t q_offset,
              float scale, cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           q_offset, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           q_offset, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           q_offset, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                            q_offset, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                            q_offset, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// the "tc" variant: bf16 on the tensor cores (TMA, mbarriers, wgmma)
// ---------------------------------------------------------------------------

using namespace sm90;
using bf16 = __nv_bfloat16;

// two floats as a bf16 pair: lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64 f32, 32 registers a thread) (+)= a (64 x 16, K-major,
// shared memory) . b (64 x 16, K-major: tnspB = 0); the previous d is
// kept when `acc` is non-zero, else ignored
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128 f32, 64 registers a thread) (+)= a (64 x 16, K-major,
// shared memory) . b (128 x 16, K-major: tnspB = 0); the previous d is
// kept when `acc` is non-zero, else ignored
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 f32, 32 registers a thread) += a (64 x 16 bf16, from
// registers: 4 a thread) . b (16 x 64, MN-major: tnspB = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32, 64 registers a thread) += a (64 x 16 bf16, from
// registers: 4 a thread) . b (16 x 128, MN-major: tnspB = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32, 128 registers a thread) += a (64 x 16 bf16, from
// registers: 4 a thread) . b (16 x 256, MN-major: tnspB = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

namespace tc {
constexpr int BM = 128;                  // q rows a block
constexpr int CONSUMERS = 2 * 128;       // two MMA warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128; // and a loader warpgroup
// registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 64 K
constexpr int LOADER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 2;                // K/V ring depth
constexpr int PANEL_COLS = 64;           // head-dim columns a 128-byte panel
template <int DH>
struct Cfg {
  static constexpr int BK = DH == 256 ? 64 : 128;  // keys a KV tile
  static constexpr int PANELS = DH / PANEL_COLS;
  static constexpr int Q_PANEL = BM * 128;          // bytes
  static constexpr int KV_PANEL = BK * 128;
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K or V tile
  static constexpr int K0 = Q_BYTES;                  // K of stage s at
  static constexpr int V0 = K0 + STAGES * KV_BYTES;   //   K0 + s KV_BYTES
  static constexpr int BAR = V0 + STAGES * KV_BYTES;  // mbarriers (below)
  // 1 KB to align the ring for the 128-byte swizzle, then the barriers: Q
  // landed; K and V of each stage landed; K and V of each stage used
  static constexpr int SMEM = 1024 + BAR + (1 + 4 * STAGES) * 8;
  static_assert(DH % PANEL_COLS == 0 && SMEM <= 232448, "tile shape");
};
}  // namespace tc

// visible keys of query position p, clamped to [0, skv] and [-1, skv - 1]:
// key c is visible iff lo <= c <= hi
__device__ __forceinline__ void visible_range(int64_t p, int64_t skv,
                                              int causal, int64_t window,
                                              int& lo, int& hi) {
  const int64_t l = visible_lo(p, window), h = visible_hi(p, skv, causal);
  lo = int(l < skv ? l : skv);
  hi = int(h > -1 ? h : -1);
}

// Named barriers 1 and 2 order the two consumer warpgroups' MMA issue
// (ping-pong): a warpgroup issues its products when the other has issued
// its own, so one's softmax runs while the other's products do.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(tc::CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(tc::CONSUMERS)
               : "memory");
}
// 2^x on the special-function unit; -inf and -1e30 give 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block: q rows [q0, q0 + 128) of (batch blockIdx.y, q head
// blockIdx.x), q tile gridDim.z - 1 - blockIdx.z (heaviest first).  Warps
// 0-3 and 4-7 are the consumer warpgroups of rows 0-63 and 64-127; warps
// 8-11 give their registers to the consumers (setmaxnreg: at dh 256 the
// O accumulator alone is 128 registers a consumer thread), and one thread
// of warp 8 issues the TMA loads.  A consumer warpgroup is pipelined by
// one tile: it issues S_i = Q K_i^T together with O += P_{i-1} V_{i-1},
// then runs the softmax of S_i while the second product is in flight.  K
// is released as soon as S is computed, V when its product is, so two
// stages keep the next K one tile ahead.  o is written through its
// element strides.
template <int DH>
__global__ void __launch_bounds__(tc::THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    bf16* __restrict__ o, int64_t os_b, int64_t os_h,
                    int64_t os_s, int hq, int hkv, int sq, int skv,
                    int causal, int64_t window, int64_t q_offset,
                    float scale_log2) {
  using C = tc::Cfg<DH>;
  constexpr int BK = C::BK, STAGES = tc::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_tc[];
  const uint32_t base = (smem_u32(smem_tc) + 1023) & ~1023u;
  const uint32_t bar_q = base + C::BAR;
  const uint32_t bar_k = bar_q + 8;            // + 8 s: K of stage s landed
  const uint32_t bar_v = bar_k + 8 * STAGES;   // + 8 s: V of stage s landed
  const uint32_t bar_ku = bar_v + 8 * STAGES;  // + 8 s: K of stage s used
  const uint32_t bar_vu = bar_ku + 8 * STAGES; // + 8 s: V of stage s used
  const int h = blockIdx.x, bi = blockIdx.y;
  const int hk = h / (hq / hkv);
  const int q0 = int(gridDim.z - 1 - blockIdx.z) * tc::BM;
  const int nq = sq - q0 < tc::BM ? sq - q0 : tc::BM;   // valid q rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ku + 8 * s, tc::CONSUMERS);
      mbar_init(bar_vu + 8 * s, tc::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the KV range this tile visits, as the simt variant's (see the header);
  // the barrier also publishes the mbarriers' initialisation
  const int64_t pos0 = q_offset + q0;
  const bool empty = tid < nq && visible_lo(pos0 + tid, window) >
                                     visible_hi(pos0 + tid, skv, causal);
  const bool any_empty = __syncthreads_or(empty);
  int64_t k_lo = 0, k_hi = skv - 1;
  if (!any_empty) {
    k_lo = visible_lo(pos0, window);
    k_hi = visible_hi(pos0 + nq - 1, skv, causal);
  }
  const int kt0 = int(k_lo / BK), nt = int(k_hi / BK) - kt0 + 1;

  if (warp >= tc::CONSUMERS / 32) {              // the loader warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(tc::LOADER_REGS));
    if (warp == tc::CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < C::PANELS; ++p)
        tma_load_4d(base + p * C::Q_PANEL, &map_q, bar_q, p * 64, q0, h, bi);
      for (int it = 0; it < nt; ++it) {
        const int s = it % STAGES;
        const uint32_t used = (it / STAGES - 1) & 1;
        const int k0 = (kt0 + it) * BK;
        if (it >= STAGES) mbar_wait(bar_ku + 8 * s, used);
        mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_4d(base + C::K0 + s * C::KV_BYTES + p * C::KV_PANEL,
                      &map_k, bar_k + 8 * s, p * 64, k0, hk, bi);
        if (it >= STAGES) mbar_wait(bar_vu + 8 * s, used);
        mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int p = 0; p < C::PANELS; ++p)
          tma_load_4d(base + C::V0 + s * C::KV_BYTES + p * C::KV_PANEL,
                      &map_v, bar_v + 8 * s, p * 64, k0, hk, bi);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(tc::CONSUMER_REGS));
  // a consumer thread holds rows r and r + 8 (tile-local) of its
  // warpgroup's accumulators: element i of an m64nN fragment is row
  // r + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1)
  const int wg = warp >> 2;
  const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int t2 = (lane & 3) * 2;
  int lo[2], hi[2], lo_last, hi_first, unused;
  visible_range(pos0 + r, skv, causal, window, lo[0], hi[0]);
  visible_range(pos0 + r + 8, skv, causal, window, lo[1], hi[1]);
  // a tile is wholly visible to the warpgroup's 64 rows iff it lies inside
  // [lo of its last row, hi of its first row] (both grow with the row)
  visible_range(pos0 + wg * 64 + 63, skv, causal, window, lo_last, unused);
  visible_range(pos0 + wg * 64, skv, causal, window, unused, hi_first);

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, corr[2];
  float sc[BK / 2];
  uint32_t pa[BK / 16][4];
  const uint32_t qa = base + wg * 64 * 128;      // this warpgroup's Q rows

  // S = Q K^T: k16 slice kk of dh is 32 bytes into panel kk / 4 of both
  // (K-major rows of 128 B, 8-row atoms 1 KB apart)
  auto issue_qk = [&](int s) {
    const uint32_t ks = base + C::K0 + s * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(sc,
               smem_desc(qa + (kk >> 2) * C::Q_PANEL + (kk & 3) * 32, 16,
                         1024),
               smem_desc(ks + (kk >> 2) * C::KV_PANEL + (kk & 3) * 32, 16,
                         1024),
               kk);
    wgmma_commit();
  };
  // O += P V: V MN-major, k16 = 16 key rows = 2 KB, 64-column panels
  // KV_PANEL apart (leading), 8-row key groups 1 KB apart (stride)
  auto issue_pv = [&](int s) {
    const uint32_t vs = base + C::V0 + s * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, pa[kk], smem_desc(vs + kk * 2048, C::KV_PANEL, 1024));
    wgmma_commit();
  };
  // mask S of the tile at key k0, then the online softmax: sc becomes the
  // float32 P, corr the rescale of O, l and m the running statistics
  auto softmax = [&](int k0) {
    // scale (log2 domain) and mask: -1e30 outside the band, -inf past skv
    if (k0 + BK <= skv && k0 >= lo_last && k0 + BK - 1 <= hi_first) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int c = k0 + 8 * (i >> 2) + t2 + (i & 1);
        const int j = (i >> 1) & 1;
        sc[i] = c >= skv ? -INFINITY
                : (c < lo[j] || c > hi[j]) ? kMasked
                                          : sc[i] * scale_log2;
      }
    }
    // the quad of lanes 4g..4g+3 holds a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      corr[j] = ex2(m[j] - mx[j]);
      l[j] *= corr[j];
      m[j] = mx[j];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];                  // l from the float32 p
    }
  };
  // P in bf16 as the A operand: slice kk's fragment is S elements
  // 8 kk .. 8 kk + 7, pair by pair
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
  };

  // ping-pong: warpgroup 0 issues first
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) named_arrive(their_turn);
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_qk(0);
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(bar_ku);
  softmax(kt0 * BK);
  pack_p();
  for (int it = 1; it < nt; ++it) {
    const int s = it % STAGES, sp = (it - 1) % STAGES;
    mbar_wait(bar_k + 8 * s, (it / STAGES) & 1);
    mbar_wait(bar_v + 8 * sp, ((it - 1) / STAGES) & 1);
    rescale_o();
    named_sync(my_turn);
    wgmma_fence();
    issue_qk(s);
    issue_pv(sp);
    named_arrive(their_turn);
    wgmma_wait<1>();                             // S_it is done
    fence_regs(sc);
    mbar_arrive(bar_ku + 8 * s);
    softmax((kt0 + it) * BK);
    wgmma_wait<0>();                             // P_{it-1} V_{it-1} too
    fence_regs(acc);
    mbar_arrive(bar_vu + 8 * sp);
    pack_p();
  }
  const int sl = (nt - 1) % STAGES;
  mbar_wait(bar_v + 8 * sl, ((nt - 1) / STAGES) & 1);
  rescale_o();
  named_sync(my_turn);
  wgmma_fence();
  issue_pv(sl);
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive(bar_vu + 8 * sl);
  if (wg == 0) named_sync(my_turn);              // the other's last arrive

  // epilogue: the quad's partial sums, O / max(l, 1e-37) as bf16 pairs
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    l[j] = fmaxf(l[j], 1e-37f);
    const int row = q0 + r + 8 * j;
    if (row >= sq) continue;
    bf16* orow = o + bi * os_b + h * os_h + row * os_s + t2;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * j] / l[j],
                                acc[4 * c + 2 * j + 1] / l[j]);
  }
}

// a bf16 (b, h, s, dh) view as a 4-D tensor map, geom = {dh, s, h, b,
// byte strides of s, h, b}; the box is (64, box_rows, 1, 1), 128-byte
// swizzled, and elements past s read as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, const int64_t* geom,
                int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || (reinterpret_cast<uintptr_t>(ptr) & 15))
    return false;
  for (int i = 0; i < 4; ++i)
    if (geom[i] <= 0 || geom[i] > 0x7fffffffLL) return false;
  for (int i = 4; i < 7; ++i)
    if (geom[i] <= 0 || geom[i] % 16 || geom[i] >= (int64_t(1) << 40))
      return false;
  const cuuint64_t dims[4] = {cuuint64_t(geom[0]), cuuint64_t(geom[1]),
                              cuuint64_t(geom[2]), cuuint64_t(geom[3])};
  const cuuint64_t strides[3] = {cuuint64_t(geom[4]), cuuint64_t(geom[5]),
                                 cuuint64_t(geom[6])};
  const cuuint32_t box[4] = {cuuint32_t(tc::PANEL_COLS),
                             cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_tc(const void* q, const int64_t* qg, const void* k,
              const int64_t* kg, const void* v, const int64_t* vg, void* o,
              const int64_t* os, int causal, int64_t window,
              int64_t q_offset, float scale, cudaStream_t stream) {
  using C = tc::Cfg<DH>;
  auto kern = flash_fwd_tc_kernel<DH>;
  static bool opted_in = false;            // once per process (one card)
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return int(e);
    opted_in = true;
  }
  const int64_t b = qg[3], hq = qg[2], sq = qg[1], hkv = kg[2], skv = kg[1];
  const int64_t n_qt = (sq + tc::BM - 1) / tc::BM;
  if (n_qt > 65535 || b > 65535 || hq > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!tensor_map(&mq, q, qg, tc::BM) || !tensor_map(&mk, k, kg, C::BK) ||
      !tensor_map(&mv, v, vg, C::BK))
    return int(cudaErrorInvalidValue);
  const dim3 grid{unsigned(hq), unsigned(b), unsigned(n_qt)};
  kern<<<grid, tc::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), os[0], os[1], os[2], int(hq),
      int(hkv), int(sq), int(skv), causal, window, q_offset,
      scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

// o = attention(q, k, v) over contiguous (b, h, s, dh) tensors; see the
// header for the masks.  bf16: q, k, v and o are bfloat16 (else float32).
// window <= 0 disables the window; q is scaled by `scale`.  Launches on
// `stream` without synchronising; returns cudaGetLastError() (or cudaErrorInvalidValue for
// an unsupported dh or grid).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int64_t b,
                                     int64_t hq, int64_t hkv, int64_t sq,
                                     int64_t skv, int64_t dh, int bf16,
                                     int causal, int64_t window,
                                     int64_t q_offset, float scale,
                                     void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || skv <= 0 || hq % hkv) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, b, hq, hkv, sq, skv,
                                    causal, window, q_offset, scale, s);
  return launch_dh<float>(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                          window, q_offset, scale, s);
}

// The "tc" variant: o = attention(q, k, v) over bf16 (b, h, s, dh) views
// with any strides whose head dim is contiguous.  q_geom, k_geom, v_geom:
// {dh, s, h, b, byte strides of s, h and b} of q, k and v (the tensor
// maps' geometry: 16-byte-aligned base, strides multiples of 16 bytes);
// o_strides: the element strides {b, h, s} of o, which has q's shape.  dh
// is 64, 128 or 256 (the wrapper pads), the same for q, k and v; hq % hkv
// == 0 and k, v share b with q.  window <= 0 disables the window; S is
// scaled by `scale` after the dot.  Launches on `stream` without
// synchronising; returns cudaGetLastError() (or cudaErrorInvalidValue for
// an unsupported dh, geometry or grid).
extern "C" int repro_flash_attention_tc(const void* q, const int64_t* q_geom,
                                        const void* k, const int64_t* k_geom,
                                        const void* v, const int64_t* v_geom,
                                        void* o, const int64_t* o_strides,
                                        int causal, int64_t window,
                                        int64_t q_offset, float scale,
                                        void* stream) {
  const int64_t dh = q_geom[0];
  if (q_geom[1] <= 0 || q_geom[2] <= 0 || q_geom[3] <= 0) return 0;
  if (k_geom[0] != dh || v_geom[0] != dh || k_geom[1] <= 0 ||
      k_geom[2] <= 0 || q_geom[2] % k_geom[2] || k_geom[3] != q_geom[3] ||
      v_geom[1] != k_geom[1] || v_geom[2] != k_geom[2] ||
      v_geom[3] != k_geom[3] || (reinterpret_cast<uintptr_t>(o) & 3) ||
      ((o_strides[0] | o_strides[1] | o_strides[2]) & 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch_tc<64>(q, q_geom, k, k_geom, v, v_geom, o, o_strides,
                           causal, window, q_offset, scale, s);
    case 128:
      return launch_tc<128>(q, q_geom, k, k_geom, v, v_geom, o, o_strides,
                            causal, window, q_offset, scale, s);
    case 256:
      return launch_tc<256>(q, q_geom, k, k_geom, v, v_geom, o, o_strides,
                            causal, window, q_offset, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
