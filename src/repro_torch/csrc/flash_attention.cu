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
// acc / max(l, 1e-37).  q is scaled by `scale` (the caller's 1/sqrt(dh) of
// the true head dim) in float32 before the dot, and all statistics
// (running max m, exp-sum l, accumulator) are float32.  The kernel is
// instantiated for dh 16/32/64/128/256; the wrapper zero-pads any other dh
// up to the next of these (zero columns add nothing to q.k, and the padded
// output columns are dropped), which is why the scale is an argument.
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
// bytes.  This first kernel runs the dots on the CUDA cores in float32
// (67 TFLOP/s peak), far from that bound: each thread keeps a register
// tile of scores (S = Q K^T) and of the output accumulator, reading Q, K,
// V and P from shared memory (rows padded by one float, so the lanes of a
// warp fall on distinct banks).  What the design does about the bound is
// to do only the visible work: a q tile visits just the KV tiles inside
// the union of its rows' visible ranges [q_pos - window + 1, q_pos]
// (the causal triangle, the sliding-window band), which keeps a 512-wide
// window at 1/4 of the causal cost at s = 2048.  Skipping is exact: a
// skipped tile is masked for every row, and a row's masked scores get
// weight exp(-1e30 - m) = 0 once the row has seen a key.  Only when some
// row of the tile sees no key at all does the tile visit every KV tile,
// so that row comes out as the uniform average over all skv keys.
// wgmma/TMA tiles are later work.
//
// Shared memory: 30 KB (dh 16) to 103 KB (dh 256), above the 48 KB
// default for dh >= 64, so every instantiation opts in with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize).  Build without
// --use_fast_math (expf, not __expf).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
