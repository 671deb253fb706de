// The SSM mixer's conv stage for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: the reference runs the stage in plain jnp
// (repro/models/ssm.py: _causal_conv, then jax.nn.silu, and the softplus
// of dt).  Added because, run as PyTorch passes over the column views of
// the mixer's fused [z|x|dt] product (rows 4160 elements apart in
// mamba2-370m: every pass takes the strided elementwise kernel, ~19
// launches a layer), the stage held half the device time of a mamba2-370m
// prefill.  Per row (t, b) -- t the time step, b the sequence -- of
// xs (s, bs, ch) and dt_raw (s, bs, h):
//     y[t, b, c]  = silu(sum_k w[K-1-k, c] * x[t-k, b, c]),  x[t < 0] = 0
//     dt[t, b, j] = softplus(dt_raw[t, b, j] + dt_bias[j])
// with x, dt_raw and w in one dtype (float32 or bfloat16), dt_bias in
// float32, y in x's dtype and dt in float32, both contiguous; x and
// dt_raw are read through their row strides, row (t, b) at t * bs + b.
//
// Bound: device memory bandwidth.  A call must read xs and dt_raw once
// and write y and dt once (mamba2-370m at 16384 tokens: ~137 MB a layer,
// 41 us at 3.35 TB/s).  It also does ~40 instructions a value (the
// conv, the exact expf and division of SiLU, the bf16 conversions): at the
// card's issue rate about as long as the bytes take, so the design moves
// each byte once and keeps loads in flight while it computes:
//   * a thread owns 16 bytes of channels (8 bf16 or 4 float32) of one
//     sequence and walks kWalk consecutive time steps (successive steps
//     bs rows apart), kTile at a time: it holds the tile's rows and the
//     K-1 rows before them in registers as the sliding window (zeros
//     before the sequence's start, also for s < K-1), issues the loads of
//     the next tile's rows, then computes and stores the tile, so each
//     input row is read once, and K-1 halo rows a walk a second time
//     (from L2: the walk before it is the neighbouring block);
//   * threads are laid out (walk, channel vector), channel vectors
//     fastest, so a warp reads and writes neighbouring 16-byte pieces of
//     one row and no thread of a block idles at a row's end; the blocks
//     after the conv's take dt, a walk's rows a block, one value a
//     thread;
//   * 16-byte loads and stores: the view's base, row stride and width
//     must be multiples of 16 bytes (the mixer's are: its rows are padded
//     to a multiple of 64 elements and x starts at d_inner).
// Numerics: the conv's products and sums in float32 in the plain
// version's order (x[t] w[K-1], then + x[t-k] w[K-1-k] for k = 1..K-1),
// each rounded on its own (no fused multiply-add): a float32 call is the
// plain version's float32 arithmetic, and a bf16 call is that arithmetic
// on the same bf16 values, rounded once to bf16 (the plain bf16 version
// rounds every product and sum).  SiLU x / (1 + expf(-x)) and softplus
// (x above 20, else log1pf(expf(x))) in float32, as torch computes them.
// Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // threads a block
// time steps between loads: at 4, 106 registers (bf16) leave 4 blocks an
// SM; 8 tiles ran 40% slower (139 registers, 3 blocks), 2 kept too little
// in flight; a walk of 64 steps puts every prefill shape of 16384 tokens
// in one wave
constexpr int kTile = 4;
constexpr int kWalk = 16 * kTile;       // time steps a thread walks
// the conv width the kernel is built for: Mamba2's 4, every config's
// ssm_conv_kernel (the wrapper rejects any other before the launch)
constexpr int K = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// element i of a 16-byte vector of T (little-endian: element 0 in the low
// bits of word 0), as float
template <typename T> __device__ __forceinline__ float elem(const uint4& r,
                                                           int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& r,
                                                         int i) {
  return __uint_as_float(word(r, i));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint4& r, int i) {
  const uint32_t w = word(r, i >> 1);
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// V floats rounded to T, as one 16-byte vector
template <typename T, int V> __device__ __forceinline__ uint4 pack(
    const float (&f)[V]);
template <> __device__ __forceinline__ uint4 pack<float, 4>(
    const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16, 8>(
    const float (&f)[8]) {
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                    bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// row t of a thread's sequence and channels, zeros outside [0, s)
template <typename T>
__device__ __forceinline__ uint4 load_row(const T* xb, int64_t x_step, int t,
                                          int s) {
  return t >= 0 && t < s
             ? __ldg(reinterpret_cast<const uint4*>(xb + t * x_step))
             : make_uint4(0, 0, 0, 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ dt_raw,
                const float* __restrict__ dt_bias, T* __restrict__ y,
                float* __restrict__ dt, int s, int bs, int ch, int h,
                int64_t x_row, int64_t dt_row, int nwalks, int nv,
                int64_t conv_blocks) {
  constexpr int V = 16 / int(sizeof(T));               // channels a thread

  if (int64_t(blockIdx.x) >= conv_blocks) {           // dt: a walk a block
    const int64_t walk = int64_t(blockIdx.x) - conv_blocks;
    const int b = int(walk / nwalks);
    const int t0 = int(walk % nwalks) * kWalk;
    for (int e = threadIdx.x; e < kWalk * h; e += kThreads) {
      const int t = t0 + e / h, j = e % h;
      if (t < s) {
        const int64_t row = int64_t(t) * bs + b;
        dt[row * h + j] = softplus(to_f(dt_raw[row * dt_row + j]) +
                                   dt_bias[j]);
      }
    }
    return;
  }

  // this thread's (walk, channel vector), channel vectors fastest
  const int64_t item = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t walk = item / nv;
  if (walk >= int64_t(bs) * nwalks) return;
  const int c0 = int(item % nv) * V;
  const int b = int(walk / nwalks);
  const int t0 = int(walk % nwalks) * kWalk;
  const T* xb = x + int64_t(b) * x_row + c0;
  const int64_t x_step = int64_t(bs) * x_row;          // one time step
  T* yb = y + int64_t(b) * ch + c0;
  const int64_t y_step = int64_t(bs) * ch;

  // the window: the K-1 rows before the tile, then its kTile rows
  uint4 win[K - 1 + kTile], nxt[kTile];
#pragma unroll
  for (int i = 0; i < K - 1 + kTile; ++i)
    win[i] = load_row(xb, x_step, t0 - (K - 1) + i, s);
  float wf[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i)
      wf[k][i] = to_f(w[int64_t(k) * ch + c0 + i]);

  for (int t = t0; t < t0 + kWalk && t < s; t += kTile) {
    // the next tile's rows, in flight while this tile is computed
    if (t + kTile < t0 + kWalk && t + kTile < s) {
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        nxt[i] = load_row(xb, x_step, t + kTile + i, s);
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (t + j < s) {
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          // x[t+j] w[K-1], then + x[t+j-k] w[K-1-k]
          float acc = __fmul_rn(elem<T>(win[j + K - 1], i), wf[K - 1][i]);
#pragma unroll
          for (int k = 1; k < K; ++k)
            acc = __fadd_rn(acc, __fmul_rn(elem<T>(win[j + K - 1 - k], i),
                                           wf[K - 1 - k][i]));
          o[i] = silu(acc);
        }
        *reinterpret_cast<uint4*>(yb + (t + j) * y_step) = pack<T, V>(o);
      }
    }
#pragma unroll
    for (int i = 0; i < K - 1; ++i) win[i] = win[kTile + i];
#pragma unroll
    for (int i = 0; i < kTile; ++i) win[K - 1 + i] = nxt[i];
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

struct Args {
  const void *x, *w, *dt_raw, *dt_bias;
  void *y, *dt;
  int s, bs, ch, h;
  int64_t x_row, dt_row;
};

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int V = 16 / int(sizeof(T));
  const int nwalks = (a.s + kWalk - 1) / kWalk;
  const int64_t walks = int64_t(a.bs) * nwalks;
  const int nv = a.ch / V;
  const int64_t conv_blocks = (walks * nv + kThreads - 1) / kThreads;
  const int64_t blocks = conv_blocks + (a.h > 0 ? walks : 0);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssm_conv_kernel<T><<<unsigned(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.dt_raw), static_cast<const float*>(a.dt_bias),
      static_cast<T*>(a.y), static_cast<float*>(a.dt), a.s, a.bs, a.ch, a.h,
      a.x_row, a.dt_row, nwalks, nv > 0 ? nv : 1, conv_blocks);
  return cudaGetLastError();
}

// what the 16-byte loads and stores need: x's base, row stride and width
// and y's base in 16-byte units (the wrapper checks it first)
template <typename T>
bool aligned(const Args& a) {
  return a.ch % (16 / int(sizeof(T))) == 0 && aligned16(a.x) &&
         aligned16(a.y) && (a.x_row * int64_t(sizeof(T))) % 16 == 0;
}

}  // namespace

// y = silu(causal_conv(x, w)) and dt = softplus(dt_raw + dt_bias) for x
// (s, bs, ch) and dt_raw (s, bs, h) with unit last stride and row strides
// x_row and dt_row (elements); w (K = 4, ch) contiguous, all three float32
// (bf16 0) or bfloat16 (bf16 1); dt_bias (h,) float32; y (s, bs, ch) in
// x's dtype and dt (s, bs, h) float32, both contiguous.  Returns 0 or the
// CUDA error of the launch.
extern "C" int repro_ssm_conv(const void* x, const void* dt_raw,
                              const void* w, const void* dt_bias, void* y,
                              void* dt, int64_t s, int64_t bs, int64_t ch,
                              int64_t h, int64_t x_row, int64_t dt_row,
                              int bf16, void* stream) {
  if (s <= 0 || bs <= 0 || ch + h <= 0) return 0;
  if (s > 0x7fffffff || bs > 0x7fffffff || ch > 0x7fffffff ||
      h > 0x7fffffff)
    return cudaErrorInvalidValue;
  Args a{x, w, dt_raw, dt_bias, y, dt, int(s), int(bs), int(ch), int(h),
         x_row, dt_row};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!aligned<__nv_bfloat16>(a)) return cudaErrorMisalignedAddress;
    return launch<__nv_bfloat16>(a, st);
  }
  if (!aligned<float>(a)) return cudaErrorMisalignedAddress;
  return launch<float>(a, st);
}
