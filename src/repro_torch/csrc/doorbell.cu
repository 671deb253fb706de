// Doorbell stage-copy for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/doorbell/kernel.py:22
// (stage_copy_tpu, body _stage_copy_kernel at :18): a row-blocked copy of
// a doorbell's (K, E) payload matrix into the wire dtype (float32 ->
// bfloat16 when wire_bf16 is on, identity otherwise), viewed as uint8
// wire rows.  One launch stages a whole doorbell (up to kMaxRows rows in
// the gather mode), in one of three modes:
//
//   dense   (repro_stage_copy, ids == NULL): row r of the wire image lands
//           at dst + r * row_bytes.  The caller passes the whole burst as
//           ONE segment (rows = 1), since source and wire image are both
//           contiguous: the copy is then a flat stream of 16-byte vectors.
//   scatter (repro_stage_copy, ids != NULL): row r lands at dst + ids[r] *
//           dst_stride (a packet slot), zero-padded over [row_bytes,
//           dst_stride).  A row whose id is outside [0, n_slots) is
//           dropped, as the reference's scatter with mode="drop" drops it:
//           that is the prefix-accept contract of pool_get_copy_n
//           (repro/core/packet_pool.py:408-436), where only the first `got`
//           ids are valid (-1 marks the rest).  `got` is never read back.
//   gather  (repro_stage_copy_rows): the K source rows are K separate
//           addresses (one tensor per message), passed by value in the
//           kernel's parameters (RowTable, at most kMaxRows = 256 pointers,
//           2 KB of the 4 KB parameter space: no host-to-device copy, no
//           pinned table).  Row r lands at dst + r * row_bytes.  The
//           TPU kernel takes a stacked (K, E) array only because a jitted
//           program holds one array; here the stack copy ahead of the
//           stage copy goes, and a doorbell is staged in one pass.
//
// Bound: device memory bandwidth.  The kernel does no arithmetic beyond
// the cast; it must read K*E*itemsize bytes once and write K*row_bytes
// bytes once (plus the zero padding in scatter mode).  What its design
// does about that:
//   * the grid is sized to the card (kBlocksPerSm blocks an SM) and
//     strides over (row, unit) pairs, a unit being kUnitBytes of one
//     output row;
//   * in a unit each thread issues all of its loads (kUnroll 16-byte
//     loads of the copy, 2 * kUnroll of the cast) before its first store,
//     neighbouring threads on neighbouring 16-byte vectors, so that
//     enough bytes are in flight to reach HBM's rate;
//   * each row picks the vector or the byte path by its own alignment
//     (rows of a gather may sit at any byte offset), and a row's byte tail
//     past its last whole vector goes through the byte path.
//
// The cast is __float2bfloat16_rn: round to nearest even with subnormals
// kept, like torch's CPU cast and ml_dtypes in the reference (a NaN keeps
// no payload: cvt.rn gives 0x7FFF).  Build without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// output bytes of one unit: kUnroll 16-byte vectors a thread
constexpr int64_t kUnitBytes = int64_t(kThreads) * kUnroll * 16;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxRows = 256;

__device__ __forceinline__ bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// d[lo:end] = s[lo:end] over bytes; lo is a multiple of kUnitBytes and
// end - lo <= kUnitBytes
__device__ __forceinline__ void copy_unit(const uint8_t* __restrict__ s,
                                          uint8_t* __restrict__ d,
                                          int64_t lo, int64_t end) {
  if (aligned(s, 16) && aligned(d, 16)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const int64_t v0 = (lo >> 4) + threadIdx.x;
    const int64_t vb = end >> 4;                 // whole vectors end here
    uint4 v[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {          // every load first ...
      const int64_t j = v0 + int64_t(i) * kThreads;
      if (j < vb) v[i] = __ldg(s4 + j);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {          // ... then every store
      const int64_t j = v0 + int64_t(i) * kThreads;
      if (j < vb) d4[j] = v[i];
    }
    for (int64_t j = imax(vb << 4, lo) + threadIdx.x; j < end; j += kThreads)
      d[j] = s[j];                               // byte tail, < 16
  } else {
    for (int64_t j = lo + threadIdx.x; j < end; j += kThreads) d[j] = s[j];
  }
}

// d[lo:end] = bf16(s) over OUTPUT bytes (2 a value); lo is a multiple of
// kUnitBytes and end - lo <= kUnitBytes.  A group is 4 values: one 16-byte
// load, one 8-byte store.
__device__ __forceinline__ void cast_unit(const float* __restrict__ s,
                                          __nv_bfloat16* __restrict__ d,
                                          int64_t lo, int64_t end) {
  const int64_t e0 = lo >> 1, e1 = end >> 1;     // elements
  if (aligned(s, 16) && aligned(d, 8)) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    uint2* d2 = reinterpret_cast<uint2*>(d);
    const int64_t g0 = (e0 >> 2) + threadIdx.x;
    const int64_t gb = e1 >> 2;                  // whole groups end here
    constexpr int kG = 2 * kUnroll;              // groups a thread a unit
    float4 v[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int64_t g = g0 + int64_t(i) * kThreads;
      if (g < gb) v[i] = __ldg(s4 + g);
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int64_t g = g0 + int64_t(i) * kThreads;
      if (g < gb)
        d2[g] = make_uint2(bf16_bits(v[i].x) | (bf16_bits(v[i].y) << 16),
                           bf16_bits(v[i].z) | (bf16_bits(v[i].w) << 16));
    }
    for (int64_t j = imax(gb << 2, e0) + threadIdx.x; j < e1; j += kThreads)
      d[j] = __float2bfloat16_rn(s[j]);          // element tail, < 4
  } else {
    for (int64_t j = e0 + threadIdx.x; j < e1; j += kThreads)
      d[j] = __float2bfloat16_rn(s[j]);
  }
}

// d[a:b] = 0
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ d,
                                           int64_t a, int64_t b) {
  // bytes up to the next 16-byte address, then vectors, then the tail
  int64_t m = a + ((16 - (reinterpret_cast<uintptr_t>(d + a) & 15)) & 15);
  if (m > b) m = b;
  for (int64_t j = a + threadIdx.x; j < m; j += kThreads) d[j] = 0;
  uint4* d4 = reinterpret_cast<uint4*>(d + m);
  const int64_t nv = (b - m) >> 4;
  for (int64_t j = threadIdx.x; j < nv; j += kThreads)
    d4[j] = make_uint4(0, 0, 0, 0);
  for (int64_t j = m + (nv << 4) + threadIdx.x; j < b; j += kThreads)
    d[j] = 0;
}

// the dense and scatter modes' source: rows of one contiguous matrix
struct Strided {
  const uint8_t* base;
  int64_t row_bytes;
  __device__ __forceinline__ const uint8_t* row(int64_t r) const {
    return base + r * row_bytes;
  }
};

// the gather mode's source: one address a row, by value
struct RowTable {
  const uint8_t* p[kMaxRows];
  __device__ __forceinline__ const uint8_t* row(int64_t r) const {
    return p[r];
  }
};

// a unit of work: kUnitBytes of one output row's dst_stride bytes;
// the grid strides over rows * units-a-row of them
template <typename Src, bool kCast>
__global__ void __launch_bounds__(kThreads)
stage_copy_kernel(const Src src, uint8_t* __restrict__ dst,
                  const int32_t* __restrict__ ids, int64_t n_slots,
                  int64_t rows, int64_t row_bytes, int64_t dst_stride) {
  const int64_t per_row = (dst_stride + kUnitBytes - 1) / kUnitBytes;
  const int64_t units = rows * per_row;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int64_t r = u / per_row;
    const int64_t lo = (u - r * per_row) * kUnitBytes;
    int64_t slot = r;
    if (ids != nullptr) {
      slot = ids[r];
      if (slot < 0 || slot >= n_slots) continue;   // unallocated: dropped
    }
    const uint8_t* s = src.row(r);
    uint8_t* d = dst + slot * dst_stride;
    const int64_t hi = imin(lo + kUnitBytes, dst_stride);
    const int64_t end = imin(hi, row_bytes);
    if (lo < end) {
      if (kCast)
        cast_unit(reinterpret_cast<const float*>(s),
                  reinterpret_cast<__nv_bfloat16*>(d), lo, end);
      else
        copy_unit(s, d, lo, end);
    }
    const int64_t zlo = imax(lo, row_bytes);
    if (zlo < hi) zero_bytes(d, zlo, hi);
  }
}

// blocks for `units` units: at most kBlocksPerSm on each SM of the card
int grid_for(int64_t units) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = int64_t(sms) * kBlocksPerSm;
  return int(units < cap ? units : cap);
}

template <typename Src>
int launch(const Src& src, void* dst, const int32_t* ids, int64_t n_slots,
           int64_t rows, int64_t row_bytes, int64_t dst_stride,
           int cast_bf16, cudaStream_t stream) {
  const int64_t units = rows * ((dst_stride + kUnitBytes - 1) / kUnitBytes);
  const int grid = grid_for(units);
  uint8_t* d = static_cast<uint8_t*>(dst);
  if (cast_bf16)
    stage_copy_kernel<Src, true><<<grid, kThreads, 0, stream>>>(
        src, d, ids, n_slots, rows, row_bytes, dst_stride);
  else
    stage_copy_kernel<Src, false><<<grid, kThreads, 0, stream>>>(
        src, d, ids, n_slots, rows, row_bytes, dst_stride);
  return int(cudaGetLastError());
}

}  // namespace

// Stage `rows` source rows of src_row_bytes each, contiguous from src,
// into dst (the dense and scatter modes above).  row_bytes is the wire
// bytes of one row (src_row_bytes / 2 when cast_bf16), dst_stride the
// distance between destination rows, n_slots the number of destination
// rows dst holds (scatter mode).  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int repro_stage_copy(const void* src, void* dst, const int32_t* ids,
                                int64_t n_slots, int64_t rows,
                                int64_t src_row_bytes, int64_t row_bytes,
                                int64_t dst_stride, int cast_bf16,
                                void* stream) {
  if (rows <= 0 || dst_stride <= 0) return 0;
  const Strided s{static_cast<const uint8_t*>(src), src_row_bytes};
  return launch(s, dst, ids, n_slots, rows, row_bytes, dst_stride, cast_bf16,
                static_cast<cudaStream_t>(stream));
}

// The gather mode: stage the k rows at the addresses rows[0..k) (each
// row_bytes * (cast_bf16 ? 2 : 1) bytes) into the contiguous (k,
// row_bytes) wire image at dst, one launch for each kMaxRows rows.
// Launches on `stream` without synchronising; returns cudaGetLastError()
// of the first launch that failed, else 0.
extern "C" int repro_stage_copy_rows(const void* const* rows, int64_t k,
                                     void* dst, int64_t row_bytes,
                                     int cast_bf16, void* stream) {
  if (k <= 0 || row_bytes <= 0) return 0;
  RowTable table;
  for (int64_t r0 = 0; r0 < k; r0 += kMaxRows) {
    const int64_t n = k - r0 < kMaxRows ? k - r0 : kMaxRows;
    for (int64_t i = 0; i < n; ++i)
      table.p[i] = static_cast<const uint8_t*>(rows[r0 + i]);
    const int rc = launch(table, static_cast<uint8_t*>(dst) + r0 * row_bytes,
                          nullptr, 0, n, row_bytes, row_bytes, cast_bf16,
                          static_cast<cudaStream_t>(stream));
    if (rc != 0) return rc;
  }
  return 0;
}

