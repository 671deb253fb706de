// Doorbell stage-copy for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/doorbell/kernel.py:22
// (stage_copy_tpu, body _stage_copy_kernel at :18): a row-blocked copy of
// a doorbell's (K, E) payload matrix into the wire dtype (float32 ->
// bfloat16 when wire_bf16 is on, identity otherwise), viewed as uint8
// wire rows.  One launch stages a whole doorbell, in one of two modes:
//
//   dense   (ids == NULL): row r of the wire image lands at
//           dst + r * row_bytes.  The caller passes the whole burst as ONE
//           segment (rows = 1), since source and wire image are both
//           contiguous: the copy is then a flat stream of 16-byte vectors.
//   scatter (ids != NULL): row r lands at dst + ids[r] * dst_stride (a
//           packet slot), zero-padded over [row_bytes, dst_stride).  A row
//           whose id is outside [0, n_slots) is dropped, as the reference's
//           scatter with mode="drop" drops it: that is the prefix-accept
//           contract of pool_get_copy_n (repro/core/packet_pool.py:408-436),
//           where only the first `got` ids are valid (-1 marks the rest).
//           `got` is never read back.
//
// Bound: device memory bandwidth.  The kernel does no arithmetic beyond
// the cast; it must read K*E*itemsize bytes once and write K*row_bytes
// bytes once (plus the zero padding in scatter mode).  Its design answers
// that with 16-byte vectorised loads and stores on neighbouring
// addresses (a warp moves 512 contiguous bytes per instruction), a byte
// tail where a row is not a multiple of 16 bytes, and enough blocks to
// cover the card: a block owns an 8 KiB slice of one output row.
//
// The cast is __float2bfloat16_rn: round to nearest even with subnormals
// kept, like torch's CPU cast and ml_dtypes in the reference.  Build
// without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// output bytes one block owns: 2 vectors of 16 bytes per thread
constexpr int64_t kChunkBytes = int64_t(kThreads) * 2 * 16;

__device__ __forceinline__ bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// d[a:b] = s[a:b]; a is a multiple of 16
__device__ __forceinline__ void copy_bytes(const uint8_t* __restrict__ s,
                                           uint8_t* __restrict__ d,
                                           int64_t a, int64_t b) {
  if (aligned(s, 16) && aligned(d, 16)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const int64_t vb = b >> 4;
    for (int64_t j = (a >> 4) + threadIdx.x; j < vb; j += blockDim.x)
      d4[j] = s4[j];
    for (int64_t j = (vb << 4) + threadIdx.x; j < b; j += blockDim.x)
      d[j] = s[j];                                   // byte tail, < 16
  } else {
    for (int64_t j = a + threadIdx.x; j < b; j += blockDim.x) d[j] = s[j];
  }
}

// d[a:b] = bf16(s[a:b]) over elements; a is a multiple of 4
__device__ __forceinline__ void to_bf16(const float* __restrict__ s,
                                        __nv_bfloat16* __restrict__ d,
                                        int64_t a, int64_t b) {
  if (aligned(s, 16) && aligned(d, 8)) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    uint2* d2 = reinterpret_cast<uint2*>(d);
    const int64_t gb = b >> 2;
    for (int64_t g = (a >> 2) + threadIdx.x; g < gb; g += blockDim.x) {
      const float4 v = s4[g];                        // 16-byte load
      uint2 o;                                       // 8-byte store
      o.x = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v.x))) |
            (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v.y))) << 16);
      o.y = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v.z))) |
            (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v.w))) << 16);
      d2[g] = o;
    }
    for (int64_t j = (gb << 2) + threadIdx.x; j < b; j += blockDim.x)
      d[j] = __float2bfloat16_rn(s[j]);
  } else {
    for (int64_t j = a + threadIdx.x; j < b; j += blockDim.x)
      d[j] = __float2bfloat16_rn(s[j]);
  }
}

// d[a:b] = 0
__device__ __forceinline__ void zero_bytes(uint8_t* __restrict__ d,
                                           int64_t a, int64_t b) {
  // bytes up to the next 16-byte address, then vectors, then the tail
  int64_t m = a + ((16 - (reinterpret_cast<uintptr_t>(d + a) & 15)) & 15);
  if (m > b) m = b;
  for (int64_t j = a + threadIdx.x; j < m; j += blockDim.x) d[j] = 0;
  uint4* d4 = reinterpret_cast<uint4*>(d + m);
  const int64_t nv = (b - m) >> 4;
  for (int64_t j = threadIdx.x; j < nv; j += blockDim.x)
    d4[j] = make_uint4(0, 0, 0, 0);
  for (int64_t j = m + (nv << 4) + threadIdx.x; j < b; j += blockDim.x)
    d[j] = 0;
}

// grid: x = kChunkBytes slices of one output row, y = source row
__global__ void __launch_bounds__(kThreads)
stage_copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  const int32_t* __restrict__ ids, int64_t n_slots,
                  int64_t src_row_bytes, int64_t row_bytes,
                  int64_t dst_stride, int cast_bf16) {
  const int64_t r = blockIdx.y;
  int64_t slot = r;
  if (ids != nullptr) {
    slot = ids[r];
    if (slot < 0 || slot >= n_slots) return;   // unallocated: dropped
  }
  const uint8_t* s = src + r * src_row_bytes;
  uint8_t* d = dst + slot * dst_stride;
  const int64_t lo = int64_t(blockIdx.x) * kChunkBytes;
  const int64_t hi = imin(lo + kChunkBytes, dst_stride);
  const int64_t end = imin(hi, row_bytes);
  if (lo < end) {
    if (cast_bf16)
      to_bf16(reinterpret_cast<const float*>(s),
              reinterpret_cast<__nv_bfloat16*>(d), lo >> 1, end >> 1);
    else
      copy_bytes(s, d, lo, end);
  }
  const int64_t zlo = imax(lo, row_bytes);
  if (zlo < hi) zero_bytes(d, zlo, hi);
}

}  // namespace

// Stage `rows` source rows of src_row_bytes each into dst (see the modes
// above).  row_bytes is the wire bytes of one row (src_row_bytes / 2 when
// cast_bf16), dst_stride the distance between destination rows, n_slots
// the number of destination rows dst holds (scatter mode).  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int repro_stage_copy(const void* src, void* dst, const int32_t* ids,
                                int64_t n_slots, int64_t rows,
                                int64_t src_row_bytes, int64_t row_bytes,
                                int64_t dst_stride, int cast_bf16,
                                void* stream) {
  if (rows <= 0 || dst_stride <= 0) return 0;
  const dim3 grid(unsigned((dst_stride + kChunkBytes - 1) / kChunkBytes),
                  unsigned(rows));
  stage_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), ids,
      n_slots, src_row_bytes, row_bytes, dst_stride, cast_bf16);
  return int(cudaGetLastError());
}
