// mma.sync helpers shared by the port's SSD-scan kernels on the tensor
// cores (ssd_scan_tc.cu, ssd_scan_bwd_tc.cu): ldmatrix loads of 8x8 bf16
// tiles from shared memory, the m16n8k16 bf16 product with fp32 sums,
// the bf16 hi + lo split of fp32 pairs, and the lane offsets that feed
// ldmatrix for each operand layout.
#pragma once

#include "common.cuh"

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d += a b: m16n8k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// (v0, v1) -> bf16 pairs hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(v0 - h.x, v1 - h.y);
}

// Row and column offsets, within a 16x16 bf16 tile of a row-major shared
// array, of the row address lane i gives ldmatrix.x4.  a_*: the four 8x8
// matrices are (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
// 8-15) -- an A operand stored [m][k] (registers a0..a3), or with .trans
// a B operand stored [k][n] ((b0, b1) of n8 tiles 0 and 1).  bt_*: (0-7,
// 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) -- a B operand stored
// [n][k] ((b0, b1) of n8 tiles 0 and 1), or with .trans an A operand
// stored [k][m] (a0..a3).
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ int a_col(int lane) { return 8 * (lane >> 4); }
__device__ __forceinline__ int bt_row(int lane) {
  return (lane & 7) + 8 * (lane >> 4);
}
__device__ __forceinline__ int bt_col(int lane) {
  return 8 * ((lane >> 3) & 1);
}
__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

}  // namespace repro
