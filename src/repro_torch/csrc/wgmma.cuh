// wgmma helpers shared by the port's tensor-core attention kernels
// (flash_attention_tc.cu, flash_attention_bwd_tc.cu), sm_90a only.
//
// The tile layout is wgmma's canonical no-swizzle ("interleave") layout:
// a tile of 64 rows x D bf16 is cut into 8x8 core matrices (8 rows x 16
// bytes), stored as contiguous 128-byte blocks, the D/8 blocks of an
// 8-row group one after another, so 16-byte chunk i of a tile lives at
// byte 16*i.  One tile serves as a K-major operand (rows on M or N, D
// on K: core matrices 128 B apart along K, D*16 B apart along M/N) and
// as an MN-major one (rows on K: the same two strides, read the other
// way).  A descriptor's leading byte offset is always the stride along
// K, its stride byte offset the stride along M or N.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kTcRows = 64;      // q rows per block: one wgmma M
constexpr int kTcKeys = 64;      // keys per K/V tile: q K^T's N
constexpr int kTcThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// wgmma shared-memory matrix descriptor, no-swizzle layout: start
// address, leading (K-direction) and stride (M/N-direction) byte
// offsets between core matrices, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most n committed wgmma groups are in flight
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// keeps the compiler from touching accumulators across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// orders this thread's generic-proxy shared-memory writes before the
// async proxy (wgmma) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D = A B (+ D if scale_d): m64nNk16, bf16 in, fp32 accumulators; A from
// registers (K-major fragments), B through a shared-memory descriptor,
// kTransB = 0 for a K-major B, 1 for an MN-major one.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(kTransB), "r"(scale_d));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n112k16(
    float (&d)[56], const uint32_t (&a)[4], uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, %61;\n}\n"
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
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(kTransB), "r"(scale_d));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(
    float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "n"(kTransB), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (D == 64) wgmma_m64n64k16<1>(o, a, desc, 1);
  else if constexpr (D == 112) wgmma_m64n112k16<1>(o, a, desc, 1);
  else wgmma_m64n128k16<1>(o, a, desc, 1);
}

// One K or V tile (64 keys x D) moves in D/16 16-byte bf16 chunks per
// thread; chunk i = tid + 128*j holds key (i/8)/(D/8)*8 + i%8, columns
// 8*((i/8)%(D/8)) .. +7, and lands at byte 16*i of the tile.
template <int D>
__device__ __forceinline__ size_t chunk_src(int i, int k0, size_t kv_row,
                                            int* key) {
  constexpr int kGroups = D / 8;
  const int kj = k0 + (i >> 3) / kGroups * 8 + (i & 7);
  *key = kj;
  return (size_t)kj * kv_row + (size_t)((i >> 3) % kGroups) * 8;
}

template <typename KT, int D>
struct TileLoader;

// fp32 K/V: 16-byte loads into a register stage, bf16 stores after
template <int D>
struct TileLoader<float, D> {
  static constexpr int kPer = kTcKeys * D / 8 / kTcThreads;
  float4 st[kPer][2];

  __device__ __forceinline__ void issue(const float* base, int k0,
                                        int kv_valid, size_t kv_row,
                                        uint8_t*) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      int kj;
      const size_t off = chunk_src<D>(threadIdx.x + kTcThreads * j, k0,
                                      kv_row, &kj);
      if (kj < kv_valid) {
        const float4* p = reinterpret_cast<const float4*>(base + off);
        st[j][0] = p[0];
        st[j][1] = p[1];
      } else {
        st[j][0] = st[j][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __device__ __forceinline__ void finish(uint8_t* tile) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      uint4 w;
      w.x = pack_bf16(st[j][0].x, st[j][0].y);
      w.y = pack_bf16(st[j][0].z, st[j][0].w);
      w.z = pack_bf16(st[j][1].x, st[j][1].y);
      w.w = pack_bf16(st[j][1].z, st[j][1].w);
      *reinterpret_cast<uint4*>(tile + 16 * (threadIdx.x + kTcThreads * j)) =
          w;
    }
  }
};

// bf16 K/V: cp.async straight into the layout, zero-fill past kv_valid
template <int D>
struct TileLoader<__nv_bfloat16, D> {
  static constexpr int kPer = kTcKeys * D / 8 / kTcThreads;

  __device__ __forceinline__ void issue(const __nv_bfloat16* base, int k0,
                                        int kv_valid, size_t kv_row,
                                        uint8_t* tile) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + kTcThreads * j;
      int kj;
      const size_t off = chunk_src<D>(i, k0, kv_row, &kj);
      const bool ok = kj < kv_valid;
      cp_async16(tile + 16 * i, ok ? base + off : base, ok);
    }
  }
  __device__ __forceinline__ void finish(uint8_t*) {}
};

// D = A B (+ D if scale_d): m64n64k16 with A too through a shared-memory
// descriptor, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

}  // namespace repro
