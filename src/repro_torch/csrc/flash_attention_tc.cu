// Flash attention on Hopper's tensor cores, for bf16 queries (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel) with the padding wrapper
// ops.flash_attention, for every served call: the models compute in
// bf16, so q is bf16; K/V come from the fp32 cache (or are bf16).  An
// fp32 q goes to the CUDA-core kernel in flash_attention.cu instead.
// Same masks as that kernel: causal, sliding window, kv_len, q_offset,
// ragged Sq/Skv without padding; layout q (B,Sq,H,D), k/v
// (B,Skv,HKV,D), out like q, all contiguous; D a multiple of 16.
//
// Numerical contract (what a plain emulation must reproduce):
//  - K and V are rounded to bf16 (round to nearest even).  Lossless on
//    the served paths: the fp32 cache holds bf16 projections.
//  - S = q K^T and O = P V are bf16 products summed in fp32.
//  - Softmax statistics (row max, row sum), the rescale and the final
//    division are fp32; the row sum adds the fp32 probabilities.
//  - P is rounded to bf16 before P V, as FlashAttention does.
//  - A row with no visible key writes exact zeros.
//
// Bound on the H100: at the prefill shapes (Sq 64..1024, D 64 or 112)
// the causal work is ~2*Sq*Skv*D*H flops per product against
// ~(2*Sq + 2*Skv)*H*D*bytes of traffic: bytes-bound below a few hundred
// rows, then tensor-core bound.  Design:
//  - One warpgroup (128 threads) per 64-row q tile of one (head,
//    batch).  Its q rows live in registers as wgmma A fragments, loaded
//    once; the O accumulators (D/2 fp32 a thread) and the m/l
//    statistics of its two rows per thread stay in registers.
//  - S = q K^T: wgmma m64n64k16, A from registers, B = the K tile in
//    shared memory, K-major (D contiguous).  O += P V: wgmma m64nDk16
//    with P taken from the S accumulators rounded to bf16 (the
//    accumulator layout of an n16 slice is the A fragment layout), V in
//    its natural (key, d) layout as an MN-major ("transposed") B.
//  - Shared-memory layout: the canonical no-swizzle ("interleave")
//    layout of wgmma.  A 64-key tile is cut into 8x8 core matrices (8
//    keys x 16 bytes of bf16), stored as contiguous 128-byte blocks,
//    the D/8 blocks of an 8-key group one after another.  So 16-byte
//    chunk i of a tile lives at byte 16*i, a warp's 32 chunks are 512
//    contiguous bytes (no bank conflict on the stores), and D = 112 (14
//    core matrices) needs no padding, which a 64- or 128-byte swizzle
//    atom would (D = 112 rows are 224 bytes).  The same bytes serve as
//    K-major B for K (core matrices 128 B apart along D, D*16 B apart
//    along keys) and as MN-major B for V (the same two strides, read
//    the other way).
//  - K/V tiles are double-buffered.  fp32 K/V (the served case): the
//    next tile is loaded as 16-byte vectors into registers before this
//    tile's products, converted to bf16 and stored into the layout
//    after them (K after q K^T, V after P V, so one register stage
//    serves both).  bf16 K/V: cp.async straight into the layout.
//  - Tiles wholly outside the causal or window range are never loaded;
//    keys at or past min(kv_len, Skv) are zero-filled, never read.
//  - The q tiles are scheduled heaviest first: the grid's slowest axis
//    is the reversed q-tile index, so the causal tiles with the most
//    keys start in the first wave.
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kTcRows = 64;      // q rows per block: one wgmma M
constexpr int kTcKeys = 64;      // keys per K/V tile: q K^T's N
constexpr int kTcThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

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

template <typename KT, int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq,
    int Skv, int H, int HKV, float scale_log2, int causal, int window,
    int q_offset, int kv_len) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16");
  constexpr int kSlices = D / 16;       // k16 slices of q K^T
  constexpr int kTile = kTcKeys * D * 2;  // bytes of one bf16 tile
  constexpr uint32_t kKeyGroup = D * 16;  // bytes between 8-key groups
  extern __shared__ __align__(128) uint8_t smem[];  // K0 K1 V0 V1

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const int kh = h / (H / HKV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const bool ok0 = r0 < Sq, ok1 = r0 + 8 < Sq;
  const int qp0 = q_offset + r0, qp1 = qp0 + 8;

  // q as A fragments: slice j, regs {row g, row g+8} x {cols 2c, 8+2c}
  const size_t q_row = (size_t)H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_row + (size_t)h * D;
  uint32_t qf[kSlices][4];
#pragma unroll
  for (int j = 0; j < kSlices; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = r0 + 8 * (f & 1), col = 16 * j + 8 * (f >> 1) + 2 * c;
      qf[j][f] = r < Sq ? *reinterpret_cast<const uint32_t*>(
                              qb + (size_t)r * q_row + col)
                        : 0u;
    }

  // keys this tile of rows can see: [kv_start, kv_stop)
  const int kv_valid = min(kv_len, Skv);
  int kv_stop = kv_valid;
  if (causal) kv_stop = min(kv_stop, q_offset + min(q0 + kTcRows, Sq));
  int kv_start = window >= 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_start = kv_start / kTcKeys * kTcKeys;
  const int n_tiles =
      kv_stop > kv_start ? (kv_stop - kv_start + kTcKeys - 1) / kTcKeys : 0;

  const size_t kv_row = (size_t)HKV * D;
  const KT* kb = k + (size_t)b * Skv * kv_row + (size_t)kh * D;
  const KT* vb = v + (size_t)b * Skv * kv_row + (size_t)kh * D;
  TileLoader<KT, D> ld;

  float o[D / 2], s[kTcKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) s[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    ld.issue(kb, kv_start, kv_valid, kv_row, smem);
    ld.finish(smem);
    ld.issue(vb, kv_start, kv_valid, kv_row, smem + 2 * kTile);
    ld.finish(smem + 2 * kTile);
    if constexpr (sizeof(KT) == 2) cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_start + t * kTcKeys, buf = t & 1;
    const bool next = t + 1 < n_tiles;
    uint8_t* ks = smem + buf * kTile;
    uint8_t* vs = smem + (2 + buf) * kTile;
    uint8_t* kn = smem + (buf ^ 1) * kTile;
    uint8_t* vn = smem + (2 + (buf ^ 1)) * kTile;
    if (next) ld.issue(kb, k0 + kTcKeys, kv_valid, kv_row, kn);

    // S = q K^T
    const uint64_t dk = smem_desc(ks, 128, kKeyGroup);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
      wgmma_m64n64k16<0>(s, qf[j], dk + (uint64_t)(16 * j), j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // masks, then the online softmax in base 2 on fp32 statistics;
    // s[4i + e] is (row r0, key k0 + 8i + 2c + e), s[4i + 2 + e] row r0+8
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * i + 2 * c + e;
        const bool in = kj < kv_valid;
        const bool v0 = ok0 && in && (!causal || kj <= qp0) &&
                        (window < 0 || kj > qp0 - window);
        const bool v1 = ok1 && in && (!causal || kj <= qp1) &&
                        (window < 0 || kj > qp1 - window);
        s[4 * i + e] = v0 ? s[4 * i + e] * scale_log2 : kNegInf;
        s[4 * i + 2 + e] = v1 ? s[4 * i + 2 + e] * scale_log2 : kNegInf;
        mx0 = fmaxf(mx0, s[4 * i + e]);
        mx1 = fmaxf(mx1, s[4 * i + 2 + e]);
      }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& p0 = s[4 * i + e];
        float& p1 = s[4 * i + 2 + e];
        p0 = p0 > kNegInf ? exp2f(p0 - mn0) : 0.f;  // masked: exactly 0
        p1 = p1 > kNegInf ? exp2f(p1 - mn1) : 0.f;
        ps0 += p0;
        ps1 += p1;
      }
    l0 = l0 * a0 + ps0;  // this thread's share of the row sums
    l1 = l1 * a1 + ps1;
    uint32_t pf[kTcKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j) {
      pf[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
      pf[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
      pf[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
      pf[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i + 0] *= a0;
      o[4 * i + 1] *= a0;
      o[4 * i + 2] *= a1;
      o[4 * i + 3] *= a1;
    }

    if (next) {
      ld.finish(kn);
      ld.issue(vb, k0 + kTcKeys, kv_valid, kv_row, vn);
    }

    // O += P V, V as an MN-major B: keys 16j.. at 2j key groups in
    const uint64_t dv = smem_desc(vs, kKeyGroup, 128);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kTcKeys / 16; ++j)
      wgmma_pv<D>(o, pf[j], dv + (uint64_t)((2 * kKeyGroup * j) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    if (next) {
      ld.finish(vn);
      if constexpr (sizeof(KT) == 2) cp_async_wait_all();
    }
    fence_proxy_async();
    __syncthreads();  // tile t+1 visible; tile t's buffers free
  }

  // a row with no visible key has l == 0 and o == 0: exact zeros
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + (size_t)b * Sq * q_row + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (ok0)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * q_row + col) =
          pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (ok1)
      *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * q_row + col) =
          pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

template <typename KT, int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Skv, int H, int HKV, float sm_scale,
                      int causal, int window, int q_offset, int kv_len,
                      cudaStream_t s) {
  constexpr int kSmem = 4 * kTcKeys * D * 2;  // K and V, two buffers each
  // once per instantiation, before any launch: no call under CUDA-graph
  // capture sets it
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_tc_kernel<KT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  dim3 grid(H, B, (Sq + kTcRows - 1) / kTcRows);
  flash_attention_tc_kernel<KT, D><<<grid, kTcThreads, kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<__nv_bfloat16*>(out), Sq, Skv,
      H, HKV, sm_scale * kLog2e, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t tc_dispatch_d(int D, const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Skv, int H, int HKV,
                          float sm_scale, int causal, int window,
                          int q_offset, int kv_len, cudaStream_t s) {
#define TC_ARGS q, k, v, out, B, Sq, Skv, H, HKV, sm_scale, causal, window, \
                q_offset, kv_len, s
  if (D == 64) return launch_tc<KT, 64>(TC_ARGS);
  if (D == 112) return launch_tc<KT, 112>(TC_ARGS);
  if (D == 128) return launch_tc<KT, 128>(TC_ARGS);
#undef TC_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// q and out bf16; k and v fp32 or bf16 (kv_dtype), 16-byte aligned.
// window < 0: no sliding window.  kv_len: keys at or past it are masked.
extern "C" int flash_attention_tc_fwd(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int HKV, int D,
                                      float sm_scale, int causal, int window,
                                      int q_offset, int kv_len, int kv_dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (kv_dtype == kF32)
    e = tc_dispatch_d<float>(D, q, k, v, out, B, Sq, Skv, H, HKV, sm_scale,
                             causal, window, q_offset, kv_len, s);
  else if (kv_dtype == kBF16)
    e = tc_dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, HKV,
                                     sm_scale, causal, window, q_offset,
                                     kv_len, s);
  return (int)e;
}
