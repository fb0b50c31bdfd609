// Backward of the port's flash attention on Hopper's tensor cores, for
// bf16 q, k, v and dout (sm_90a).
//
// The JAX package has no backward Pallas kernel: XLA differentiates its
// jnp attention (src/repro/models/layers.py gqa_attention).  This is the
// gradient of flash_attention_tc.cu's forward (which replaces
// src/repro/kernels/flash_attention.py flash_attention) for every bf16
// training call; fp32 q, k, v go to the CUDA-core kernel in
// flash_attention_bwd.cu.  Same layout and masks as the forward: q, out,
// dout, dq (B,Sq,H,D); k, v, dk, dv (B,Skv,HKV,D), all contiguous and
// 16-byte aligned; head_dim 64, 112 or 128; causal or not, sliding window,
// q_offset, kv_len, ragged Sq and Skv without padding; GQA (H = G * HKV).
// The forward's log-sum-exp lse (B,H,Sq) fp32 comes in.
//
// Numerical contract (what tests/_flash_bwd_emulation.py reproduces):
//  - delta = rowsum(dO * O) in fp32 over the bf16 O and dO;
//  - S = Q K^T and dP = dO V^T are bf16 products summed in fp32;
//  - P = exp(S * scale - lse) in fp32 from the forward's fp32 lse, and
//    dS = P * (dP - delta) in fp32;
//  - P and dS are rounded to bf16 (round to nearest even) before
//    dV = P^T dO, dK = dS^T Q and dQ = dS K, which sum in fp32 (dK and
//    dV over all the group's heads in one fp32 sum);
//  - dQ and dK are multiplied by the softmax scale once, and every
//    gradient is rounded to bf16 once, at the store;
//  - a key at or past kv_len, or seen by no row, gets exact zero dk and
//    dv; a row with no visible key gets exact zero dq.
//
// Bound on the H100: ~2.5x the forward's products (S and dP recomputed,
// dV, dK, dQ), halved for causal, against one read of q, k, v, out,
// dout and one write of dq, dk, dv: bytes-bound at 3.35 TB/s up to about
// 1000 causal keys, which covers the 512 of the training shapes, and
// operations-bound beyond.  So the design reads each operand tile from
// device memory as few times as the blocking allows, keeps every
// product on the tensor cores and every accumulator in registers, and
// overlaps the next tile's loads with this tile's products.  Three
// launches and no atomics, so two runs give the same bits (a bitwise
// resume needs it) and GQA's sum over the group's heads runs in order:
//  1. delta: D/8 threads a row (16 at D = 112, two idle), one 16-byte
//     chunk of O and dO each;
//  2. dK/dV: one warpgroup per (64-key tile, kv head, batch), the
//     heaviest tiles first (the grid's slowest axis is the key tile, and
//     tile 0 of a causal call is seen by the most q rows).  Its K and V
//     tiles are loaded once into shared memory in wgmma.cuh's layout;
//     for each head of the group and each 64-row q tile that sees the
//     keys, the Q and dO tiles and the rows' lse and delta arrive by
//     cp.async, double-buffered, in the same layout.  S^T = K Q^T and
//     dP^T = V dO^T are wgmma m64n64k16 with both operands in shared
//     memory (K or V as A, Q or dO as a K-major B); P^T and dS^T are made
//     in the accumulators (lse and delta per column) and, rounded to
//     bf16, are the A fragments of dV += P^T dO and dK += dS^T Q
//     (m64nDk16, dO and Q read MN-major as the forward reads V).  dK and
//     dV stay in registers (D fp32 a thread) until the one store;
//  3. dQ: one warpgroup per (64-row q tile, head, batch), the heaviest
//     first as the forward's.  Q and dO are A fragments in registers,
//     loaded once; the K and V tiles of the forward's visible key range
//     are double-buffered by cp.async; S = Q K^T and dP = dO V^T read K
//     and V K-major, dQ += dS K reads K MN-major.
// Tiles wholly outside the causal or window range are never loaded;
// rows and keys past the ends are zero-filled, never read.
#include <stdint.h>

#include "wgmma.cuh"

namespace repro {
namespace {

// 4 bytes global -> shared, fill = false writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool fill) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

// the A fragment of k16 slice j of a 64-column accumulator, rounded to
// bf16: the accumulator layout of an n16 slice is the A layout
__device__ __forceinline__ void a_fragment(const float (&x)[32], int j,
                                           uint32_t (&f)[4]) {
  f[0] = pack_bf16(x[8 * j + 0], x[8 * j + 1]);
  f[1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
  f[2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
  f[3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
}

// rows r and r + 8 of a 64 x D accumulator (columns 8i + 2c, +1) times
// `mul`, as bf16 pairs; a row past `rows` is not stored
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t row,
                                           int r, int rows, int c,
                                           const float (&a)[D / 2],
                                           float mul) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (r < rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)r * row + col) =
          pack_bf16(a[4 * i] * mul, a[4 * i + 1] * mul);
    if (r + 8 < rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)(r + 8) * row + col) =
          pack_bf16(a[4 * i + 2] * mul, a[4 * i + 3] * mul);
  }
}

// threads a row of the delta kernel: one 16-byte chunk each, a power of
// two (D = 112's 14 chunks take 16 threads, two of them idle)
template <int D>
__host__ __device__ constexpr int delta_lanes() {
  return D / 8 > 8 ? 16 : 8;
}

template <int D>
__global__ void flash_bwd_tc_delta_kernel(
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
    int Sq, int H, size_t rows) {
  constexpr int kLanes = delta_lanes<D>();
  const size_t r =
      ((size_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  float s = 0.f;
  if (r < rows && part < D / 8) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + r * D + 8 * part);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + r * D + 8 * part);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 b = __bfloat1622float2(g2[i]);
      s += a.x * b.x;
      s += a.y * b.y;
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  if (r < rows && part == 0) {
    const size_t bi = r / H;  // b * Sq + i
    const int h = (int)(r % H), i = (int)(bi % Sq);
    delta[((bi / Sq) * H + h) * Sq + i] = s;
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_tc_dkdv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H, int HKV,
    float sm_scale, int causal, int window, int q_offset, int kv_len) {
  static_assert(D == 64 || D == 112 || D == 128,
                "head_dim 64, 112 or 128");
  constexpr int kSlices = D / 16;         // k16 slices over D
  constexpr int kTile = kTcKeys * D * 2;  // bytes of one bf16 tile
  constexpr uint32_t kGroup = D * 16;     // bytes between 8-row groups
  // K, V, Q0, Q1, dO0, dO1, then [buffer][lse, delta][64 rows] fp32
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ks = smem;
  uint8_t* vs = smem + kTile;
  float* stats = reinterpret_cast<float*>(smem + 6 * kTile);

  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kTcKeys;
  const int G = H / HKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int kr0 = k0 + warp * 16 + g;  // this thread's keys: kr0, kr0 + 8
  const int kv_valid = min(kv_len, Skv);
  const float scale_log2 = sm_scale * kLog2e;
  // the q rows that see key kj: [lo, hi) (causal: q_offset + i >= kj;
  // window: q_offset + i < kj + window), none for a key past kv_len
  auto rows_of = [&](int kj, int* lo, int* hi) {
    *lo = causal ? max(0, kj - q_offset) : 0;
    *hi = window >= 0 ? min(Sq, kj + window - q_offset) : Sq;
    if (kj >= kv_valid) *hi = 0;
  };
  int lo0, hi0, lo1, hi1;
  rows_of(kr0, &lo0, &hi0);
  rows_of(kr0 + 8, &lo1, &hi1);

  // the q rows that can see a key of [k0, k0 + 64): [q_lo, q_hi)
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window >= 0) q_hi = min(Sq, k0 + kTcKeys - 1 + window - q_offset);
  if (k0 >= kv_valid) q_hi = 0;
  const int q_start = q_lo / kTcRows * kTcRows;
  const int n_q =
      q_hi > q_start ? (q_hi - q_start + kTcRows - 1) / kTcRows : 0;
  const int n_steps = G * n_q;  // (head of the group, q tile), in order

  const size_t q_row = (size_t)H * D, kv_row = (size_t)HKV * D;
  const size_t kv_at = (size_t)b * Skv * kv_row + (size_t)kh * D;
  TileLoader<__nv_bfloat16, D> ld;

  // step t's Q and dO tiles and its rows' lse and delta, into buffer buf
  auto load_step = [&](int t, int buf) {
    const int h = kh * G + t / n_q, q0 = q_start + (t % n_q) * kTcRows;
    const size_t at = (size_t)b * Sq * q_row + (size_t)h * D;
    ld.issue(q + at, q0, Sq, q_row, smem + (2 + buf) * kTile);
    ld.issue(dout + at, q0, Sq, q_row, smem + (4 + buf) * kTile);
    const float* src =
        (threadIdx.x < kTcRows ? lse : delta) + ((size_t)b * H + h) * Sq;
    const int qi = q0 + (threadIdx.x & (kTcRows - 1));
    cp_async4(stats + 2 * kTcRows * buf + threadIdx.x,
              qi < Sq ? src + qi : src, qi < Sq);
  };

  float dka[D / 2], dva[D / 2], s[kTcKeys / 2], dp[kTcKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) s[i] = dp[i] = 0.f;

  if (n_steps > 0) {
    ld.issue(k + kv_at, k0, kv_valid, kv_row, ks);
    ld.issue(v + kv_at, k0, kv_valid, kv_row, vs);
    load_step(0, 0);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }
  const uint64_t k_desc = smem_desc(ks, 128, kGroup);
  const uint64_t v_desc = smem_desc(vs, 128, kGroup);

  for (int t = 0; t < n_steps; ++t) {
    const int buf = t & 1;
    const int q0 = q_start + (t % n_q) * kTcRows;
    if (t + 1 < n_steps) load_step(t + 1, buf ^ 1);
    uint8_t* qs = smem + (2 + buf) * kTile;
    uint8_t* dos = smem + (4 + buf) * kTile;
    const float* lse_s = stats + 2 * kTcRows * buf;
    const float* del_s = lse_s + kTcRows;

    // S^T = K Q^T, dP^T = V dO^T: two groups, so that P^T is made while
    // dP^T is in flight
    const uint64_t q_desc = smem_desc(qs, 128, kGroup);
    const uint64_t do_desc = smem_desc(dos, 128, kGroup);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
      wgmma_m64n64k16_ss(s, k_desc + (uint64_t)(16 * j),
                         q_desc + (uint64_t)(16 * j), j > 0);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
      wgmma_m64n64k16_ss(dp, v_desc + (uint64_t)(16 * j),
                         do_desc + (uint64_t)(16 * j), j > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // s[4i + e] is (key kr0, q row q0 + 8i + 2c + e), s[4i + 2 + e] key
    // kr0 + 8: P^T into s
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * c + e, qi = q0 + col;
        const float l = lse_s[col] * kLog2e;
        s[4 * i + e] = qi >= lo0 && qi < hi0
                           ? exp2f(s[4 * i + e] * scale_log2 - l) : 0.f;
        s[4 * i + 2 + e] = qi >= lo1 && qi < hi1
                               ? exp2f(s[4 * i + 2 + e] * scale_log2 - l)
                               : 0.f;
      }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q, one
    // k16 slice (q rows 16j..) at a time: dO and Q as MN-major B, the
    // slice 2j row groups in
    const uint64_t do_t = smem_desc(dos, kGroup, 128);
    const uint64_t q_t = smem_desc(qs, kGroup, 128);
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + half;
          const float dl = del_s[8 * i + 2 * c + e];
          dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - dl);
          dp[4 * i + 2 + e] = s[4 * i + 2 + e] * (dp[4 * i + 2 + e] - dl);
        }
      a_fragment(s, j, pf[j]);
      a_fragment(dp, j, dsf[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_pv<D>(dva, pf[j], do_t + (uint64_t)((2 * kGroup * j) >> 4));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_pv<D>(dka, dsf[j], q_t + (uint64_t)((2 * kGroup * j) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);

    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // step t+1 visible; step t's buffers free
  }

  store_rows<D>(dk + kv_at, kv_row, kr0, Skv, c, dka, sm_scale);
  store_rows<D>(dv + kv_at, kv_row, kr0, Skv, c, dva, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_tc_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Skv, int H, int HKV, float sm_scale, int causal, int window,
    int q_offset, int kv_len) {
  static_assert(D == 64 || D == 112 || D == 128,
                "head_dim 64, 112 or 128");
  constexpr int kSlices = D / 16;
  constexpr int kTile = kTcKeys * D * 2;
  constexpr uint32_t kGroup = D * 16;
  extern __shared__ __align__(128) uint8_t smem[];  // K0 K1 V0 V1

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;
  const int kh = h / (H / HKV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const bool ok0 = r0 < Sq, ok1 = r0 + 8 < Sq;
  const float scale_log2 = sm_scale * kLog2e;

  // Q and dO as A fragments: slice j, regs {row g, row g+8} x {cols 2c,
  // 8+2c}
  const size_t q_row = (size_t)H * D;
  const size_t at = (size_t)b * Sq * q_row + (size_t)h * D;
  uint32_t qf[kSlices][4], df[kSlices][4];
#pragma unroll
  for (int j = 0; j < kSlices; ++j)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = r0 + 8 * (f & 1), col = 16 * j + 8 * (f >> 1) + 2 * c;
      const size_t off = at + (size_t)r * q_row + col;
      qf[j][f] = r < Sq ? *reinterpret_cast<const uint32_t*>(q + off) : 0u;
      df[j][f] =
          r < Sq ? *reinterpret_cast<const uint32_t*>(dout + off) : 0u;
    }
  const size_t st = ((size_t)b * H + h) * Sq;
  const float l0 = ok0 ? lse[st + r0] * kLog2e : 0.f;
  const float l1 = ok1 ? lse[st + r0 + 8] * kLog2e : 0.f;
  const float d0 = ok0 ? delta[st + r0] : 0.f;
  const float d1 = ok1 ? delta[st + r0 + 8] : 0.f;

  // keys this tile of rows can see: [kv_start, kv_stop), as the forward
  const int kv_valid = min(kv_len, Skv);
  int kv_stop = kv_valid;
  if (causal) kv_stop = min(kv_stop, q_offset + min(q0 + kTcRows, Sq));
  int kv_start = window >= 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_start = kv_start / kTcKeys * kTcKeys;
  const int n_tiles =
      kv_stop > kv_start ? (kv_stop - kv_start + kTcKeys - 1) / kTcKeys : 0;

  // the keys row r sees: [lo, hi) (causal: kj <= q_offset + r; window:
  // kj > q_offset + r - window; kj < kv_len), none for a row past Sq
  auto keys_of = [&](int r, int* lo, int* hi) {
    const int qp = q_offset + r;
    *lo = window >= 0 ? max(0, qp - window + 1) : 0;
    *hi = causal ? min(kv_valid, qp + 1) : kv_valid;
    if (r >= Sq) *hi = 0;
  };
  int lo0, hi0, lo1, hi1;
  keys_of(r0, &lo0, &hi0);
  keys_of(r0 + 8, &lo1, &hi1);

  const size_t kv_row = (size_t)HKV * D;
  const size_t kv_at = (size_t)b * Skv * kv_row + (size_t)kh * D;
  TileLoader<__nv_bfloat16, D> ld;

  float dqa[D / 2], s[kTcKeys / 2], dp[kTcKeys / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTcKeys / 2; ++i) s[i] = dp[i] = 0.f;

  if (n_tiles > 0) {
    ld.issue(k + kv_at, kv_start, kv_valid, kv_row, smem);
    ld.issue(v + kv_at, kv_start, kv_valid, kv_row, smem + 2 * kTile);
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_start + t * kTcKeys, buf = t & 1;
    uint8_t* ks = smem + buf * kTile;
    uint8_t* vs = smem + (2 + buf) * kTile;
    if (t + 1 < n_tiles) {
      ld.issue(k + kv_at, k0 + kTcKeys, kv_valid, kv_row,
               smem + (buf ^ 1) * kTile);
      ld.issue(v + kv_at, k0 + kTcKeys, kv_valid, kv_row,
               smem + (2 + (buf ^ 1)) * kTile);
    }

    // S = Q K^T, dP = dO V^T: two groups, so that P is made while dP is
    // in flight
    const uint64_t k_desc = smem_desc(ks, 128, kGroup);
    const uint64_t v_desc = smem_desc(vs, 128, kGroup);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
      wgmma_m64n64k16<0>(s, qf[j], k_desc + (uint64_t)(16 * j), j > 0);
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < kSlices; ++j)
      wgmma_m64n64k16<0>(dp, df[j], v_desc + (uint64_t)(16 * j), j > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // s[4i + e] is (row r0, key k0 + 8i + 2c + e), s[4i + 2 + e] row
    // r0 + 8: P into s, then dS into dp and its A fragments
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kj = k0 + 8 * i + 2 * c + e;
        s[4 * i + e] = kj >= lo0 && kj < hi0
                           ? exp2f(s[4 * i + e] * scale_log2 - l0) : 0.f;
        s[4 * i + 2 + e] = kj >= lo1 && kj < hi1
                               ? exp2f(s[4 * i + 2 + e] * scale_log2 - l1)
                               : 0.f;
      }
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t dsf[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * j + half;
          dp[4 * i + e] = s[4 * i + e] * (dp[4 * i + e] - d0);
          dp[4 * i + 2 + e] = s[4 * i + 2 + e] * (dp[4 * i + 2 + e] - d1);
        }
      a_fragment(dp, j, dsf[j]);
    }

    // dQ += dS K, K as an MN-major B: keys 16j.. at 2j key groups in
    const uint64_t k_t = smem_desc(ks, kGroup, 128);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_pv<D>(dqa, dsf[j], k_t + (uint64_t)((2 * kGroup * j) >> 4));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);

    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile t+1 visible; tile t's buffers free
  }

  store_rows<D>(dq + at, q_row, r0, Sq, c, dqa, sm_scale);
}

template <int D>
constexpr int dkdv_smem() {
  return 6 * kTcKeys * D * 2 + 2 * 2 * kTcRows * (int)sizeof(float);
}
template <int D>
constexpr int dq_smem() {
  return 4 * kTcKeys * D * 2;
}

template <int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* out, const void* dout, const void* lse,
                          void* delta, void* dq, void* dk, void* dv, int B,
                          int Sq, int Skv, int H, int HKV, float sm_scale,
                          int causal, int window, int q_offset, int kv_len,
                          cudaStream_t s) {
  // once per instantiation, before any launch: no call under CUDA-graph
  // capture sets it
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_tc_dkdv_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_tc_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<D>());
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  using bf16 = __nv_bfloat16;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const size_t rows = (size_t)B * Sq * H;
  const size_t threads = rows * delta_lanes<D>();
  flash_bwd_tc_delta_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0,
                                  s>>>(static_cast<const bf16*>(out), dot,
                                       dl, Sq, H, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 g_kv(HKV, B, (Skv + kTcKeys - 1) / kTcKeys);
  flash_bwd_tc_dkdv_kernel<D><<<g_kv, kTcThreads, dkdv_smem<D>(), s>>>(
      qt, kt, vt, dot, lt, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Sq, Skv, H, HKV, sm_scale, causal, window, q_offset, kv_len);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 g_q(H, B, (Sq + kTcRows - 1) / kTcRows);
  flash_bwd_tc_dq_kernel<D><<<g_q, kTcThreads, dq_smem<D>(), s>>>(
      qt, kt, vt, dot, lt, dl, static_cast<bf16*>(dq), Sq, Skv, H, HKV,
      sm_scale, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// q, k, v, out, dout, dq, dk, dv bf16 (dtype must say so), 16-byte
// aligned; lse and the delta workspace (B,H,Sq) fp32.  window < 0: no
// sliding window.  The same arguments as flash_attention_bwd.
extern "C" int flash_attention_tc_bwd(const void* q, const void* k,
                                      const void* v, const void* out,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk,
                                      void* dv, int B, int Sq, int Skv,
                                      int H, int HKV, int D, float sm_scale,
                                      int causal, int window, int q_offset,
                                      int kv_len, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
#define BWD_ARGS q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, \
                 HKV, sm_scale, causal, window, q_offset, kv_len, s
  if (D == 64) return (int)launch_bwd_tc<64>(BWD_ARGS);
  if (D == 112) return (int)launch_bwd_tc<112>(BWD_ARGS);
  if (D == 128) return (int)launch_bwd_tc<128>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
