// Paged decode attention for Hopper (sm_90a), split-KV.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_decode_attention, body _kernel): one query token per row,
// K/V gathered through a per-row page table from a shared page pool,
// GQA-native, fp32 online softmax, mask pos < len plus an optional
// sliding window anchored at len-1, exact zeros for len == 0.
//
// Bound on the H100: bytes.  Each row reads len * KV * D K and V
// elements once and does 4 flops per element pair, far below the ~295
// flops/byte the card needs to be compute-bound, so the floor is the
// live K/V bytes over 3.35 TB/s.  Reaching it takes many bytes in flight
// on every SM, also at a one-row decode bucket.
//
// Design against that bound:
//  - Split-KV on logical positions.  Split s of a row covers its logical
//    tokens [64 s, 64 s + 64), whatever the page size (a token maps to
//    page pos / ps of the table).  The grid is (KV head, row, split);
//    a split that lies wholly past len or before the window returns at
//    once and writes nothing.  So a row's splits depend only on its own
//    len and window: 8 rows of 130..563 tokens give 656 live blocks of
//    a 16-head model, one row of 300 tokens 80.
//  - Each live block holds the G query heads of one KV head (no GQA
//    replication of K/V), issues its whole split's K and then V rows as
//    16-byte cp.async (float4 of an fp32 pool, 8 bf16 of a bf16 one; rows
//    past len or before the window are zero-filled, never read, so table
//    entries past the live pages and the trash page are never touched),
//    and computes the scores while V is still landing.
//  - Scores: a quarter-warp (8 lanes) per token, each lane D/8 of the
//    dot product, reduced with three shuffles.  P.V: every thread owns
//    one 16-byte column chunk of a token group and sums its tokens for
//    up to 8 heads at once, reduced over lanes by shuffles and over the
//    four warps through shared memory, so all 128 threads work at G = 1.
//    Tensor cores are not needed: one query token and G <= 8 heads.
//  - Each split writes its (m, l, acc[D]) per query head, unnormalised,
//    to an fp32 workspace the wrapper allocates.  A second small kernel
//    combines a row's live splits in split order 0, 1, 2, ....
//
// Numerics: fp32 throughout, q and K/V converted on load; out in q's
// dtype.  The split boundaries are logical and the combine order fixed,
// so the same logical K/V gives bitwise the same output on any physical
// page layout, with any table width, and in any batch (the engine moves
// rows between decode buckets 1, 2, 4 and 8).  len == 0: no live split,
// the combine writes exact zeros.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kSplit = 64;  // logical tokens per split
constexpr int kPagedThreads = 128;
constexpr int kPagedWarps = kPagedThreads / 32;

// one 16-byte chunk of a K/V row, as E floats
template <typename KT>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__host__ __device__ inline size_t paged_smem_bytes(int D, int kv_bytes,
                                                   int G, int GB) {
  return 2 * (size_t)kSplit * D * kv_bytes +
         ((size_t)G * D + (size_t)G * kSplit + (size_t)kPagedWarps * GB * D) *
             sizeof(float);
}

// One (KV head, row, split) per block.  GB: query heads per P.V pass.
template <typename QT, typename KT, int D, int GB>
__global__ void __launch_bounds__(kPagedThreads) paged_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int H, int KV, int ps, int PMAX, int NS,
    float sm_scale, int window) {
  constexpr int E = Chunk<KT>::E;
  constexpr int CPR = D / E;                  // 16-byte chunks per row
  constexpr int LPT = CPR / 8;                // chunks per lane in a dot
  constexpr int TG = kPagedThreads / CPR;     // token groups in P.V
  static_assert(CPR % 8 == 0 && CPR <= 32, "D: 64 or 128");
  const int kh = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int G = H / KV;
  const int len = min(lengths[b], PMAX * ps);
  // first live position: pos > len - 1 - window  <=>  pos >= len - window
  const int first = window >= 0 ? max(0, len - window) : 0;
  const int t_lo = max(first, s * kSplit) - s * kSplit;
  const int t_hi = min(len, (s + 1) * kSplit) - s * kSplit;
  if (t_lo >= t_hi) return;  // nothing live here: the combine skips it

  extern __shared__ __align__(16) uint8_t smem[];
  KT* k_s = reinterpret_cast<KT*>(smem);                     // [kSplit][D]
  KT* v_s = k_s + kSplit * D;                                 // [kSplit][D]
  float* q_s = reinterpret_cast<float*>(v_s + kSplit * D);    // [G][D]
  float* p_s = q_s + G * D;                                   // [G][kSplit]
  float* red = p_s + G * kSplit;                  // [warps][GB][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int* table = page_table + (size_t)b * PMAX;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const KT* pool = half ? v_pages : k_pages;
    KT* dst = half ? v_s : k_s;
    for (int c = tid; c < kSplit * CPR; c += kPagedThreads) {
      const int t = c / CPR, part = c % CPR;
      const bool ok = t >= t_lo && t < t_hi;
      const KT* src = pool;
      if (ok) {
        const int pos = s * kSplit + t;
        const size_t phys = (size_t)table[pos / ps];
        src = pool + ((phys * ps + pos % ps) * KV + kh) * D + part * E;
      }
      cp_async16(dst + t * D + part * E, src, ok);
    }
    cp_async_commit();  // group 0: K, group 1: V
  }
  const size_t q_base = ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kPagedThreads)
    q_s[i] = to_f32(q[q_base + i]);
  cp_async_wait<1>();
  __syncthreads();  // K and q visible; V may still be landing

  // scores: quarter-warp qw takes tokens qw, qw + 16, ...; lane ql of it
  // the chunks ql, ql + 8, ... of the row
  const int qw = tid >> 3, ql = tid & 7;
  for (int g = 0; g < G; ++g) {
    float qv[LPT][E];
#pragma unroll
    for (int i = 0; i < LPT; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) qv[i][e] = q_s[g * D + (ql + 8 * i) * E + e];
#pragma unroll
    for (int t = qw; t < kSplit; t += kPagedThreads / 8) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        float kv[E];
        Chunk<KT>::load(k_s + t * D + (ql + 8 * i) * E, kv);
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[i][e], kv[e], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      if (ql == 0)
        p_s[g * kSplit + t] =
            t >= t_lo && t < t_hi ? dot * sm_scale : kNegInf;
    }
  }
  __syncthreads();

  // this split's softmax, one warp per head: lane owns tokens lane and
  // lane + 32
  const size_t head0 = (size_t)b * H + (size_t)kh * G;
  for (int g = warp; g < G; g += kPagedWarps) {
    float* ps_g = p_s + g * kSplit;
    const float s0 = ps_g[lane], s1 = ps_g[lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = lane >= t_lo && lane < t_hi ? expf(s0 - m) : 0.f;
    const float p1 =
        lane + 32 >= t_lo && lane + 32 < t_hi ? expf(s1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    ps_g[lane] = p0;
    ps_g[lane + 32] = p1;
    if (lane == 0) {
      float* ml = ws_ml + ((head0 + g) * NS + s) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V and the probabilities visible

  // P.V: thread owns column chunk cc of token group tg (tokens tg, tg +
  // TG, ...); rows outside [t_lo, t_hi) are zeros with p = 0
  const int cc = tid % CPR, tg = tid / CPR;
  for (int g0 = 0; g0 < G; g0 += GB) {
    const int gn = min(GB, G - g0);
    float acc[GB][E];
#pragma unroll
    for (int j = 0; j < GB; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
#pragma unroll 4
    for (int t = tg; t < kSplit; t += TG) {
      float vv[E];
      Chunk<KT>::load(v_s + t * D + cc * E, vv);
#pragma unroll
      for (int j = 0; j < GB; ++j) {
        if (j < gn) {
          const float p = p_s[(g0 + j) * kSplit + t];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] = fmaf(p, vv[e], acc[j][e]);
        }
      }
    }
    // token groups that share a warp sit CPR lanes apart
#pragma unroll
    for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < GB; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
    if (lane < CPR) {
#pragma unroll
      for (int j = 0; j < GB; ++j)
        if (j < gn) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            red[(warp * GB + j) * D + cc * E + e] = acc[j][e];
        }
    }
    __syncthreads();
    for (int i = tid; i < gn * D; i += kPagedThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kPagedWarps; ++w) a += red[w * GB * D + i];
      ws_acc[((head0 + g0 + i / D) * NS + s) * D + i % D] = a;
    }
    __syncthreads();  // red is reused by the next head block
  }
}

// One (query head, row) per block, a thread per output column: the
// row's live splits [s0, s1) in split order.  The threads first read the
// splits' maxima in parallel and leave each split's weight exp(m_s - M)
// in shared memory, so the sums' loads are independent of each other.
template <typename QT, int D>
__global__ void __launch_bounds__(D) paged_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
    const int* __restrict__ lengths, QT* __restrict__ out, int H, int ps,
    int PMAX, int NS, int window) {
  extern __shared__ float w_s[];  // [NS] split weights
  __shared__ float wmax[D / 32];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = min(lengths[b], PMAX * ps);
  const int first = window >= 0 ? max(0, len - window) : 0;
  const int s0 = first / kSplit;
  const int s1 = len > first ? (len - 1) / kSplit + 1 : s0;
  const size_t row = (size_t)b * H + h;
  const float* ml = ws_ml + row * NS * 2;
  float m = kNegInf;
  for (int s = s0 + d; s < s1; s += D) {
    w_s[s] = ml[2 * s];
    m = fmaxf(m, w_s[s]);
  }
  m = warp_max(m);
  if ((d & 31) == 0) wmax[d >> 5] = m;
  __syncthreads();
  m = wmax[0];
#pragma unroll
  for (int i = 1; i < D / 32; ++i) m = fmaxf(m, wmax[i]);
  for (int s = s0 + d; s < s1; s += D) w_s[s] = expf(w_s[s] - m);
  __syncthreads();
  float o = 0.f, l = 0.f;
#pragma unroll 8
  for (int s = s0; s < s1; ++s) {
    l = fmaf(w_s[s], ml[2 * s + 1], l);
    o = fmaf(w_s[s], ws_acc[(row * NS + s) * D + d], o);
  }
  // len == 0: no split, l == 0 and o == 0, so the row is exactly zero
  out[row * D + d] = from_f32<QT>(o / fmaxf(l, 1e-30f));
}

template <typename QT, typename KT, int D, int GB>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const void* pt, const void* lens, void* out,
                         void* ws_acc, void* ws_ml, int B, int H, int KV,
                         int ps, int PMAX, float sm_scale, int window,
                         cudaStream_t stream) {
  const int G = H / KV;
  const int NS = (PMAX * ps + kSplit - 1) / kSplit;
  const size_t smem = paged_smem_bytes(D, sizeof(KT), G, GB);
  auto split = paged_split_kernel<QT, KT, D, GB>;
  auto combine = paged_combine_kernel<QT, D>;
  const size_t smem_c = NS * sizeof(float);
  // above 48 KB (large G at D = 128, or a very long table) a block needs
  // an opt-in; it is set once per size, on the first call, not under
  // CUDA-graph capture
  static size_t opted = 48 * 1024, opted_c = 48 * 1024;
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  if (smem_c > opted_c) {
    cudaError_t e = cudaFuncSetAttribute(
        combine, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
    if (e != cudaSuccess) return e;
    opted_c = smem_c;
  }
  split<<<dim3(KV, B, NS), kPagedThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), H, KV, ps, PMAX, NS, sm_scale, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine<<<dim3(H, B), D, smem_c, stream>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
      static_cast<const int*>(lens), static_cast<QT*>(out), H, ps, PMAX, NS,
      window);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* pt, const void* lens, void* out,
                       void* ws_acc, void* ws_ml, int B, int H, int KV,
                       int ps, int PMAX, float sm_scale, int window,
                       cudaStream_t s) {
#define PAGED_ARGS q, k, v, pt, lens, out, ws_acc, ws_ml, B, H, KV, ps, \
                   PMAX, sm_scale, window, s
  const bool one = H == KV;  // G = 1: a one-head P.V pass
  if (D == 64)
    return one ? launch_paged<QT, KT, 64, 1>(PAGED_ARGS)
               : launch_paged<QT, KT, 64, 8>(PAGED_ARGS);
  if (D == 128)
    return one ? launch_paged<QT, KT, 128, 1>(PAGED_ARGS)
               : launch_paged<QT, KT, 128, 8>(PAGED_ARGS);
#undef PAGED_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// window < 0: no sliding window.  dtype codes: see common.cuh.  ws_acc
// (B, H, NS, D) and ws_ml (B, H, NS, 2) fp32 with NS = ceil(PMAX*ps/64):
// the per-split partials, scratch owned by the caller.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* page_table,
                                   const void* lengths, void* out,
                                   void* ws_acc, void* ws_ml, int B, int H,
                                   int KV, int D, int ps, int PMAX,
                                   float sm_scale, int window, int q_dtype,
                                   int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV || ps < 1 || PMAX < 1) return (int)cudaErrorInvalidValue;
#define ARGS D, q, k_pages, v_pages, page_table, lengths, out, ws_acc, ws_ml, \
             B, H, KV, ps, PMAX, sm_scale, window, s
  cudaError_t e = cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32)
    e = dispatch_d<float, float>(ARGS);
  else if (q_dtype == kF32 && kv_dtype == kBF16)
    e = dispatch_d<float, __nv_bfloat16>(ARGS);
  else if (q_dtype == kBF16 && kv_dtype == kF32)
    e = dispatch_d<__nv_bfloat16, float>(ARGS);
  else if (q_dtype == kBF16 && kv_dtype == kBF16)
    e = dispatch_d<__nv_bfloat16, __nv_bfloat16>(ARGS);
#undef ARGS
  return (int)e;
}
