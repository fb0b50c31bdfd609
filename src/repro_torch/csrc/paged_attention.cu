// Paged decode attention for Hopper (sm_90a).
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
// live K/V bytes over 3.35 TB/s.
//
// Design against that bound: one block per (row, KV head) holds the G
// query heads that share the KV head, so each K/V element is read from
// device memory exactly once for all G heads (no GQA replication).
// Only live pages are walked, in logical order 0..ceil(len/ps)-1 (the
// trash page and table entries past the live pages are never read),
// and pages wholly before a sliding window are skipped.  Each page is
// consumed in chunks of 32 tokens staged in shared memory, one token
// per lane for the softmax.  The fixed logical order makes the output
// bitwise identical under any physical page layout.  No split-KV yet:
// a short batch leaves most SMs idle, which later work addresses.
#include "common.cuh"

namespace repro {

constexpr int kPagedThreads = 128;
constexpr int kChunk = 32;  // tokens per step: one lane each

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kPagedThreads) paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pages,
    const KT* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, QT* __restrict__ out, int H, int KV,
    int ps, int PMAX, float sm_scale, int window) {
  constexpr int kWarps = kPagedThreads / 32;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;              // [G][D] the G query heads, fp32
  float* acc = q_s + G * D;       // [G][D] running sum of p * v
  float* p_s = acc + G * D;       // [G][kChunk] scores, then probabilities
  float* m_s = p_s + G * kChunk;  // [G] running max
  float* l_s = m_s + G;           // [G] running denominator
  float* a_s = l_s + G;           // [G] this chunk's rescale factor
  __shared__ float k_s[kChunk][D + 1];  // +1: conflict-free per-lane rows
  __shared__ float v_s[kChunk][D];

  const size_t q_base = ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += kPagedThreads) {
    q_s[i] = to_f32(q[q_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kPagedThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int len = min(lengths[b], PMAX * ps);
  // first live position: pos > len - 1 - window  <=>  pos >= len - window
  const int first = window >= 0 ? max(0, len - window) : 0;
  __syncthreads();

  for (int j = first / ps; j * ps < len; ++j) {
    const size_t phys = (size_t)page_table[(size_t)b * PMAX + j];
    for (int t0 = 0; t0 < ps && j * ps + t0 < len; t0 += kChunk) {
      const int base = j * ps + t0;  // logical position of lane 0
      const int n = min(kChunk, ps - t0);
      for (int i = tid; i < n * D; i += kPagedThreads) {
        const int t = i / D, d = i % D;
        const size_t off = ((phys * ps + t0 + t) * KV + kh) * D + d;
        k_s[t][d] = to_f32(k_pages[off]);
        v_s[t][d] = to_f32(v_pages[off]);
      }
      __syncthreads();
      for (int i = tid; i < G * kChunk; i += kPagedThreads) {
        const int g = i / kChunk, t = i % kChunk, pos = base + t;
        float s = kNegInf;
        if (t < n && pos < len && pos >= first) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[t][d];
          s = dot * sm_scale;
        }
        p_s[i] = s;
      }
      __syncthreads();
      for (int g = warp; g < G; g += kWarps) {
        const int pos = base + lane;
        const bool valid = lane < n && pos < len && pos >= first;
        const float s = p_s[g * kChunk + lane];
        const float m_prev = m_s[g];
        const float m_cur = fmaxf(m_prev, warp_max(s));
        const float p = valid ? expf(s - m_cur) : 0.f;
        const float psum = warp_sum(p);
        p_s[g * kChunk + lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_cur);
          a_s[g] = alpha;
          l_s[g] = l_s[g] * alpha + psum;
          m_s[g] = m_cur;
        }
      }
      __syncthreads();
      for (int i = tid; i < G * D; i += kPagedThreads) {
        const int g = i / D, d = i % D;
        float a = acc[i] * a_s[g];
        for (int t = 0; t < n; ++t) a += p_s[g * kChunk + t] * v_s[t][d];
        acc[i] = a;
      }
      __syncthreads();
    }
  }
  // len == 0: l stays 0 and acc 0, so the row is exactly zero
  for (int i = tid; i < G * D; i += kPagedThreads)
    out[q_base + i] = from_f32<QT>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename QT, typename KT, int D>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const void* pt, const void* lens, void* out, int B,
                         int H, int KV, int ps, int PMAX, float sm_scale,
                         int window, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = (2 * G * D + G * kChunk + 3 * G) * sizeof(float);
  auto kernel = paged_attention_kernel<QT, KT, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(B, KV), kPagedThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const int*>(pt),
      static_cast<const int*>(lens), static_cast<QT*>(out), H, KV, ps, PMAX,
      sm_scale, window);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* pt, const void* lens, void* out, int B,
                       int H, int KV, int ps, int PMAX, float sm_scale,
                       int window, cudaStream_t s) {
  if (D == 64)
    return launch_paged<QT, KT, 64>(q, k, v, pt, lens, out, B, H, KV, ps,
                                    PMAX, sm_scale, window, s);
  if (D == 128)
    return launch_paged<QT, KT, 128>(q, k, v, pt, lens, out, B, H, KV, ps,
                                     PMAX, sm_scale, window, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro

using namespace repro;

// window < 0: no sliding window.  dtype codes: see common.cuh.
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* page_table,
                                   const void* lengths, void* out, int B,
                                   int H, int KV, int D, int ps, int PMAX,
                                   float sm_scale, int window, int q_dtype,
                                   int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS D, q, k_pages, v_pages, page_table, lengths, out, B, H, KV, ps, \
             PMAX, sm_scale, window, s
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
