// Blocked (flash) attention on CUDA cores in fp32, for fp32 queries
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel) together with the padding wrapper
// ops.flash_attention, for fp32 q: the fp32-compute model checks and
// the fp32 parity runs, which hold the port to ~1e-5.  Every served
// call has bf16 q and goes to the tensor-core kernel in
// flash_attention_tc.cu.  Causal / sliding-window / kv_len-masked GQA
// attention with an fp32 online softmax.  Ragged Sq and Skv are masked
// in the kernel, so nothing is padded and non-causal attention needs no
// special case.
//
// Layout: the model's own, q (B,Sq,H,D), k/v (B,Skv,HKV,D), out like q,
// all contiguous, so the caller transposes nothing.  q is fp32, k and v
// fp32 or bf16 (one dtype); the math is fp32, and so is the output.
//
// Bound on the H100: at the prefill buckets (64..1024 tokens, D = 64)
// the causal work is ~2*Sq*Skv*D*H flops against
// ~(Sq+2*Skv)*H*D*bytes of traffic, i.e. compute-bound at the bf16
// tensor-core peak once Sq is a few hundred.  This kernel does its
// arithmetic on CUDA cores in fp32 (the tensor cores would round to
// bf16 or TF32), so it runs far from that bound; what the design does
// is keep the traffic at the floor: one block per (64-row q tile, head,
// batch) keeps its q rows and output accumulators in registers, streams
// 32-key K/V tiles through shared memory once per q tile, and stops at
// the causal limit of its last row (and starts at the sliding-window
// limit of its first row), so masked tiles are never loaded.
#include "common.cuh"

namespace repro {

constexpr int kBQ = 64;            // q rows per block
constexpr int kBK = 32;            // keys per shared-memory tile
constexpr int kFlashThreads = 128;  // two threads per q row

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kFlashThreads) flash_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, QT* __restrict__ out, float* __restrict__ lse,
    int Sq, int Skv, int H, int HKV, float sm_scale, int causal, int window,
    int q_offset, int kv_len) {
  constexpr int DH = D / 2;  // each thread owns half of the head dim
  constexpr int kRow = D + 2;  // halves offset by DH+1: no bank conflict
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / HKV);
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const int qpos = q_offset + qi;

  __shared__ float k_s[kBK * kRow];
  __shared__ float v_s[kBK * kRow];

  float qr[DH], acc[DH];
  const size_t q_off = (((size_t)b * Sq + qi) * H + h) * D + half * DH;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qr[i] = row_ok ? to_f32(q[q_off + i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // keys this tile of rows can see: [kv_begin, kv_end)
  int kv_end = min(kv_len, Skv);
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kBQ, Sq));
  int kv_begin = window >= 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = kv_begin / kBK * kBK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += kFlashThreads) {
      const int t = i / D, d = i % D, kj = k0 + t;
      float kx = 0.f, vx = 0.f;
      if (kj < Skv) {
        const size_t off = (((size_t)b * Skv + kj) * HKV + kh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      const int at = t * kRow + d + (d >= DH ? 1 : 0);
      k_s[at] = kx;
      v_s[at] = vx;
    }
    __syncthreads();

    const float* kh_s = k_s + half * (DH + 1);
    const float* vh_s = v_s + half * (DH + 1);
    float sc[kBK];
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < kBK; ++t) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) part += qr[i] * kh_s[t * kRow + i];
      // both threads of the pair add the same two halves: same value
      const float s = (part + __shfl_xor_sync(0xffffffffu, part, 1)) *
                      sm_scale;
      const int kj = k0 + t;
      const bool valid = row_ok && kj < kv_end && (!causal || kj <= qpos) &&
                         (window < 0 || kj > qpos - window);
      sc[t] = valid ? s : kNegInf;
      mx = fmaxf(mx, sc[t]);
    }
    const float m_cur = fmaxf(m, mx);
    const float alpha = expf(m - m_cur);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < kBK; ++t) {
      const int kj = k0 + t;
      const bool valid = row_ok && kj < kv_end && (!causal || kj <= qpos) &&
                         (window < 0 || kj > qpos - window);
      sc[t] = valid ? expf(sc[t] - m_cur) : 0.f;
      psum += sc[t];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      float a = acc[i] * alpha;
#pragma unroll
      for (int t = 0; t < kBK; ++t) a += sc[t] * vh_s[t * kRow + i];
      acc[i] = a;
    }
    m = m_cur;
    __syncthreads();
  }
  if (row_ok) {
    // a row with no visible key has l == 0 and acc == 0: exact zeros
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DH; ++i) out[q_off + i] = from_f32<QT>(acc[i] / denom);
    // the log-sum-exp the backward recomputes P from (-inf: no key)
    if (lse != nullptr && half == 0)
      lse[((size_t)b * H + h) * Sq + qi] = l > 0.f ? m + logf(l) : neg_inf();
  }
}

template <typename QT, typename KT, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Sq, int Skv, int H,
                         int HKV, float sm_scale, int causal, int window,
                         int q_offset, int kv_len, cudaStream_t s) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<QT, KT, D><<<grid, kFlashThreads, 0, s>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<QT*>(out), lse, Sq, Skv, H, HKV,
      sm_scale, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t flash_dispatch_d(int D, const void* q, const void* k,
                             const void* v, void* out, float* lse, int B,
                             int Sq, int Skv, int H, int HKV, float sm_scale,
                             int causal,
                             int window, int q_offset, int kv_len,
                             cudaStream_t s) {
  if (D == 64)
    return launch_flash<QT, KT, 64>(q, k, v, out, lse, B, Sq, Skv, H, HKV,
                                    sm_scale, causal, window, q_offset,
                                    kv_len, s);
  if (D == 112)  // zamba2's shared attention block: DH = 56
    return launch_flash<QT, KT, 112>(q, k, v, out, lse, B, Sq, Skv, H, HKV,
                                     sm_scale, causal, window, q_offset,
                                     kv_len, s);
  if (D == 128)
    return launch_flash<QT, KT, 128>(q, k, v, out, lse, B, Sq, Skv, H, HKV,
                                     sm_scale, causal, window, q_offset,
                                     kv_len, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro

using namespace repro;

// q and out fp32; k and v fp32 or bf16 (kv_dtype); lse (B,H,Sq) fp32
// or null (serving).  window < 0: no sliding window.  kv_len: keys at
// or past it are masked.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int HKV,
                                   int D,
                                   float sm_scale, int causal, int window,
                                   int q_offset, int kv_len, int kv_dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
#define ARGS D, q, k, v, out, lse_f, B, Sq, Skv, H, HKV, sm_scale, causal, \
             window, q_offset, kv_len, s
  cudaError_t e = cudaErrorInvalidValue;
  if (kv_dtype == kF32)
    e = flash_dispatch_d<float, float>(ARGS);
  else if (kv_dtype == kBF16)
    e = flash_dispatch_d<float, __nv_bfloat16>(ARGS);
#undef ARGS
  return (int)e;
}
