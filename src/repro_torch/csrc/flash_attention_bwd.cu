// Backward of the port's flash attention for fp32 q, k, v, on CUDA cores
// (sm_90a).
//
// The JAX package has no backward Pallas kernel: XLA differentiates its
// jnp attention (src/repro/models/layers.py gqa_attention).  This is
// the gradient of the forward in flash_attention.cu (which replaces
// src/repro/kernels/flash_attention.py flash_attention for fp32 q),
// held against autograd of the plain version kernels/ref.attention_ref;
// it serves the fp32 training gate, as the forward keeps
// flash_attention.cu for fp32 q.  bf16 calls (every bf16 training step)
// go to the tensor-core kernel in flash_attention_bwd_tc.cu.  Same
// layout and masks as the forward: q, out, dout, dq (B,Sq,H,D); k, v,
// dk, dv (B,Skv,HKV,D), all contiguous fp32; causal, sliding window,
// q_offset and kv_len; GQA (H = G * HKV).  The forward's log-sum-exp lse
// (B,H,Sq) fp32 comes in; a row with no visible key has no visible
// pair, so its lse is never read.
//
// Three launches, all math in fp32:
//  1. delta = rowsum(dout * out) (B,H,Sq), one warp a row;
//  2. dK/dV: one block per (64-key tile, kv head, batch).  It loops over
//     the group's G query heads, in order, and over the 64-row q tiles
//     that can see its keys (the causal, window and kv_len limits as
//     the forward's), recomputes P = exp(S * scale - lse) and
//     dS = P * (dO V^T - delta), accumulates dV += P^T dO and
//     dK += dS^T Q in registers and writes each once (dK times scale).
//     Keys at or past kv_len, and keys no row sees, get exact zeros;
//  3. dQ: one block per (64-row q tile, head, batch), looping over the
//     key tiles the tile sees (the forward's range), dQ += dS K, written
//     once times scale.  A row with no visible key gets exact zeros.
// No atomics: GQA's sum over the group runs in a fixed order, so two
// runs give the same bits.
//
// Bound on the H100: the backward does 2.5x the forward's products (S
// and dO V^T recomputed, dV, dK, dQ), halved for causal, against one
// read of q, k, v, out, dout and one write of the three gradients; in
// fp32 outside the tensor cores (67 TFLOP/s) operations bound it at the
// training shapes.  The design keeps it simple: every operand tile sits
// in shared memory as fp32 (rows padded to D+1 floats, so the 16 key
// rows a warp reads fall in 16 banks), each of 256 threads owns a 4 x 4
// micro-tile of S and dO V^T (rows ty + 16i, keys tx + 16j) and a
// 4 x D/16 tile of its outputs, and masked tiles are never visited.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBR = 64;          // q rows per tile
constexpr int kBC = 64;          // keys per tile
constexpr int kBwdThreads = 256;  // 16 x 16
constexpr int kPRow = kBC + 1;   // padded row of a P / dS tile

__device__ __forceinline__ bool visible(int qi, int kj, int Sq,
                                        int kv_valid, int q_offset,
                                        int causal, int window) {
  const int p = q_offset + qi;
  return qi < Sq && kj < kv_valid && (!causal || kj <= p) &&
         (window < 0 || kj > p - window);
}

// rows [r0, r0 + 64) of head hh of a (B, S, heads, D) tensor -> fp32
// shared rows of D + 1 floats; rows at or past `valid` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int r0, int valid, int S,
                                          int heads, int hh) {
  for (int idx = threadIdx.x; idx < kBR * D; idx += kBwdThreads) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    dst[r * (D + 1) + d] =
        row < valid ? to_f32(src[(((size_t)b * S + row) * heads + hh) * D + d])
                    : 0.f;
  }
}

// s = A B^T and dp = C E^T over D for this thread's 4 x 4 micro-tile:
// rows ty + 16i of A, C; rows tx + 16j of B, E
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* C, const float* E,
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], c[4], b[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      c[i] = C[(ty + 16 * i) * (D + 1) + d];
      b[i] = B[(tx + 16 * i) * (D + 1) + d];
      e[i] = E[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * b[j];
        dp[i][j] += c[i] * e[j];
      }
  }
}

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ out,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, int Sq,
                                       int H, int D, size_t rows) {
  const size_t r = (size_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += to_f32(out[r * D + d]) * to_f32(dout[r * D + d]);
  s = warp_sum(s);
  if (lane == 0) {
    const size_t bi = r / H;  // b * Sq + i
    const int h = (int)(r % H), i = (int)(bi % Sq);
    delta[((bi / Sq) * H + h) * Sq + i] = s;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H,
    int HKV, float sm_scale, int causal, int window, int q_offset,
    int kv_len) {
  constexpr int kRow = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBC * kRow;
  float* Qs = Vs + kBC * kRow;
  float* dOs = Qs + kBR * kRow;
  float* Ps = dOs + kBR * kRow;
  float* dSs = Ps + kBR * kPRow;
  float* lse_s = dSs + kBR * kPRow;
  float* delta_s = lse_s + kBR;

  const int k0 = blockIdx.x * kBC, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / HKV;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kv_valid = min(kv_len, Skv);

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  // the q rows that can see a key of [k0, k0 + 64): [q_lo, q_hi)
  int q_lo = 0, q_hi = Sq;
  if (causal) q_lo = max(0, k0 - q_offset);
  if (window >= 0) q_hi = min(Sq, k0 + kBC - 1 + window - q_offset);
  if (k0 >= kv_valid) q_hi = 0;
  const int q_start = q_lo / kBR * kBR;

  if (q_start < q_hi) {
    load_tile<T, D>(Ks, k, b, k0, kv_valid, Skv, HKV, kh);
    load_tile<T, D>(Vs, v, b, k0, kv_valid, Skv, HKV, kh);
  }
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const float* lse_h = lse + ((size_t)b * H + h) * Sq;
    const float* delta_h = delta + ((size_t)b * H + h) * Sq;
    for (int q0 = q_start; q0 < q_hi; q0 += kBR) {
      __syncthreads();  // the last tile's Q, dO, P, dS are consumed
      load_tile<T, D>(Qs, q, b, q0, Sq, Sq, H, h);
      load_tile<T, D>(dOs, dout, b, q0, Sq, Sq, H, h);
      if (threadIdx.x < kBR) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < Sq ? lse_h[qi] : 0.f;
        delta_s[threadIdx.x] = qi < Sq ? delta_h[qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p =
              visible(q0 + r, k0 + c, Sq, kv_valid, q_offset, causal, window)
                  ? expf(s[i][j] * sm_scale - lse_s[r])
                  : 0.f;
          Ps[r * kPRow + c] = p;
          dSs[r * kPRow + c] = p * (dp[i][j] - delta_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's live rows
      const int nq = min(kBR, Sq - q0);
      for (int r = 0; r < nq; ++r) {
        float p[4], ds[4], o[DJ], qq[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Ps[r * kPRow + ty + 16 * i];
          ds[i] = dSs[r * kPRow + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = dOs[r * kRow + tx + 16 * j];
          qq[j] = Qs[r * kRow + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dva[i][j] += p[i] * o[j];
            dka[i][j] += ds[i] * qq[j];
          }
      }
    }
  }

  // rows ty + 16i of the tile, columns tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Skv) continue;
    const size_t off = (((size_t)b * Skv + kj) * HKV + kh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(dka[i][j] * sm_scale);
      dv[off + tx + 16 * j] = from_f32<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Skv, int H, int HKV, float sm_scale,
    int causal, int window, int q_offset, int kv_len) {
  constexpr int kRow = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBR * kRow;
  float* Ks = dOs + kBR * kRow;
  float* Vs = Ks + kBC * kRow;
  float* dSs = Vs + kBC * kRow;
  float* lse_s = dSs + kBR * kPRow;
  float* delta_s = lse_s + kBR;

  const int q0 = blockIdx.x * kBR, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / HKV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kv_valid = min(kv_len, Skv);

  // keys this tile of rows can see: [kv_begin, kv_end), as the forward
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + min(q0 + kBR, Sq));
  int kv_begin = window >= 0 ? max(0, q_offset + q0 - window + 1) : 0;
  kv_begin = kv_begin / kBC * kBC;

  load_tile<T, D>(Qs, q, b, q0, Sq, Sq, H, h);
  load_tile<T, D>(dOs, dout, b, q0, Sq, Sq, H, h);
  if (threadIdx.x < kBR) {
    const int qi = q0 + threadIdx.x;
    const size_t at = ((size_t)b * H + h) * Sq + qi;
    lse_s[threadIdx.x] = qi < Sq ? lse[at] : 0.f;
    delta_s[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
  }

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBC) {
    __syncthreads();  // the last tile's K and dS are consumed
    load_tile<T, D>(Ks, k, b, k0, kv_valid, Skv, HKV, kh);
    load_tile<T, D>(Vs, v, b, k0, kv_valid, Skv, HKV, kh);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p =
            visible(q0 + r, k0 + c, Sq, kv_valid, q_offset, causal, window)
                ? expf(s[i][j] * sm_scale - lse_s[r])
                : 0.f;
        dSs[r * kPRow + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < kBC; ++c) {
      float ds[4], kk[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * kPRow + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = Ks[c * kRow + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] += ds[i] * kk[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const size_t off = (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[off + tx + 16 * j] = from_f32<T>(dqa[i][j] * sm_scale);
  }
}

template <int D>
constexpr int dkdv_smem() {
  return (int)sizeof(float) *
         (2 * kBC * (D + 1) + 2 * kBR * (D + 1) + 2 * kBR * kPRow + 2 * kBR);
}
template <int D>
constexpr int dq_smem() {
  return (int)sizeof(float) *
         (2 * kBR * (D + 1) + 2 * kBC * (D + 1) + kBR * kPRow + 2 * kBR);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
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
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_smem<D>());
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const size_t rows = (size_t)B * Sq * H;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(out), dot, dl, Sq, H, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 g_kv((Skv + kBC - 1) / kBC, HKV, B);
  flash_bwd_dkdv_kernel<T, D><<<g_kv, kBwdThreads, dkdv_smem<D>(), s>>>(
      qt, kt, vt, dot, lt, dl, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Skv, H, HKV, sm_scale, causal, window, q_offset, kv_len);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 g_q((Sq + kBR - 1) / kBR, H, B);
  flash_bwd_dq_kernel<T, D><<<g_q, kBwdThreads, dq_smem<D>(), s>>>(
      qt, kt, vt, dot, lt, dl, static_cast<T*>(dq), Sq, Skv, H, HKV,
      sm_scale, causal, window, q_offset, kv_len);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch_d(int D, const void* q, const void* k, const void* v,
                           const void* out, const void* dout, const void* lse,
                           void* delta, void* dq, void* dk, void* dv, int B,
                           int Sq, int Skv, int H, int HKV, float sm_scale,
                           int causal, int window, int q_offset, int kv_len,
                           cudaStream_t s) {
#define BWD_ARGS q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, \
                 HKV, sm_scale, causal, window, q_offset, kv_len, s
  if (D == 64) return launch_bwd<T, 64>(BWD_ARGS);
  if (D == 112) return launch_bwd<T, 112>(BWD_ARGS);
  if (D == 128) return launch_bwd<T, 128>(BWD_ARGS);
#undef BWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// q, k, v, out, dout, dq, dk, dv fp32 (dtype must say so); lse and the
// delta workspace (B,H,Sq) fp32.  window < 0: no sliding window.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Skv, int H, int HKV,
                                   int D, float sm_scale, int causal,
                                   int window, int q_offset, int kv_len,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  return (int)bwd_dispatch_d<float>(D, q, k, v, out, dout, lse, delta, dq,
                                    dk, dv, B, Sq, Skv, H, HKV, sm_scale,
                                    causal, window, q_offset, kv_len, s);
}
