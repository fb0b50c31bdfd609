// Backward of the port's Mamba2 SSD chunked scan, on CUDA cores in fp32
// (sm_90a), for fp32 x, B, C (the fp32 gates); bf16 goes to the
// tensor-core kernel in ssd_scan_bwd_tc.cu.
//
// The JAX package has no backward Pallas kernel: XLA differentiates its
// jnp scan (src/repro/models/mamba2.py ssd_chunked).  This is the
// gradient of the forward in ssd_scan.cu (which replaces
// src/repro/kernels/ssd_scan.py ssd_scan), held against autograd of the
// plain version kernels/ref.ssd_chunked_ref.
// The scanned function does not depend on the chunk length, so this
// kernel walks chunks of Qb = min(Q, 64) positions of its own.  In a
// chunk, with a = dt * A, cum its running sum from the chunk's start,
// cl = cum of the chunk's last position, h the state entering the chunk
// and h' = exp(cl) h + sum_k w_k x_k B_k^T (w_k = dt_k exp(cl - cum_k))
// the state leaving it, y_q = sum_{k<=q} M[q,k] (C_q . B_k) x_k +
// exp(cum_q) h C_q + D x_q with M[q,k] = exp(cum_q - cum_k) dt_k.  Given
// dy and g' = dL/dh' (the gradient of the state after the chunk):
//
//   S[q,k] = C_q . B_k,  G[q,k] = dy_q . x_k   (k <= q, zero above)
//   dx_k  = w_k g' B_k + D dy_k + sum_q M[q,k] S[q,k] dy_q
//   dB_k  = w_k g'^T x_k + sum_q M[q,k] G[q,k] C_q
//   dC_q  = exp(cum_q) h^T dy_q + sum_k M[q,k] G[q,k] B_k
//   g     = exp(cl) g' + sum_q exp(cum_q) dy_q C_q^T      (dL/dh)
//   dcum_j = sum_k dt_k T[j,k] - dt_j sum_q T[q,j]
//            + exp(cum_j) dy_j . (h C_j) - w_j x_j . (g' B_j)
//            + [j last] <g', h'>,      T[q,k] = exp(cum_q - cum_k) S G
//   da_j  = sum_{q>=j} dcum_q,  ddt_j = A da_j + sum_q T[q,j]
//            + exp(cl - cum_j) x_j . (g' B_j),  dA = sum_j dt_j da_j,
//   dD    = sum_q dy_q . x_q.
//
// Layout: the forward's, x, dy, dx (B,S,H,P) and B, C, dB, dC (B,S,G,N)
// fp32, dt, ddt (B,S,H), A, D, dA, dD (H,),
// h0, dh_T (the final state's gradient) and dh0 (B,H,P,N) fp32; head h
// reads group h / (H/G).  Three launches, all math in fp32 from the
// inputs' values, no atomics (the same inputs give the same bits):
//  1. states: grid (H, B, 2).  z = 0 walks the chunks forward and
//     writes the state entering each chunk and the final one, (B, H,
//     nc+1, P, N); z = 1 walks them backward from dh_T (or zeros) and
//     writes g for each chunk boundary, index 0 being dh0;
//  2. chunks: grid (nc, H, B), one block per (chunk, head, batch), every
//     term above from the chunk's x, dy, B, C, dt and the two boundary
//     states, all in shared memory (216 KB at P = 64, N = 128).  dx and
//     ddt are written once; dB and dC go to per-head fp32 partial sums
//     (B, S, H, N), dA and dD to per-chunk partials (B, nc, H);
//  3. reduce: dB and dC summed over the heads of each group in head
//     order, dA and dD over (batch, chunk) in order.
//
// Bound on the H100: at the training shapes (mamba2: B=8, S=512, H=48,
// P=64, N=128) one read of x, dy, B, C, dt and one write of the
// gradients move ~81 MB, 24 us at 3.35 TB/s, against ~26 GFLOP of the
// products above at chunk 64.  This is the simple first kernel: CUDA
// cores in fp32 from shared memory, each of 256 threads owning a
// register tile of every product (rows ty + 16i, columns tx + 16j), so a
// shared-memory load feeds several FMAs; it runs far from that bound.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kQ = 64;              // positions per backward chunk (most)
constexpr int kMaxN = 128;          // N
constexpr int kNP = kMaxN + 1;      // padded row of a (., N) tile
constexpr int kQP = kQ + 1;         // padded row of a (Q, Q) tile

// acc[i][j] += sum_{r < R} a[(ty + 16 i) * ai + r * ar]
//                          * b[(tx + 16 j) * bj + r * br]
template <int RM, int RN>
__device__ __forceinline__ void gemm(float (&acc)[RM][RN], const float* a,
                                     int ai, int ar, const float* b, int bj,
                                     int br, int R) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    float av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = a[(ty + 16 * i) * ai + r * ar];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = b[(tx + 16 * j) * bj + r * br];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] += av[i] * bv[j];
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

// sum over the 16 threads of a half warp: the columns tx of one row
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// warp 0: dt of the chunk's Qc positions and cum, the running sum of
// dt * A (each lane two consecutive positions, then a warp scan of the
// lane totals); past Qc dt is 0 and cum stays at the chunk's last value
__device__ __forceinline__ void chunk_decay(const float* __restrict__ dt,
                                            size_t at, int H, int Qc,
                                            float a_h, float* dts,
                                            float* cum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float d[2], part[2], run = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = 2 * lane + j;
    d[j] = k < Qc ? dt[at + (size_t)k * H] : 0.f;
    run += d[j] * a_h;
    part[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    dts[2 * lane + j] = d[j];
    cum[2 * lane + j] = before + part[j];
  }
}

template <int P>
constexpr int state_smem_floats() {
  return P * kNP + kQ * (P + 1) + kQ * kNP + 2 * kQ;
}

// launch 1: z = 0 the states entering each chunk (and the final one),
// z = 1 the gradients g of the states at each chunk boundary
template <typename T, int P>
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ h0,
    const T* __restrict__ dy, const float* __restrict__ dhT,
    float* __restrict__ states, float* __restrict__ dstates, int S, int H,
    int G, int N, int Qb, int nc) {
  constexpr int PP = P + 1, RP = P / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  extern __shared__ float sm[];
  float* st = sm;                // [P][kNP] the running state (or g)
  float* us = st + P * kNP;      // [kQ][PP] w_k x_k (or exp(cum_q) dy_q)
  float* vs = us + kQ * PP;      // [kQ][kNP] B (or C)
  float* dts = vs + kQ * kNP;    // [kQ]
  float* cum = dts + kQ;         // [kQ]

  const T* src_u = rev ? dy : x;
  const T* src_v = rev ? Cm : Bm;
  const float* init = rev ? dhT : h0;
  const size_t PN = (size_t)P * N;
  const size_t bh = (size_t)b * H + h;
  float* out = (rev ? dstates : states) + bh * (nc + 1) * PN;
  const float a_h = A[h];
  for (int i = tid; i < P * N; i += kThreads)
    st[(i / N) * kNP + i % N] = init ? init[bh * PN + i] : 0.f;

  for (int step = 0; step < nc; ++step) {
    const int c = rev ? nc - 1 - step : step;
    const int t0 = c * Qb, Qc = min(Qb, S - t0);
    __syncthreads();  // st final for this boundary; us, vs free
    float* o = out + (size_t)(rev ? c + 1 : c) * PN;
    for (int i = tid; i < P * N; i += kThreads)
      o[i] = st[(i / N) * kNP + i % N];
    chunk_decay(dt, ((size_t)b * S + t0) * H + h, H, Qc, a_h, dts, cum);
    __syncthreads();
    const float cl = cum[Qc - 1];
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int k = i / P, p = i % P;
      float v = 0.f;
      if (k < Qc) {
        const float s = rev ? expf(cum[k]) : dts[k] * expf(cl - cum[k]);
        v = s * to_f32(src_u[(((size_t)b * S + t0 + k) * H + h) * P + p]);
      }
      us[k * PP + p] = v;
    }
    for (int i = tid; i < kQ * kMaxN; i += kThreads) {
      const int k = i / kMaxN, n = i % kMaxN;
      vs[k * kNP + n] =
          k < Qc && n < N
              ? to_f32(src_v[(((size_t)b * S + t0 + k) * G + g) * N + n])
              : 0.f;
    }
    __syncthreads();
    // st <- exp(cl) st + sum_k us_k^T vs_k; each thread reads and writes
    // only its own elements of st
    const float e = expf(cl);
    float acc[RP][8];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = e * st[(ty + 16 * i) * kNP + tx + 16 * j];
    gemm<RP, 8>(acc, us, 1, PP, vs, 1, kNP, Qc);
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tx + 16 * j < N) st[(ty + 16 * i) * kNP + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  float* o = out + (size_t)(rev ? 0 : nc) * PN;
  for (int i = tid; i < P * N; i += kThreads) o[i] = st[(i / N) * kNP + i % N];
}

template <int P>
constexpr int chunk_smem_floats() {
  return 2 * kQ * (P + 1) + 2 * kQ * kNP + 2 * P * kNP + 3 * kQ * kQP +
         8 * kQ + kThreads / 32;
}

// launch 2: every gradient term of one (chunk, head, batch)
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    const T* __restrict__ dy, const float* __restrict__ states,
    const float* __restrict__ dstates, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pB, float* __restrict__ pC,
    float* __restrict__ pA, float* __restrict__ pD, int S, int H, int G,
    int N, int Qb, int nc) {
  constexpr int PP = P + 1, RP = P / 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = c * Qb, Qc = min(Qb, S - t0);
  extern __shared__ float sm[];
  float* xs = sm;                // [kQ][PP] x
  float* ys = xs + kQ * PP;      // [kQ][PP] dy
  float* bs = ys + kQ * PP;      // [kQ][kNP] B
  float* cs = bs + kQ * kNP;     // [kQ][kNP] C
  float* hs = cs + kQ * kNP;     // [P][kNP] the state entering the chunk
  float* gs = hs + P * kNP;      // [P][kNP] g', the state after it
  float* ms = gs + P * kNP;      // [kQ][kQP] M o S
  float* mg = ms + kQ * kQP;     // [kQ][kQP] M o G
  float* lt = mg + kQ * kQP;     // [kQ][kQP] exp(cum_q - cum_k) S G
  float* dts = lt + kQ * kQP;    // [kQ] dt
  float* cum = dts + kQ;         // [kQ] running sum of dt * A
  float* vrow = cum + kQ;        // [kQ] sum_k dt_k T[j, k]
  float* vcol = vrow + kQ;       // [kQ] sum_q T[q, j] / dt_j
  float* vxv = vcol + kQ;        // [kQ] x_j . (g' B_j)
  float* vcar = vxv + kQ;        // [kQ] exp(cum_j) dy_j . (h C_j)
  float* vdd = vcar + kQ;        // [kQ] dy_j . x_j
  float* vda = vdd + kQ;         // [kQ] da_j
  float* red = vda + kQ;         // [kThreads / 32]

  const size_t pos0 = (size_t)b * S + t0;
  const size_t PN = (size_t)P * N;
  const size_t bh = (size_t)b * H + h;
  chunk_decay(dt, pos0 * H + h, H, Qc, A[h], dts, cum);
  for (int i = tid; i < kQ * P; i += kThreads) {
    const int k = i / P, p = i % P;
    const bool ok = k < Qc;
    const size_t at = ((pos0 + k) * H + h) * P + p;
    xs[k * PP + p] = ok ? to_f32(x[at]) : 0.f;
    ys[k * PP + p] = ok ? to_f32(dy[at]) : 0.f;
  }
  for (int i = tid; i < kQ * kMaxN; i += kThreads) {
    const int k = i / kMaxN, n = i % kMaxN;
    const bool ok = k < Qc && n < N;
    const size_t at = ((pos0 + k) * G + g) * N + n;
    bs[k * kNP + n] = ok ? to_f32(Bm[at]) : 0.f;
    cs[k * kNP + n] = ok ? to_f32(Cm[at]) : 0.f;
  }
  const float* hsrc = states + (bh * (nc + 1) + c) * PN;
  const float* gsrc = dstates + (bh * (nc + 1) + c + 1) * PN;
  for (int i = tid; i < P * kMaxN; i += kThreads) {
    const int p = i / kMaxN, n = i % kMaxN;
    hs[p * kNP + n] = n < N ? hsrc[p * N + n] : 0.f;
    gs[p * kNP + n] = n < N ? gsrc[p * N + n] : 0.f;
  }
  __syncthreads();
  const float cl = cum[Qc - 1];

  // S and G over the (q, k) tile, rows q = ty + 16i, keys k = tx + 16j;
  // masked (k <= q < Qc) into M o S, M o G and exp(cum_q - cum_k) S G
  {
    float s[4][4], gg[4][4];
    zero(s);
    zero(gg);
    gemm<4, 4>(s, cs, kNP, 1, bs, kNP, 1, N);
    gemm<4, 4>(gg, ys, PP, 1, xs, PP, 1, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tx + 16 * j;
        float m_s = 0.f, m_g = 0.f, l_sg = 0.f;
        if (q < Qc && k <= q) {
          const float L = expf(cum[q] - cum[k]);
          const float md = L * dts[k];
          m_s = md * s[i][j];
          m_g = md * gg[i][j];
          l_sg = L * s[i][j] * gg[i][j];
        }
        ms[q * kQP + k] = m_s;
        mg[q * kQP + k] = m_g;
        lt[q * kQP + k] = l_sg;
      }
    }
  }
  __syncthreads();
  if (tid < kQ) {  // per position: T's row and column sums, dy . x
    const int j = tid;
    float row = 0.f, col = 0.f, dd = 0.f;
    for (int k = 0; k < kQ; ++k) row += dts[k] * lt[j * kQP + k];
    for (int q = 0; q < kQ; ++q) col += lt[q * kQP + j];
    for (int p = 0; p < P; ++p) dd += ys[j * PP + p] * xs[j * PP + p];
    vrow[j] = row;
    vcol[j] = col;
    vdd[j] = dd;
  }

  // dx: v = g' B_k first (for x . v), then w_k v + D dy_k + (M o S)^T dy
  {
    float acc[4][RP];
    zero(acc);
    gemm<4, RP>(acc, bs, kNP, 1, gs, kNP, 1, N);
    const float d_h = Dv[h];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ty + 16 * i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j)
        part += xs[k * PP + tx + 16 * j] * acc[i][j];
      part = half_warp_sum(part);
      if (tx == 0) vxv[k] = part;
      const float w = dts[k] * expf(cl - cum[k]);
#pragma unroll
      for (int j = 0; j < RP; ++j)
        acc[i][j] = w * acc[i][j] + d_h * ys[k * PP + tx + 16 * j];
    }
    gemm<4, RP>(acc, ms, 1, kQP, ys, 1, PP, Qc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ty + 16 * i;
      if (k >= Qc) continue;
#pragma unroll
      for (int j = 0; j < RP; ++j)
        dx[((pos0 + k) * H + h) * P + tx + 16 * j] = from_f32<T>(acc[i][j]);
    }
  }

  // dB (this head's part): w_k g'^T x_k + (M o G)^T C
  {
    float acc[4][8];
    zero(acc);
    gemm<4, 8>(acc, xs, PP, 1, gs, 1, kNP, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ty + 16 * i;
      const float w = dts[k] * expf(cl - cum[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= w;
    }
    gemm<4, 8>(acc, mg, 1, kQP, cs, 1, kNP, Qc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = ty + 16 * i;
      if (k >= Qc) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) pB[((pos0 + k) * H + h) * N + n] = acc[i][j];
      }
    }
  }

  // dC (this head's part): exp(cum_q) h^T dy_q + (M o G) B
  {
    float acc[4][8];
    zero(acc);
    gemm<4, 8>(acc, ys, PP, 1, hs, 1, kNP, P);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e = expf(cum[ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= e;
    }
    gemm<4, 8>(acc, mg, kQP, 1, bs, 1, kNP, Qc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
      if (q >= Qc) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) pC[((pos0 + q) * H + h) * N + n] = acc[i][j];
      }
    }
  }

  // the carried-state term of dcum: exp(cum_q) dy_q . (h C_q)
  {
    float acc[4][RP];
    zero(acc);
    gemm<4, RP>(acc, cs, kNP, 1, hs, kNP, 1, N);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < RP; ++j)
        part += ys[q * PP + tx + 16 * j] * acc[i][j];
      part = half_warp_sum(part);
      if (tx == 0) vcar[q] = expf(cum[q]) * part;
    }
  }

  // <g', h'>: the chunk's last cum scales the whole state after it
  {
    const float* hnext = states + (bh * (nc + 1) + c + 1) * PN;
    float part = 0.f;
    for (int i = tid; i < P * N; i += kThreads)
      part += gs[(i / N) * kNP + i % N] * hnext[i];
    part = warp_sum(part);
    if ((tid & 31) == 0) red[tid >> 5] = part;
  }
  __syncthreads();
  if (tid == 0) {  // dcum, its reverse running sum da, dA and dD, in order
    float gh = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) gh += red[w];
    float run = 0.f, da_sum = 0.f, dd_sum = 0.f;
    for (int j = Qc - 1; j >= 0; --j) {
      const float w = dts[j] * expf(cl - cum[j]);
      float dcum = vrow[j] - dts[j] * vcol[j] + vcar[j] - w * vxv[j];
      if (j == Qc - 1) dcum += gh;
      run += dcum;
      vda[j] = run;
      da_sum += dts[j] * run;
    }
    for (int j = 0; j < Qc; ++j) dd_sum += vdd[j];
    pA[((size_t)b * nc + c) * H + h] = da_sum;
    pD[((size_t)b * nc + c) * H + h] = dd_sum;
  }
  __syncthreads();
  if (tid < Qc) {
    const int j = tid;
    ddt[(pos0 + j) * H + h] =
        A[h] * vda[j] + vcol[j] + expf(cl - cum[j]) * vxv[j];
  }
}

// launch 3: dB, dC over each group's heads; dA, dD over (batch, chunk)
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ pB,
                                      const float* __restrict__ pC,
                                      const float* __restrict__ pA,
                                      const float* __restrict__ pD,
                                      T* __restrict__ dB, T* __restrict__ dC,
                                      float* __restrict__ dA,
                                      float* __restrict__ dD, int B, int S,
                                      int H, int G, int N, int nc) {
  const int HG = H / G;
  const size_t total = (size_t)B * S * G * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % N);
    const size_t sg = i / N;  // (b * S + s) * G + g
    const int g = (int)(sg % G);
    const size_t at = ((sg / G) * H + (size_t)g * HG) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < HG; ++j) {
      sb += pB[at + (size_t)j * N];
      sc += pC[at + (size_t)j * N];
    }
    dB[i] = from_f32<T>(sb);
    dC[i] = from_f32<T>(sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float sa = 0.f, sd = 0.f;
      for (int r = 0; r < B * nc; ++r) {
        sa += pA[(size_t)r * H + h];
        sd += pD[(size_t)r * H + h];
      }
      dA[h] = sa;
      dD[h] = sd;
    }
  }
}

template <typename T, int P>
cudaError_t launch_bwd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* D,
                       const void* h0, const void* dy, const void* dhT,
                       void* dx, void* ddt, void* dA, void* dD, void* dB,
                       void* dC, void* states, void* dstates, void* pB,
                       void* pC, void* pAD, int B, int S, int H, int G,
                       int N, int Qb, cudaStream_t s) {
  // once per instantiation, before any launch: no call under CUDA-graph
  // capture sets it
  static bool opted_in = false;
  const int state_bytes = state_smem_floats<P>() * (int)sizeof(float);
  const int chunk_bytes = chunk_smem_floats<P>() * (int)sizeof(float);
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_state_kernel<T, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               chunk_bytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int nc = (S + Qb - 1) / Qb;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* dst = static_cast<float*>(dstates);
  float* pa = static_cast<float*>(pAD);
  float* pd = pa + (size_t)B * nc * H;
  ssd_bwd_state_kernel<T, P><<<dim3(H, B, 2), kThreads, state_bytes, s>>>(
      xt, dtf, af, bt, ct, static_cast<const float*>(h0), dyt,
      static_cast<const float*>(dhT), st, dst, S, H, G, N, Qb, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_chunk_kernel<T, P><<<dim3(nc, H, B), kThreads, chunk_bytes, s>>>(
      xt, dtf, af, bt, ct, static_cast<const float*>(D), dyt, st, dst,
      static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(pB), static_cast<float*>(pC), pa, pd, S, H, G, N,
      Qb, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)B * S * G * N;
  const size_t want = (total + 255) / 256;
  const int blocks = want < 132 * 8 ? (int)want : 132 * 8;
  ssd_bwd_reduce_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(pB), static_cast<const float*>(pC), pa, pd,
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), B, S, H, G, N, nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch_p(int P, const void* x, const void* dt,
                           const void* A, const void* Bm, const void* Cm,
                           const void* D, const void* h0, const void* dy,
                           const void* dhT, void* dx, void* ddt, void* dA,
                           void* dD, void* dB, void* dC, void* states,
                           void* dstates, void* pB, void* pC, void* pAD,
                           int B, int S, int H, int G, int N, int Qb,
                           cudaStream_t s) {
#define BWD_ARGS x, dt, A, Bm, Cm, D, h0, dy, dhT, dx, ddt, dA, dD, dB, dC, \
                 states, dstates, pB, pC, pAD, B, S, H, G, N, Qb, s
  if (P == 32) return launch_bwd<T, 32>(BWD_ARGS);
  if (P == 64) return launch_bwd<T, 64>(BWD_ARGS);
#undef BWD_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// x, B, C, dy, dx, dB, dC in `dtype` (fp32 only: bf16 takes
// ssd_scan_tc_bwd); dt, A, D, h0 and dhT (either may be null: zeros),
// ddt, dA, dD fp32.  Workspaces, fp32:
// states and dstates (B, H, nc+1, P, N), dstates[:, :, 0] being dh0;
// pB, pC (B, S, H, N); pAD (2, B, nc, H); nc = ceil(S / Qb).  P in {32,
// 64}, 1 <= N <= 128, 1 <= Qb <= 64, H % G == 0, B, S, H >= 1.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            const void* h0, const void* dy, const void* dhT,
                            void* dx, void* ddt, void* dA, void* dD,
                            void* dB, void* dC, void* states, void* dstates,
                            void* pB, void* pC, void* pAD, int B, int S,
                            int H, int G, int P, int N, int Qb, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || N < 1 || N > kMaxN ||
      Qb < 1 || Qb > kQ)
    return (int)cudaErrorInvalidValue;
#define BWD_ARGS P, x, dt, A, Bm, Cm, D, h0, dy, dhT, dx, ddt, dA, dD, dB, \
                 dC, states, dstates, pB, pC, pAD, B, S, H, G, N, Qb, s
  if (dtype == kF32) return (int)bwd_dispatch_p<float>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
