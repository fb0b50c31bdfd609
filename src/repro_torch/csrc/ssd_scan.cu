// Mamba2 SSD chunked scan on Hopper's CUDA cores, for fp32 inputs
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _kernel) for fp32 x, B and C: the fp32-compute model checks and parity
// runs.  Every served call (bf16 x, B and C) runs the tensor-core kernel
// in ssd_scan_tc.cu instead.  Per (batch, head) it walks the sequence in
// chunks of Q tokens; per chunk, with a = dt * A and cum its running sum
// in the chunk:
//
//   y_q = sum_{k<=q} exp(cum_q - cum_k) (C_q . B_k) dt_k x_k   (intra-chunk)
//       + exp(cum_q) C_q . h                                   (carried state)
//       + D x_q                                                (skip)
//   h  <- exp(cum_last) h + sum_k exp(cum_last - cum_k) dt_k x_k B_k^T
//
// and returns y and the final fp32 state h (P, N).  The causal mask is
// applied before the exponent is taken (above the diagonal
// cum_q - cum_k > 0 could overflow).  A ragged tail chunk simply has
// fewer tokens, which is exactly the reference's zero padding: a padded
// token has dt = 0 and changes neither cum nor the state.
//
// Layout: the model's own, x (B,S,H,P), dt (B,S,H), A and D (H,), B/C
// (B,S,G,N), optional h0 and the output state (B,H,P,N), all fp32; head
// h reads group h / (H/G).  Nothing is transposed on the host.
//
// Bound on the H100: bytes, as for the tensor-core kernel; this one does
// its arithmetic in fp32 on CUDA cores from shared memory and runs far
// from it.  One block per (batch, head) walks the chunks in order and
// keeps the fp32 state in shared memory for the whole sequence; each
// input element is read from device memory once.  The Q x Q score tile
// does not fit beside the chunk's x, B and the state (at Q = N = 128:
// 32 + 64 + 32 KB), so scores are built 32 query rows at a time, each
// row tile with its own slice of C.
#include "common.cuh"

namespace repro {

constexpr int kSsdThreads = 256;
constexpr int kSsdWarps = kSsdThreads / 32;
constexpr int kMaxChunk = 128;  // Q: keys per lane = kMaxChunk / 32
constexpr int kMaxState = 128;  // N
constexpr int kTQ = 32;         // query rows per score tile (4 per warp)
constexpr int kKJ = kMaxChunk / 32;
constexpr int kRJ = kTQ / kSsdWarps;
constexpr int kNI = kMaxState / kSsdWarps;

// Shared memory, in floats:
//   st  [N][P+1]   carried state, transposed, rows padded (lanes walk p)
//   xs  [Q][P]     the chunk's x
//   bs  [Q][N+1]   the chunk's B, rows padded (lanes walk k)
//   cs  [kTQ][N]   one query tile's C
//   ss  [kTQ][Q]   one query tile's masked, decayed, dt-weighted scores
//   cum, dts, wk [Q]
__host__ __device__ inline size_t ssd_smem_floats(int P, int N, int Q) {
  return (size_t)N * (P + 1) + (size_t)Q * P + (size_t)Q * (N + 1) +
         (size_t)kTQ * N + (size_t)kTQ * Q + 3 * (size_t)Q;
}

template <typename T, int P>
__global__ void __launch_bounds__(kSsdThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, T* __restrict__ y,
    float* __restrict__ hout, int S, int H, int G, int N, int Q) {
  constexpr int PJ = P / 32;  // state / output columns per lane
  constexpr int SP = P + 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NB = N + 1;

  extern __shared__ float smem[];
  float* st = smem;
  float* xs = st + (size_t)N * SP;
  float* bs = xs + (size_t)Q * P;
  float* cs = bs + (size_t)Q * NB;
  float* ss = cs + (size_t)kTQ * N;
  float* cum = ss + (size_t)kTQ * Q;
  float* dts = cum + Q;
  float* wk = dts + Q;

  const float a_h = A[h], d_h = D[h];
  const size_t sbase = ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kSsdThreads)
    st[(i % N) * SP + i / N] = h0 ? h0[sbase + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int Qc = min(Q, S - t0);
    __syncthreads();  // the previous chunk's readers are done

    // warp 0: dt and its running decay (each lane owns kKJ consecutive
    // positions, then a warp scan of the lane totals)
    if (warp == 0) {
      float d[kKJ], part[kKJ], run = 0.f;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const int k = lane * kKJ + j;
        d[j] = k < Qc ? dt[((size_t)b * S + t0 + k) * H + h] : 0.f;
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
      for (int j = 0; j < kKJ; ++j) {
        const int k = lane * kKJ + j;
        if (k < Qc) {
          cum[k] = before + part[j];
          dts[k] = d[j];
        }
      }
    }
    for (int i = tid; i < Qc * P; i += kSsdThreads)
      xs[i] = to_f32(x[(((size_t)b * S + t0 + i / P) * H + h) * P + i % P]);
    for (int i = tid; i < Qc * N; i += kSsdThreads)
      bs[(i / N) * NB + i % N] =
          to_f32(Bm[(((size_t)b * S + t0 + i / N) * G + g) * N + i % N]);
    __syncthreads();
    const float cum_last = cum[Qc - 1];
    for (int k = tid; k < Qc; k += kSsdThreads)
      wk[k] = dts[k] * expf(cum_last - cum[k]);

    for (int q0 = 0; q0 < Qc; q0 += kTQ) {
      const int rows = min(kTQ, Qc - q0);
      for (int i = tid; i < rows * N; i += kSsdThreads)
        cs[i] = to_f32(
            Cm[(((size_t)b * S + t0 + q0 + i / N) * G + g) * N + i % N]);
      __syncthreads();

      // scores: warp owns rows warp + 8i, lane owns keys lane + 32j.
      // Rows past `rows` and keys past Qc read stale shared memory; the
      // mask selects them away (never multiplies them).
      {
        float acc[kRJ][kKJ];
#pragma unroll
        for (int i = 0; i < kRJ; ++i)
#pragma unroll
          for (int j = 0; j < kKJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float c[kRJ], bk[kKJ];
#pragma unroll
          for (int i = 0; i < kRJ; ++i) c[i] = cs[(warp + kSsdWarps * i) * N + n];
#pragma unroll
          for (int j = 0; j < kKJ; ++j) {
            const int k = lane + 32 * j;
            bk[j] = k < Q ? bs[k * NB + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kRJ; ++i)
#pragma unroll
            for (int j = 0; j < kKJ; ++j) acc[i][j] += c[i] * bk[j];
        }
#pragma unroll
        for (int i = 0; i < kRJ; ++i) {
          const int r = warp + kSsdWarps * i, q = q0 + r;
#pragma unroll
          for (int j = 0; j < kKJ; ++j) {
            const int k = lane + 32 * j;
            if (k < Q)
              ss[r * Q + k] = (q < Qc && k <= q)
                                  ? acc[i][j] * expf(cum[q] - cum[k]) * dts[k]
                                  : 0.f;
          }
        }
      }
      __syncthreads();

      // outputs: warp owns rows warp + 8i, lane owns columns lane + 32j
      {
        float acc[kRJ][PJ], off[kRJ][PJ];
#pragma unroll
        for (int i = 0; i < kRJ; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = off[i][j] = 0.f;
        const int kend = min(Qc, q0 + kTQ);  // ss is zero past each row's q
#pragma unroll 4
        for (int k = 0; k < kend; ++k) {
          float xv[PJ];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = xs[k * P + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < kRJ; ++i) {
            const float s = ss[(warp + kSsdWarps * i) * Q + k];
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] += s * xv[j];
          }
        }
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float sv[PJ];
#pragma unroll
          for (int j = 0; j < PJ; ++j) sv[j] = st[n * SP + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < kRJ; ++i) {
            const float c = cs[(warp + kSsdWarps * i) * N + n];
#pragma unroll
            for (int j = 0; j < PJ; ++j) off[i][j] += c * sv[j];
          }
        }
#pragma unroll
        for (int i = 0; i < kRJ; ++i) {
          const int r = warp + kSsdWarps * i;
          if (r < rows) {
            const int q = q0 + r;
            const float e = expf(cum[q]);
            const size_t ybase = (((size_t)b * S + t0 + q) * H + h) * P;
#pragma unroll
            for (int j = 0; j < PJ; ++j) {
              const int p = lane + 32 * j;
              y[ybase + p] =
                  from_f32<T>(acc[i][j] + e * off[i][j] + d_h * xs[q * P + p]);
            }
          }
        }
      }
      __syncthreads();  // before the next tile overwrites cs and ss
    }

    // state update (every reader of the old state finished above): warp
    // owns rows n = warp + 8i of the transposed state, lane owns p
    {
      const float decay = expf(cum_last);
      float acc[kNI][PJ];
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int n = warp + kSsdWarps * i;
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          acc[i][j] = n < N ? decay * st[n * SP + lane + 32 * j] : 0.f;
      }
#pragma unroll 2
      for (int k = 0; k < Qc; ++k) {
        const float w = wk[k];
        float xv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = w * xs[k * P + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < kNI; ++i) {
          const int n = warp + kSsdWarps * i;
          const float bv = n < N ? bs[k * NB + n] : 0.f;
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += bv * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int n = warp + kSsdWarps * i;
        if (n < N) {
#pragma unroll
          for (int j = 0; j < PJ; ++j) st[n * SP + lane + 32 * j] = acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kSsdThreads)
    hout[sbase + i] = st[(i % N) * SP + i / N];
}

template <typename T, int P>
cudaError_t launch_ssd(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* D,
                       const void* h0, void* y, void* hout, int B, int S,
                       int H, int G, int N, int Q, cudaStream_t s) {
  // above 48 KB a block's dynamic shared memory needs an opt-in; raise it
  // to the largest this instantiation can ask for, once, so that no call
  // under CUDA-graph capture sets it
  static bool opted_in = false;
  if (!opted_in) {
    const size_t most = ssd_smem_floats(P, kMaxState, kMaxChunk) *
                        sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const size_t smem = ssd_smem_floats(P, N, Q) * sizeof(float);
  dim3 grid(H, B);
  ssd_scan_kernel<T, P><<<grid, kSsdThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hout), S, H, G, N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ssd_dispatch_p(int P, const void* x, const void* dt,
                           const void* A, const void* Bm, const void* Cm,
                           const void* D, const void* h0, void* y, void* hout,
                           int B, int S, int H, int G, int N, int Q,
                           cudaStream_t s) {
  if (P == 32)
    return launch_ssd<T, 32>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, H, G, N,
                             Q, s);
  if (P == 64)
    return launch_ssd<T, 64>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, H, G, N,
                             Q, s);
  return cudaErrorInvalidValue;
}

}  // namespace repro

using namespace repro;

// fp32 throughout; h0 may be null (zero initial state).  1 <= N <= 128,
// 1 <= Q <= 128, P in {32, 64}, H % G == 0.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            const void* h0, void* y, void* hout, int B, int S,
                            int H, int G, int P, int N, int Q,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxState || Q < 1 || Q > kMaxChunk || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  return (int)ssd_dispatch_p<float>(P, x, dt, A, Bm, Cm, D, h0, y, hout, B,
                                    S, H, G, N, Q, s);
}
