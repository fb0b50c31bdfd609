// Mamba2 SSD chunked scan on Hopper's tensor cores, for bf16 x, B and C
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, body
// _kernel) for every served call: the models compute in bf16, so x, B
// and C are bf16.  fp32 inputs go to the CUDA-core kernel in
// ssd_scan.cu.  Same function and layout as that kernel: per (batch,
// head), chunks of Q tokens, with a = dt * A and cum its running sum in
// the chunk,
//
//   y_q = sum_{k<=q} exp(cum_q - cum_k) (C_q . B_k) dt_k x_k + exp(cum_q)
//         C_q . h + D x_q
//   h  <- exp(cum_last) h + sum_k exp(cum_last - cum_k) dt_k x_k B_k^T
//
// x (B,S,H,P), dt (B,S,H) fp32, A and D (H,) fp32, B/C (B,S,G,N), h0
// and the returned state (B,H,P,N) fp32, y (B,S,H,P) bf16.
//
// Bound on the H100: bytes.  At mamba2's prefill (B=8, S=500, H=48,
// P=64, N=128) one read of x, dt, B, C and h0 and one write of y and the
// state move ~77 MB, 23 us at 3.35 TB/s, against ~10 GFLOP of products
// (the causal half), ~10 us on the bf16 tensor cores.
//
// Design:
//  - The reference's algorithm: one block (8 warps) per (head, batch)
//    walks the chunks in order with the fp32 (P, N) state on chip the
//    whole way; each input element is read from device memory once.
//  - The four products per chunk run on the tensor cores as mma.sync
//    m16n8k16 (bf16 in, fp32 sums), fed by ldmatrix from shared memory.
//    Not wgmma: a warpgroup's 64-row tile does not fit these products'
//    shapes (16-row causal score blocks per warp, a P x N state split
//    over eight warps), the A operands are built in registers from fp32
//    values split into two bf16 halves, and the state stays in the
//    accumulator registers of the warp that owns its tile across chunks.
//     1. scores C.B^T per warp: its 16 query rows x each 16-key block at
//        or below the diagonal, depth N; C's fragments are loaded once a
//        chunk into registers and reused by product 3;
//     2. y_diag = (scores * decay * dt).x: the weighted scores go from
//        the accumulators straight into A fragments (the accumulator
//        layout of two n8 tiles is the A layout of one k16 step);
//     3. y_off = C.h^T with h read from shared memory, scaled by
//        exp(cum_q), as the accumulator that product 2 adds into;
//     4. the state increment x^T.(w * dt * B): the per-key factor s_k =
//        w_k dt_k is applied to x (P <= N, the smaller operand, read by
//        ldmatrix.trans as the A fragments), so B serves as it was loaded.
//  - cum, exp(cum), s_k and the decays stay fp32 on CUDA cores; the
//    causal mask is applied before the exponent.
//  - x, B and C are staged in bf16, rows padded by 16 bytes (conflict-
//    free ldmatrix), loaded with 16-byte cp.async.  With two stages the
//    next chunk's loads fly during this chunk's products; one stage
//    halves the shared memory (more blocks per SM).  The host picks the
//    stage count that keeps the most blocks per SM, two on a tie.
//  - Ragged tails, Q not a multiple of 16 and N not a multiple of 64
//    are zero padding in shared memory: a padded token has dt = 0 and
//    zero rows, a padded state column stays zero and is never written.
//
// Numerical contract (emulated in tests/_ssd_emulation.py):
//  - x, B and C are bf16 and enter the products exactly.
//  - Each fp32 operand is split into bf16 hi + lo (lo = bf16(v - hi)),
//    and both halves are multiplied and summed in fp32: the weighted
//    score matrix (product 2), h (product 3) and s_k x (product 4).
//    The split keeps ~16 significant bits, a relative error below 2^-16
//    of each operand.
//  - The state update adds the increment into exp(cum_last) h in the
//    fp32 accumulators; y = (exp(cum_q) C.h^T + y_diag) + D x, rounded
//    to bf16 once.
#include "mma_sync.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 256;  // 8 warps
constexpr int kMaxQ = 128;       // chunk length: 8 row tiles of 16
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTables = 5;  // cum, dt, s_k, exp(cum), cum log2(e)

__host__ __device__ inline size_t tc_smem_bytes(int P, int NP, int Q,
                                                int stages) {
  const int Qr = round16(Q);
  const size_t stage = (size_t)Qr * (P + 8) + 2 * (size_t)Qr * (NP + 8);
  return (stages * stage + 2 * (size_t)P * (NP + 8)) * sizeof(bf16) +
         2 * kTables * (size_t)Qr * sizeof(float);
}

// N <= 64: two blocks a SM fit in shared memory with one stage, and the
// registers are capped to let them
template <int P, int NP>
__global__ void __launch_bounds__(kTcThreads, NP == 64 ? 2 : 1)
    ssd_scan_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, bf16* __restrict__ y,
    float* __restrict__ hout, int S, int H, int G, int N, int Q,
    int stages) {
  constexpr int XS = P + 8, BS = NP + 8;  // padded row strides (elements)
  constexpr int PT = P / 8;               // n8 tiles of a y row tile
  constexpr int KS = NP / 16;             // k16 steps over the state dim
  constexpr int MT = P / 16;              // m16 tiles of the state
  constexpr int NTW = NP * P / 1024;      // n8 state tiles per warp
  static_assert(NTW % 2 == 0 && PT % 2 == 0, "P in {32, 64}, NP in {64, 128}");
  const int h = blockIdx.x, b = blockIdx.y, grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int Qr = round16(Q);
  const int nc = (S + Q - 1) / Q;

  extern __shared__ __align__(16) uint8_t smem[];
  const int stage_elems = Qr * XS + 2 * Qr * BS;
  bf16* stage0 = reinterpret_cast<bf16*>(smem);  // xs [Qr][XS], bs, cs
  bf16* hh = stage0 + stages * stage_elems;      // [P][BS] state, hi
  bf16* hl = hh + P * BS;                        // [P][BS] state, lo
  // a chunk's decay tables, two buffers of kTables x Qr floats
  float* tables0 = reinterpret_cast<float*>(hl + P * BS);

  // state columns N..NP of B and C stay zero in every stage
  if (N < NP)
    for (int i = tid; i < stages * 2 * Qr * (NP - N); i += kTcThreads) {
      const int row = i / (NP - N), col = N + i % (NP - N);
      stage0[(row / (2 * Qr)) * stage_elems + Qr * XS +
             (row % (2 * Qr)) * BS + col] = __float2bfloat16(0.f);
    }

  auto load_chunk = [&](int c, bf16* xs) {
    bf16* bs = xs + Qr * XS;
    bf16* cs = bs + Qr * BS;
    const int t0 = c * Q, Qc = min(Q, S - t0);
    for (int i = tid; i < Qr * (P / 8); i += kTcThreads) {
      const int r = i / (P / 8), cc = i % (P / 8);
      const bool ok = r < Qc;
      cp_async16(xs + r * XS + cc * 8,
                 ok ? x + (((size_t)b * S + t0 + r) * H + h) * P + cc * 8
                    : x,
                 ok);
    }
    const int NC = N / 8;
    for (int i = tid; i < Qr * NC; i += kTcThreads) {
      const int r = i / NC, cc = i % NC;
      const bool ok = r < Qc;
      const size_t off = (((size_t)b * S + t0 + r) * G + grp) * N + cc * 8;
      cp_async16(bs + r * BS + cc * 8, ok ? Bm + off : Bm, ok);
      cp_async16(cs + r * BS + cc * 8, ok ? Cm + off : Cm, ok);
    }
    cp_async_commit();
  };
  // the warp's state tile: rows p0.., n8 tiles n_base / 8 ..
  const int p0 = (warp % MT) * 16, n_base = (warp / MT) * NTW * 8;
  const size_t sbase = ((size_t)b * H + h) * P * N;
  float st[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + g8 + 8 * r, n = n_base + 8 * j + 2 * c4;
      float2 v = make_float2(0.f, 0.f);
      if (h0 && n < N)
        v = *reinterpret_cast<const float2*>(h0 + sbase + (size_t)p * N + n);
      st[j][2 * r] = v.x;
      st[j][2 * r + 1] = v.y;
    }
  auto store_split_state = [&]() {
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (p0 + g8 + 8 * r) * BS + n_base + 8 * j + 2 * c4;
        uint32_t hi, lo;
        split2(st[j][2 * r], st[j][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hh + off) = hi;
        *reinterpret_cast<uint32_t*>(hl + off) = lo;
      }
  };

  const float a_h = A[h], d_h = Dv[h];

  // warp 0 (the lightest causal load, row tile 0) builds chunk c's
  // tables: cum (lane owns positions 4 lane .. +3: per-lane running sums,
  // then a warp scan of the lane totals), dt, s_k = dt_k exp(cum_last -
  // cum_k) (0 past the chunk), exp(cum) and cum log2(e)
  auto build_tables = [&](int c) {
    const int t0 = c * Q, Qc = min(Q, S - t0);
    float* cum = tables0 + (c & 1) * kTables * Qr;
    float* dts = cum + Qr;
    float* sk = dts + Qr;
    float* ecum = sk + Qr;
    float* cum2 = ecum + Qr;
    float d[4], part[4], run = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = lane * 4 + j;
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
    for (int j = 0; j < 4; ++j) {
      const int k = lane * 4 + j;
      if (k < Qr) {
        cum[k] = before + part[j];
        dts[k] = d[j];
      }
    }
    __syncwarp();
    const float cum_last = cum[Qc - 1];
    for (int k = lane; k < Qr; k += 32) {
      sk[k] = k < Qc ? dts[k] * expf(cum_last - cum[k]) : 0.f;
      ecum[k] = expf(cum[k]);
      cum2[k] = cum[k] * kLog2e;
    }
  };

  load_chunk(0, stage0);
  if (warp == 0) build_tables(0);
  store_split_state();

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q, Qc = min(Q, S - t0);
    bf16* xs = stage0 + (stages == 2 ? (c & 1) : 0) * stage_elems;
    const bf16* bs = xs + Qr * XS;
    bf16* cs = xs + Qr * XS + Qr * BS;
    const float* cum = tables0 + (c & 1) * kTables * Qr;
    const float* dts = cum + Qr;
    const float* sk = dts + Qr;
    const float* ecum = sk + Qr;
    const float* cum2 = ecum + Qr;

    cp_async_wait<0>();
    __syncthreads();  // chunk c's x, B, C, its tables and h visible
    if (stages == 2 && c + 1 < nc)
      load_chunk(c + 1, stage0 + ((c + 1) & 1) * stage_elems);
    // the other table buffer was last read in chunk c - 1
    if (warp == 0 && c + 1 < nc) build_tables(c + 1);

    // ---- y for this warp's 16 query rows ----
    // Row tile rt has rt + 1 key blocks.  Warps w and w + 4 share one of
    // the SM's four schedulers, so warp w takes tile w and warp w + 4
    // tile 7 - w: nine key blocks per scheduler.
    const int rt = warp < 4 ? warp : 11 - warp;
    const int q0 = rt * 16;
    if (q0 < Qc) {
      uint32_t cf[KS][4];  // C rows q0.., all of N, as A fragments
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(cf[ks], cs + (q0 + a_row(lane)) * BS + ks * 16 + a_col(lane));
      float yacc[PT][4];
#pragma unroll
      for (int i = 0; i < PT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[i][e] = 0.f;
      // product 3: C h^T, both halves of h
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int pp = 0; pp < PT / 2; ++pp) {
          const int off =
              (pp * 16 + bt_row(lane)) * BS + ks * 16 + bt_col(lane);
          uint32_t bh[4], bl[4];
          ldsm_x4(bh, hh + off);
          ldsm_x4(bl, hl + off);
          mma(yacc[2 * pp], cf[ks], bh[0], bh[1]);
          mma(yacc[2 * pp + 1], cf[ks], bh[2], bh[3]);
          mma(yacc[2 * pp], cf[ks], bl[0], bl[1]);
          mma(yacc[2 * pp + 1], cf[ks], bl[2], bl[3]);
        }
      const int qa = q0 + g8, qb = qa + 8;
      const float ea = ecum[qa], eb = ecum[qb];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        yacc[i][0] *= ea;
        yacc[i][1] *= ea;
        yacc[i][2] *= eb;
        yacc[i][3] *= eb;
      }
      // products 1 and 2, two 16-key blocks at a time up to the diagonal
      // (four independent accumulator chains in product 1); the weights
      // only reach y, so their decay takes exp2 of the log2e-scaled cum
      const float ca2 = cum2[qa], cb2 = cum2[qb];
      for (int kb0 = 0; kb0 <= rt; kb0 += 2) {
        const bool two = kb0 < rt;
        float sacc[2][2][4];  // [key block][n8 tile][fragment]
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[u][j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (u == 0 || two) {
              uint32_t bb[4];
              ldsm_x4(bb, bs + ((kb0 + u) * 16 + bt_row(lane)) * BS +
                              ks * 16 + bt_col(lane));
              mma(sacc[u][0], cf[ks], bb[0], bb[1]);
              mma(sacc[u][1], cf[ks], bb[2], bb[3]);
            }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == 1 && !two) break;
          const int kb = kb0 + u;
          // sacc[u][j][2r + e]: row (r ? qb : qa), key kb*16 + 8j + 2c4 +
          // e; as A fragments: register 2j + r
          uint32_t ah[4], al[4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int k = kb * 16 + 8 * j + 2 * c4;
            const float ck0 = cum2[k], ck1 = cum2[k + 1];
            const float d0 = dts[k], d1 = dts[k + 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int q = r ? qb : qa;
              const float cq = r ? cb2 : ca2;
              const float w0 =
                  k <= q ? sacc[u][j][2 * r] * exp2f(cq - ck0) * d0 : 0.f;
              const float w1 = k + 1 <= q
                                   ? sacc[u][j][2 * r + 1] * exp2f(cq - ck1) *
                                         d1
                                   : 0.f;
              split2(w0, w1, ah[2 * j + r], al[2 * j + r]);
            }
          }
#pragma unroll
          for (int pp = 0; pp < PT / 2; ++pp) {
            uint32_t bx[4];
            ldsm_x4_t(bx, xs + (kb * 16 + a_row(lane)) * XS + pp * 16 +
                              a_col(lane));
            mma(yacc[2 * pp], ah, bx[0], bx[1]);
            mma(yacc[2 * pp + 1], ah, bx[2], bx[3]);
            mma(yacc[2 * pp], al, bx[0], bx[1]);
            mma(yacc[2 * pp + 1], al, bx[2], bx[3]);
          }
        }
      }
      // y = acc + D x, staged in this warp's own rows of the C tile (read
      // only into cf above), then written as 16-byte rows
      bf16* ys = cs + q0 * BS;
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const int col = i * 8 + 2 * c4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = r ? qb : qa;
          const float2 xv = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(xs + q * XS + col));
          *reinterpret_cast<uint32_t*>(ys + (g8 + 8 * r) * BS + col) =
              pack_bf16(yacc[i][2 * r] + d_h * xv.x,
                        yacc[i][2 * r + 1] + d_h * xv.y);
        }
      }
      __syncwarp();
      for (int i = lane; i < 16 * (P / 8); i += 32) {
        const int r = i / (P / 8), cc = i % (P / 8), q = q0 + r;
        if (q < Qc)
          *reinterpret_cast<uint4*>(
              y + (((size_t)b * S + t0 + q) * H + h) * P + cc * 8) =
              *reinterpret_cast<const uint4*>(ys + r * BS + cc * 8);
      }
    }

    // ---- product 4: st = exp(cum_last) st + (s x)^T B ----
    {
      const float decay = expf(cum[Qc - 1]);
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] *= decay;
      const int kend = (Qc + 15) / 16;
      for (int ks = 0; ks < kend; ++ks) {
        uint32_t ax[4];  // x^T: (p, key) fragments
        ldsm_x4_t(ax, xs + (ks * 16 + bt_row(lane)) * XS + p0 + bt_col(lane));
        const int k = ks * 16 + 2 * c4;
        const float s0 = sk[k], s1 = sk[k + 1], s2 = sk[k + 8],
                    s3 = sk[k + 9];
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = unpack_bf16(ax[i]);
          split2(f.x * (i & 2 ? s2 : s0), f.y * (i & 2 ? s3 : s1), ah[i],
                 al[i]);
        }
#pragma unroll
        for (int jj = 0; jj < NTW / 2; ++jj) {
          uint32_t bb[4];
          ldsm_x4_t(bb, bs + (ks * 16 + a_row(lane)) * BS + n_base + jj * 16 +
                            a_col(lane));
          mma(st[2 * jj], ah, bb[0], bb[1]);
          mma(st[2 * jj + 1], ah, bb[2], bb[3]);
          mma(st[2 * jj], al, bb[0], bb[1]);
          mma(st[2 * jj + 1], al, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every read of this stage, h and the decays done
    store_split_state();
    if (stages == 1 && c + 1 < nc) load_chunk(c + 1, stage0);
  }

#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + g8 + 8 * r, n = n_base + 8 * j + 2 * c4;
      if (n < N)
        *reinterpret_cast<float2*>(hout + sbase + (size_t)p * N + n) =
            make_float2(st[j][2 * r], st[j][2 * r + 1]);
    }
}

// blocks per SM of an instantiation at this shared-memory size
template <int P, int NP>
int tc_blocks_per_sm(size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ssd_scan_tc_kernel<P, NP>, kTcThreads, smem) != cudaSuccess)
    return 0;
  return n;
}

// The stage count of a chunk length: the one that keeps more blocks per
// SM, two on a tie.  It depends only on the instantiation and Q, so it is
// worked out at a Q's first launch and looked up after; the first launch
// also sets the shared-memory opt-in, so no call under CUDA-graph capture
// sets it.  0 in the table: not yet known.
template <int P, int NP>
cudaError_t tc_stages(int Q, int* stages) {
  static bool opted_in = false;
  static int table[kMaxQ + 1] = {};
  if (!opted_in) {
    // covers the largest size this instantiation can ask for
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<P, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc_smem_bytes(P, NP, kMaxQ, 2));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  if (table[Q] == 0) {
    const int one = tc_blocks_per_sm<P, NP>(tc_smem_bytes(P, NP, Q, 1));
    const int two = tc_blocks_per_sm<P, NP>(tc_smem_bytes(P, NP, Q, 2));
    if (one == 0 && two == 0) return cudaErrorInvalidConfiguration;
    table[Q] = one > two ? 1 : 2;
  }
  *stages = table[Q];
  return cudaSuccess;
}

template <int P, int NP>
cudaError_t launch_tc(const void* x, const void* dt, const void* A,
                      const void* Bm, const void* Cm, const void* D,
                      const void* h0, void* y, void* hout, int B, int S,
                      int H, int G, int N, int Q, cudaStream_t s) {
  int stages = 0;
  cudaError_t e = tc_stages<P, NP>(Q, &stages);
  if (e != cudaSuccess) return e;
  ssd_scan_tc_kernel<P, NP>
      <<<dim3(H, B), kTcThreads, tc_smem_bytes(P, NP, Q, stages), s>>>(
          static_cast<const bf16*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(A), static_cast<const bf16*>(Bm),
          static_cast<const bf16*>(Cm), static_cast<const float*>(D),
          static_cast<const float*>(h0), static_cast<bf16*>(y),
          static_cast<float*>(hout), S, H, G, N, Q, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// bf16 x, B, C and y (16-byte aligned); fp32 dt, A, D, h0 (nullable:
// zero initial state) and hout.  P in {32, 64}, N a multiple of 8 up to
// 128, 1 <= Q <= 128, H % G == 0.
extern "C" int ssd_scan_tc_fwd(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, void* y, void* hout, int B,
                               int S, int H, int G, int P, int N, int Q,
                               void* stream) {
  if (!((P == 32 || P == 64) && N >= 8 && N <= 128 && N % 8 == 0 &&
        Q >= 1 && Q <= kMaxQ && G >= 1 && H % G == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(P_, NP_) \
  launch_tc<P_, NP_>(x, dt, A, Bm, Cm, D, h0, y, hout, B, S, H, G, N, Q, s)
  if (P == 32 && N <= 64) return (int)LAUNCH(32, 64);
  if (P == 32) return (int)LAUNCH(32, 128);
  if (N <= 64) return (int)LAUNCH(64, 64);
  return (int)LAUNCH(64, 128);
#undef LAUNCH
}
