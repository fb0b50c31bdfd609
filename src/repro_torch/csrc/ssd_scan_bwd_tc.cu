// Backward of the port's Mamba2 SSD chunked scan on Hopper's tensor
// cores, for bf16 x, B, C and dy (sm_90a).
//
// The JAX package has no backward Pallas kernel: XLA differentiates its
// jnp scan (src/repro/models/mamba2.py ssd_chunked).  This is the
// gradient of the forward in ssd_scan_tc.cu (which replaces
// src/repro/kernels/ssd_scan.py ssd_scan) for every bf16 training step;
// fp32 inputs go to the CUDA-core kernel in ssd_scan_bwd.cu, whose note
// derives the terms below.  The scanned function does not depend on the
// chunk length, so this kernel walks chunks of Qb = min(Q, 64) positions
// of its own.  In a chunk, with cum the running sum of dt * A, cl its
// last value, w_k = dt_k exp(cl - cum_k), M[q,k] = exp(cum_q - cum_k)
// dt_k (k <= q), h the state entering the chunk and g' the gradient of
// the state leaving it:
//
//   S = C B^T, G = dy x^T, T = exp(cum_q - cum_k) S G   (k <= q)
//   dx  = w o (B g'^T) + D dy + (M o S)^T dy
//   dB  = (w o x) g' + (M o G)^T C          summed over a group's heads
//   dC  = (exp(cum) o dy) h + (M o G) B     ″
//   dcum_j = sum_k dt_k T[j,k] - dt_j sum_q T[q,j] + exp(cum_j) dy_j .
//            (h C_j) - w_j x_j . (g' B_j) + [j last] <g', h'>,
//   <g', h'> = exp(cl) <g', h> + sum_k w_k x_k . (g' B_k)
//   da_j = sum_{q>=j} dcum_q, ddt_j = A da_j + sum_q T[q,j] +
//          exp(cl - cum_j) x_j . (g' B_j), dA = sum_j dt_j da_j,
//   dD  = sum_q dy_q . x_q.
//
// Layout: the forward's, x, dy, dx (B,S,H,P) and B, C, dB, dC (B,S,G,N)
// bf16, dt, ddt (B,S,H), A, D, dA, dD (H,), h0, dh_T, dh0 (B,H,P,N)
// fp32; head h reads group h / (H/G).  P in {32, 64}, N a multiple of 8
// up to 128 (state width NP: 64 or 128).  Three launches:
//  1. walks: grid (H, B, 2), 8 warps, B4's design.  z = 0 walks the
//     chunks forward from h0 and stores the state entering each chunk;
//     z = 1 walks them backward from dh_T and stores the gradient of the
//     state after each chunk, then writes dh0.  The fp32 (P, N) state
//     lives in the mma accumulators of the warp that owns its tile; each
//     chunk's increment (w o x)^T B or (exp(cum) o dy)^T C is one
//     tensor-core product, with the next chunk's tiles loading by
//     cp.async meanwhile.  States are stored as their bf16 hi and lo
//     halves, (B, nc, H, 2, P, N): the bytes of fp32, but ready for
//     ldmatrix, and a chunk's heads side by side, so a run's states are
//     one span;
//  2. chunks: grid (nc, runs, B), 16 warps (one block an SM: 147 KB of
//     shared memory at P = 64, N = 128), one block per (chunk, run of R
//     consecutive heads of one group, batch).  C and B are staged once
//     and S = C B^T is computed once for the run; then, head by head in
//     order, x, dy, h and g' are staged and every product above runs as
//     mma.sync m16n8k16 fed by ldmatrix.  dB and dC stay in the
//     accumulators across the run's heads; the masked M o G of the heads
//     is summed in fp32 registers and multiplied by C and B once at the
//     run's end.  dx and ddt are written once a head; dB and dC once a
//     run, as fp32 partials (B, S, runs, N); dA and dD as (B, nc, H);
//  3. reduce: dB and dC summed over each group's runs in order and
//     rounded to bf16; dA and dD summed over (batch, chunk) in order.
// No atomics: the same inputs give the same bits.
//
// Numerical contract (emulated in tests/_ssd_bwd_tc_emulation.py):
//  - x, dy, B and C are bf16 and enter the products exactly (S, G, B
//    g'^T, C h^T, and as the exact operand elsewhere).
//  - Every fp32 operand is split into bf16 hi + lo (lo = bf16(v - hi)),
//    both halves multiplied and summed in fp32: g' and h, M o S, the
//    run's sum of M o G, w o x and exp(cum) o dy (and, in launch 1, the
//    w- or exp(cum)-scaled x and dy).  Where both operands are fp32 ((w
//    o x) g', (exp(cum) o dy) h) the lo x lo product is dropped.
//  - Sums: dB, dC over the heads of a run in head order in fp32 (the
//    products of head 1, head 2, ..., then the (M o G) term), then over
//    a group's runs in order; dA, dD over (batch, chunk) in order;
//    within a chunk over fixed warp and lane trees.
//  - dx, dB and dC are rounded to bf16 once; ddt, dA, dD and dh0 stay
//    fp32.
//
// Bound on the H100: bytes.  At mamba2's training call (B=8, S=512,
// H=48, P=64, N=128) one read of x, dy, B, C, dt and one write of the
// gradients move ~81 MB, 24 us at 3.35 TB/s, against ~40 GFLOP of the
// chunked products with their splits (~0.04 ms on the bf16 tensor
// cores).  What the design does about it: the products run on the
// tensor cores from bf16 tiles; the boundary states cost one fp32-sized
// write and read each way (2 x 101 MB), written as 16-byte rows from a
// per-warp staging tile (the mma layout's 4-byte pieces left the walks
// store-bound); runs of 8 heads cut the dB and dC partials to an eighth
// of one per head and compute S once a run; <g', h'> needs no third
// state read.
#include "mma_sync.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kQ = 64;               // positions per backward chunk (most)
constexpr int kQS = kQ + 8;          // padded row of a (Q, Q) bf16 tile
constexpr int kWalkThreads = 256;    // launch 1: 8 warps
constexpr int kThreads = 512;        // launch 2: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 10;           // causal 16 x 16 (q, k) tiles of kQ

// one warp: dt of the chunk's Qc positions and cum, the running sum of
// dt * A (each lane two consecutive positions, then a warp scan of the
// lane totals); past Qc dt is 0 and cum stays at the chunk's last value
__device__ __forceinline__ void chunk_decay(const float* __restrict__ dt,
                                            size_t at, int H, int Qc,
                                            float a_h, float* dts,
                                            float* cum) {
  const int lane = threadIdx.x & 31;
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

template <int P, int NP>
constexpr int walk_smem_bytes() {
  // two stages and their tables, then each warp's hi and lo state tile
  return 2 * kQ * ((P + 8) + (NP + 8)) * 2 + 2 * 3 * kQ * 4 +
         (kWalkThreads / 32) * 2 * 16 * (NP * P / 128 + 8) * 2;
}

// launch 1: z = 0 the states entering each chunk, z = 1 the gradients
// of the states after each chunk (and dh0)
template <int P, int NP>
__global__ void __launch_bounds__(kWalkThreads) ssd_bwd_walk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ h0,
    const bf16* __restrict__ dy, const float* __restrict__ dhT,
    bf16* __restrict__ hs, bf16* __restrict__ gs,
    float* __restrict__ dh0, int S, int H, int G, int N, int Qb, int nc) {
  constexpr int XS = P + 8, BS = NP + 8;  // padded row strides (elements)
  constexpr int MT = P / 16;              // m16 tiles of the state
  constexpr int NTW = NP * P / 1024;      // n8 state tiles per warp
  static_assert(NTW % 2 == 0, "P in {32, 64}, NP in {64, 128}");
  const int h = blockIdx.x, b = blockIdx.y;
  const bool rev = blockIdx.z == 1;
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int stage_elems = kQ * XS + kQ * BS;
  constexpr int SW = NTW * 8 + 8;  // padded row of a warp's state tile
  // 2 x {us [kQ][XS], vs [kQ][BS]}, then 2 x {dt, cum, s_k} of a chunk,
  // then per warp its state tile's bf16 hi and lo halves [2][16][SW] on
  // their way to device memory
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  float* tab0 = reinterpret_cast<float*>(stage0 + 2 * stage_elems);
  bf16* stw = reinterpret_cast<bf16*>(tab0 + 2 * 3 * kQ) +
              warp * 2 * 16 * SW;

  const bf16* u = rev ? dy : x;
  const bf16* v = rev ? Cm : Bm;
  // state columns N..NP of B (or C) stay zero in both stages
  if (N < NP)
    for (int i = tid; i < 2 * kQ * (NP - N); i += kWalkThreads) {
      const int row = i / (NP - N), col = N + i % (NP - N);
      stage0[(row / kQ) * stage_elems + kQ * XS + (row % kQ) * BS + col] =
          __float2bfloat16(0.f);
    }
  auto load_chunk = [&](int c, bf16* us) {
    bf16* vs = us + kQ * XS;
    const int t0 = c * Qb, Qc = min(Qb, S - t0), Qr = round16(Qc);
    for (int i = tid; i < Qr * (P / 8); i += kWalkThreads) {
      const int r = i / (P / 8), cc = i % (P / 8);
      const bool ok = r < Qc;
      cp_async16(us + r * XS + cc * 8,
                 ok ? u + (((size_t)b * S + t0 + r) * H + h) * P + cc * 8
                    : u,
                 ok);
    }
    const int NC = N / 8;
    for (int i = tid; i < Qr * NC; i += kWalkThreads) {
      const int r = i / NC, cc = i % NC;
      const bool ok = r < Qc;
      cp_async16(vs + r * BS + cc * 8,
                 ok ? v + (((size_t)b * S + t0 + r) * G + grp) * N + cc * 8
                    : v,
                 ok);
    }
    cp_async_commit();
  };
  const float a_h = A[h];
  // warp 0: chunk c's dt, cum and s_k (w_k forward, exp(cum_k) backward;
  // 0 past the chunk)
  auto build_tables = [&](int c, float* tab) {
    float* dts = tab;
    float* cum = tab + kQ;
    float* sk = tab + 2 * kQ;
    const int t0 = c * Qb, Qc = min(Qb, S - t0);
    chunk_decay(dt, ((size_t)b * S + t0) * H + h, H, Qc, a_h, dts, cum);
    __syncwarp();
    const float cl = cum[Qc - 1];
    for (int k = lane; k < kQ; k += 32)
      sk[k] = k < Qc ? (rev ? expf(cum[k]) : dts[k] * expf(cl - cum[k]))
                     : 0.f;
  };

  // the warp's state tile: rows p0.., n8 tiles n_base / 8 ..
  const int p0 = (warp % MT) * 16, n_base = (warp / MT) * NTW * 8;
  const size_t PN = (size_t)P * N;
  const size_t bh = (size_t)b * H + h;
  const float* init = rev ? dhT : h0;
  float st[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + g8 + 8 * r, n = n_base + 8 * j + 2 * c4;
      float2 val = make_float2(0.f, 0.f);
      if (init && n < N)
        val = *reinterpret_cast<const float2*>(init + bh * PN +
                                               (size_t)p * N + n);
      st[j][2 * r] = val.x;
      st[j][2 * r + 1] = val.y;
    }
  bf16* out = rev ? gs : hs;

  int c = rev ? nc - 1 : 0;
  load_chunk(c, stage0);
  if (warp == 0) build_tables(c, tab0);
  for (int step = 0; step < nc; ++step) {
    c = rev ? nc - 1 - step : step;
    const int Qc = min(Qb, S - c * Qb);
    const bf16* us = stage0 + (step & 1) * stage_elems;
    const bf16* vs = us + kQ * XS;
    const float* tab = tab0 + (step & 1) * 3 * kQ;
    cp_async_wait<0>();
    __syncthreads();  // this chunk's tiles and tables visible; the other
                      // stage's last reads done
    if (step + 1 < nc) {
      const int cn = rev ? c - 1 : c + 1;
      load_chunk(cn, stage0 + ((step + 1) & 1) * stage_elems);
      if (warp == 0) build_tables(cn, tab0 + ((step + 1) & 1) * 3 * kQ);
    }
    // the state at this chunk's boundary, as bf16 hi and lo halves:
    // split into the warp's staging tile, then out as 16-byte rows
    __syncwarp();  // the last step's reads of the staging tile done
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t hi, lo;
        split2(st[j][2 * r], st[j][2 * r + 1], hi, lo);
        const int off = (g8 + 8 * r) * SW + 8 * j + 2 * c4;
        *reinterpret_cast<uint32_t*>(stw + off) = hi;
        *reinterpret_cast<uint32_t*>(stw + 16 * SW + off) = lo;
      }
    __syncwarp();
    {
      bf16* o = out + (((size_t)b * nc + c) * H + h) * 2 * PN;
      for (int i = lane; i < 2 * 16 * NTW; i += 32) {  // NTW vectors a row
        const int half = i / (16 * NTW), row = (i / NTW) % 16;
        const int n = n_base + 8 * (i % NTW);
        if (n < N)
          *reinterpret_cast<uint4*>(o + half * PN +
                                    (size_t)(p0 + row) * N + n) =
              *reinterpret_cast<const uint4*>(stw + (half * 16 + row) * SW +
                                              8 * (i % NTW));
      }
    }
    // st = exp(cl) st + (s o u)^T v
    const float* cum = tab + kQ;
    const float* sk = tab + 2 * kQ;
    const float decay = expf(cum[Qc - 1]);
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= decay;
    const int kend = (Qc + 15) / 16;
    for (int ks = 0; ks < kend; ++ks) {
      uint32_t au[4];  // u^T: (p, position) fragments
      ldsm_x4_t(au, us + (ks * 16 + bt_row(lane)) * XS + p0 + bt_col(lane));
      const int k = ks * 16 + 2 * c4;
      const float s0 = sk[k], s1 = sk[k + 1], s2 = sk[k + 8],
                  s3 = sk[k + 9];
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(au[i]);
        split2(f.x * (i & 2 ? s2 : s0), f.y * (i & 2 ? s3 : s1), ah[i],
               al[i]);
      }
#pragma unroll
      for (int jj = 0; jj < NTW / 2; ++jj) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vs + (ks * 16 + a_row(lane)) * BS + n_base + jj * 16 +
                          a_col(lane));
        mma(st[2 * jj], ah, bb[0], bb[1]);
        mma(st[2 * jj + 1], ah, bb[2], bb[3]);
        mma(st[2 * jj], al, bb[0], bb[1]);
        mma(st[2 * jj + 1], al, bb[2], bb[3]);
      }
    }
  }
  if (rev && dh0) {  // the gradient of the state entering chunk 0
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + g8 + 8 * r, n = n_base + 8 * j + 2 * c4;
        if (n < N)
          *reinterpret_cast<float2*>(dh0 + bh * PN + (size_t)p * N + n) =
              make_float2(st[j][2 * r], st[j][2 * r + 1]);
      }
  }
}

template <int P, int NP>
constexpr int chunk_smem_bytes() {
  return (2 * kQ * (NP + 8) + 2 * kQ * (P + 8) + 4 * P * (NP + 8) +
          2 * kQ * kQS) * 2 +
         (4 * kQ + 16 * kQ + kQ + kWarps) * 4;
}

// the causal (q, k) tile of warp w < kTiles: (0,0), (1,0), (1,1), (2,0),
// ..., (3,3)
__device__ __forceinline__ int tile_q(int w) {
  return w < 1 ? 0 : w < 3 ? 1 : w < 6 ? 2 : 3;
}

// launch 2: every gradient term of one (chunk, run of heads, batch)
template <int P, int NP>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_tc_chunk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dv,
    const bf16* __restrict__ dy, const bf16* __restrict__ hs,
    const bf16* __restrict__ gs, bf16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pB, float* __restrict__ pC,
    float* __restrict__ pA, float* __restrict__ pD, int S, int H, int G,
    int N, int Qb, int nc, int R) {
  constexpr int XS = P + 8, BS = NP + 8;
  constexpr int KN = NP / 16;   // k16 steps over the state width
  constexpr int KP = P / 16;    // k16 steps over the head width
  constexpr int CB = NP / 4;    // dB / dC columns of a warp
  constexpr int DBN = CB / 8;   // ... as n8 tiles (4 or 2)
  const int c = blockIdx.x, run = blockIdx.y, b = blockIdx.z;
  const int HG = H / G, rpg = (HG + R - 1) / R, NR = G * rpg;
  const int grp = run / rpg, h_first = grp * HG + (run % rpg) * R;
  const int h_end = min(h_first + R, (grp + 1) * HG);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int t0 = c * Qb, Qc = min(Qb, S - t0);
  const int RT = (Qc + 15) / 16;  // row tiles of the chunk
  const size_t pos0 = (size_t)b * S + t0;
  const size_t PN = (size_t)P * N;

  extern __shared__ __align__(16) uint8_t smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem);  // [kQ][BS] B
  bf16* cs = bs + kQ * BS;                   // [kQ][BS] C
  bf16* xs = cs + kQ * BS;                   // [kQ][XS] x of the head
  bf16* ys = xs + kQ * XS;                   // [kQ][XS] dy of the head
  bf16* hst = ys + kQ * XS;                  // [2][P][BS] h: hi, lo
  bf16* gst = hst + 2 * P * BS;              // [2][P][BS] g': hi, lo
  bf16* mh = gst + 2 * P * BS;               // [kQ][kQS] M o S (run end:
  bf16* ml = mh + kQ * kQS;                  //   the summed M o G), hi, lo
  float* dts = reinterpret_cast<float*>(ml + kQ * kQS);  // [kQ] dt
  float* cum = dts + kQ;                     // [kQ] running sum of dt A
  float* wk = cum + kQ;                      // [kQ] w_k
  float* ecum = wk + kQ;                     // [kQ] exp(cum_q)
  float* rowp = ecum + kQ;   // [4][kQ] sum_k dt_k T[q,k] by key tile
  float* colp = rowp + 4 * kQ;   // [4][kQ] sum_q T[q,k] by query tile
  float* vxvp = colp + 4 * kQ;   // [4][kQ] x_k . (g' B_k) by p group
  float* vcarp = vxvp + 4 * kQ;  // [4][kQ] dy_q . (h C_q) by p group
  float* vdd = vcarp + 4 * kQ;   // [kQ] dy_q . x_q
  float* red = vdd + kQ;         // [kWarps] <g', h> by warp

  // state columns N..NP stay zero (cp.async never writes them)
  if (N < NP) {
    for (int i = tid; i < 2 * kQ * (NP - N); i += kThreads) {
      const int row = i / (NP - N), col = N + i % (NP - N);
      bs[row * BS + col] = __float2bfloat16(0.f);  // rows of bs, then cs
    }
    for (int i = tid; i < 4 * P * (NP - N); i += kThreads) {
      const int row = i / (NP - N), col = N + i % (NP - N);
      hst[row * BS + col] = __float2bfloat16(0.f);  // h, then g'
    }
  }
  const int NC = N / 8;
  for (int i = tid; i < 16 * RT * NC; i += kThreads) {
    const int r = i / NC, cc = i % NC;
    const bool ok = r < Qc;
    const size_t off = ((pos0 + r) * G + grp) * N + cc * 8;
    cp_async16(bs + r * BS + cc * 8, ok ? Bm + off : Bm, ok);
    cp_async16(cs + r * BS + cc * 8, ok ? Cm + off : Cm, ok);
  }
  cp_async_commit();

  // warp roles: the causal tile (tq, tk) of S, G and the masked products
  // (warps < kTiles); a 16-row x 16-column block (rt, cg) of dx and C h^T;
  // a 16-row x CB-column block (rt, cb) of dB and dC
  const int tq = tile_q(warp), tk = warp - tq * (tq + 1) / 2;
  const bool tiled = warp < kTiles && tq < RT;
  const int rt = warp & 3, cg = warp >> 2, cb = warp >> 2;
  const bool dx_warp = rt < RT && cg * 16 < P;
  const bool db_warp = rt < RT;

  float sacc[2][4], zacc[2][4];
  float dbacc[DBN][4], dcacc[DBN][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = zacc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DBN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[j][e] = dcacc[j][e] = 0.f;

  for (int h = h_first; h < h_end; ++h) {
    // ---- stage the head: x, dy rows; h and g' (hi, lo) ----
    for (int i = tid; i < 16 * RT * (P / 8); i += kThreads) {
      const int r = i / (P / 8), cc = i % (P / 8);
      const bool ok = r < Qc;
      const size_t at = ((pos0 + r) * H + h) * P + cc * 8;
      cp_async16(xs + r * XS + cc * 8, ok ? x + at : x, ok);
      cp_async16(ys + r * XS + cc * 8, ok ? dy + at : dy, ok);
    }
    const size_t st_at = (((size_t)b * nc + c) * H + h) * 2 * PN;
    for (int i = tid; i < 2 * P * NC; i += kThreads) {
      const int row = i / NC, cc = i % NC;  // row: half * P + p
      cp_async16(hst + row * BS + cc * 8, hs + st_at + (size_t)row * N +
                 cc * 8, true);
      cp_async16(gst + row * BS + cc * 8, gs + st_at + (size_t)row * N +
                 cc * 8, true);
    }
    cp_async_commit();
    const float a_h = A[h];
    if (warp == 0) {
      chunk_decay(dt, pos0 * H + h, H, Qc, a_h, dts, cum);
      __syncwarp();
      const float cl = cum[Qc - 1];
      for (int k = lane; k < kQ; k += 32) {
        wk[k] = k < Qc ? dts[k] * expf(cl - cum[k]) : 0.f;
        ecum[k] = expf(cum[k]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // sync 1: the head's tiles and tables visible

    // ---- (A) S (once a run), G, and the masked products of the tile ----
    if (tiled) {
      const int q0 = tq * 16, k0 = tk * 16;
      if (h == h_first) {
#pragma unroll
        for (int ks = 0; ks < KN; ++ks) {
          uint32_t a[4], bb[4];
          ldsm_x4(a, cs + (q0 + a_row(lane)) * BS + ks * 16 + a_col(lane));
          ldsm_x4(bb, bs + (k0 + bt_row(lane)) * BS + ks * 16 + bt_col(lane));
          mma(sacc[0], a, bb[0], bb[1]);
          mma(sacc[1], a, bb[2], bb[3]);
        }
      }
      float gacc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KP; ++ks) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, ys + (q0 + a_row(lane)) * XS + ks * 16 + a_col(lane));
        ldsm_x4(bb, xs + (k0 + bt_row(lane)) * XS + ks * 16 + bt_col(lane));
        mma(gacc[0], a, bb[0], bb[1]);
        mma(gacc[1], a, bb[2], bb[3]);
      }
      // acc[j][2r + e]: row q0 + g8 + 8r, key k0 + 8j + 2c4 + e
      float rsum[2] = {0.f, 0.f}, csum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + g8 + 8 * r;
          float ms[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = k0 + 8 * j + 2 * c4 + e;
            const float s_ = sacc[j][2 * r + e], g_ = gacc[j][2 * r + e];
            const float L = k <= q ? expf(cum[q] - cum[k]) : 0.f;
            const float md = L * dts[k];
            const float lt = L * s_ * g_;
            ms[e] = md * s_;
            zacc[j][2 * r + e] += md * g_;
            rsum[r] += dts[k] * lt;
            csum[j][e] += lt;
            if (k == q) vdd[q] = g_;
          }
          uint32_t hi, lo;
          split2(ms[0], ms[1], hi, lo);
          const int off = q * kQS + k0 + 8 * j + 2 * c4;
          *reinterpret_cast<uint32_t*>(mh + off) = hi;
          *reinterpret_cast<uint32_t*>(ml + off) = lo;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = rsum[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (c4 == 0) rowp[tk * kQ + q0 + g8 + 8 * r] = v;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = csum[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g8 == 0) colp[tq * kQ + k0 + 8 * j + 2 * c4 + e] = v;
        }
    }

    // ---- (B) C h^T, then B g'^T: dx's first terms ----
    float acc[2][4];
    if (dx_warp) {
      const int r0 = rt * 16, p0 = cg * 16;
      // U = C h^T (h split), for dy_q . (h C_q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t a[4], bh[4], bl[4];
        ldsm_x4(a, cs + (r0 + a_row(lane)) * BS + ks * 16 + a_col(lane));
        const int off = (p0 + bt_row(lane)) * BS + ks * 16 + bt_col(lane);
        ldsm_x4(bh, hst + off);
        ldsm_x4(bl, hst + P * BS + off);
        mma(acc[0], a, bh[0], bh[1]);
        mma(acc[1], a, bh[2], bh[3]);
        mma(acc[0], a, bl[0], bl[1]);
        mma(acc[1], a, bl[2], bl[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r0 + g8 + 8 * r;
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 yv = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              ys + q * XS + p0 + 8 * j + 2 * c4));
          v += yv.x * acc[j][2 * r] + yv.y * acc[j][2 * r + 1];
        }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (c4 == 0) vcarp[cg * kQ + q] = v;
      }
      // V = B g'^T (g' split); x . V, then dx = w V + D dy
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KN; ++ks) {
        uint32_t a[4], bh[4], bl[4];
        ldsm_x4(a, bs + (r0 + a_row(lane)) * BS + ks * 16 + a_col(lane));
        const int off = (p0 + bt_row(lane)) * BS + ks * 16 + bt_col(lane);
        ldsm_x4(bh, gst + off);
        ldsm_x4(bl, gst + P * BS + off);
        mma(acc[0], a, bh[0], bh[1]);
        mma(acc[1], a, bh[2], bh[3]);
        mma(acc[0], a, bl[0], bl[1]);
        mma(acc[1], a, bl[2], bl[3]);
      }
      const float d_h = Dv[h];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = r0 + g8 + 8 * r;
        const float w = wk[k];
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = p0 + 8 * j + 2 * c4;
          const float2 xv = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(xs + k * XS + col));
          const float2 yv = unpack_bf16(
              *reinterpret_cast<const uint32_t*>(ys + k * XS + col));
          v += xv.x * acc[j][2 * r] + xv.y * acc[j][2 * r + 1];
          acc[j][2 * r] = w * acc[j][2 * r] + d_h * yv.x;
          acc[j][2 * r + 1] = w * acc[j][2 * r + 1] + d_h * yv.y;
        }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (c4 == 0) vxvp[cg * kQ + k] = v;
      }
    }

    // ---- (C) this head's parts of the run's dB and dC ----
    if (db_warp) {
      const int r0 = rt * 16, n0 = cb * CB;
      // out += (s o src) rhs, rows r0.., both operands split, lo x lo
      // dropped: dB's (w o x) g', then dC's (exp(cum) o dy) h
      auto term = [&](const bf16* src, const bf16* rhs, float sa, float sb,
                      float (&out)[DBN][4]) {
#pragma unroll
        for (int ks = 0; ks < KP; ++ks) {
          uint32_t a[4], ah[4], al[4];
          ldsm_x4(a, src + (r0 + a_row(lane)) * XS + ks * 16 + a_col(lane));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = unpack_bf16(a[i]);
            const float sc = i & 1 ? sb : sa;
            split2(f.x * sc, f.y * sc, ah[i], al[i]);
          }
#pragma unroll
          for (int jj = 0; jj < DBN / 2; ++jj) {
            const int off = (ks * 16 + a_row(lane)) * BS + n0 + jj * 16 +
                            a_col(lane);
            uint32_t bh[4], bl[4];
            ldsm_x4_t(bh, rhs + off);
            ldsm_x4_t(bl, rhs + P * BS + off);
            mma(out[2 * jj], ah, bh[0], bh[1]);
            mma(out[2 * jj + 1], ah, bh[2], bh[3]);
            mma(out[2 * jj], ah, bl[0], bl[1]);
            mma(out[2 * jj + 1], ah, bl[2], bl[3]);
            mma(out[2 * jj], al, bh[0], bh[1]);
            mma(out[2 * jj + 1], al, bh[2], bh[3]);
          }
        }
      };
      term(xs, gst, wk[r0 + g8], wk[r0 + g8 + 8], dbacc);
      term(ys, hst, ecum[r0 + g8], ecum[r0 + g8 + 8], dcacc);
    }

    // ---- <g', h> over the split values ----
    {
      float part = 0.f;
      for (int i = tid; i < (int)(PN / 2); i += kThreads) {
        const int p = (2 * i) / N, n = (2 * i) % N;
        const int off = p * BS + n;
        const float2 a0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            gst + off));
        const float2 a1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            gst + P * BS + off));
        const float2 b0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            hst + off));
        const float2 b1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            hst + P * BS + off));
        part += (a0.x + a1.x) * (b0.x + b1.x) + (a0.y + a1.y) * (b0.y + b1.y);
      }
      part = warp_sum(part);
      if (lane == 0) red[warp] = part;
    }
    __syncthreads();  // sync 2: M o S and every partial written

    // ---- (D) dx += (M o S)^T dy, then store ----
    if (dx_warp) {
      const int r0 = rt * 16, p0 = cg * 16;
      for (int qs = rt; qs < RT; ++qs) {
        uint32_t ah[4], al[4], bx[4];
        const int off = (qs * 16 + bt_row(lane)) * kQS + r0 + bt_col(lane);
        ldsm_x4_t(ah, mh + off);
        ldsm_x4_t(al, ml + off);
        ldsm_x4_t(bx, ys + (qs * 16 + a_row(lane)) * XS + p0 + a_col(lane));
        mma(acc[0], ah, bx[0], bx[1]);
        mma(acc[1], ah, bx[2], bx[3]);
        mma(acc[0], al, bx[0], bx[1]);
        mma(acc[1], al, bx[2], bx[3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = r0 + g8 + 8 * r;
        if (k < Qc)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<uint32_t*>(
                dx + ((pos0 + k) * H + h) * P + p0 + 8 * j + 2 * c4) =
                pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }

    // ---- (E) warp 0: dcum, its reverse running sum da, ddt, dA, dD ----
    if (warp == 0) {
      float gh = 0.f;
      for (int w = 0; w < kWarps; ++w) gh += red[w];
      const float cl = cum[Qc - 1];
      float dc[2], vcol[2], vxv[2], part_w = 0.f, part_d = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * lane + u, jt = j >> 4;
        dc[u] = vcol[u] = vxv[u] = 0.f;
        if (j < Qc) {
          float vrow = 0.f, vcar = 0.f;
#pragma unroll
          for (int t = 0; t < 4; ++t) {  // tiles and p groups in order
            if (t <= jt) vrow += rowp[t * kQ + j];
            if (t >= jt && t < RT) vcol[u] += colp[t * kQ + j];
            if (t < P / 16) {
              vxv[u] += vxvp[t * kQ + j];
              vcar += vcarp[t * kQ + j];
            }
          }
          dc[u] = vrow - dts[j] * vcol[u] + ecum[j] * vcar - wk[j] * vxv[u];
          part_w += wk[j] * vxv[u];
          part_d += vdd[j];
        }
      }
      const float gh_next = expf(cl) * gh + warp_sum(part_w);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (2 * lane + u == Qc - 1) dc[u] += gh_next;
      // da_j = sum_{q >= j} dcum_q: the lane's two, then a suffix scan
      const float s1 = dc[1], s0 = dc[0] + dc[1];
      float incl = s0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float down = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += down;
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float da[2] = {after + s0, after + s1};
      float part_a = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * lane + u;
        if (j < Qc) {
          ddt[(pos0 + j) * H + h] =
              a_h * da[u] + vcol[u] + expf(cl - cum[j]) * vxv[u];
          part_a += dts[j] * da[u];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {  // warp_sum's tree, both at once
        part_a += __shfl_xor_sync(0xffffffffu, part_a, o);
        part_d += __shfl_xor_sync(0xffffffffu, part_d, o);
      }
      if (lane == 0) {
        pA[((size_t)b * nc + c) * H + h] = part_a;
        pD[((size_t)b * nc + c) * H + h] = part_d;
      }
    }
    __syncthreads();  // sync 3: the head's tiles and tables free
  }

  // ---- the run's sum of M o G, split, then its dB and dC terms ----
  if (tiled) {
    const int q0 = tq * 16, k0 = tk * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t hi, lo;
        split2(zacc[j][2 * r], zacc[j][2 * r + 1], hi, lo);
        const int off = (q0 + g8 + 8 * r) * kQS + k0 + 8 * j + 2 * c4;
        *reinterpret_cast<uint32_t*>(mh + off) = hi;
        *reinterpret_cast<uint32_t*>(ml + off) = lo;
      }
  }
  __syncthreads();
  if (db_warp) {
    const int r0 = rt * 16, n0 = cb * CB;
    // dB += Z^T C over query tiles qs >= rt
    for (int qs = rt; qs < RT; ++qs) {
      uint32_t ah[4], al[4];
      const int off = (qs * 16 + bt_row(lane)) * kQS + r0 + bt_col(lane);
      ldsm_x4_t(ah, mh + off);
      ldsm_x4_t(al, ml + off);
#pragma unroll
      for (int jj = 0; jj < DBN / 2; ++jj) {
        uint32_t bb[4];
        ldsm_x4_t(bb, cs + (qs * 16 + a_row(lane)) * BS + n0 + jj * 16 +
                          a_col(lane));
        mma(dbacc[2 * jj], ah, bb[0], bb[1]);
        mma(dbacc[2 * jj + 1], ah, bb[2], bb[3]);
        mma(dbacc[2 * jj], al, bb[0], bb[1]);
        mma(dbacc[2 * jj + 1], al, bb[2], bb[3]);
      }
    }
    // dC += Z B over key tiles ks <= rt
    for (int ks = 0; ks <= rt; ++ks) {
      uint32_t ah[4], al[4];
      const int off = (r0 + a_row(lane)) * kQS + ks * 16 + a_col(lane);
      ldsm_x4(ah, mh + off);
      ldsm_x4(al, ml + off);
#pragma unroll
      for (int jj = 0; jj < DBN / 2; ++jj) {
        uint32_t bb[4];
        ldsm_x4_t(bb, bs + (ks * 16 + a_row(lane)) * BS + n0 + jj * 16 +
                          a_col(lane));
        mma(dcacc[2 * jj], ah, bb[0], bb[1]);
        mma(dcacc[2 * jj + 1], ah, bb[2], bb[3]);
        mma(dcacc[2 * jj], al, bb[0], bb[1]);
        mma(dcacc[2 * jj + 1], al, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = r0 + g8 + 8 * r;
      if (k >= Qc) continue;
      const size_t at = ((pos0 + k) * NR + run) * N;
#pragma unroll
      for (int j = 0; j < DBN; ++j) {
        const int n = n0 + 8 * j + 2 * c4;
        if (n < N) {
          *reinterpret_cast<float2*>(pB + at + n) =
              make_float2(dbacc[j][2 * r], dbacc[j][2 * r + 1]);
          *reinterpret_cast<float2*>(pC + at + n) =
              make_float2(dcacc[j][2 * r], dcacc[j][2 * r + 1]);
        }
      }
    }
  }
}

// launch 3: dB, dC over each group's runs; dA, dD over (batch, chunk)
__global__ void ssd_bwd_tc_reduce_kernel(
    const float* __restrict__ pB, const float* __restrict__ pC,
    const float* __restrict__ pA, const float* __restrict__ pD,
    bf16* __restrict__ dB, bf16* __restrict__ dC, float* __restrict__ dA,
    float* __restrict__ dD, int B, int S, int H, int G, int N, int nc,
    int rpg) {
  const size_t total = (size_t)B * S * G * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % N);
    const size_t sg = i / N;  // (b * S + s) * G + g
    const int g = (int)(sg % G);
    const size_t at = ((sg / G) * G * rpg + (size_t)g * rpg) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < rpg; ++j) {
      sb += pB[at + (size_t)j * N];
      sc += pC[at + (size_t)j * N];
    }
    dB[i] = __float2bfloat16(sb);
    dC[i] = __float2bfloat16(sc);
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

template <int P, int NP>
cudaError_t launch_tc_bwd(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, const void* D,
                          const void* h0, const void* dy, const void* dhT,
                          void* dx, void* ddt, void* dA, void* dD, void* dB,
                          void* dC, void* dh0, void* hs, void* gs, void* pB,
                          void* pC, void* pAD, int B, int S, int H, int G,
                          int N, int Qb, int R, cudaStream_t s) {
  // once per instantiation, before any launch: no call under CUDA-graph
  // capture sets it
  static bool opted_in = false;
  constexpr int walk_bytes = walk_smem_bytes<P, NP>();
  constexpr int chunk_bytes = chunk_smem_bytes<P, NP>();
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_bwd_walk_kernel<P, NP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, walk_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_bwd_tc_chunk_kernel<P, NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               chunk_bytes);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int nc = (S + Qb - 1) / Qb;
  const int rpg = (H / G + R - 1) / R;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* bt = static_cast<const bf16*>(Bm);
  const bf16* ct = static_cast<const bf16*>(Cm);
  const bf16* dyt = static_cast<const bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  bf16* hst = static_cast<bf16*>(hs);
  bf16* gst = static_cast<bf16*>(gs);
  float* pa = static_cast<float*>(pAD);
  float* pd = pa + (size_t)B * nc * H;
  ssd_bwd_walk_kernel<P, NP><<<dim3(H, B, 2), kWalkThreads, walk_bytes, s>>>(
      xt, dtf, af, bt, ct, static_cast<const float*>(h0), dyt,
      static_cast<const float*>(dhT), hst, gst, static_cast<float*>(dh0), S,
      H, G, N, Qb, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_tc_chunk_kernel<P, NP>
      <<<dim3(nc, G * rpg, B), kThreads, chunk_bytes, s>>>(
          xt, dtf, af, bt, ct, static_cast<const float*>(D), dyt, hst, gst,
          static_cast<bf16*>(dx), static_cast<float*>(ddt),
          static_cast<float*>(pB), static_cast<float*>(pC), pa, pd, S, H, G,
          N, Qb, nc, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)B * S * G * N;
  const size_t want = (total + 255) / 256;
  const int blocks = want < 132 * 8 ? (int)want : 132 * 8;
  ssd_bwd_tc_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(pB), static_cast<const float*>(pC), pa, pd,
      static_cast<bf16*>(dB), static_cast<bf16*>(dC), static_cast<float*>(dA),
      static_cast<float*>(dD), B, S, H, G, N, nc, rpg);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// bf16 x, B, C, dy, dx, dB, dC (16-byte aligned); fp32 dt, A, D, h0 and
// dhT (either may be null: zeros; 8-byte aligned), ddt, dA, dD and dh0
// (null: not written).  Workspaces: hs and gs bf16 (B, nc, H, 2, P, N);
// pB, pC fp32 (B, S, G * ceil(H / G / R), N); pAD fp32 (2, B, nc, H);
// nc = ceil(S / Qb).  P in {32, 64}, N a multiple of 8 up to 128, 1 <=
// Qb <= 64, R >= 1 heads a run, H % G == 0, B, S, H >= 1.
extern "C" int ssd_scan_tc_bwd(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* D,
                               const void* h0, const void* dy,
                               const void* dhT, void* dx, void* ddt,
                               void* dA, void* dD, void* dB, void* dC,
                               void* dh0, void* hs, void* gs, void* pB,
                               void* pC, void* pAD, int B, int S, int H,
                               int G, int P, int N, int Qb, int R,
                               void* stream) {
  if (!((P == 32 || P == 64) && N >= 8 && N <= 128 && N % 8 == 0 &&
        Qb >= 1 && Qb <= kQ && R >= 1 && B >= 1 && S >= 1 && H >= 1 &&
        G >= 1 && H % G == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(P_, NP_)                                                     \
  launch_tc_bwd<P_, NP_>(x, dt, A, Bm, Cm, D, h0, dy, dhT, dx, ddt, dA, dD, \
                         dB, dC, dh0, hs, gs, pB, pC, pAD, B, S, H, G, N,   \
                         Qb, R, s)
  if (P == 32 && N <= 64) return (int)LAUNCH(32, 64);
  if (P == 32) return (int)LAUNCH(32, 128);
  if (N <= 64) return (int)LAUNCH(64, 64);
  return (int)LAUNCH(64, 128);
#undef LAUNCH
}
