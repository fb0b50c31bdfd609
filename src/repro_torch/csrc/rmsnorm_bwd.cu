// Backward of the port's row RMSNorm (sm_90a).
//
// The JAX package has no backward Pallas kernel: XLA differentiates its
// jnp RMSNorm.  This is the gradient of rmsnorm.cu's forward (which
// replaces src/repro/kernels/rmsnorm.py rmsnorm), y = x * r * scale with
// r = rsqrt(mean(x^2) + eps), held against autograd of the plain version
// kernels/ref.rmsnorm_ref.  With g = dy * scale, all in fp32:
//   dx     = r * g - x * r^3 * mean(g * x)        (per row)
//   dscale = sum over rows of dy * x * r
// r is recomputed here from x (the forward saves nothing), with the
// forward's formula 1 / sqrtf(sum(x^2) / d + eps).
//
// Two launches:
//  1. rows of d <= kWarpMaxD (1024, 32 elements a lane): one warp per
//     row, kWarps (16) warps a block, each block a run of consecutive
//     rows (the wrapper's blocks, at most one per SM), warp w taking the
//     block's rows w, w + 16, ...  A lane owns the fixed columns
//     8 (32 j + lane) .. +7 (j < ceil(d / 256)), so a row's x and dy sit
//     in its registers (16-byte vectors where d % 8 == 0 and x, dy, dx
//     start on 16-byte boundaries, scalars otherwise), sum(x^2) and
//     sum(g * x) are warp shuffles with no block-wide sync, dx is written
//     from the registers, and the lane's dscale partial sums stay in
//     registers across all its warp's rows.  At the end the warps add
//     theirs in warp order through shared memory, once, into the block's
//     row of an fp32 (blocks, d) buffer.  Wider rows (up to 16384) take a
//     team of 256 threads (1024 beyond 8192) per row, two teams a block
//     (one beyond 8192) and a run of rows a block: the row's x and dy in
//     the team's registers (the same vectors or scalars), the team's next
//     row's loads in flight while this row is reduced, one shared-memory
//     exchange a row, dx from the registers, the column sums in the owner
//     threads' registers, added in team order once at the end into the
//     block's row of the (blocks, d) buffer;
//  2. dscale[c] = the partial sums of column c added over the blocks in
//     block order (16 loads in flight a thread).  No atomics: the same
//     inputs give the same bits.
//
// Bound on the H100: bytes (a few flops per element): x and dy read, dx
// written, scale read and dscale written once, at 3.35 TB/s.  Each row
// is read from device memory once and written once, as 16-byte vectors;
// the per-row work needs no sync beyond the warp, and the column sums
// stay on chip until one (blocks, d) fp32 round trip for the
// fixed-order sum.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 16;       // warps of a warp-per-row block
constexpr int kWarpMaxD = 1024;  // widest row a warp holds: 32 values a lane

// 8 values of a row from column col: 16-byte vectors (kVec: d % 8 == 0
// and the row 16-byte aligned) or scalars, zeros past d
template <bool kVec>
__device__ __forceinline__ void load8(const float* p, int col, int d,
                                      float (&f)[8]) {
  if constexpr (kVec) {
    const float4 a = *reinterpret_cast<const float4*>(p + col);
    const float4 b = *reinterpret_cast<const float4*>(p + col + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = col + e < d ? p[col + e] : 0.f;
  }
}
template <bool kVec>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int col, int d,
                                      float (&f)[8]) {
  if constexpr (kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + col);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = col + e < d ? __bfloat162float(p[col + e]) : 0.f;
  }
}
template <bool kVec>
__device__ __forceinline__ void store8(float* p, int col, int d,
                                       const float (&f)[8]) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p + col) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(p + col + 4) =
        make_float4(f[4], f[5], f[6], f[7]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < d) p[col + e] = f[e];
  }
}
template <bool kVec>
__device__ __forceinline__ void store8(__nv_bfloat16* p, int col, int d,
                                       const float (&f)[8]) {
  if constexpr (kVec) {
    uint4 u;
    u.x = pack_bf16(f[0], f[1]);
    u.y = pack_bf16(f[2], f[3]);
    u.z = pack_bf16(f[4], f[5]);
    u.w = pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(p + col) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < d) p[col + e] = __float2bfloat16(f[e]);
  }
}

// rows of d <= kWarpMaxD, one warp per row; kChunks = ceil(d / 256)
template <typename XT, typename ST, int kChunks, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, 1) rmsnorm_bwd_warp_kernel(
    const XT* __restrict__ x, const ST* __restrict__ scale,
    const XT* __restrict__ dy, XT* __restrict__ dx,
    float* __restrict__ partial, int rows, int d, float eps,
    int rows_per_block) {
  extern __shared__ float sm[];  // scale (d), then the warps' partials
  float* sc = sm;
  float* red = sm + d;           // kWarps rows of d
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < d; c += blockDim.x) sc[c] = to_f32(scale[c]);
  __syncthreads();

  float acc[kChunks][8];
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0 + w; row < r1; row += kWarps) {
    const XT* xr = x + (size_t)row * d;
    const XT* gr = dy + (size_t)row * d;
    float xv[kChunks][8], gv[kChunks][8];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 8 * (32 * j + lane);
      if (col < d) {
        load8<kVec>(xr, col, d, xv[j]);
        load8<kVec>(gr, col, d, gv[j]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) xv[j][e] = gv[j][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s_ = col + e < d ? sc[col + e] : 0.f;
        ss += xv[j][e] * xv[j][e];
        gx += gv[j][e] * s_ * xv[j][e];
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    const float coef = gx * r * r * r / (float)d;
    XT* dxr = dx + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 8 * (32 * j + lane);
      if (col >= d) continue;
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s_ = col + e < d ? sc[col + e] : 0.f;
        out[e] = r * (gv[j][e] * s_) - coef * xv[j][e];
        acc[j][e] += gv[j][e] * (xv[j][e] * r);
      }
      store8<kVec>(dxr, col, d, out);
    }
  }

  // the block's dscale partials: the warps' sums added in warp order
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = 8 * (32 * j + lane) + e;
      if (col < d) red[w * d + col] = acc[j][e];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s_ = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s_ += red[i * d + c];
    partial[(size_t)blockIdx.x * d + c] = s_;
  }
}

// 8 values of a row as loaded: a 16-byte vector of bf16, or two of fp32
template <typename XT> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 v; };
template <> struct Raw8<float> { float4 a, b; };

template <bool kVec>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, int col,
                                         int d, Raw8<__nv_bfloat16>& r) {
  if constexpr (kVec) {
    r.v = *reinterpret_cast<const uint4*>(p + col);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = col + 2 * i;
      __nv_bfloat162 t;
      t.x = c < d ? p[c] : __float2bfloat16(0.f);
      t.y = c + 1 < d ? p[c + 1] : __float2bfloat16(0.f);
      w[i] = *reinterpret_cast<uint32_t*>(&t);
    }
    r.v = make_uint4(w[0], w[1], w[2], w[3]);
  }
}
template <bool kVec>
__device__ __forceinline__ void load_raw(const float* p, int col, int d,
                                         Raw8<float>& r) {
  float f[8];
  load8<kVec>(p, col, d, f);
  r.a = make_float4(f[0], f[1], f[2], f[3]);
  r.b = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r,
                                       float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float (&f)[8]) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}
template <typename XT>
__device__ __forceinline__ void zero_raw(Raw8<XT>& r) {
  r = Raw8<XT>{};
}

// a team's threads only (barrier 0 is the block's __syncthreads)
template <int T, int kTeams>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (kTeams == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(T) : "memory");
}

// rows wider than kWarpMaxD: a team of T threads per row, kTeams teams a
// block, a run of rows a block (team t taking its rows t, t + kTeams,
// ...).  Thread i of a team holds columns 8 (T j + i) .. +7 of x and dy
// (j < kChunks) in registers, as loaded: teams of 256 hold rows up to
// 2048 values in one chunk (four teams a SM), 4096 in two and 8192 in
// four (32 values of x and of dy a thread; two teams a SM), a team of
// 1024 up to MAX_D = 16384 in two.  The team's next row's loads are
// issued before this row's sums, so two rows a team are in flight; one
// shared-memory exchange a row (red double-buffered: the row after
// writes the other half, so no second barrier); dx from the registers.
// Each column has one owner thread a team, whose dscale partial stays
// in registers over the team's rows; at the end the teams' partials are
// added in team order into the block's row of the (blocks, d) buffer
template <typename XT, typename ST, int T, int kTeams, int kChunks,
          bool kVec>
__global__ void __launch_bounds__(T * kTeams, kChunks == 1 ? 2 : 1)
    rmsnorm_bwd_row_kernel(
    const XT* __restrict__ x, const ST* __restrict__ scale,
    const XT* __restrict__ dy, XT* __restrict__ dx,
    float* __restrict__ partial, int rows, int d, float eps,
    int rows_per_block) {
  constexpr int NW = T / 32;
  // d floats of scale, then (kTeams > 1) each team's d dscale partials
  extern __shared__ float sc[];
  // [team][row parity][sum x^2, sum g x][warp]
  __shared__ float red[kTeams][2][2][NW];
  const int team = threadIdx.x / T, tid = threadIdx.x % T;
  const int lane = tid & 31, w = tid >> 5;
  for (int c = threadIdx.x; c < d; c += T * kTeams) sc[c] = to_f32(scale[c]);

  float acc[kChunks][8];
#pragma unroll
  for (int j = 0; j < kChunks; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.f;

  const int first = (int)blockIdx.x * rows_per_block;
  const int r0 = first + team, r1 = min(rows, first + rows_per_block);
  Raw8<XT> xr[kChunks], gr[kChunks];
  auto load_row = [&](int row, Raw8<XT> (&xa)[kChunks],
                      Raw8<XT> (&ga)[kChunks]) {
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 8 * (T * j + tid);
      if (col < d) {
        load_raw<kVec>(x + (size_t)row * d, col, d, xa[j]);
        load_raw<kVec>(dy + (size_t)row * d, col, d, ga[j]);
      } else {
        zero_raw(xa[j]);
        zero_raw(ga[j]);
      }
    }
  };
  if (r0 < r1) load_row(r0, xr, gr);
  __syncthreads();  // sc visible
  int par = 0;
  for (int row = r0; row < r1; row += kTeams) {
    Raw8<XT> xn[kChunks], gn[kChunks];
    if (row + kTeams < r1) load_row(row + kTeams, xn, gn);
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 8 * (T * j + tid);
      if (col >= d) continue;
      float xv[8], gv[8];
      unpack(xr[j], xv);
      unpack(gr[j], gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s_ = kVec || col + e < d ? sc[col + e] : 0.f;
        ss += xv[e] * xv[e];
        gx += gv[e] * s_ * xv[e];
      }
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if (lane == 0) {
      red[team][par][0][w] = ss;
      red[team][par][1][w] = gx;
    }
    team_sync<T, kTeams>(team);
    ss = gx = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      ss += red[team][par][0][i];
      gx += red[team][par][1][i];
    }
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    const float coef = gx * r * r * r / (float)d;
    XT* dxr = dx + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int col = 8 * (T * j + tid);
      if (col >= d) continue;
      float xv[8], gv[8], out[8];
      unpack(xr[j], xv);
      unpack(gr[j], gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float s_ = kVec || col + e < d ? sc[col + e] : 0.f;
        out[e] = r * (gv[e] * s_) - coef * xv[e];
        acc[j][e] += gv[e] * (xv[e] * r);
      }
      store8<kVec>(dxr, col, d, out);
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      xr[j] = xn[j];
      gr[j] = gn[j];
    }
    par ^= 1;
  }
  // the block's dscale partials: the teams' added in team order
  float* pr = partial + (size_t)blockIdx.x * d;
  float* mine = kTeams == 1 ? pr : sc + (1 + team) * d;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int col = 8 * (T * j + tid);
    if (col < d) store8<kVec>(mine, col, d, acc[j]);
  }
  if constexpr (kTeams > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += T * kTeams) {
      float s_ = 0.f;
#pragma unroll
      for (int t = 0; t < kTeams; ++t) s_ += sc[(1 + t) * d + c];
      pr[c] = s_;
    }
  }
}

template <typename ST>
__global__ void rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial,
                                          ST* __restrict__ dscale, int blocks,
                                          int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  int b = 0;
  for (; b + 16 <= blocks; b += 16) {  // block order, 16 loads in flight
    float t[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) t[u] = partial[(size_t)(b + u) * d + c];
#pragma unroll
    for (int u = 0; u < 16; ++u) s += t[u];
  }
  for (; b < blocks; ++b) s += partial[(size_t)b * d + c];
  dscale[c] = from_f32<ST>(s);
}

template <typename XT, typename ST, int kChunks, bool kVec>
cudaError_t launch_warp(const XT* x, const ST* scale, const XT* dy, XT* dx,
                        float* partial, int rows, int d, float eps,
                        int blocks, cudaStream_t s) {
  static bool opted_in = false;  // once, before any launch (graph capture)
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_warp_kernel<XT, ST, kChunks, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kWarps + 1) * kWarpMaxD * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int per = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_warp_kernel<XT, ST, kChunks, kVec>
      <<<blocks, kWarps * 32, (kWarps + 1) * d * (int)sizeof(float), s>>>(
          x, scale, dy, dx, partial, rows, d, eps, per);
  return cudaGetLastError();
}

template <typename XT, typename ST, bool kVec>
cudaError_t launch_warp_d(const XT* x, const ST* scale, const XT* dy, XT* dx,
                          float* partial, int rows, int d, float eps,
                          int blocks, cudaStream_t s) {
#define WARP(n) launch_warp<XT, ST, n, kVec>(x, scale, dy, dx, partial, \
                                               rows, d, eps, blocks, s)
  switch ((d + 255) / 256) {
    case 1: return WARP(1);
    case 2: return WARP(2);
    case 3: return WARP(3);
    default: return WARP(4);
  }
#undef WARP
}

template <typename XT, typename ST, int T, int kTeams, int kChunks,
          bool kVec>
cudaError_t launch_row(const XT* x, const ST* scale, const XT* dy, XT* dx,
                       float* partial, int rows, int d, float eps,
                       int blocks, cudaStream_t s) {
  static bool opted_in = false;  // once, before any launch (graph capture)
  const int smem = (kTeams == 1 ? 1 : 1 + kTeams) * d * (int)sizeof(float);
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_row_kernel<XT, ST, T, kTeams, kChunks, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kTeams == 1 ? 1 : 1 + kTeams) * 16384 * (int)sizeof(float));
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int per = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_row_kernel<XT, ST, T, kTeams, kChunks, kVec>
      <<<blocks, T * kTeams, smem, s>>>(x, scale, dy, dx, partial, rows, d,
                                        eps, per);
  return cudaGetLastError();
}

template <typename XT, typename ST, bool kVec>
cudaError_t launch_row_d(const XT* x, const ST* scale, const XT* dy, XT* dx,
                         float* partial, int rows, int d, float eps,
                         int blocks, cudaStream_t s) {
#define ROW(T_, teams, n)                                                   \
  launch_row<XT, ST, T_, teams, n, kVec>(x, scale, dy, dx, partial, rows, \
                                         d, eps, blocks, s)
  if (d <= 2048) return ROW(256, 2, 1);
  if (d <= 4096) return ROW(256, 2, 2);
  if (d <= 8192) return ROW(256, 2, 4);
  return ROW(1024, 1, 2);
#undef ROW
}

template <typename XT, typename ST>
cudaError_t launch_bwd(const void* x_, const void* scale_, const void* dy_,
                       void* dx_, void* dscale, void* partial_, int rows,
                       int d, float eps, int blocks, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(x_);
  const ST* scale = static_cast<const ST*>(scale_);
  const XT* dy = static_cast<const XT*>(dy_);
  XT* dx = static_cast<XT*>(dx_);
  float* partial = static_cast<float*>(partial_);
  // 16-byte vectors where d % 8 == 0 and every row of x, dy, dx starts on
  // a 16-byte boundary; scalars otherwise
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(dy) |
                                   reinterpret_cast<uintptr_t>(dx)) &
                                  15) == 0;
  cudaError_t e;
  if (d <= kWarpMaxD)
    e = vec ? launch_warp_d<XT, ST, true>(x, scale, dy, dx, partial, rows, d,
                                          eps, blocks, s)
            : launch_warp_d<XT, ST, false>(x, scale, dy, dx, partial, rows,
                                           d, eps, blocks, s);
  else
    e = vec ? launch_row_d<XT, ST, true>(x, scale, dy, dx, partial, rows, d,
                                         eps, blocks, s)
            : launch_row_d<XT, ST, false>(x, scale, dy, dx, partial, rows, d,
                                          eps, blocks, s);
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_reduce_kernel<ST><<<(d + 255) / 256, 256, 0, s>>>(
      partial, static_cast<ST*>(dscale), blocks, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// x, dy, dx in x_dtype; scale, dscale in scale_dtype; partial an fp32
// (blocks, d) workspace (a block past the last row writes zero sums).
// d <= 16384; rows of d <= 1024 take a warp each, kWarps a block.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* dscale, void* partial, int rows,
                           int d, float eps, int x_dtype, int scale_dtype,
                           int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > 16384 || rows <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
#define BWD(XT, ST) \
  launch_bwd<XT, ST>(x, scale, dy, dx, dscale, partial, rows, d, eps, \
                     blocks, s)
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == kF32 && scale_dtype == kF32)
    e = BWD(float, float);
  else if (x_dtype == kF32 && scale_dtype == kBF16)
    e = BWD(float, __nv_bfloat16);
  else if (x_dtype == kBF16 && scale_dtype == kF32)
    e = BWD(__nv_bfloat16, float);
  else if (x_dtype == kBF16 && scale_dtype == kBF16)
    e = BWD(__nv_bfloat16, __nv_bfloat16);
#undef BWD
  return (int)e;
}
