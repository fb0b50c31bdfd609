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
//     block per row: a run of rows a block, two block reductions a row,
//     the column sums in shared memory;
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

// rows wider than kWarpMaxD: a block per row, a run of rows a block
template <typename XT, typename ST>
__global__ void rmsnorm_bwd_kernel(const XT* __restrict__ x,
                                   const ST* __restrict__ scale,
                                   const XT* __restrict__ dy,
                                   XT* __restrict__ dx,
                                   float* __restrict__ partial, int rows,
                                   int d, float eps, int rows_per_block) {
  extern __shared__ float acc[];  // d floats: this block's dscale sums
  __shared__ float red[2][32];
  const int nw = blockDim.x / 32, lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < d; c += blockDim.x) acc[c] = 0.f;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const XT* xr = x + (size_t)row * d;
    const XT* gr = dy + (size_t)row * d;
    float ss = 0.f, gx = 0.f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xv = to_f32(xr[c]);
      ss += xv * xv;
      gx += to_f32(gr[c]) * to_f32(scale[c]) * xv;
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    if (lane == 0) {
      red[0][w] = ss;
      red[1][w] = gx;
    }
    __syncthreads();
    ss = gx = 0.f;
    for (int i = 0; i < nw; ++i) {
      ss += red[0][i];
      gx += red[1][i];
    }
    __syncthreads();  // red is refilled by the next row
    const float r = 1.0f / sqrtf(ss / (float)d + eps);
    const float coef = gx * r * r * r / (float)d;
    XT* dxr = dx + (size_t)row * d;
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float xv = to_f32(xr[c]), dyv = to_f32(gr[c]);
      dxr[c] = from_f32<XT>(r * (dyv * to_f32(scale[c])) - coef * xv);
      acc[c] += dyv * (xv * r);  // each column has one owner thread
    }
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    partial[(size_t)blockIdx.x * d + c] = acc[c];
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

template <typename XT, typename ST>
cudaError_t launch_bwd(const void* x_, const void* scale_, const void* dy_,
                       void* dx_, void* dscale, void* partial_, int rows,
                       int d, float eps, int blocks, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(x_);
  const ST* scale = static_cast<const ST*>(scale_);
  const XT* dy = static_cast<const XT*>(dy_);
  XT* dx = static_cast<XT*>(dx_);
  float* partial = static_cast<float*>(partial_);
  cudaError_t e;
  if (d <= kWarpMaxD) {
    const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(x) |
                                     reinterpret_cast<uintptr_t>(dy) |
                                     reinterpret_cast<uintptr_t>(dx)) &
                                    15) == 0;
    e = vec ? launch_warp_d<XT, ST, true>(x, scale, dy, dx, partial, rows, d,
                                          eps, blocks, s)
            : launch_warp_d<XT, ST, false>(x, scale, dy, dx, partial, rows,
                                           d, eps, blocks, s);
  } else {
    static bool opted_in = false;  // once, before any launch
    if (!opted_in) {
      e = cudaFuncSetAttribute(rmsnorm_bwd_kernel<XT, ST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               16384 * 4);
      if (e != cudaSuccess) return e;
      opted_in = true;
    }
    const int per = (rows + blocks - 1) / blocks;
    rmsnorm_bwd_kernel<XT, ST><<<blocks, 256, d * (int)sizeof(float), s>>>(
        x, scale, dy, dx, partial, rows, d, eps, per);
    e = cudaGetLastError();
  }
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
