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
//  1. one block per run of consecutive rows (at most 528 blocks, four per
//     SM): per row, a block reduction of sum(x^2) and sum(g * x), then dx
//     written once; each thread adds its columns' dy * x * r into a
//     shared-memory row of d floats, written once at the end as the
//     block's partial sums into an fp32 (blocks, d) buffer;
//  2. dscale[c] = the partial sums of column c added over the blocks in
//     block order.  No atomics: the same inputs give the same bits.
//
// Bound on the H100: bytes (a few flops per element): x and dy read, dx
// written, scale read and dscale written once, at 3.35 TB/s.  The design
// reads each row of x and dy from device memory once (the second pass
// over a row hits L1), keeps the column sums on chip until the end, and
// spends one extra (blocks, d) fp32 round trip on the fixed-order sum.
#include "common.cuh"

namespace repro {
namespace {

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
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * d + c];
  dscale[c] = from_f32<ST>(s);
}

template <typename XT, typename ST>
cudaError_t launch_bwd(const void* x, const void* scale, const void* dy,
                       void* dx, void* dscale, void* partial, int rows, int d,
                       float eps, int blocks, cudaStream_t s) {
  const int smem = d * (int)sizeof(float);
  static bool opted_in = false;  // once, before any launch (graph capture)
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<XT, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 16384 * 4);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const int per = (rows + blocks - 1) / blocks;
  const int threads = d >= 256 ? 256 : (d + 31) / 32 * 32;
  rmsnorm_bwd_kernel<XT, ST><<<blocks, threads, smem, s>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale),
      static_cast<const XT*>(dy), static_cast<XT*>(dx),
      static_cast<float*>(partial), rows, d, eps, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rmsnorm_bwd_reduce_kernel<ST><<<(d + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<ST*>(dscale), blocks,
      d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

using namespace repro;

// x, dy, dx in x_dtype; scale, dscale in scale_dtype; partial an fp32
// (blocks, d) workspace (a block past the last row writes zero sums).
// d <= 16384.
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
