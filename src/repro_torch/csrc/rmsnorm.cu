// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, body
// _kernel): y = x * rsqrt(mean(x^2) + eps) * scale per row, fp32 math,
// output in x's dtype.  The model calls it for the two block norms, the
// final norm, and qk-norm (rows = tokens * heads, d = head_dim).
//
// Bound on the H100: bytes.  A handful of flops per element against
// one read of x and one write of y (plus d scale values), so the floor
// is (2 * rows * d * itemsize + d * scale_itemsize) / 3.35 TB/s.
//
// Design against that bound: one block per row, any number of rows,
// d up to 16k.  The first pass reads the row once, each thread keeping
// an fp32 partial sum of squares, reduced by warp shuffles and one
// shared-memory step; the second pass re-reads the row (from L1/L2, it
// was just touched) and writes y.  Device memory sees x once and y
// once.
#include "common.cuh"

namespace repro {

template <typename XT, typename ST>
__global__ void rmsnorm_kernel(const XT* __restrict__ x,
                               const ST* __restrict__ scale,
                               XT* __restrict__ out, int d, float eps) {
  const size_t row = blockIdx.x;
  const XT* xr = x + row * d;
  XT* yr = out + row * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __shared__ float red[32];

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < n_warps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float r = 1.0f / sqrtf(red[0] / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    yr[i] = from_f32<XT>(to_f32(xr[i]) * r * to_f32(scale[i]));
}

template <typename XT, typename ST>
cudaError_t launch_rmsnorm(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, cudaStream_t s) {
  const int threads = d >= 4096 ? 512 : d >= 1024 ? 256 : d >= 256 ? 128
                                                                    : 32;
  rmsnorm_kernel<XT, ST><<<rows, threads, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale),
      static_cast<XT*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace repro

using namespace repro;

extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int x_dtype,
                           int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == kF32 && scale_dtype == kF32)
    e = launch_rmsnorm<float, float>(x, scale, out, rows, d, eps, s);
  else if (x_dtype == kF32 && scale_dtype == kBF16)
    e = launch_rmsnorm<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  else if (x_dtype == kBF16 && scale_dtype == kF32)
    e = launch_rmsnorm<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  else if (x_dtype == kBF16 && scale_dtype == kBF16)
    e = launch_rmsnorm<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d,
                                                     eps, s);
  return (int)e;
}
