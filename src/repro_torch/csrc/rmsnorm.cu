// Row RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, body
// _kernel): y = x * rsqrt(mean(x^2) + eps) * scale per row, fp32 math,
// output in x's dtype.  The model calls it for the two block norms, the
// final norm, the gated norm of the Mamba2 blocks and qk-norm (rows =
// tokens * heads, d = head_dim).
//
// Bound on the H100: bytes.  A handful of flops per element against
// one read of x and one write of y (plus d scale values), so the floor
// is (2 * rows * d * itemsize + d * scale_itemsize) / 3.35 TB/s.
//
// Design against that bound: x is read from device memory once, into
// registers, and y written once, both as 16-byte vectors.
//  - A row belongs to a group of TPR threads; each thread holds NV
//    16-byte vectors of it (vector j of thread t covers elements
//    (j*TPR + t)*E .. +E-1, E = 16 / itemsize, so each load of a group
//    is contiguous).  The fp32 sum of squares is reduced by shuffles
//    within the group (and through shared memory for TPR = 256).
//  - d <= 2048: TPR <= 32 (a warp, or 4..16 lanes for the qk-norm's
//    d = 64), several rows a 128-thread block: 4 rows at d = 1024, 16 at
//    d = 64.  The block stages scale in shared memory as fp32 once (in
//    16-byte loads where it is aligned); its row groups read it there.
//  - d > 2048 (3072, 3584, 7168, up to 16384): one 256-thread block per
//    row, each thread reading its own slice of scale once (16-byte
//    vectors where scale has x's dtype and is aligned).
//  - Fewer rows than the H100 has SMs (decode: 8 rows) and a row of
//    more than 32 vectors: one 128-thread block per row instead, so the
//    few rows spread over as many SMs and each thread issues one to four
//    loads (8 x 1536 bf16: 8 blocks, not 2).
//  - A d that is not a multiple of E, or a pointer that is not 16-byte
//    aligned, takes the same register layout with scalar, bounds-checked
//    loads and stores (the kernel's `vec` = 0 branch).
// The sum of squares runs in another order than the plain version's; its
// terms and precision are the same.
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kNormThreads = 128;  // block size for TPR <= 128
constexpr int kNormMaxSmallD = 2048;
constexpr int kNormFewRows = 132;  // the H100's SMs
// bits of the kernel's `vec`: 16-byte loads and stores of x and y rows,
// 16-byte loads of scale
constexpr int kVecRows = 1, kVecScale = 2;

// 16 bytes <-> 16 / sizeof(T) floats, by bit operations (a reinterpret
// through a pointer would put the vector in local memory)
__device__ __forceinline__ void unpack16(uint4 w, float* v, float) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(uint4 w, float* v, __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // the low half is the lower address
    v[2 * k] = __uint_as_float(u[k] << 16);
    v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));  // nearest even
}
__device__ __forceinline__ uint4 pack16(const float* v, __nv_bfloat16) {
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v, bool vec,
                                         int valid) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    unpack16(*reinterpret_cast<const uint4*>(p), v, T());
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) v[i] = i < valid ? to_f32(p[i]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v, bool vec,
                                          int valid) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    *reinterpret_cast<uint4*>(p) = pack16(v, T());
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (i < valid) p[i] = from_f32<T>(v[i]);
  }
}

template <typename XT, typename ST, int TPR, int NV>
__global__ void __launch_bounds__(TPR > kNormThreads ? TPR : kNormThreads)
    rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
                   XT* __restrict__ out, int rows, int d, float eps,
                   int vec) {
  constexpr int E = 16 / sizeof(XT);
  constexpr int kThreads = TPR > kNormThreads ? TPR : kNormThreads;
  constexpr int kRowsPerBlock = kThreads / TPR;
  constexpr bool kStageScale = TPR <= 32;
  __shared__ float scale_s[kStageScale ? kNormMaxSmallD : 1];
  __shared__ float red[kThreads / 32];

  const int t = threadIdx.x % TPR;
  const size_t row = (size_t)blockIdx.x * kRowsPerBlock + threadIdx.x / TPR;
  const bool live = row < (size_t)rows;
  const XT* xr = x + row * d;
  XT* yr = out + row * d;

  float v[NV][E];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * TPR + t) * E;
    if (live && c < d) {
      load_vec(xr + c, v[j], vec & kVecRows, d - c);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) ss += v[j][i] * v[j][i];
  }
  if constexpr (kStageScale) {
    // the row loads above are in flight while the block stages scale
    if (vec & kVecScale) {
      constexpr int ES = 16 / sizeof(ST);
      for (int i = threadIdx.x * ES; i < d; i += kThreads * ES)
        load_vec(scale + i, scale_s + i, true, ES);
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads)
        scale_s[i] = to_f32(scale[i]);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    __syncthreads();
  } else {
    ss = warp_sum(ss);
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) ss += red[w];
  }
  if (!live) return;
  const float r = 1.0f / sqrtf(ss / (float)d + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * TPR + t) * E;
    if (c >= d) continue;
    float sc[E], y[E];
    if constexpr (kStageScale) {
#pragma unroll
      for (int i = 0; i < E; ++i) sc[i] = c + i < d ? scale_s[c + i] : 0.f;
    } else if constexpr (sizeof(ST) == sizeof(XT)) {
      load_vec(scale + c, sc, vec & kVecScale, d - c);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i)
        sc[i] = c + i < d ? to_f32(scale[c + i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) y[i] = v[j][i] * r * sc[i];
    store_vec(yr + c, y, vec & kVecRows, d - c);
  }
}

template <typename XT, typename ST, int TPR, int NV>
cudaError_t launch_rows(const void* x, const void* scale, void* out,
                        int rows, int d, float eps, int vec,
                        cudaStream_t s) {
  constexpr int kThreads = TPR > kNormThreads ? TPR : kNormThreads;
  constexpr int kRowsPerBlock = kThreads / TPR;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_kernel<XT, ST, TPR, NV><<<blocks, kThreads, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const ST*>(scale),
      static_cast<XT*>(out), rows, d, eps, vec);
  return cudaGetLastError();
}

// The group size and vectors per thread for width d: the smallest
// group (down to 4 threads) that covers a d <= 2048 row in at most 16
// vectors a thread, else a 256-thread block per row; a 128-thread block
// per row for a few rows of more than 32 vectors.
template <typename XT, typename ST>
cudaError_t launch_rmsnorm(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int vec,
                           cudaStream_t s) {
  constexpr int E = 16 / sizeof(XT);
  const int n_vec = (d + E - 1) / E;
#define ROWS(TPR, NV) \
  launch_rows<XT, ST, TPR, NV>(x, scale, out, rows, d, eps, vec, s)
  if (d <= kNormMaxSmallD && rows < kNormFewRows && n_vec > 32) {
    if (n_vec <= 128) return ROWS(128, 1);
    if (n_vec <= 256) return ROWS(128, 2);
    return ROWS(128, 4);  // fp32 rows: n_vec <= 512
  }
  if (d <= kNormMaxSmallD) {
    if (n_vec <= 4) return ROWS(4, 1);
    if (n_vec <= 8) return ROWS(8, 1);
    if (n_vec <= 16) return ROWS(16, 1);
    if (n_vec <= 32) return ROWS(32, 1);
    if (n_vec <= 64) return ROWS(32, 2);
    if (n_vec <= 128) return ROWS(32, 4);
    if (n_vec <= 256) return ROWS(32, 8);
    // only fp32 rows (E = 4) get here; no bf16 copy is compiled
    if constexpr (E == 4) return ROWS(32, 16);
    return cudaErrorInvalidValue;
  }
  if (n_vec <= 512) return ROWS(256, 2);
  if (n_vec <= 1024) return ROWS(256, 4);
  if (n_vec <= 2048) return ROWS(256, 8);
  if constexpr (E == 4)
    if (n_vec <= 4096) return ROWS(256, 16);
#undef ROWS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

using namespace repro;

// vec (the wrapper decides): bit 0 if d is a multiple of 16 / sizeof(x)
// and x, out are 16-byte aligned, else the rows take scalar loads and
// stores; bit 1 likewise for scale.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int x_dtype,
                           int scale_dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == kF32 && scale_dtype == kF32)
    e = launch_rmsnorm<float, float>(x, scale, out, rows, d, eps, vec, s);
  else if (x_dtype == kF32 && scale_dtype == kBF16)
    e = launch_rmsnorm<float, __nv_bfloat16>(x, scale, out, rows, d, eps,
                                             vec, s);
  else if (x_dtype == kBF16 && scale_dtype == kF32)
    e = launch_rmsnorm<__nv_bfloat16, float>(x, scale, out, rows, d, eps,
                                             vec, s);
  else if (x_dtype == kBF16 && scale_dtype == kBF16)
    e = launch_rmsnorm<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d,
                                                     eps, vec, s);
  return (int)e;
}
