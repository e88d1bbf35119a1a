// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel megatron_llm_tpu/ops/pallas/rmsnorm.py
// `_fwd_kernel` (reached through `_fwd_call` and `fused_rms_norm`):
//   y = x * rsqrt(mean(x^2) + eps) * scale, accumulated in fp32,
//   y in the input's type, rstd [n, 1] fp32 kept for the backward.
//
// Bound on this card: memory, 2*n*h*sizeof(x) bytes (x read once, y
// written once) plus h scale values; at decode (n = 8 rows of h = 4096
// bf16) that is 131 KB, about 0.04 us at 3.35 TB/s, so the launch
// latency (a few us) is the real floor there.
//
// Design: one block of 256 threads per row.  Each thread reads 16-byte
// vectors (8 bf16 or 4 fp32 values), the sum of squares is reduced by
// warp shuffles and one shared-memory step, and the second pass re-reads
// the row (an L1/L2 hit) to scale and store it with 16-byte writes.  The
// Pallas kernel's row blocks sized for VMEM have no counterpart here: a
// row is one block, and the grid of n blocks spreads over the SMs.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd, int h,
                   float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * h);
  const int nvec = h / kVec;

  float ss = 0.f;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 raw = xr[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float f = mlt::to_float(e[t]);
      ss += f * f;
    }
  }
  __shared__ float partial[kThreads / 32];
  __shared__ float row_rstd;
  ss = mlt::warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? partial[lane] : 0.f;
    v = mlt::warp_sum(v);
    if (lane == 0) {
      const float r = rsqrtf(v / (float)h + eps);
      row_rstd = r;
      rstd[row] = r;
    }
  }
  __syncthreads();
  const float r = row_rstd;

  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 raw = xr[v];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float s = mlt::to_float(scale[v * kVec + t]);
      o[t] = mlt::from_float<T>(mlt::to_float(e[t]) * r * s);
    }
    yr[v] = packed;
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* y, float* rstd,
                   int n, int h, float eps, cudaStream_t stream) {
  rmsnorm_fwd_kernel<T, S><<<n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rstd, h, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, h] row-major, 16-byte aligned, h a multiple of 16 / sizeof(x);
// scale: [h]; rstd: [n] fp32.  Returns a cudaError_t (0 on success).
extern "C" int mlt_rmsnorm_fwd(const void* x, const void* scale, void* y,
                               float* rstd, int n, int h, float eps,
                               int x_dtype, int scale_dtype, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == mlt::kBFloat16 && scale_dtype == mlt::kBFloat16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rstd, n, h,
                                                     eps, st);
  if (x_dtype == mlt::kBFloat16 && scale_dtype == mlt::kFloat32)
    return (int)launch<__nv_bfloat16, float>(x, scale, y, rstd, n, h, eps,
                                             st);
  if (x_dtype == mlt::kFloat32 && scale_dtype == mlt::kFloat32)
    return (int)launch<float, float>(x, scale, y, rstd, n, h, eps, st);
  return (int)cudaErrorInvalidValue;
}
