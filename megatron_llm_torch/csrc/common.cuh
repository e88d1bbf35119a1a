// Small device helpers shared by the port's CUDA kernels.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mlt {

// dtype codes of the C interface (ops/kernels/build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// butterfly sum: every lane of the warp ends with the total
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// butterfly max: every lane of the warp ends with the maximum
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[c] = sum over the rows of partial [nrows, width], one thread a
// column: the second pass of a reduction across blocks, in a fixed order.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
column_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int nrows, int width) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  float s = 0.f;
  for (int i = 0; i < nrows; ++i) s += partial[(size_t)i * width + c];
  out[c] = s;
}

}  // namespace mlt
