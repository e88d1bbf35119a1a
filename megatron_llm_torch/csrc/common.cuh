// Small device helpers shared by the port's CUDA kernels.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace mlt {

// dtype codes of the C interface (ops/kernels/build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

// A source whose kernels are instantiated for every dtype is compiled once
// a dtype (ops/kernels/build.py passes -DMLT_PART=<dtype code>), so that
// the parts build in parallel; compiled without MLT_PART it holds every
// part.  MLT_IN_PART(code) says whether this object holds part `code`,
// and CodeType<code>::T is the part's element type.
#ifdef MLT_PART
#define MLT_IN_PART(code) (MLT_PART == (code))
#else
#define MLT_IN_PART(code) 1
#endif

template <int Code> struct CodeType;
template <> struct CodeType<kFloat32> { using T = float; };
template <> struct CodeType<kBFloat16> { using T = __nv_bfloat16; };
template <> struct CodeType<kFloat16> { using T = __half; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to nearest; past 65504 gives inf (an overflow stays visible)
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
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

}  // namespace mlt
