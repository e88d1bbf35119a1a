// The RMSNorm backward (kernel C) for Hopper (sm_90a).  The RMSNorm
// forward (kernel B) is one instantiation of the norm forward in
// layernorm.cu.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Kernel C, the backward, replaces rmsnorm.py `_bwd_kernel` (through
// `_bwd_call`):
//   dx = rstd * (g*s - x * rstd^2 * mean(g*s*x))     per row
//   dscale = sum over rows of g * x * rstd            [h] fp32
// with the forward's saved rstd (not recomputed).
//
// Bound on this card: memory, x and g read once and dx written once,
// 3*n*h*sizeof(x) bytes plus rstd and the scale: 0.030 ms at n = h = 4096
// bf16 and 3.35 TB/s.
//
// Design: the TPU kernel carries dscale across its sequential grid in VMEM
// scratch; blocks here run in no order, so dscale takes two passes and no
// atomics.  Pass 1: each block walks a run of rows, one row at a time with
// 16-byte loads and a block reduction for the row's mean(g*s*x), writes dx,
// and accumulates g*x*rstd for the columns each thread owns in shared
// memory; at the end it writes its partial sums, one row of
// partial [nblocks, h] fp32.  Pass 2 sums the partials per column.  The
// summation order is fixed, so the result is the same on every run.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   const T* __restrict__ g, const float* __restrict__ rstd,
                   T* __restrict__ dx, float* __restrict__ partial, int n,
                   int h, int rows_per_block) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float ds_part[];   // [h], column c owned by one thread
  __shared__ float red[kThreads / 32];
  __shared__ float row_mean;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = h / kVec;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) ds_part[v * kVec + t] = 0.f;
  }
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);
  for (int row = row0; row < row1; ++row) {
    const float r = rstd[row];
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
    const uint4* gr = reinterpret_cast<const uint4*>(g + (size_t)row * h);
    float dot = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 xraw = xr[v], graw = gr[v];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const float xv = mlt::to_float(xe[t]), gv = mlt::to_float(ge[t]);
        dot += gv * mlt::to_float(scale[v * kVec + t]) * xv;
        ds_part[v * kVec + t] += gv * xv * r;
      }
    }
    dot = mlt::warp_sum(dot);
    if (lane == 0) red[warp] = dot;
    __syncthreads();
    if (warp == 0) {
      float s = lane < kThreads / 32 ? red[lane] : 0.f;
      s = mlt::warp_sum(s);
      if (lane == 0) row_mean = s / (float)h;
    }
    __syncthreads();
    const float m = row_mean;
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * h);
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 xraw = xr[v], graw = gr[v];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const float xv = mlt::to_float(xe[t]);
        const float gs = mlt::to_float(ge[t])
                         * mlt::to_float(scale[v * kVec + t]);
        o[t] = mlt::from_float<T>(r * (gs - xv * r * r * m));
      }
      dxr[v] = packed;
    }
  }
  // each thread wrote only its own columns: no barrier needed before it
  // reads them back
  float* out = partial + (size_t)blockIdx.x * h;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) out[v * kVec + t] = ds_part[v * kVec + t];
  }
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* x, const void* scale, const void* g,
                       const float* rstd, void* dx, float* partial,
                       float* dscale, int n, int h, int rows_per_block,
                       int nblocks, cudaStream_t stream) {
  const size_t smem = (size_t)h * sizeof(float);
  auto kernel = rmsnorm_bwd_kernel<T, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const T*>(g), rstd, static_cast<T*>(dx), partial, n, h,
      rows_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mlt::column_sum_kernel<kThreads>
      <<<(h + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          partial, dscale, nblocks, h);
  return cudaGetLastError();
}

}  // namespace

// x, g, dx: [n, h] row-major, 16-byte aligned, h a multiple of
// 16 / sizeof(x); scale: [h]; rstd: [n] fp32 from the forward;
// partial: [nblocks, h] fp32 scratch with nblocks * rows_per_block >= n;
// dscale: [h] fp32.  Returns a cudaError_t (0 on success).
extern "C" int mlt_rmsnorm_bwd(const void* x, const void* scale,
                               const void* g, const float* rstd, void* dx,
                               float* partial, float* dscale, int n, int h,
                               int rows_per_block, int nblocks, int x_dtype,
                               int scale_dtype, void* stream) {
  if (n <= 0 || h <= 0 || rows_per_block <= 0
      || (long long)nblocks * rows_per_block < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == mlt::kBFloat16 && scale_dtype == mlt::kBFloat16)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, scale, g, rstd, dx, partial, dscale, n, h, rows_per_block,
        nblocks, st);
  if (x_dtype == mlt::kBFloat16 && scale_dtype == mlt::kFloat32)
    return (int)launch_bwd<__nv_bfloat16, float>(
        x, scale, g, rstd, dx, partial, dscale, n, h, rows_per_block,
        nblocks, st);
  if (x_dtype == mlt::kFloat32 && scale_dtype == mlt::kFloat32)
    return (int)launch_bwd<float, float>(x, scale, g, rstd, dx, partial,
                                         dscale, n, h, rows_per_block,
                                         nblocks, st);
  return (int)cudaErrorInvalidValue;
}
