// Fused LayerNorm forward (kernel D) and backward (kernel E, further down)
// for Hopper (sm_90a).
//
// The forward replaces the TPU kernel megatron_llm_tpu/ops/pallas/layernorm.py
// `_fwd_kernel` (reached through `_fwd_call` and `fused_layer_norm`):
//   mu = mean(x), rstd = rsqrt(mean((x - mu)^2) + eps),
//   y = (x - mu) * rstd * gamma + beta, accumulated in fp32,
//   y in the input's type, mu and rstd [n, 1] fp32 kept for the backward.
//
// Bound on this card: memory, 2*n*h*sizeof(x) bytes (x read once, y
// written once) plus gamma, beta and the two statistics.
//
// Design: one block of 256 threads per row.  The variance is the mean of
// the squared deviations from the mean, as the TPU kernel takes it (not
// E[x^2] - mu^2, which loses the fp32 digits of a row with a large mean),
// so the row is needed twice after its mean is known.  It is read from
// device memory once, with 16-byte loads, and kept as fp32 in shared
// memory ([h] floats: 18 KB for Falcon-7B's 4544); the deviations and the
// output are computed from that copy.  Each thread re-reads only the
// elements it stored itself, so the only barriers are those of the two
// block reductions.  Any h that is a multiple of the 16-byte vector works:
// the loops stride over the row's vectors and the tail is a shorter trip.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// Sum over the block; every thread gets the total.  `red` holds one float
// per warp and is free again on return.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = mlt::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < kWarpsPerBlock ? red[lane] : 0.f;
  t = mlt::warp_sum(t);
  __syncthreads();
  return t;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ gamma,
                     const S* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mu_out, float* __restrict__ rstd_out,
                     int h, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float row_f[];   // [h], element c owned by one thread
  __shared__ float red[kWarpsPerBlock];
  const int row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * h);
  const int nvec = h / kVec;

  float s = 0.f;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    const uint4 raw = xr[v];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float f = mlt::to_float(e[t]);
      row_f[v * kVec + t] = f;
      s += f;
    }
  }
  const float mu = block_sum(s, red) / (float)h;

  float ss = 0.f;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const float c = row_f[v * kVec + t] - mu;
      ss += c * c;
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / (float)h + eps);
  if (threadIdx.x == 0) {
    mu_out[row] = mu;
    rstd_out[row] = r;
  }

  for (int v = threadIdx.x; v < nvec; v += kThreads) {
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = v * kVec + t;
      o[t] = mlt::from_float<T>((row_f[c] - mu) * r * mlt::to_float(gamma[c])
                                + mlt::to_float(beta[c]));
    }
    yr[v] = packed;
  }
}

template <typename T, typename S>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta,
                       void* y, float* mu, float* rstd, int n, int h,
                       float eps, cudaStream_t stream) {
  const size_t smem = (size_t)h * sizeof(float);
  auto kernel = layernorm_fwd_kernel<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(gamma),
      static_cast<const S*>(beta), static_cast<T*>(y), mu, rstd, h, eps);
  return cudaGetLastError();
}

// Kernel E, the backward, replaces layernorm.py `_bwd_kernel` (through
// `_bwd_call`), with the forward's saved mu and rstd (not recomputed):
//   xhat = (x - mu) * rstd, ggam = g * gamma
//   dx = rstd * (ggam - mean(ggam) - xhat * mean(ggam * xhat))   per row
//   dgamma = sum over rows of g * xhat, dbeta = sum over rows of g  [h] fp32
//
// Bound on this card: memory, x and g read once and dx written once,
// 3*n*h*sizeof(x) bytes plus the statistics, gamma and the two [h] sums.
//
// Design: the TPU kernel carries dgamma and dbeta across its sequential
// grid in VMEM scratch; blocks here run in no order, so they take two
// passes and no atomics, as the RMSNorm backward does.  Pass 1: each block
// walks a run of rows, one row at a time with 16-byte loads; one block
// reduction gives the row's two means at once, then dx is written, and
// g * xhat and g are added into the columns each thread owns in shared
// memory ([2, h] fp32).  Only rows below n are visited, so no padded row
// enters the sums.  At the end the block writes its partial sums, one row
// of partial [nblocks, 2h] fp32.  Pass 2 sums the partials per column:
// the first h columns are dgamma, the next h dbeta.  The summation order
// is fixed, so the result is the same on every run.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ gamma,
                     const T* __restrict__ g, const float* __restrict__ mu,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ partial, int n, int h,
                     int rows_per_block) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float part[];    // [2, h]: dgamma then dbeta columns
  __shared__ float red1[kWarpsPerBlock], red2[kWarpsPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dg_part = part;
  float* db_part = part + h;
  const int nvec = h / kVec;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      dg_part[v * kVec + t] = 0.f;
      db_part[v * kVec + t] = 0.f;
    }
  }
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);
  for (int row = row0; row < row1; ++row) {
    const float m = mu[row], r = rstd[row];
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
    const uint4* gr = reinterpret_cast<const uint4*>(g + (size_t)row * h);
    float s1 = 0.f, s2 = 0.f;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 xraw = xr[v], graw = gr[v];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const int c = v * kVec + t;
        const float xhat = (mlt::to_float(xe[t]) - m) * r;
        const float gv = mlt::to_float(ge[t]);
        const float ggam = gv * mlt::to_float(gamma[c]);
        s1 += ggam;
        s2 += ggam * xhat;
        dg_part[c] += gv * xhat;
        db_part[c] += gv;
      }
    }
    s1 = mlt::warp_sum(s1);
    s2 = mlt::warp_sum(s2);
    if (lane == 0) {
      red1[warp] = s1;
      red2[warp] = s2;
    }
    __syncthreads();
    float t1 = lane < kWarpsPerBlock ? red1[lane] : 0.f;
    float t2 = lane < kWarpsPerBlock ? red2[lane] : 0.f;
    const float m1 = mlt::warp_sum(t1) / (float)h;
    const float m2 = mlt::warp_sum(t2) / (float)h;
    __syncthreads();   // red1/red2 are free for the next row
    uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * h);
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 xraw = xr[v], graw = gr[v];
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const int c = v * kVec + t;
        const float xhat = (mlt::to_float(xe[t]) - m) * r;
        const float ggam = mlt::to_float(ge[t]) * mlt::to_float(gamma[c]);
        o[t] = mlt::from_float<T>(r * (ggam - m1 - xhat * m2));
      }
      dxr[v] = packed;
    }
  }
  // each thread wrote only its own columns: no barrier needed before it
  // reads them back
  float* out = partial + (size_t)blockIdx.x * 2 * h;
  for (int v = threadIdx.x; v < nvec; v += kThreads) {
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const int c = v * kVec + t;
      out[c] = dg_part[c];
      out[h + c] = db_part[c];
    }
  }
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* g,
                       const float* mu, const float* rstd, void* dx,
                       float* partial, float* dgamma_dbeta, int n, int h,
                       int rows_per_block, int nblocks, cudaStream_t stream) {
  const size_t smem = (size_t)2 * h * sizeof(float);
  auto kernel = layernorm_bwd_kernel<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(gamma),
      static_cast<const T*>(g), mu, rstd, static_cast<T*>(dx), partial, n, h,
      rows_per_block);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = 2 * h;
  mlt::column_sum_kernel<kThreads>
      <<<(width + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          partial, dgamma_dbeta, nblocks, width);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, h] row-major, 16-byte aligned, h a multiple of 16 / sizeof(x);
// gamma, beta: [h] of one type; mu, rstd: [n] fp32.  Returns a cudaError_t
// (0 on success).
extern "C" int mlt_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, float* mu,
                                 float* rstd, int n, int h, float eps,
                                 int x_dtype, int param_dtype, void* stream) {
  if (n <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == mlt::kBFloat16 && param_dtype == mlt::kBFloat16)
    return (int)launch_fwd<__nv_bfloat16, __nv_bfloat16>(
        x, gamma, beta, y, mu, rstd, n, h, eps, st);
  if (x_dtype == mlt::kBFloat16 && param_dtype == mlt::kFloat32)
    return (int)launch_fwd<__nv_bfloat16, float>(x, gamma, beta, y, mu, rstd,
                                                 n, h, eps, st);
  if (x_dtype == mlt::kFloat32 && param_dtype == mlt::kFloat32)
    return (int)launch_fwd<float, float>(x, gamma, beta, y, mu, rstd, n, h,
                                         eps, st);
  return (int)cudaErrorInvalidValue;
}

// x, g, dx: [n, h] row-major, 16-byte aligned, h a multiple of
// 16 / sizeof(x); gamma: [h]; mu, rstd: [n] fp32 from the forward;
// partial: [nblocks, 2h] fp32 scratch with nblocks * rows_per_block >= n;
// dgamma_dbeta: [2h] fp32, dgamma then dbeta.  Returns a cudaError_t
// (0 on success).
extern "C" int mlt_layernorm_bwd(const void* x, const void* gamma,
                                 const void* g, const float* mu,
                                 const float* rstd, void* dx, float* partial,
                                 float* dgamma_dbeta, int n, int h,
                                 int rows_per_block, int nblocks, int x_dtype,
                                 int param_dtype, void* stream) {
  if (n <= 0 || h <= 0 || rows_per_block <= 0
      || (long long)nblocks * rows_per_block < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == mlt::kBFloat16 && param_dtype == mlt::kBFloat16)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, gamma, g, mu, rstd, dx, partial, dgamma_dbeta, n, h,
        rows_per_block, nblocks, st);
  if (x_dtype == mlt::kBFloat16 && param_dtype == mlt::kFloat32)
    return (int)launch_bwd<__nv_bfloat16, float>(
        x, gamma, g, mu, rstd, dx, partial, dgamma_dbeta, n, h,
        rows_per_block, nblocks, st);
  if (x_dtype == mlt::kFloat32 && param_dtype == mlt::kFloat32)
    return (int)launch_bwd<float, float>(x, gamma, g, mu, rstd, dx, partial,
                                         dgamma_dbeta, n, h, rows_per_block,
                                         nblocks, st);
  return (int)cudaErrorInvalidValue;
}
