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
// written once) plus gamma, beta and the two statistics.  At decode rows
// (8 x 4544) the bytes take 0.05 us: the launch and the latency of one
// load bound it.
//
// Design: rows in registers.  A row is split over `row_threads` threads
// (a multiple of 32); each holds V 16-byte vectors of it (vector v of the
// row belongs to thread v % row_threads, slot v / row_threads), so the V
// loads of x are all in flight before any arithmetic, and the deviations
// and the output are computed from the registers: no copy of the row in
// shared memory.  The variance is the mean of the squared deviations from
// the mean, as the TPU kernel takes it (not E[x^2] - mu^2, which loses the
// fp32 digits of a row with a large mean).  Sums are warp shuffles, plus
// one exchange through shared memory across the row's warps (one barrier)
// when the row spans more than one warp.  A block holds rows_per_block
// rows side by side and walks the rows with a stride of the grid; gamma
// and beta are read once a block, as 16-byte vectors, and kept in shared
// memory (not registers, which x alone fills: a block of more than 4
// vectors a thread is held to 512 threads so that ptxas need not spill).
// The plan (row_threads, V, rows_per_block, grid) is chosen in Python
// (ops/kernels/layernorm.py `plan`): decode rows spread a row over about
// 256 threads to cut its latency; training rows take about 128 threads a
// row (four warps) in 512-thread blocks, two blocks an SM.

#include <stdint.h>

#include "common.cuh"

namespace {

// the backward's block
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// most threads a forward block takes at V vectors a thread: up to 4 a
// thread fit ptxas's 64 registers of a 1024-thread block, more need up to
// 128 (ops/kernels/layernorm.py `max_threads`, the same rule)
template <int V>
struct FwdMaxThreads {
  static constexpr int kValue = V <= 4 ? 1024 : 512;
};

template <typename T, typename S, int V>
__global__ void __launch_bounds__(FwdMaxThreads<V>::kValue)
layernorm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ gamma,
                     const S* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mu_out, float* __restrict__ rstd_out,
                     int n, int h, int row_threads, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kW = kVec * sizeof(S) / 16;  // 16-byte words of S a vector
  // one partial a warp, for each of the two sums (two buffers, so the
  // second sum's writes never race the first sum's reads)
  __shared__ float red[2][32];
  extern __shared__ uint4 params[];  // gamma's [h] then beta's [h], raw
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = blockDim.x / row_threads;
  const int slot = tid / row_threads, t = tid % row_threads;
  const int wpr = row_threads >> 5;  // warps a row
  const int nvec = h / kVec;
  const float inv_h = 1.f / (float)h;

  // x of this thread's vectors in the row at `base + slot` (zero past the
  // last row or the row's end)
  uint4 xv[V];
  auto load_x = [&](int base) {
    const int row = base + slot;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = t + j * row_threads;
      xv[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < n && v < nvec) xv[j] = xr[v];
    }
  };
  const int stride = gridDim.x * rows;
  // the first rows' loads are in flight while gamma and beta are copied
  load_x(blockIdx.x * rows);
  uint4* gs = params;
  uint4* bs = params + nvec * kW;
  for (int i = tid; i < nvec * kW; i += blockDim.x) {
    gs[i] = reinterpret_cast<const uint4*>(gamma)[i];
    bs[i] = reinterpret_cast<const uint4*>(beta)[i];
  }
  __syncthreads();

  // the sum over the row's threads; every thread of the row gets it
  auto row_sum = [&](float s, int which) {
    s = mlt::warp_sum(s);
    if (wpr == 1) return s;
    if (lane == 0) red[which][warp] = s;
    __syncthreads();
    float tot = 0.f;
    for (int w = 0; w < wpr; ++w) tot += red[which][slot * wpr + w];
    return tot;
  };

  // every thread runs every trip (the barriers of row_sum need the whole
  // block); a slot past the last row stores nothing
  for (int base = blockIdx.x * rows; base < n; base += stride) {
    const int row = base + slot;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) s += mlt::to_float(e[i]);
    }
    const float mu = row_sum(s, 0) * inv_h;
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (t + j * row_threads < nvec) {
        const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float c = mlt::to_float(e[i]) - mu;
          ss += c * c;
        }
      }
    }
    const float r = rsqrtf(row_sum(ss, 1) * inv_h + eps);
    if (row < n) {
      if (t == 0) {
        mu_out[row] = mu;
        rstd_out[row] = r;
      }
      uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * h);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int v = t + j * row_threads;
        if (v < nvec) {
          const T* e = reinterpret_cast<const T*>(&xv[j]);
          uint4 gv[kW], bv[kW];
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            gv[w] = gs[v * kW + w];
            bv[w] = bs[v * kW + w];
          }
          const S* ge = reinterpret_cast<const S*>(gv);
          const S* be = reinterpret_cast<const S*>(bv);
          uint4 packed;
          T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            o[i] = mlt::from_float<T>((mlt::to_float(e[i]) - mu) * r
                                      * mlt::to_float(ge[i])
                                      + mlt::to_float(be[i]));
          yr[v] = packed;
        }
      }
    }
    if (base + stride < n) load_x(base + stride);
  }
}

template <typename T, typename S, int V>
cudaError_t launch_fwd_v(const void* x, const void* gamma, const void* beta,
                         void* y, float* mu, float* rstd, int n, int h,
                         float eps, int row_threads, int rows_per_block,
                         int grid, cudaStream_t stream) {
  if (row_threads * rows_per_block > FwdMaxThreads<V>::kValue)
    return cudaErrorInvalidValue;
  auto kernel = layernorm_fwd_kernel<T, S, V>;
  const size_t smem = (size_t)2 * h * sizeof(S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, row_threads * rows_per_block, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const S*>(gamma),
          static_cast<const S*>(beta), static_cast<T*>(y), mu, rstd, n, h,
          row_threads, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_fwd(const void* x, const void* gamma, const void* beta,
                       void* y, float* mu, float* rstd, int n, int h,
                       float eps, int row_threads, int vecs,
                       int rows_per_block, int grid, cudaStream_t stream) {
  // the plan must cover the row: row_threads * vecs vectors
  if ((long long)row_threads * vecs < h / (16 / (int)sizeof(T)))
    return cudaErrorInvalidValue;
  switch (vecs) {
#define MLT_LN_V(V)                                                        \
  case V:                                                                  \
    return launch_fwd_v<T, S, V>(x, gamma, beta, y, mu, rstd, n, h, eps,   \
                                 row_threads, rows_per_block, grid, stream);
    MLT_LN_V(1) MLT_LN_V(2) MLT_LN_V(3) MLT_LN_V(4)
    MLT_LN_V(5) MLT_LN_V(6) MLT_LN_V(7) MLT_LN_V(8)
#undef MLT_LN_V
    default:
      return cudaErrorInvalidValue;
  }
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

// One forward call's arguments, packed by the wrapper into one buffer
// (ops/kernels/layernorm.py `_FWD_CALL`, the same fields in the same
// order), so the host passes one pointer instead of sixteen values.
// x, y: [n, h] row-major, 16-byte aligned, h a multiple of 16 / sizeof(x);
// gamma, beta: [h] of one type, 16-byte aligned; mu, rstd: [n] fp32.  The
// plan (ops/kernels/layernorm.py `plan`): row_threads (a multiple of 32)
// threads a row, vecs (1..8) 16-byte vectors a thread, rows_per_block
// rows a block, grid blocks.
struct LnFwdCall {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* mu;
  float* rstd;
  void* stream;
  int n, h, x_dtype, param_dtype;
  int row_threads, vecs, rows_per_block, grid;
  float eps;
};

// Returns a cudaError_t (0 on success).
extern "C" int mlt_layernorm_fwd(const LnFwdCall* c) {
  if (c->n <= 0 || c->h <= 0 || c->row_threads <= 0 || c->row_threads % 32
      || c->rows_per_block <= 0 || c->grid <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  if (c->x_dtype == mlt::kBFloat16 && c->param_dtype == mlt::kBFloat16)
    return (int)launch_fwd<__nv_bfloat16, __nv_bfloat16>(
        c->x, c->gamma, c->beta, c->y, c->mu, c->rstd, c->n, c->h, c->eps,
        c->row_threads, c->vecs, c->rows_per_block, c->grid, st);
  if (c->x_dtype == mlt::kBFloat16 && c->param_dtype == mlt::kFloat32)
    return (int)launch_fwd<__nv_bfloat16, float>(
        c->x, c->gamma, c->beta, c->y, c->mu, c->rstd, c->n, c->h, c->eps,
        c->row_threads, c->vecs, c->rows_per_block, c->grid, st);
  if (c->x_dtype == mlt::kFloat32 && c->param_dtype == mlt::kFloat32)
    return (int)launch_fwd<float, float>(
        c->x, c->gamma, c->beta, c->y, c->mu, c->rstd, c->n, c->h, c->eps,
        c->row_threads, c->vecs, c->rows_per_block, c->grid, st);
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
