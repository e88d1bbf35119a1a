// The norm kernels for Hopper (sm_90a): one forward for RMSNorm (kernel
// B) and LayerNorm (kernel D), and one backward for RMSNorm (kernel C)
// and LayerNorm (kernel E), further down.
//
// The forward replaces two TPU kernels, megatron_llm_tpu/ops/pallas/
// rmsnorm.py `_fwd_kernel` (B, through `_fwd_call`) and layernorm.py
// `_fwd_kernel` (D, through `_fwd_call`), each reached through its
// `fused_*_norm`; accumulated in fp32, y in the input's type:
//   B: rstd = rsqrt(mean(x^2) + eps), y = x * rstd * scale, rstd [n] kept
//      for the backward when a pointer is given;
//   D: mu = mean(x), rstd = rsqrt(mean((x - mu)^2) + eps),
//      y = (x - mu) * rstd * gamma + beta, mu and rstd [n] kept likewise.
//
// Bound on this card: memory, 2*n*h*sizeof(x) bytes (x read once, y
// written once) plus the parameters and the statistics.  At decode rows
// (8 x 4096) the bytes take 0.04 us: the launch and the latency of one
// load bound it.
//
// Design: rows in registers.  A row is split over `row_threads` threads
// (a multiple of 32); each holds V 16-byte vectors of it (vector v of the
// row belongs to thread v % row_threads, slot v / row_threads), so the V
// loads of x are all in flight before any arithmetic, and the output is
// computed from the registers: x is read once, with no copy of the row
// in shared memory.  LayerNorm's variance is the mean of the squared
// deviations from the mean, as the TPU kernel takes it (not E[x^2] -
// mu^2, which loses the fp32 digits of a row with a large mean); RMSNorm
// (kRms) takes the sum of squares alone, with no mean and no beta.  Sums
// are warp shuffles, plus one exchange through shared memory across the
// row's warps (one barrier) when the row spans more than one warp.  A
// block holds rows_per_block rows side by side and walks the rows with a
// stride of the grid; the parameters are read once a block, as 16-byte
// vectors, and kept in shared memory (not registers, which x alone
// fills: a block of more than 4 vectors a thread is held to 512 threads
// so that ptxas need not spill).  The plan (row_threads, V,
// rows_per_block, grid) is chosen in Python (ops/kernels/norm_plan.py
// `plan`): decode rows spread a row over about 256 threads to cut its
// latency; training rows take about 128 threads a row (four warps) in
// 512-thread blocks, two blocks an SM.

#include <stdint.h>

#include "common.cuh"

// One forward call's arguments, packed by the wrapper into one buffer
// (ops/kernels/norm_plan.py `FWD_CALL`, the same fields in the same
// order), so the host passes one pointer instead of seventeen values.
// x, y: [n, h] row-major, 16-byte aligned, h a multiple of 16 / sizeof(x);
// gamma (RMSNorm's scale), beta: [h] of one type, 16-byte aligned; beta
// and mu are not read or written by RMSNorm (rms != 0); mu and rstd: [n]
// fp32, or null when the caller keeps no statistics.  The plan: row_threads
// (a multiple of 32) threads a row, vecs (1..8) 16-byte vectors a thread,
// rows_per_block rows a block, grid blocks.
struct NormFwdCall {
  const void* x;
  const void* gamma;
  const void* beta;
  void* y;
  float* mu;
  float* rstd;
  void* stream;
  int n, h, x_dtype, param_dtype;
  int row_threads, vecs, rows_per_block, grid, rms;
  float eps;
};

// One backward call's arguments, packed by the wrapper (ops/kernels/
// norm_plan.py `BWD_CALL`, the same fields in the same order).  x, g, dx:
// [n, h] row-major, 16-byte aligned, h a multiple of 16 / sizeof(x);
// gamma (RMSNorm's scale): [h], 16-byte aligned; mu (not read by RMSNorm,
// rms != 0) and rstd: [n] fp32 from the forward; partial: [grid, w] fp32
// scratch and sums: [w] fp32, where w is h for RMSNorm (dscale) and 2h for
// LayerNorm (dgamma, then dbeta).  The plan: row_threads (a multiple of
// 32) threads a row, vecs (1..8) 16-byte vectors a thread, rows_per_block
// rows a block, grid blocks.
struct NormBwdCall {
  const void* x;
  const void* gamma;
  const void* g;
  const float* mu;
  const float* rstd;
  void* dx;
  float* partial;
  float* sums;
  void* stream;
  int n, h, x_dtype, param_dtype;
  int row_threads, vecs, rows_per_block, grid, rms;
};

namespace {

// most threads a forward block takes at V vectors a thread: up to 4 a
// thread fit ptxas's 64 registers of a 1024-thread block, more need up to
// 128 (ops/kernels/norm_plan.py `max_threads`, the same rule)
template <int V>
struct FwdMaxThreads {
  static constexpr int kValue = V <= 4 ? 1024 : 512;
};

template <typename T, typename S, int V, bool kRms>
__global__ void __launch_bounds__(FwdMaxThreads<V>::kValue)
norm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ gamma,
                const S* __restrict__ beta, T* __restrict__ y,
                float* __restrict__ mu_out, float* __restrict__ rstd_out,
                int n, int h, int row_threads, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kW = kVec * sizeof(S) / 16;  // 16-byte words of S a vector
  // one partial a warp, for each of the two sums (two buffers, so the
  // second sum's writes never race the first sum's reads)
  __shared__ float red[2][32];
  extern __shared__ uint4 params[];  // gamma's [h], then beta's [h], raw
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
  // the first rows' loads are in flight while the parameters are copied
  load_x(blockIdx.x * rows);
  uint4* gs = params;
  uint4* bs = params + nvec * kW;
  for (int i = tid; i < nvec * kW; i += blockDim.x) {
    gs[i] = reinterpret_cast<const uint4*>(gamma)[i];
    if (!kRms) bs[i] = reinterpret_cast<const uint4*>(beta)[i];
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
  // block); a slot past the last row stores nothing.  RMSNorm's one sum a
  // row takes the two buffers in turn, so a row's writes never race the
  // last row's reads.
  int parity = 0;
  for (int base = blockIdx.x * rows; base < n; base += stride) {
    const int row = base + slot;
    float mu = 0.f, r;
    if (kRms) {
      // zeros past the row's end add nothing
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float f = mlt::to_float(e[i]);
          ss += f * f;
        }
      }
      r = rsqrtf(row_sum(ss, parity) * inv_h + eps);
      parity ^= 1;
    } else {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) s += mlt::to_float(e[i]);
      }
      mu = row_sum(s, 0) * inv_h;
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
      r = rsqrtf(row_sum(ss, 1) * inv_h + eps);
    }
    if (row < n) {
      if (t == 0) {
        if (mu_out != nullptr) mu_out[row] = mu;
        if (rstd_out != nullptr) rstd_out[row] = r;
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
            if (!kRms) bv[w] = bs[v * kW + w];
          }
          const S* ge = reinterpret_cast<const S*>(gv);
          const S* be = reinterpret_cast<const S*>(bv);
          uint4 packed;
          T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float f = mlt::to_float(e[i]);
            o[i] = kRms ? mlt::from_float<T>(f * r * mlt::to_float(ge[i]))
                        : mlt::from_float<T>((f - mu) * r
                                             * mlt::to_float(ge[i])
                                             + mlt::to_float(be[i]));
          }
          yr[v] = packed;
        }
      }
    }
    if (base + stride < n) load_x(base + stride);
  }
}

template <typename T, typename S, int V, bool kRms>
cudaError_t launch_fwd_v(const NormFwdCall* c) {
  if (c->row_threads * c->rows_per_block > FwdMaxThreads<V>::kValue)
    return cudaErrorInvalidValue;
  auto kernel = norm_fwd_kernel<T, S, V, kRms>;
  const size_t smem = (size_t)(kRms ? 1 : 2) * c->h * sizeof(S);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<c->grid, c->row_threads * c->rows_per_block, smem,
           static_cast<cudaStream_t>(c->stream)>>>(
      static_cast<const T*>(c->x), static_cast<const S*>(c->gamma),
      static_cast<const S*>(c->beta), static_cast<T*>(c->y), c->mu, c->rstd,
      c->n, c->h, c->row_threads, c->eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_fwd(const NormFwdCall* c) {
  // the plan must cover the row: row_threads * vecs vectors
  if ((long long)c->row_threads * c->vecs < c->h / (16 / (int)sizeof(T)))
    return cudaErrorInvalidValue;
  switch (c->vecs * 2 + (c->rms != 0)) {
#define MLT_NORM_V(V)                                                      \
  case 2 * V:                                                              \
    return launch_fwd_v<T, S, V, false>(c);                                \
  case 2 * V + 1:                                                          \
    return launch_fwd_v<T, S, V, true>(c);
    MLT_NORM_V(1) MLT_NORM_V(2) MLT_NORM_V(3) MLT_NORM_V(4)
    MLT_NORM_V(5) MLT_NORM_V(6) MLT_NORM_V(7) MLT_NORM_V(8)
#undef MLT_NORM_V
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward, one template for both norms (kRms as in the forward), with
// the forward's saved statistics (not recomputed).  Kernel E, the
// LayerNorm backward, replaces layernorm.py `_bwd_kernel` (through
// `_bwd_call`); kernel C, the RMSNorm backward, replaces rmsnorm.py
// `_bwd_kernel` (through `_bwd_call`):
//   E: xhat = (x - mu) * rstd, ggam = g * gamma
//      dx = rstd * (ggam - mean(ggam) - xhat * mean(ggam * xhat))  per row
//      dgamma = sum over rows of g * xhat, dbeta = sum over rows of g
//   C: gs = g * scale
//      dx = rstd * (gs - x * rstd^2 * mean(gs * x))                per row
//      dscale = sum over rows of g * x * rstd
// with the column sums [h] fp32.
//
// Bound on this card: memory, x and g read once and dx written once,
// 3*n*h*sizeof(x) bytes plus the statistics, the parameter and the sums
// (E at Falcon-7B's 2048 x 4544 bf16 rows: 55.8 MB, 0.0167 ms at 3.35
// TB/s; C at Llama-2-7B's 4096 x 4096: 100.7 MB, 0.0301 ms).
//
// Design: the TPU kernels carry the column sums across their sequential
// grid in VMEM scratch; blocks here run in no order, so they take two
// passes and no atomics.  Pass 1 keeps rows in registers as the forward
// does (the same vector-to-thread map): x and g of a row are read once,
// as 16-byte vectors, and the row's sums (E: of ggam and of ggam * xhat;
// C: of gs * x alone) go through one exchange across the row's warps, one
// barrier a row (two buffers, used in turn, so a row's writes never race
// the last row's reads).  Where registers allow (BwdShape::kPrefetch),
// the next row's loads start before this row's exchange.  gamma is copied
// once a block into shared memory as 16-byte vectors.  Every row a thread
// walks puts the same columns on it, so the column sums accumulate in its
// registers for those columns; at the end a block adds its row slots'
// sums in slot order through shared memory and writes one partial row:
// [dgamma | dbeta], 2h fp32, for E; dscale, h fp32, for C.  The grid is
// about one block an SM (ops/kernels/norm_plan.py `bwd_plan`), so the
// partial rows add ~132 rows of traffic each way.  Pass 2, the column
// pass, gives each block 64 columns: its 8 warps take every 8th partial
// row, each in row order, and their sums are added in warp order through
// shared memory.  Every order is fixed, so the column sums are the same
// bits on every run.

// Registers a thread needs at V vectors of kVec elements: the column
// sums (2*V*kVec fp32 for E's dgamma and dbeta, V*kVec for C's dscale),
// x and g of this row (8 a vector), of the next row when it is loaded
// ahead (8 more), and about 24 for the rest.  The next row is loaded
// ahead only where the whole fits the 128 registers of a 512-thread
// block; the most threads a block takes follows from the registers
// (ops/kernels/norm_plan.py `bwd_shape`, the same rule).
template <int kVec, int V, bool kRms>
struct BwdShape {
  static constexpr int kBase = (kRms ? 1 : 2) * V * kVec + 8 * V + 24;
  static constexpr bool kPrefetch = kBase + 8 * V <= 128;
  static constexpr int kNeed = kBase + (kPrefetch ? 8 * V : 0);
  static constexpr int kMaxThreads =
      kNeed <= 128 ? 512 : (kNeed <= 168 ? 384 : 256);
};

// x and g of one row's vectors of a thread, with the row's statistics
template <int V>
struct BwdRow {
  uint4 x[V], g[V];
  float mu, rstd;
};

template <typename T, typename S, int V, bool kRms>
__global__ void __launch_bounds__(
    BwdShape<(int)(16 / sizeof(T)), V, kRms>::kMaxThreads)
norm_bwd_kernel(const T* __restrict__ x, const S* __restrict__ gamma,
                const T* __restrict__ g, const float* __restrict__ mu,
                const float* __restrict__ rstd, T* __restrict__ dx,
                float* __restrict__ partial, int n, int h, int row_threads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kW = kVec * sizeof(S) / 16;
  constexpr int kSums = kRms ? 1 : 2;  // column sums a column
  constexpr bool kPrefetch = BwdShape<kVec, V, kRms>::kPrefetch;
  __shared__ float2 red[2][32];
  // gamma's [h], raw; then, for blocks of several rows, the block's
  // [kSums * h] fp32 sums
  extern __shared__ uint4 smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = blockDim.x / row_threads;
  const int slot = tid / row_threads, t = tid % row_threads;
  const int wpr = row_threads >> 5;
  const int nvec = h / kVec;
  const float fh = (float)h;

  // a row past the last one loads zeros (and mu = rstd = 0), which add
  // nothing to the sums
  auto load = [&](BwdRow<V>& r, int base) {
    const int row = base + slot;
    const bool live = row < n;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * h);
    const uint4* gr = reinterpret_cast<const uint4*>(g + (size_t)row * h);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = t + j * row_threads;
      r.x[j] = make_uint4(0u, 0u, 0u, 0u);
      r.g[j] = make_uint4(0u, 0u, 0u, 0u);
      if (live && v < nvec) {
        r.x[j] = xr[v];
        r.g[j] = gr[v];
      }
    }
    r.mu = !kRms && live ? mu[row] : 0.f;
    r.rstd = live ? rstd[row] : 0.f;
  };
  auto gamma_of = [&](int v, uint4 (&gw)[kW]) {
#pragma unroll
    for (int w = 0; w < kW; ++w) gw[w] = smem[v * kW + w];
  };

  // the column sums of this thread's columns: dgamma (E) or dscale (C),
  // and E's dbeta
  float dg[V][kVec], db[V][kVec];
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) dg[j][i] = db[j][i] = 0.f;
  }
  const int stride = gridDim.x * rows;
  BwdRow<V> cur, nxt;
  // the first rows' loads are in flight while gamma is copied
  load(cur, blockIdx.x * rows);
  for (int i = tid; i < nvec * kW; i += blockDim.x)
    smem[i] = reinterpret_cast<const uint4*>(gamma)[i];
  __syncthreads();

  int parity = 0;
  for (int base = blockIdx.x * rows; base < n; base += stride) {
    const int row = base + slot;
    // E: the sums of ggam and ggam * xhat; C: s2 alone, of gs * x
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = t + j * row_threads;
      if (v < nvec) {
        uint4 gw[kW];
        gamma_of(v, gw);
        const S* ge = reinterpret_cast<const S*>(gw);
        const T* xe = reinterpret_cast<const T*>(&cur.x[j]);
        const T* ye = reinterpret_cast<const T*>(&cur.g[j]);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xv = mlt::to_float(xe[i]);
          const float gv = mlt::to_float(ye[i]);
          const float ggam = gv * mlt::to_float(ge[i]);
          if (kRms) {
            s2 += ggam * xv;
            dg[j][i] += gv * xv * cur.rstd;
          } else {
            const float xhat = (xv - cur.mu) * cur.rstd;
            s1 += ggam;
            s2 += ggam * xhat;
            dg[j][i] += gv * xhat;
            db[j][i] += gv;
          }
        }
      }
    }
    if (kPrefetch) load(nxt, base + stride);
    if (!kRms) s1 = mlt::warp_sum(s1);
    s2 = mlt::warp_sum(s2);
    if (wpr > 1) {
      float2* rb = red[parity];
      parity ^= 1;
      if (lane == 0) rb[warp] = make_float2(s1, s2);
      __syncthreads();
      s1 = s2 = 0.f;
      for (int w = 0; w < wpr; ++w) {
        const float2 p = rb[slot * wpr + w];
        s1 += p.x;
        s2 += p.y;
      }
    }
    const float m1 = s1 / fh, m2 = s2 / fh;
    const float r2 = cur.rstd * cur.rstd;
    if (row < n) {
      uint4* dxr = reinterpret_cast<uint4*>(dx + (size_t)row * h);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int v = t + j * row_threads;
        if (v < nvec) {
          uint4 gw[kW];
          gamma_of(v, gw);
          const S* ge = reinterpret_cast<const S*>(gw);
          const T* xe = reinterpret_cast<const T*>(&cur.x[j]);
          const T* ye = reinterpret_cast<const T*>(&cur.g[j]);
          uint4 packed;
          T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const float xv = mlt::to_float(xe[i]);
            const float ggam = mlt::to_float(ye[i]) * mlt::to_float(ge[i]);
            if (kRms) {
              o[i] = mlt::from_float<T>(cur.rstd * (ggam - xv * r2 * m2));
            } else {
              const float xhat = (xv - cur.mu) * cur.rstd;
              o[i] = mlt::from_float<T>(cur.rstd * (ggam - m1 - xhat * m2));
            }
          }
          dxr[v] = packed;
        }
      }
    }
    if (kPrefetch) {
      cur = nxt;
    } else {
      load(cur, base + stride);
    }
  }

  // this block's partial row: [dgamma | dbeta] (E) or dscale (C)
  float* out = partial + (size_t)blockIdx.x * kSums * h;
  if (rows == 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int v = t + j * row_threads;
      if (v < nvec) {
        float4* og = reinterpret_cast<float4*>(out + v * kVec);
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          og[q] = make_float4(dg[j][4 * q], dg[j][4 * q + 1],
                              dg[j][4 * q + 2], dg[j][4 * q + 3]);
          if (!kRms) {
            float4* ob = reinterpret_cast<float4*>(out + h + v * kVec);
            ob[q] = make_float4(db[j][4 * q], db[j][4 * q + 1],
                                db[j][4 * q + 2], db[j][4 * q + 3]);
          }
        }
      }
    }
    return;
  }
  // the row slots' sums added in slot order; the last barrier of the row
  // loop (or of the gamma copy) is behind every thread
  float4* sums = reinterpret_cast<float4*>(smem + nvec * kW);
  for (int s = 0; s < rows; ++s) {
    if (slot == s) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int v = t + j * row_threads;
        if (v < nvec) {
#pragma unroll
          for (int q = 0; q < kVec / 4; ++q) {
            float4 a = make_float4(dg[j][4 * q], dg[j][4 * q + 1],
                                   dg[j][4 * q + 2], dg[j][4 * q + 3]);
            float4* pg = sums + v * (kVec / 4) + q;
            if (s > 0) {
              const float4 og = *pg;
              a = make_float4(og.x + a.x, og.y + a.y, og.z + a.z, og.w + a.w);
            }
            *pg = a;
            if (!kRms) {
              float4 b = make_float4(db[j][4 * q], db[j][4 * q + 1],
                                     db[j][4 * q + 2], db[j][4 * q + 3]);
              float4* pb = sums + (h + v * kVec) / 4 + q;
              if (s > 0) {
                const float4 ob = *pb;
                b = make_float4(ob.x + b.x, ob.y + b.y, ob.z + b.z,
                                ob.w + b.w);
              }
              *pb = b;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  float4* out4 = reinterpret_cast<float4*>(out);
  for (int i = tid; i < kSums * h / 4; i += blockDim.x) out4[i] = sums[i];
}

// The column pass: out[c] = sum over the nrows rows of partial
// [nrows, width] fp32, 64 columns a block (two adjacent ones a lane);
// warp w adds rows w, w + kColWarps, ... in row order, then the warps'
// sums are added in warp order.
constexpr int kColWarps = 8;

__global__ void __launch_bounds__(kColWarps * 32)
norm_column_pass_kernel(const float* __restrict__ partial,
                        float* __restrict__ out, int nrows, int width) {
  __shared__ float2 part[kColWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pairs = width / 2;
  const int c = blockIdx.x * 32 + lane;
  float2 s = make_float2(0.f, 0.f);
  if (c < pairs) {
    const float2* p = reinterpret_cast<const float2*>(partial) + c;
    int r = warp;
    // four rows' loads in flight, added in row order
    for (; r + 3 * kColWarps < nrows; r += 4 * kColWarps) {
      float2 a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = p[(size_t)(r + k * kColWarps) * pairs];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s.x += a[k].x;
        s.y += a[k].y;
      }
    }
    for (; r < nrows; r += kColWarps) {
      const float2 a = p[(size_t)r * pairs];
      s.x += a.x;
      s.y += a.y;
    }
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < pairs) {
    float2 tot = part[0][lane];
#pragma unroll
    for (int w = 1; w < kColWarps; ++w) {
      tot.x += part[w][lane].x;
      tot.y += part[w][lane].y;
    }
    reinterpret_cast<float2*>(out)[c] = tot;
  }
}

template <typename T, typename S, int V, bool kRms>
cudaError_t launch_bwd_v(const NormBwdCall* c) {
  constexpr int kSums = kRms ? 1 : 2;
  const int threads = c->row_threads * c->rows_per_block;
  if (threads > BwdShape<(int)(16 / sizeof(T)), V, kRms>::kMaxThreads)
    return cudaErrorInvalidValue;
  auto kernel = norm_bwd_kernel<T, S, V, kRms>;
  const size_t smem = (size_t)c->h * sizeof(S)
                      + (c->rows_per_block > 1 ? (size_t)kSums * c->h * 4 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(c->stream);
  kernel<<<c->grid, threads, smem, st>>>(
      static_cast<const T*>(c->x), static_cast<const S*>(c->gamma),
      static_cast<const T*>(c->g), c->mu, c->rstd, static_cast<T*>(c->dx),
      c->partial, c->n, c->h, c->row_threads);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // kSums * h columns, 64 a block
  const int width = kSums * c->h;
  norm_column_pass_kernel<<<(width + 63) / 64, kColWarps * 32, 0, st>>>(
      c->partial, c->sums, c->grid, width);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_bwd(const NormBwdCall* c) {
  if ((long long)c->row_threads * c->vecs < c->h / (16 / (int)sizeof(T)))
    return cudaErrorInvalidValue;
  switch (c->vecs * 2 + (c->rms != 0)) {
#define MLT_NORM_BWD_V(V)                                                  \
  case 2 * V:                                                              \
    return launch_bwd_v<T, S, V, false>(c);                                \
  case 2 * V + 1:                                                          \
    return launch_bwd_v<T, S, V, true>(c);
    MLT_NORM_BWD_V(1) MLT_NORM_BWD_V(2) MLT_NORM_BWD_V(3) MLT_NORM_BWD_V(4)
    MLT_NORM_BWD_V(5) MLT_NORM_BWD_V(6) MLT_NORM_BWD_V(7) MLT_NORM_BWD_V(8)
#undef MLT_NORM_BWD_V
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Call>
bool plan_ok(const Call* c) {
  return c->n > 0 && c->h > 0 && c->row_threads > 0 && c->row_threads % 32 == 0
         && c->rows_per_block > 0 && c->grid > 0;
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int mlt_norm_fwd(const NormFwdCall* c) {
  if (!plan_ok(c)) return (int)cudaErrorInvalidValue;
  if (c->x_dtype == mlt::kBFloat16 && c->param_dtype == mlt::kBFloat16)
    return (int)launch_fwd<__nv_bfloat16, __nv_bfloat16>(c);
  if (c->x_dtype == mlt::kBFloat16 && c->param_dtype == mlt::kFloat32)
    return (int)launch_fwd<__nv_bfloat16, float>(c);
  if (c->x_dtype == mlt::kFloat32 && c->param_dtype == mlt::kFloat32)
    return (int)launch_fwd<float, float>(c);
  return (int)cudaErrorInvalidValue;
}

// Returns a cudaError_t (0 on success).
extern "C" int mlt_norm_bwd(const NormBwdCall* c) {
  if (!plan_ok(c)) return (int)cudaErrorInvalidValue;
  if (c->x_dtype == mlt::kBFloat16 && c->param_dtype == mlt::kBFloat16)
    return (int)launch_bwd<__nv_bfloat16, __nv_bfloat16>(c);
  if (c->x_dtype == mlt::kBFloat16 && c->param_dtype == mlt::kFloat32)
    return (int)launch_bwd<__nv_bfloat16, float>(c);
  if (c->x_dtype == mlt::kFloat32 && c->param_dtype == mlt::kFloat32)
    return (int)launch_bwd<float, float>(c);
  return (int)cudaErrorInvalidValue;
}
