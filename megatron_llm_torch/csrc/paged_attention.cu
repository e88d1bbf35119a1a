// Ragged paged attention for Hopper (sm_90a): decode and chunked prefill
// share one kernel, as they share one body on the TPU.
//
// Replaces the TPU kernel megatron_llm_tpu/ops/pallas/paged_attention.py
// `_ragged_body` through `_ragged_call` (its plain-pool variant
// `_ragged_kernel_plain`).  Query row j of slot s attends key positions
// 0..context_lens[s]+j of the slot's pages (minus a sliding window), in
// fp32 online softmax; one K/V page fetch serves every query head of the
// GQA group.  int8 pools (`_ragged_kernel_quant`) are a later port.
//
// Bound on this card: memory, the bytes of the live K/V pages each
// (slot, group) reads, plus q and the output.  At Llama-2-7B decode
// (8 slots of ~1k tokens, 32 groups of d = 128, bf16) that is about
// 8 * 1k * 32 * 128 * 2 * 2 = 134 MB per layer call: ~40 us at
// 3.35 TB/s.
//
// Design.  The TPU walks the pages as the innermost, sequential grid
// axis and carries (m, l, acc) in VMEM scratch across grid steps; blocks
// on this card run in no order, so that axis becomes a loop inside one
// block.  One block per (slot, q-block, KV group); grid (S, C / block_q,
// g).  The block reads context_lens[s] and its own block-table row and
// visits only the pages first..last that some row of the current row
// pass attends, the same page range as the TPU index map.  The pages'
// [bs, d] K and V slices of the group are copied into shared memory
// (about 32 KB of pages per tile, so one load latency and one barrier
// pair cover several pages), with 16-byte loads, once for all qpg query
// heads and all rows of the block.
// A warp owns up to 4 query rows; a lane holds d / 32 dimensions of each
// row's q (pre-scaled) and of its fp32 accumulator, so q.k is a warp
// shuffle sum and p * v stays in registers.  When the block has fewer
// rows than 4 per warp (decode: one row per head of the group) the warps
// split the page's keys instead and their (m, l, acc) states are merged
// through shared memory at the end.  Rows whose every key is masked
// write 0 (the l == 0 guard of the TPU kernel).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr float kNegInf = -1e30f;
constexpr int kTileBytes = 32 * 1024;

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out, int C, int nh,
    int g, int bs, int M, int bq, float scale, int window, int tile_pages) {
  constexpr int D = DPL * 32;
  constexpr int kVec = 16 / sizeof(T);
  const int s = blockIdx.x, qi = blockIdx.y, grp = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qpg = nh / g;
  const int R = bq * qpg;  // query rows of this block: (chunk row, head)
  const int ctx = context_lens[s];
  const int q0 = qi * bq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_tile = reinterpret_cast<T*>(smem_raw);
  T* v_tile = k_tile + tile_pages * bs * D;
  // per-warp (acc[D], m, l) of each row, for the key-split merge
  float* merge = reinterpret_cast<float*>(v_tile + tile_pages * bs * D);

  // warps = row groups x key splits; few rows -> split the keys
  const int groups_needed = (R + kRowsPerWarp - 1) / kRowsPerWarp;
  int ksplit = 1;
  while (ksplit < kWarps && groups_needed * ksplit * 2 <= kWarps) ksplit *= 2;
  const int row_groups = kWarps / ksplit;
  const int rg = warp / ksplit, kw = warp % ksplit;
  const int rows_per_pass = row_groups * kRowsPerWarp;
  const int n_pass = (R + rows_per_pass - 1) / rows_per_pass;
  const size_t page_elems = (size_t)bs * g * D;
  const int vec_per_row = D / kVec;
  const int n_vec = bs * vec_per_row;

  for (int pass = 0; pass < n_pass; ++pass) {
    const int pass_r0 = pass * rows_per_pass;
    const int pass_r1 = min(R, pass_r0 + rows_per_pass);
    // pages any row of this pass attends (block-uniform bounds)
    const int pos_lo = ctx + q0 + pass_r0 / qpg;
    const int pos_hi = ctx + q0 + (pass_r1 - 1) / qpg;
    const int last = min(pos_hi / bs, M - 1);
    const int first = window > 0 ? max(pos_lo - window + 1, 0) / bs : 0;

    float qv[kRowsPerWarp][DPL], acc[kRowsPerWarp][DPL];
    float m[kRowsPerWarp], l[kRowsPerWarp];
    int pos[kRowsPerWarp], crow[kRowsPerWarp], head[kRowsPerWarp];
    bool live[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = pass_r0 + rg * kRowsPerWarp + i;
      live[i] = r < pass_r1;
      crow[i] = q0 + (live[i] ? r / qpg : 0);
      head[i] = grp * qpg + (live[i] ? r % qpg : 0);
      pos[i] = ctx + crow[i];
      m[i] = kNegInf;
      l[i] = 0.f;
      const T* qp = q + (((size_t)s * C + crow[i]) * nh + head[i]) * D +
                    lane * DPL;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        qv[i][t] = live[i] ? mlt::to_float(qp[t]) * scale : 0.f;
        acc[i][t] = 0.f;
      }
    }

    for (int p0 = first; p0 <= last; p0 += tile_pages) {
      const int n_pages = min(tile_pages, last - p0 + 1);
      __syncthreads();  // every warp is done with the previous tile
      for (int idx = threadIdx.x; idx < n_pages * n_vec; idx += kThreads) {
        const int tp = idx / n_vec, rem = idx - tp * n_vec;
        const int j = rem / vec_per_row, c = rem - j * vec_per_row;
        const size_t page = (size_t)block_tables[(size_t)s * M + p0 + tp];
        const size_t src = page * page_elems + ((size_t)j * g + grp) * D;
        const int dst = (tp * bs + j) * D;
        reinterpret_cast<uint4*>(k_tile + dst)[c] =
            reinterpret_cast<const uint4*>(k_pages + src)[c];
        reinterpret_cast<uint4*>(v_tile + dst)[c] =
            reinterpret_cast<const uint4*>(v_pages + src)[c];
      }
      __syncthreads();
      for (int j = kw; j < n_pages * bs; j += ksplit) {
        const int kpos = p0 * bs + j;
        float kf[DPL], vf[DPL];
#pragma unroll
        for (int t = 0; t < DPL; ++t) {
          kf[t] = mlt::to_float(k_tile[j * D + lane * DPL + t]);
          vf[t] = mlt::to_float(v_tile[j * D + lane * DPL + t]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          // warp-uniform: every lane takes the same branch
          if (!live[i] || kpos > pos[i] ||
              (window > 0 && kpos <= pos[i] - window))
            continue;
          float dot = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t) dot += qv[i][t] * kf[t];
          dot = mlt::warp_sum(dot);
          const float m_new = fmaxf(m[i], dot);
          const float alpha = expf(m[i] - m_new);
          const float p = expf(dot - m_new);
          l[i] = l[i] * alpha + p;
#pragma unroll
          for (int t = 0; t < DPL; ++t) acc[i][t] = acc[i][t] * alpha + p * vf[t];
          m[i] = m_new;
        }
      }
    }

    if (ksplit > 1) {
      float* mine = merge + (size_t)warp * kRowsPerWarp * (D + 2);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        float* row = mine + i * (D + 2);
#pragma unroll
        for (int t = 0; t < DPL; ++t) row[lane * DPL + t] = acc[i][t];
        if (lane == 0) {
          row[D] = m[i];
          row[D + 1] = l[i];
        }
      }
      __syncthreads();
      if (kw == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          float mt = kNegInf;
          for (int w = 0; w < ksplit; ++w)
            mt = fmaxf(mt, merge[((size_t)(warp + w) * kRowsPerWarp + i) *
                                     (D + 2) + D]);
          float lt = 0.f;
#pragma unroll
          for (int t = 0; t < DPL; ++t) acc[i][t] = 0.f;
          for (int w = 0; w < ksplit; ++w) {
            const float* row =
                merge + ((size_t)(warp + w) * kRowsPerWarp + i) * (D + 2);
            const float f = expf(row[D] - mt);
            lt += row[D + 1] * f;
#pragma unroll
            for (int t = 0; t < DPL; ++t) acc[i][t] += row[lane * DPL + t] * f;
          }
          l[i] = lt;
        }
      }
      __syncthreads();  // merge buffer is free for the next pass
    }

    if (kw == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (!live[i]) continue;
        const float inv = l[i] == 0.f ? 1.f : 1.f / l[i];
        T* op = out + (((size_t)s * C + crow[i]) * nh + head[i]) * D +
                lane * DPL;
#pragma unroll
        for (int t = 0; t < DPL; ++t) op[t] = mlt::from_float<T>(acc[i][t] * inv);
      }
    }
  }
}

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_tables, const int* context_lens,
                   void* out, int S, int C, int nh, int g, int bs, int M,
                   int bq, float scale, int window, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  // pages staged per tile: ~32 KB of K and V, so one load latency and
  // one barrier pair cover several pages
  const int page_bytes = 2 * bs * D * (int)sizeof(T);
  const int tile_pages = max(1, min(8, kTileBytes / page_bytes));
  const size_t smem = (size_t)tile_pages * page_bytes +
                      (size_t)kWarps * kRowsPerWarp * (D + 2) * sizeof(float);
  auto kernel = ragged_paged_attention_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(S, C / bq, g);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, context_lens,
      static_cast<T*>(out), C, nh, g, bs, M, bq, scale, window, tile_pages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const int* bt, const int* cl, void* out, int S, int C,
                       int nh, int g, int d, int bs, int M, int bq,
                       float scale, int window, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<T, 1>(q, kp, vp, bt, cl, out, S, C, nh, g, bs, M, bq,
                          scale, window, st);
    case 64:
      return launch<T, 2>(q, kp, vp, bt, cl, out, S, C, nh, g, bs, M, bq,
                          scale, window, st);
    case 128:
      return launch<T, 4>(q, kp, vp, bt, cl, out, S, C, nh, g, bs, M, bq,
                          scale, window, st);
    case 256:
      return launch<T, 8>(q, kp, vp, bt, cl, out, S, C, nh, g, bs, M, bq,
                          scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: [S, C, nh, d]; k_pages, v_pages: [P, bs, g, d] (all contiguous,
// one dtype); block_tables: [S, M] int32; context_lens: [S] int32.
// block_q divides C; window <= 0 means no sliding window.  Returns a
// cudaError_t (0 on success).
extern "C" int mlt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* context_lens, void* out, int S, int C,
    int nh, int g, int d, int bs, int M, int block_q, float scale, int window,
    int dtype, void* stream) {
  if (S <= 0 || C <= 0 || g <= 0 || nh % g || block_q <= 0 || C % block_q ||
      bs <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mlt::kBFloat16)
    return (int)dispatch_d<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                          context_lens, out, S, C, nh, g, d,
                                          bs, M, block_q, scale, window, st);
  if (dtype == mlt::kFloat32)
    return (int)dispatch_d<float>(q, k_pages, v_pages, block_tables,
                                  context_lens, out, S, C, nh, g, d, bs, M,
                                  block_q, scale, window, st);
  return (int)cudaErrorInvalidValue;
}
