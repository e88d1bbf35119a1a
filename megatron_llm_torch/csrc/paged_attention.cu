// Ragged paged attention for Hopper (sm_90a): decode and chunked prefill
// share one kernel, as they share one body on the TPU.
//
// Replaces the TPU kernel megatron_llm_tpu/ops/pallas/paged_attention.py
// `_ragged_body` through `_ragged_call`, in both its variants: kernel A,
// over pools of q's type (`_ragged_kernel_plain`), and kernel A', over
// int8 pools with per-(page, position, group) fp32 absmax scales
// (`_ragged_kernel_quant`), which are two instances of one template here
// as they are two wrappers of one body there.  Query row j of slot s
// attends key positions 0..context_lens[s]+j of the slot's pages (minus a
// sliding window), in fp32 online softmax; one K/V page fetch serves
// every query head of the GQA group.
//
// Bound on this card: memory, the bytes of the live K/V pages each
// (slot, group) reads, plus q and the output.  At Llama-2-7B decode
// (8 slots of ~1k tokens, 32 groups of d = 128, bf16) that is about
// 8 * 1k * 32 * 128 * 2 * 2 = 134 MB per layer call: ~40 us at
// 3.35 TB/s; the int8 pools halve the page bytes and add 4 bytes of
// scale per 128, so about 70 MB.
//
// Design.  The TPU walks the pages as the innermost, sequential grid
// axis and carries (m, l, acc) in VMEM scratch across grid steps; blocks
// on this card run in no order, so that axis becomes a loop inside one
// block.  A q-block of one KV group has block_q * nh / g query rows,
// (chunk row, head) pairs; one block takes 4 of them, so the grid is
// (S, C / block_q, g * ceil(rows / 4)) and one KV group with many heads
// (MQA) still spreads over the card.  The block reads context_lens[s]
// and its own block-table row and visits only the pages first..last that
// some row of it attends, the same page range as the TPU index map.  The
// pages' [bs, d] K and V slices of the group are copied into shared memory
// (about 32 KB of pages per tile, so one load latency and one barrier
// pair cover several pages), with 16-byte loads, once for the block's
// rows.  The pool's element type is a template
// parameter apart from q's, because a 16-byte vector holds 16 int8 values
// but 8 bf16: an int8 page crosses device memory and sits in shared memory
// as int8, its scales are staged beside it as a second stream indexed
// [page, position, group], and a value becomes float(int8) * scale in
// fp32 only where a warp reads it for its dot product.
// Every warp holds the block's 4 rows: a lane has d / 32 dimensions of each
// row's q (pre-scaled) and of its fp32 accumulator, so q.k is a warp
// shuffle sum and p * v stays in registers.  The 4 warps split the tile's
// keys, and their (m, l, acc) states are merged through shared memory at
// the end.  More rows a block with fewer key splits (8 rows on 2 splits,
// 16 on none) were slower at every serving shape tried, MHA, GQA and MQA.
// Rows whose every key is masked write 0 (the l == 0 guard of the TPU
// kernel).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 4;
constexpr float kNegInf = -1e30f;
constexpr int kTileBytes = 32 * 1024;

// T: type of q and out; KV: element type of the pools (T, or int8_t with
// k_scales / v_scales [P, bs, g] fp32).
template <typename T, typename KV, int DPL>
__global__ void __launch_bounds__(kThreads) ragged_paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ context_lens, T* __restrict__ out, int C, int nh,
    int g, int bs, int M, int bq, float scale, int window, int tile_pages) {
  constexpr int D = DPL * 32;
  constexpr int kVec = 16 / sizeof(KV);
  constexpr bool kQuant = sizeof(KV) == 1;
  const int s = blockIdx.x, qi = blockIdx.y;
  const int grp = blockIdx.z % g, pass = blockIdx.z / g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qpg = nh / g;
  const int R = bq * qpg;  // query rows of the q-block: (chunk row, head)
  const int ctx = context_lens[s];
  const int q0 = qi * bq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* k_tile = reinterpret_cast<KV*>(smem_raw);
  KV* v_tile = k_tile + tile_pages * bs * D;
  // the staged positions' scales (int8 pools only)
  float* ks_tile = reinterpret_cast<float*>(v_tile + tile_pages * bs * D);
  float* vs_tile = ks_tile + (kQuant ? tile_pages * bs : 0);
  // per-warp (acc[D], m, l) of each row, for the key-split merge
  float* merge = vs_tile + (kQuant ? tile_pages * bs : 0);

  const size_t page_elems = (size_t)bs * g * D;
  const int vec_per_row = D / kVec;
  const int n_vec = bs * vec_per_row;

  const int pass_r0 = pass * kRowsPerBlock;
  const int pass_r1 = min(R, pass_r0 + kRowsPerBlock);
  // pages any row of this block attends
  const int pos_lo = ctx + q0 + pass_r0 / qpg;
  const int pos_hi = ctx + q0 + (pass_r1 - 1) / qpg;
  const int last = min(pos_hi / bs, M - 1);
  const int first = window > 0 ? max(pos_lo - window + 1, 0) / bs : 0;

  float qv[kRowsPerBlock][DPL], acc[kRowsPerBlock][DPL];
  float m[kRowsPerBlock], l[kRowsPerBlock];
  int pos[kRowsPerBlock], crow[kRowsPerBlock], head[kRowsPerBlock];
  bool live[kRowsPerBlock];
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    const int r = pass_r0 + i;
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
    if (kQuant) {
      for (int idx = threadIdx.x; idx < n_pages * bs; idx += kThreads) {
        const int tp = idx / bs, j = idx - tp * bs;
        const size_t page = (size_t)block_tables[(size_t)s * M + p0 + tp];
        const size_t src = (page * bs + j) * g + grp;
        ks_tile[idx] = k_scales[src];
        vs_tile[idx] = v_scales[src];
      }
    }
    __syncthreads();
    for (int j = warp; j < n_pages * bs; j += kWarps) {
      const int kpos = p0 * bs + j;
      float kf[DPL], vf[DPL];
      const float ksc = kQuant ? ks_tile[j] : 1.f;
      const float vsc = kQuant ? vs_tile[j] : 1.f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        kf[t] = mlt::to_float(k_tile[j * D + lane * DPL + t]);
        vf[t] = mlt::to_float(v_tile[j * D + lane * DPL + t]);
        if (kQuant) {
          kf[t] *= ksc;
          vf[t] *= vsc;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerBlock; ++i) {
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

  // merge the warps' states of each row in warp 0
  float* mine = merge + (size_t)warp * kRowsPerBlock * (D + 2);
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    float* row = mine + i * (D + 2);
#pragma unroll
    for (int t = 0; t < DPL; ++t) row[lane * DPL + t] = acc[i][t];
    if (lane == 0) {
      row[D] = m[i];
      row[D + 1] = l[i];
    }
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < kRowsPerBlock; ++i) {
    if (!live[i]) continue;
    float mt = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mt = fmaxf(mt, merge[((size_t)w * kRowsPerBlock + i) * (D + 2) + D]);
    float lt = 0.f, o[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) o[t] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = merge + ((size_t)w * kRowsPerBlock + i) * (D + 2);
      const float f = expf(row[D] - mt);
      lt += row[D + 1] * f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) o[t] += row[lane * DPL + t] * f;
    }
    const float inv = lt == 0.f ? 1.f : 1.f / lt;
    T* op = out + (((size_t)s * C + crow[i]) * nh + head[i]) * D + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) op[t] = mlt::from_float<T>(o[t] * inv);
  }
}

template <typename T, typename KV, int DPL>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scales, const float* v_scales,
                   const int* block_tables, const int* context_lens,
                   void* out, int S, int C, int nh, int g, int bs, int M,
                   int bq, float scale, int window, cudaStream_t stream) {
  constexpr int D = DPL * 32;
  // pages staged per tile: ~32 KB of K and V, so one load latency and
  // one barrier pair cover several pages; an int8 page also stages its
  // bs K scales and bs V scales
  const int page_bytes = 2 * bs * D * (int)sizeof(KV);
  const int scale_bytes = sizeof(KV) == 1 ? 2 * bs * (int)sizeof(float) : 0;
  const int tile_pages = max(1, min(8, kTileBytes / page_bytes));
  const size_t smem = (size_t)tile_pages * (page_bytes + scale_bytes) +
                      (size_t)kWarps * kRowsPerBlock * (D + 2) * sizeof(float);
  auto kernel = ragged_paged_attention_kernel<T, KV, DPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = bq * (nh / g);
  const int n_pass = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if ((long)g * n_pass > 65535) return cudaErrorInvalidValue;
  const dim3 grid(S, C / bq, g * n_pass);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), k_scales, v_scales, block_tables,
      context_lens,
      static_cast<T*>(out), C, nh, g, bs, M, bq, scale, window, tile_pages);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_d(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* bt,
                       const int* cl, void* out, int S, int C, int nh, int g,
                       int d, int bs, int M, int bq, float scale, int window,
                       cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<T, KV, 1>(q, kp, vp, ks, vs, bt, cl, out, S, C, nh, g,
                              bs, M, bq, scale, window, st);
    case 64:
      return launch<T, KV, 2>(q, kp, vp, ks, vs, bt, cl, out, S, C, nh, g,
                              bs, M, bq, scale, window, st);
    case 128:
      return launch<T, KV, 4>(q, kp, vp, ks, vs, bt, cl, out, S, C, nh, g,
                              bs, M, bq, scale, window, st);
    case 256:
      return launch<T, KV, 8>(q, kp, vp, ks, vs, bt, cl, out, S, C, nh, g,
                              bs, M, bq, scale, window, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_pool(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* bt,
                          const int* cl, void* out, int S, int C, int nh,
                          int g, int d, int bs, int M, int bq, float scale,
                          int window, cudaStream_t st) {
  if (ks != nullptr)
    return dispatch_d<T, int8_t>(q, kp, vp, ks, vs, bt, cl, out, S, C, nh, g,
                                 d, bs, M, bq, scale, window, st);
  return dispatch_d<T, T>(q, kp, vp, ks, vs, bt, cl, out, S, C, nh, g, d, bs,
                          M, bq, scale, window, st);
}

}  // namespace

// q, out: [S, C, nh, d]; k_pages, v_pages: [P, bs, g, d], contiguous, of
// q's dtype when k_scales and v_scales are null, else int8 with the scales
// [P, bs, g] fp32; block_tables: [S, M] int32; context_lens: [S] int32.
// block_q divides C; window <= 0 means no sliding window; dtype is q's.
// Returns a cudaError_t (0 on success).
extern "C" int mlt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* context_lens, void* out, int S, int C, int nh, int g, int d,
    int bs, int M, int block_q, float scale, int window, int dtype,
    void* stream) {
  if (S <= 0 || C <= 0 || g <= 0 || nh % g || block_q <= 0 || C % block_q ||
      bs <= 0 || M <= 0 || (k_scales == nullptr) != (v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mlt::kBFloat16)
    return (int)dispatch_pool<__nv_bfloat16>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,
        out, S, C, nh, g, d, bs, M, block_q, scale, window, st);
  if (dtype == mlt::kFloat32)
    return (int)dispatch_pool<float>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,
        out, S, C, nh, g, d, bs, M, block_q, scale, window, st);
  return (int)cudaErrorInvalidValue;
}
