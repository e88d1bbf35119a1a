// Ragged paged attention for Hopper (sm_90a): decode and chunked prefill
// share these kernels, as they share one body on the TPU.
//
// Replaces the TPU kernel megatron_llm_tpu/ops/pallas/paged_attention.py
// `_ragged_body` (:133) through `_ragged_call` (:222), in both its
// variants: kernel A, over pools of q's type (`_ragged_kernel_plain`
// :212), and kernel A', over int8 pools with per-(page, position, group)
// fp32 absmax scales (`_ragged_kernel_quant` :217).  Query row j of slot
// s attends key positions 0..context_lens[s]+j of the slot's pages (minus
// a sliding window); within a KV group the flat row r is (chunk row
// r / qpg, head r % qpg), as the TPU body flattens its q-block; one K/V
// page fetch serves every row of the group.  A row that no key reaches
// writes 0.
//
// What bounds it on this card.  Decode moves each slot's live K/V pages
// once (Llama-2-7B, 8 slots of ~1k tokens, 32 groups of d 128: ~131 MB,
// ~40 us at 3.35 TB/s); the int8 pools halve the page bytes and add 4
// bytes of scale a position and group.  A prefill chunk reads far fewer
// bytes (one slot) but does C * qpg rows of products over them: Falcon-7B's
// 64-token chunk at context 1000, 71 heads on one group of d 64, is 1.2
// GFLOP over 136 KB of int8 pages, bound by the tensor cores' rate.
//
// Design.  The TPU walks the pages as the innermost, sequential grid axis
// and carries (m, l, acc) in VMEM scratch; blocks on this card run in no
// order, so a block loops over its key tiles itself, and a second grid
// axis splits the keys over blocks.  The grid is (slot, row tile x group,
// split); every block reads context_lens[s], stages its split's
// block-table entries in shared memory (so no copy waits on a global load
// for its address) and visits only the keys [lo, hi] some row of its tile
// attends (the TPU's page range; keys past the table's last page are
// never read), cut into tiles of whole keys, each key's [d] row of the
// group copied from `((page * bs + j) * g + grp) * d` by 16-byte cp.async.
// One split (the tiles [t_begin, t_end) of its block) writes the output
// directly; more write fp32 partials (o, m, l) and `paged_merge_kernel`
// adds them in split order (no atomics: the same output bits on every
// run).  A split that no key of a row reaches leaves m = -inf and l = 0,
// weight 0.
//
// * `paged_mma_kernel` (bf16 or fp16 q; pools of q's type, or int8
//   converted exactly to it in shared memory) takes every bf16 and fp16
//   call with at least 2 rows a (slot, group): prefill chunks, and
//   decode of GQA and MQA groups (Falcon's 71 heads on one group).  On an H100 it beat the CUDA-core
//   kernel from 2 rows on at d 128 and lost by 5% at 1 row (chip_smoke.py's
//   sweep of the threshold).  4 warps own a tile of 64 flat rows, 16 a
//   warp; a warp whose rows all lie past the group's skips its products.
//   Q is staged once and kept as ldmatrix A fragments (re-read from
//   shared memory at d 256, where the fp32 O of 16 x 256 already takes 128
//   registers a thread).  Key tiles of 64 keys (4 pages at the engine's
//   page size 16) arrive by cp.async in a ring of 3 stages (2 at d 128 and
//   256), so the next tiles are in flight while the warps compute.  S =
//   QK^T on mma.sync m16n8k16 from ldmatrix fragments; masks in registers,
//   only on tiles the causal edge, the window or the table's end cuts;
//   online softmax in registers (the flash forward's rules: a fully
//   masked row keeps m = -inf and takes 0 as its exponent base); P
//   packed to q's type as the A fragment of O += PV, V through
//   ldmatrix.trans.  int8 pools: the scale of each key is applied to S's
//   column and to P's column in fp32 before P is packed, so P's
//   rounding is the only one beyond the reference's fp32.
// * `paged_simt_kernel` takes the rest: one row a (slot, group) (MHA
//   decode, as Llama-2-7B's) and every fp32 call.  A block owns 1, 2 or
//   4 rows (no more than the group has), every warp holds them all (a
//   lane has d / 32 dimensions of each row's q and fp32 accumulator), the
//   4 warps split each tile's keys and merge their (m, l, acc) in shared
//   memory at the end; q.k is a warp shuffle sum.
//   Each warp takes 4 keys at a time (2 at 8 dimensions a lane), so
//   their shuffle reductions overlap.  Key tiles of ~16 KB of K (and as
//   much V) arrive by cp.async in a ring of three; int8 values become
//   float(int8) * scale where a warp reads them.
//
// Every (q type, pool type, head_dim, rows) has its kernels, in one
// object a q type (build.py's parts, which build in parallel; the entry
// dispatches to them).
//
// The caller picks the variant and the splits (ops/kernels/paged_attention.py
// `plan`) and passes them to `mlt_ragged_paged_attention`; each kernel's
// tile (its rows, and its keys from the pool's element size) is fixed
// here, and the plan's `tile_shape` states the same.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the tiles (ops/kernels/paged_attention.py `tile_shape` states them)
constexpr int kMmaRows = 64;      // flat rows of an mma block
constexpr int kMmaKeys = 64;      // keys of an mma key tile
constexpr int kSimtTileBytes = 16384;  // K bytes of a CUDA-core key tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* bt;
  const int* cl;
  void* out;
  float* o_part;   // [splits, S * C * nh, d] when splits > 1
  float* ml_part;  // [splits, S * C * nh, 2]: m (natural log), l
  int S, C, nh, g, bs, M, window, splits;
  int pages_cap;   // entries of the shared-memory page list (pages_cap())
  float scale;
};

// The rows and keys of one block of a (tile_rows, tile_keys) kernel.
struct Block {
  int s, grp, qpg, ctx;
  int r0, r1;          // flat rows [r0, r1) of the (slot, group)
  int pos_lo, pos_hi;  // positions of the first and the last row
  int lo, hi;          // the keys some row attends: [lo, hi]
  int t_begin, t_end;  // this split's key tiles [t_begin, t_end)
  int p_lo, n_pages;   // the table entries those tiles reach
};

__device__ __forceinline__ Block block_of(const Args& a, int tile_rows,
                                          int tile_keys) {
  Block b;
  b.qpg = a.nh / a.g;
  const int R = a.C * b.qpg;
  const int n_rt = (R + tile_rows - 1) / tile_rows;
  b.s = blockIdx.x;
  b.grp = blockIdx.y / n_rt;
  b.r0 = (blockIdx.y % n_rt) * tile_rows;
  b.r1 = min(R, b.r0 + tile_rows);
  b.ctx = a.cl[b.s];
  b.pos_lo = b.ctx + b.r0 / b.qpg;
  b.pos_hi = b.ctx + (b.r1 - 1) / b.qpg;
  b.hi = min(b.pos_hi, a.M * a.bs - 1);
  b.lo = a.window > 0 ? max(b.pos_lo - a.window + 1, 0) : 0;
  const int t0 = b.lo / tile_keys;
  const int n = b.hi >= b.lo ? b.hi / tile_keys - t0 + 1 : 0;
  b.t_begin = t0 + (int)((long long)blockIdx.z * n / a.splits);
  b.t_end = t0 + (int)((long long)(blockIdx.z + 1) * n / a.splits);
  b.p_lo = b.t_begin * tile_keys / a.bs;
  b.n_pages = b.t_end > b.t_begin
      ? min(min((b.t_end * tile_keys - 1) / a.bs, a.M - 1) - b.p_lo + 1,
            a.pages_cap)
      : 0;
  return b;
}

// The split's block-table entries into shared memory, so that the copies
// of a tile wait on no global load for their addresses.
__device__ __forceinline__ void stage_pages(const Args& a, const Block& b,
                                            int* pages) {
  for (int i = threadIdx.x; i < b.n_pages; i += blockDim.x)
    pages[i] = a.bt[(size_t)b.s * a.M + b.p_lo + i];
  __syncthreads();
}

// index of flat row r among the S * C * nh rows of q and out
__device__ __forceinline__ size_t row_index(const Args& a, const Block& b,
                                            int r) {
  return ((size_t)b.s * a.C + r / b.qpg) * a.nh + b.grp * b.qpg + r % b.qpg;
}

// (page, position, group) index of a key of the split: its scale, and its
// [d] row times d
__device__ __forceinline__ size_t key_slot(const Args& a, const Block& b,
                                           const int* pages, int key) {
  const size_t page = (size_t)pages[key / a.bs - b.p_lo];
  return (page * a.bs + key % a.bs) * a.g + b.grp;
}

__device__ __forceinline__ bool visible(const Args& a, int key, int pos) {
  return key <= pos && key < a.M * a.bs &&
         (a.window <= 0 || key > pos - a.window);
}

// elements [c, c + N) of row `row` once its keys are done: the output
// when the keys are not split, else this split's partial (o, m, l)
template <typename T, int N>
__device__ __forceinline__ void store_row(const Args& a, size_t row, int D,
                                          int c, const float (&o)[N],
                                          float m, float l, bool with_ml) {
  if (a.splits == 1) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* op = static_cast<T*>(a.out) + row * D + c;
#pragma unroll
    for (int i = 0; i < N; ++i) op[i] = mlt::from_float<T>(o[i] * inv);
    return;
  }
  const size_t at = (size_t)blockIdx.z * a.S * a.C * a.nh + row;
  float* op = a.o_part + at * D + c;
#pragma unroll
  for (int i = 0; i < N; ++i) op[i] = o[i];
  if (with_ml) {
    a.ml_part[at * 2] = m;
    a.ml_part[at * 2 + 1] = l;
  }
}

// 8 int8 values -> 8 of T, bf16 or fp16 (exact: |x| <= 127)
template <typename T>
__device__ __forceinline__ uint4 i8x8_to(uint2 w) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
  uint4 r;
  r.x = sm90::pack<T>((float)b[0], (float)b[1]);
  r.y = sm90::pack<T>((float)b[2], (float)b[3]);
  r.z = sm90::pack<T>((float)b[4], (float)b[5]);
  r.w = sm90::pack<T>((float)b[6], (float)b[7]);
  return r;
}

// --------------------------------------------------------------------------
// the tensor-core kernel
// --------------------------------------------------------------------------

template <typename KV, int D>
struct MmaTile {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kPitch = D + 8;  // 16-bit elements of a staged row
  static constexpr bool kQInRegs = D <= 128;
  static constexpr int kQBytes = kMmaRows * kPitch * 2;
  static constexpr int kTile16 = kMmaKeys * kPitch * 2;  // K or V, 16-bit
  // a ring stage: K and V as they arrive (int8 pools: [64][D] int8 each,
  // then the 64 K scales and the 64 V scales)
  static constexpr int kStage =
      kQuant ? 2 * kMmaKeys * D + 2 * kMmaKeys * 4 : 2 * kTile16;
  // then the page list
  static constexpr size_t kSmem =
      kQBytes + kStages * kStage + (kQuant ? 2 * kTile16 : 0);
};

// T: type of q and out, bf16 or fp16; KV: element type of the pools (T,
// or int8_t with the scales)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_mma_kernel(Args a) {
  using L = MmaTile<KV, D>;
  constexpr int P = L::kPitch;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  unsigned char* ring = smem + L::kQBytes;
  // int8 pools: the arrived tile converted to T
  T* K16 = reinterpret_cast<T*>(ring + L::kStages * L::kStage);
  T* V16 = K16 + kMmaKeys * P;
  int* pages = reinterpret_cast<int*>(smem + L::kSmem);

  const Block b = block_of(a, kMmaRows, kMmaKeys);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_t = b.t_end - b.t_begin;
  const KV* kpool = static_cast<const KV*>(a.k);
  const KV* vpool = static_cast<const KV*>(a.v);

  // Q: the tile's 64 rows (rows past the group's are zero)
  {
    const T* q = static_cast<const T*>(a.q);
    for (int e = tid; e < kMmaRows * D / 8; e += kThreads) {
      const int i = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool in = b.r0 + i < b.r1;
      const size_t row = in ? row_index(a, b, b.r0 + i) : 0;
      sm90::cp_async16(Qs + i * P + c, q + row * D + c, in ? 16 : 0);
    }
  }
  stage_pages(a, b, pages);
  // key tile t into its ring stage; keys outside [lo, hi] are zero
  auto issue = [&](int t) {
    unsigned char* st = ring + ((t - b.t_begin) % L::kStages) * L::kStage;
    const int k0 = t * kMmaKeys;
    constexpr int kChunks = D * (int)sizeof(KV) / 16;
    for (int e = tid; e < kMmaKeys * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e % kChunks;
      const int key = k0 + j;
      const bool in = key >= b.lo && key <= b.hi;
      const size_t off = in ? key_slot(a, b, pages, key) * D : 0;
      unsigned char* dk = L::kQuant ? st + j * D + c * 16
                                    : st + j * P * 2 + c * 16;
      unsigned char* dv = dk + (L::kQuant ? kMmaKeys * D : L::kTile16);
      sm90::cp_async16(dk, reinterpret_cast<const unsigned char*>(kpool + off)
                               + c * 16, in ? 16 : 0);
      sm90::cp_async16(dv, reinterpret_cast<const unsigned char*>(vpool + off)
                               + c * 16, in ? 16 : 0);
    }
    if constexpr (L::kQuant) {
      if (tid < 2 * kMmaKeys) {  // K scales, then V scales
        const int key = k0 + tid % kMmaKeys;
        const bool in = key >= b.lo && key <= b.hi;
        const size_t at = in ? key_slot(a, b, pages, key) : 0;
        float* dst = reinterpret_cast<float*>(st + 2 * kMmaKeys * D) + tid;
        sm90::cp_async4(dst, (tid < kMmaKeys ? a.ks : a.vs) + at,
                        in ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_t) issue(b.t_begin + i);
    sm90::cp_async_commit();
  }

  const int wr = 16 * warp;  // the warp's first row in the tile
  const bool live = b.r0 + wr < b.r1;
  // positions of this lane's two rows (lane / 4 and lane / 4 + 8)
  int pos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = min(b.r0 + wr + (lane >> 2) + 8 * hf, b.r1 - 1);
    pos[hf] = b.ctx + r / b.qpg;
  }
  const int kmax = a.M * a.bs - 1;
  const float sl = a.scale * kLog2e;  // scores in log2 units
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[L::kQInRegs ? D / 16 : 1][4];

  for (int it = 0; it < n_t; ++it) {
    const int t = b.t_begin + it;
    const unsigned char* st = ring + (it % L::kStages) * L::kStage;
    // tile `it` (and Q) landed; every warp is done with tile it - 1, so
    // its stage (and the converted tile) may be refilled
    sm90::cp_async_wait<L::kStages - 2>();
    __syncthreads();
    if (it + L::kStages - 1 < n_t) issue(t + L::kStages - 1);
    sm90::cp_async_commit();
    const T* Kt;
    const T* Vt;
    const float* kst = nullptr;
    const float* vst = nullptr;
    if constexpr (L::kQuant) {
      const int8_t* K8 = reinterpret_cast<const int8_t*>(st);
      const int8_t* V8 = K8 + kMmaKeys * D;
      for (int e = tid; e < kMmaKeys * D / 8; e += kThreads) {
        const int j = e / (D / 8), c = (e % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(K16 + j * P + c) =
            i8x8_to<T>(*reinterpret_cast<const uint2*>(K8 + j * D + c));
        *reinterpret_cast<uint4*>(V16 + j * P + c) =
            i8x8_to<T>(*reinterpret_cast<const uint2*>(V8 + j * D + c));
      }
      kst = reinterpret_cast<const float*>(st + 2 * kMmaKeys * D);
      vst = kst + kMmaKeys;
      Kt = K16;
      Vt = V16;
      __syncthreads();
    } else {
      Kt = reinterpret_cast<const T*>(st);
      Vt = Kt + kMmaKeys * P;
    }
    if (!live) continue;  // warp-uniform: the warp's rows are past R
    if constexpr (L::kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::ldsm_x4(qf[kk],
                        Qs + (wr + (lane & 15)) * P + 16 * kk
                            + (lane >> 4) * 8);
      }
    }

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4];
      if constexpr (L::kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[e] = qf[kk][e];
      } else {
        sm90::ldsm_x4(aq, Qs + (wr + (lane & 15)) * P + 16 * kk
                              + (lane >> 4) * 8);
      }
#pragma unroll
      for (int n2 = 0; n2 < kMmaKeys / 16; ++n2) {
        uint32_t bk[4];
        sm90::ldsm_x4(bk, Kt + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) * P
                              + 16 * kk + ((lane >> 3) & 1) * 8);
        sm90::mma16816<T>(s[2 * n2], aq, bk[0], bk[1]);
        sm90::mma16816<T>(s[2 * n2 + 1], aq, bk[2], bk[3]);
      }
    }

    // scale (int8: times each key's scale), mask where the tile is cut,
    // row maxima over the quad of lanes that holds a row
    const int k0 = t * kMmaKeys;
    const bool full = k0 + kMmaKeys - 1 <= min(b.pos_lo, kmax) &&
                      (a.window <= 0 || k0 > b.pos_hi - a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kMmaKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * (lane & 3) + (e & 1);
        float x = s[n][e] * sl;
        if constexpr (L::kQuant) x *= kst[col];
        if (!full && !visible(a, k0 + col, pos[e >> 1])) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      // a row with no key so far keeps m = -inf and takes base 0, so no
      // inf - inf reaches its sums
      base[hf] = mx[hf] == -INFINITY ? 0.f : mx[hf];
      const float alpha = exp2f(m[hf] - base[hf]);
      m[hf] = mx[hf];
      l[hf] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * hf] *= alpha;
        o[n][2 * hf + 1] *= alpha;
      }
    }

    // P = exp2(S - base): its row sums in fp32, then (int8: times each
    // key's V scale) packed to T as the A fragment of O += P V
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t ap[4];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int n = 2 * kk + h2;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[n][e] - base[e >> 1]);
          l[e >> 1] += p[e];
        }
        if constexpr (L::kQuant) {
          const int col = 8 * n + 2 * (lane & 3);
          p[0] *= vst[col];
          p[1] *= vst[col + 1];
          p[2] *= vst[col];
          p[3] *= vst[col + 1];
        }
        ap[2 * h2] = sm90::pack<T>(p[0], p[1]);      // row lane / 4
        ap[2 * h2 + 1] = sm90::pack<T>(p[2], p[3]);  // row lane / 4 + 8
      }
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bv[4];
        sm90::ldsm_x4_t(bv, Vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                     * P + 16 * n2 + (lane >> 4) * 8);
        sm90::mma16816<T>(o[2 * n2], ap, bv[0], bv[1]);
        sm90::mma16816<T>(o[2 * n2 + 1], ap, bv[2], bv[3]);
      }
    }
  }
  sm90::cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    const int r = b.r0 + wr + (lane >> 2) + 8 * hf;
    if (r >= b.r1) continue;
    const size_t row = row_index(a, b, r);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float pair[2] = {o[n][2 * hf], o[n][2 * hf + 1]};
      store_row<T, 2>(a, row, D, 8 * n + 2 * (lane & 3), pair,
                         m[hf] * kLn2, l[hf], n == 0 && (lane & 3) == 0);
    }
  }
}

// --------------------------------------------------------------------------
// the CUDA-core kernel
// --------------------------------------------------------------------------

template <typename KV, int D>
struct SimtTile {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kRaw = kSimtTileBytes / (D * (int)sizeof(KV));
  static constexpr int kKeys = kRaw > 64 ? 64 : (kRaw < 16 ? 16 : kRaw);
  static constexpr int kBytes = kKeys * D * (int)sizeof(KV);  // K or V
  static constexpr int kStage = 2 * kBytes + (kQuant ? 2 * kKeys * 4 : 0);
  static constexpr int kStages = 3;
  // the ring, the warps' (acc, m, l) of each row, then the page list
  static constexpr size_t smem(int rows) {
    return kStages * (size_t)kStage + (size_t)kWarps * rows * (D + 2) * 4;
  }
};

// a lane's N consecutive elements of a staged row, as floats, in as few
// shared-memory loads as their bytes allow
template <typename KV, int N>
__device__ __forceinline__ void load_floats(const KV* p, float (&f)[N]) {
  constexpr int kBytes = N * (int)sizeof(KV);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[i];
      const KV* e = reinterpret_cast<const KV*>(&w);
#pragma unroll
      for (int t = 0; t < 16 / (int)sizeof(KV); ++t)
        f[i * (16 / (int)sizeof(KV)) + t] = mlt::to_float(e[t]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    const KV* e = reinterpret_cast<const KV*>(&w);
#pragma unroll
    for (int t = 0; t < N; ++t) f[t] = mlt::to_float(e[t]);
  } else if constexpr (kBytes == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    const KV* e = reinterpret_cast<const KV*>(&w);
#pragma unroll
    for (int t = 0; t < N; ++t) f[t] = mlt::to_float(e[t]);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) f[t] = mlt::to_float(p[t]);
  }
}

// T: type of q and out; KV: element type of the pools (T, or int8_t with
// the scales)
template <typename T, typename KV, int DPL, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_simt_kernel(Args a) {
  constexpr int D = DPL * 32;
  using L = SimtTile<KV, D>;
  constexpr int TK = L::kKeys;
  // keys a warp takes at once: their dot products reduce together
  constexpr int kStep = DPL >= 8 ? 2 : 4;
  static_assert(TK % (kWarps * kStep) == 0, "key tile");
  extern __shared__ __align__(16) unsigned char smem[];
  // per-warp (acc[D], m, l) of each row, for the merge of the warps
  float* merge = reinterpret_cast<float*>(smem + L::kStages * L::kStage);
  int* pages = reinterpret_cast<int*>(
      smem + L::kStages * L::kStage + kWarps * ROWS * (D + 2) * 4);

  const Block b = block_of(a, ROWS, TK);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_t = b.t_end - b.t_begin;
  const KV* kpool = static_cast<const KV*>(a.k);
  const KV* vpool = static_cast<const KV*>(a.v);
  stage_pages(a, b, pages);

  auto issue = [&](int t) {
    unsigned char* st = smem + ((t - b.t_begin) % L::kStages) * L::kStage;
    const int k0 = t * TK;
    constexpr int kChunks = D * (int)sizeof(KV) / 16;
    for (int e = tid; e < TK * kChunks; e += kThreads) {
      const int j = e / kChunks, c = e % kChunks;
      const int key = k0 + j;
      const bool in = key >= b.lo && key <= b.hi;
      const size_t off = in ? key_slot(a, b, pages, key) * D : 0;
      unsigned char* dk = st + j * D * (int)sizeof(KV) + c * 16;
      sm90::cp_async16(dk, reinterpret_cast<const unsigned char*>(kpool + off)
                               + c * 16, in ? 16 : 0);
      sm90::cp_async16(dk + L::kBytes,
                       reinterpret_cast<const unsigned char*>(vpool + off)
                           + c * 16, in ? 16 : 0);
    }
    if constexpr (L::kQuant) {
      if (tid < 2 * TK) {  // K scales, then V scales
        const int key = k0 + tid % TK;
        const bool in = key >= b.lo && key <= b.hi;
        const size_t at = in ? key_slot(a, b, pages, key) : 0;
        float* dst = reinterpret_cast<float*>(st + 2 * L::kBytes) + tid;
        sm90::cp_async4(dst, (tid < TK ? a.ks : a.vs) + at, in ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_t) issue(b.t_begin + i);
    sm90::cp_async_commit();
  }

  // scores in log2 units: q carries scale * log2(e)
  const float qscale = a.scale * kLog2e;
  float qv[ROWS][DPL], acc[ROWS][DPL], m[ROWS], l[ROWS];
  int pos[ROWS];
  bool live[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = b.r0 + i;
    live[i] = r < b.r1;
    pos[i] = b.ctx + (live[i] ? r : b.r0) / b.qpg;
    m[i] = -INFINITY;
    l[i] = 0.f;
    const T* qp = static_cast<const T*>(a.q)
                  + (live[i] ? row_index(a, b, r) : 0) * D + lane * DPL;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      qv[i][t] = live[i] ? mlt::to_float(qp[t]) * qscale : 0.f;
      acc[i][t] = 0.f;
    }
  }

  for (int it = 0; it < n_t; ++it) {
    const int t = b.t_begin + it;
    // tile `it` landed; every warp is done with tile it - 1
    sm90::cp_async_wait<L::kStages - 2>();
    __syncthreads();
    if (it + L::kStages - 1 < n_t) issue(t + L::kStages - 1);
    sm90::cp_async_commit();
    const unsigned char* st = smem + (it % L::kStages) * L::kStage;
    const KV* k_tile = reinterpret_cast<const KV*>(st);
    const KV* v_tile = reinterpret_cast<const KV*>(st + L::kBytes);
    const float* ks_tile = reinterpret_cast<const float*>(st + 2 * L::kBytes);
    const float* vs_tile = ks_tile + TK;
    for (int j0 = warp * kStep; j0 < TK; j0 += kWarps * kStep) {
      const int key0 = t * TK + j0;
      if (key0 + kStep - 1 < b.lo || key0 > b.hi) continue;  // warp-uniform
      float kf[kStep][DPL], vf[kStep][DPL];
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        load_floats<KV, DPL>(k_tile + (j0 + u) * D + lane * DPL, kf[u]);
        load_floats<KV, DPL>(v_tile + (j0 + u) * D + lane * DPL, vf[u]);
        if constexpr (L::kQuant) {
          const float ksc = ks_tile[j0 + u], vsc = vs_tile[j0 + u];
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            kf[u][e] *= ksc;
            vf[u][e] *= vsc;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (!live[i]) continue;
        float sc[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          sc[u] = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) sc[u] += qv[i][e] * kf[u][e];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < kStep; ++u)
            sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
        float mx = m[i];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          const int key = key0 + u;
          if (key < b.lo || key > b.hi || !visible(a, key, pos[i]))
            sc[u] = -INFINITY;
          mx = fmaxf(mx, sc[u]);
        }
        if (mx == -INFINITY) continue;  // no key of the step reaches the row
        const float alpha = exp2f(m[i] - mx);  // 0 while m = -inf
        float p[kStep];
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          p[u] = exp2f(sc[u] - mx);
          psum += p[u];
        }
        l[i] = l[i] * alpha + psum;
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          float x = acc[i][e] * alpha;
#pragma unroll
          for (int u = 0; u < kStep; ++u) x += p[u] * vf[u][e];
          acc[i][e] = x;
        }
        m[i] = mx;
      }
    }
  }
  sm90::cp_async_wait<0>();

  // merge the warps' states of each row in warp 0
  float* mine = merge + (size_t)warp * ROWS * (D + 2);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float* row = mine + i * (D + 2);
#pragma unroll
    for (int e = 0; e < DPL; ++e) row[lane * DPL + e] = acc[i][e];
    if (lane == 0) {
      row[D] = m[i];
      row[D + 1] = l[i];
    }
  }
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (!live[i]) continue;
    float mt = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      mt = fmaxf(mt, merge[((size_t)w * ROWS + i) * (D + 2) + D]);
    float lt = 0.f, o[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = merge + ((size_t)w * ROWS + i) * (D + 2);
      const float f = row[D] == -INFINITY ? 0.f : exp2f(row[D] - mt);
      lt += row[D + 1] * f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[e] += row[lane * DPL + e] * f;
    }
    store_row<T, DPL>(a, row_index(a, b, b.r0 + i), D, lane * DPL, o,
                      mt * kLn2, lt, lane == 0);
  }
}

// --------------------------------------------------------------------------
// the merge of the splits
// --------------------------------------------------------------------------

// out[row] = sum_i o_i exp(m_i - m) / sum_i l_i exp(m_i - m), the splits
// added in order; one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_merge_kernel(
    const float* __restrict__ o_part, const float* __restrict__ ml_part,
    T* __restrict__ out, int rows, int D, int splits) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float mt = -INFINITY;
  for (int i = 0; i < splits; ++i)
    mt = fmaxf(mt, ml_part[((size_t)i * rows + row) * 2]);
  float lt = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float mi = ml_part[((size_t)i * rows + row) * 2];
    if (mi != -INFINITY)
      lt += ml_part[((size_t)i * rows + row) * 2 + 1] * expf(mi - mt);
  }
  const float inv = lt > 0.f ? 1.f / lt : 0.f;
  for (int c = lane; c < D; c += 32) {
    float acc = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = ml_part[((size_t)i * rows + row) * 2];
      if (mi != -INFINITY)
        acc += o_part[((size_t)i * rows + row) * D + c] * expf(mi - mt);
    }
    out[(size_t)row * D + c] = mlt::from_float<T>(acc * inv);
  }
}

// --------------------------------------------------------------------------
// launch
// --------------------------------------------------------------------------

// rows of a CUDA-core block: 1, 2 or 4, no more than the group has
inline int simt_rows(int rows_per_group) {
  return rows_per_group >= 3 ? 4 : rows_per_group;
}

// shared memory above 48 KB is asked for once a kernel, at its first
// launch (and so never inside a CUDA graph's capture of a later one)
inline cudaError_t smem_attr(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// the most block-table entries one split's key tiles reach
inline int pages_cap(int M, int bs, int splits, int tile_keys) {
  const int max_tiles = (M * bs + tile_keys - 1) / tile_keys + 1;
  const int per_split = (max_tiles + splits - 1) / splits;
  return std::min(M, per_split * tile_keys / bs + 2);
}

// the largest page list any launch of a kernel may ask for (the attribute
// is set once, for this much): 4096 table entries a split
constexpr size_t kPagesSmem = 16 * 1024;

inline dim3 grid_of(const Args& a, int tile_rows) {
  const int R = a.C * (a.nh / a.g);
  return dim3(a.S, a.g * ((R + tile_rows - 1) / tile_rows), a.splits);
}

template <typename T, typename KV, int D>
cudaError_t launch_mma(Args a, cudaStream_t st) {
  auto kernel = paged_mma_kernel<T, KV, D>;
  constexpr size_t kBase = MmaTile<KV, D>::kSmem;
  static const cudaError_t attr =
      smem_attr((const void*)kernel, kBase + kPagesSmem);
  if (attr != cudaSuccess) return attr;
  a.pages_cap = pages_cap(a.M, a.bs, a.splits, kMmaKeys);
  const size_t smem = kBase + (size_t)a.pages_cap * 4;
  if (smem > kBase + kPagesSmem) return cudaErrorInvalidValue;
  kernel<<<grid_of(a, kMmaRows), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, int ROWS>
cudaError_t launch_simt(Args a, cudaStream_t st) {
  auto kernel = paged_simt_kernel<T, KV, D / 32, ROWS>;
  using L = SimtTile<KV, D>;
  const size_t base = L::smem(ROWS);
  static const cudaError_t attr =
      smem_attr((const void*)kernel, base + kPagesSmem);
  if (attr != cudaSuccess) return attr;
  a.pages_cap = pages_cap(a.M, a.bs, a.splits, L::kKeys);
  const size_t smem = base + (size_t)a.pages_cap * 4;
  if (smem > base + kPagesSmem) return cudaErrorInvalidValue;
  kernel<<<grid_of(a, ROWS), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_variant(const Args& a, int variant, cudaStream_t st) {
  if (variant == 1) {
    if constexpr (sizeof(T) == 2) return launch_mma<T, KV, D>(a, st);
    // the tensor-core kernel takes bf16 or fp16 q
    return cudaErrorInvalidValue;
  }
  switch (simt_rows(a.C * (a.nh / a.g))) {
    case 1:
      return launch_simt<T, KV, D, 1>(a, st);
    case 2:
      return launch_simt<T, KV, D, 2>(a, st);
    default:
      return launch_simt<T, KV, D, 4>(a, st);
  }
}

template <typename T, typename KV>
cudaError_t launch_d(const Args& a, int d, int variant, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch_variant<T, KV, 32>(a, variant, st);
    case 64:
      return launch_variant<T, KV, 64>(a, variant, st);
    case 128:
      return launch_variant<T, KV, 128>(a, variant, st);
    case 256:
      return launch_variant<T, KV, 256>(a, variant, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_all(const Args& a, int d, int variant, cudaStream_t st) {
  cudaError_t e = a.ks != nullptr ? launch_d<T, int8_t>(a, d, variant, st)
                                  : launch_d<T, T>(a, d, variant, st);
  if (e != cudaSuccess || a.splits == 1) return e;
  const int rows = a.S * a.C * a.nh;
  paged_merge_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      a.o_part, a.ml_part, static_cast<T*>(a.out), rows, d, a.splits);
  return cudaGetLastError();
}

// the checks of one call, its Args, and the launch of the kernels of q's
// type T
template <typename T>
int ragged_call(const void* q, const void* k_pages, const void* v_pages,
                const float* k_scales, const float* v_scales,
                const int* block_tables, const int* context_lens, void* out,
                float* o_part, float* ml_part, int S, int C, int nh, int g,
                int d, int bs, int M, float scale, int window, int splits,
                int variant, void* stream) {
  if (S <= 0 || C <= 0 || g <= 0 || nh % g || bs <= 0 || M <= 0 ||
      splits <= 0 || splits > 65535 || (variant != 0 && variant != 1) ||
      (k_scales == nullptr) != (v_scales == nullptr) ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int R = C * (nh / g);
  const int tile_rows = variant == 1 ? kMmaRows : simt_rows(R);
  if ((long long)g * ((R + tile_rows - 1) / tile_rows) > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q,       k_pages, v_pages, k_scales, v_scales, block_tables,
         context_lens, out, o_part, ml_part, S, C, nh, g, bs, M, window,
         splits, 0, scale};
  return (int)launch_all<T>(a, d, variant,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

// One part function a dtype code (common.cuh MLT_PART): each holds the
// kernels of its q type, in the object of its part.
#define MLT_PAGED_PARAMS                                                     \
  const void *q, const void *k_pages, const void *v_pages,                   \
      const float *k_scales, const float *v_scales, const int *block_tables, \
      const int *context_lens, void *out, float *o_part, float *ml_part,     \
      int S, int C, int nh, int g, int d, int bs, int M, float scale,        \
      int window, int splits, int variant, void *stream
#define MLT_PAGED_ARGS                                                      \
  q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens, out,  \
      o_part, ml_part, S, C, nh, g, d, bs, M, scale, window, splits,         \
      variant, stream
extern "C" int mlt_paged_part0(MLT_PAGED_PARAMS);
extern "C" int mlt_paged_part1(MLT_PAGED_PARAMS);
extern "C" int mlt_paged_part2(MLT_PAGED_PARAMS);
#if MLT_IN_PART(0)
extern "C" int mlt_paged_part0(MLT_PAGED_PARAMS) {
  return ragged_call<mlt::CodeType<mlt::kFloat32>::T>(MLT_PAGED_ARGS);
}
#endif
#if MLT_IN_PART(1)
extern "C" int mlt_paged_part1(MLT_PAGED_PARAMS) {
  return ragged_call<mlt::CodeType<mlt::kBFloat16>::T>(MLT_PAGED_ARGS);
}
#endif
#if MLT_IN_PART(2)
extern "C" int mlt_paged_part2(MLT_PAGED_PARAMS) {
  return ragged_call<mlt::CodeType<mlt::kFloat16>::T>(MLT_PAGED_ARGS);
}
#endif

#if MLT_IN_PART(0)
// q, out: [S, C, nh, d]; k_pages, v_pages: [P, bs, g, d], contiguous, of
// q's dtype when k_scales and v_scales are null, else int8 with the scales
// [P, bs, g] fp32; block_tables: [S, M] int32; context_lens: [S] int32.
// window <= 0 means no sliding window; dtype is q's.  variant: 0 the
// CUDA-core kernel, 1 the tensor-core kernel (bf16 and fp16 only).
// splits > 1 needs o_part [splits, S, C, nh, d] and ml_part
// [splits, S, C, nh, 2] fp32 scratch.  Returns a cudaError_t (0 on
// success).
extern "C" int mlt_ragged_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* block_tables,
    const int* context_lens, void* out, float* o_part, float* ml_part,
    int S, int C, int nh, int g, int d, int bs, int M, float scale,
    int window, int splits, int variant, int dtype, void* stream) {
  switch (dtype) {
    case mlt::kFloat32:
      return mlt_paged_part0(MLT_PAGED_ARGS);
    case mlt::kBFloat16:
      return mlt_paged_part1(MLT_PAGED_ARGS);
    case mlt::kFloat16:
      return mlt_paged_part2(MLT_PAGED_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif
