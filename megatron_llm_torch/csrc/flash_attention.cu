// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of
// megatron_llm_tpu/ops/pallas/flash_attention.py:
//   F  `_fwd_kernel` (through `_fwd_call`): flash_fwd_wgmma_kernel (bf16
//      and fp16, as every tensor-core kernel below),
//      flash_fwd_kernel (fp32)
//   G  `_bwd_fused_kernel` (through `_bwd_fused_call`):
//      flash_bwd_kv_wgmma_kernel<T, D> (T bf16 or fp16, d 64 and 128),
//      flash_bwd_kv_mma_kernel<T, 256, true> (d 256),
//      flash_bwd_kv_kernel<float, D, true> (fp32)
//   H  `_bwd_dq_kernel` + `_bwd_dkv_kernel` (through `_bwd_call`):
//      flash_bwd_dq_wgmma_kernel<T, D>, then
//      flash_bwd_kv_mma_kernel<T, D, false>, or
//      flash_bwd_dq_kernel<float, D>, then
//      flash_bwd_kv_kernel<float, D, false> (fp32)
// Causal and sliding-window attention with GQA/MQA (k and v carry ng <= nh
// heads), q [b, sq, nh, d], k and v [b, sk, ng, d] read in place through
// their batch, sequence and head strides (the JAX wrapper transposes to
// [b, heads, s, d] first; nothing is transposed here), d in {64, 128, 256}.
// A key k is visible to query q when k < sk, q < sq, k <= q (causal) and
// k > q - window, the element-level mask of the Pallas kernels.
//
// Bound on this card: operations.  At Llama-2-7B training shapes (b = 1,
// s = 4096, nh = 32, d = 128) the causal forward does 4 * s^2 * nh * d / 2
// = 137 GFLOP (0.139 ms at 989 TFLOP/s bf16) against 2 * 4096 * 32 * 128 *
// 2 B * 2 = 134 MB of q, k, v and o (0.040 ms at 3.35 TB/s); the backward
// does 2.5 times the forward's products.
//
// F in bf16 (flash_fwd_wgmma_kernel).  A block of three warpgroups owns
// 128 query rows of one head: warpgroup 0 is the producer, whose one thread
// loads the Q tile and then keeps a two-stage ring of K and V tiles filled
// by TMA (128-byte swizzled boxes of 64 columns, completion on mbarriers),
// so the load of tile j + 1 overlaps the products of tile j; warpgroups 1
// and 2 each own 64 rows.  S = Q K^T is one wgmma chain from shared memory
// into registers; the mask, the running max and sum, and the rescale of
// the O accumulator run in registers (row reductions by quad shuffles); P
// becomes bf16 in registers and is the A operand of O += P V, whose B
// operand V is read MN-major straight from the ring (no transpose).  Under
// the causal mask the last q-tiles do the most work, so they are launched
// first.  The TPU's sequential innermost grid axis, with (m, l, acc) in
// VMEM scratch, becomes the loop over the k-tiles the band reaches.
//
// G in bf16 at d 64 and 128 (flash_bwd_kv_wgmma_kernel).  A block per
// (k-tile, KV group, head split, batch) keeps K and V of its k-tile in
// shared memory (one TMA load) and dK, dV in registers while it walks the
// query heads of its split and the q-tiles that reach the tile; a
// producer warpgroup keeps a two-stage TMA ring of Q, dO, lse and delta
// filled.  Each consumer warpgroup owns 64 keys: S^T = K Q^T and dP^T =
// V dO^T are wgmma chains from shared memory; P^T and dS^T are formed in
// registers and are the register A operands of dV += P^T dO and dK +=
// dS^T Q (dO and Q MN-major from the ring); dS^T goes once to swizzled
// shared memory for dQ = dS K (A and B MN-major), whose fp32 result is
// added into an fp32 [b, sq, nh, d] buffer with 8-byte atomics (the
// counterpart of the VMEM-resident dq slab; its rounding order varies
// from run to run).  d 64 runs two consumer warpgroups (128 keys, 384
// threads, setmaxnreg); d 128 one (64 keys, 256 threads), because ptxas
// holds a 384-thread block to 168 registers a thread and dK + dV + dQ
// need more.  At d 256 dK and dV alone would take 256 registers a thread
// in a warpgroup, so G runs flash_bwd_kv_mma_kernel there: 8 warps with
// warp-level mma.sync products (fragments by ldmatrix from XOR-swizzled
// tiles), dK/dV in registers, a cp.async ring, P^T and dS^T through
// shared memory.  At MQA/GQA shapes the wrapper splits each group's
// query heads over blocks so that the grid covers the card; every split
// writes fp32 partial dK/dV and flash_dkv_sum_kernel adds them in a
// fixed order (the JAX package sums per-head dK/dV the same way), so
// dK/dV stay deterministic.  flash_bwd_prep_kernel computes delta =
// rowsum(dO * O) and zeroes the dq buffer first.
//
// H in bf16: a dQ pass (flash_bwd_dq_wgmma_kernel, replacing
// `_bwd_dq_kernel`), then the mma.sync dK/dV kernel without dQ (replacing
// `_bwd_dkv_kernel`); taken when a length is no multiple of 64.  The dQ
// pass does three of the backward's five products (S, dP, dQ) over the
// visible pairs, so it is bound by operations: 0.012 ms at s 1000, nh 32,
// d 128, causal.  It is F's skeleton: a block owns 128 query rows (64 at
// d 256) of one head, with Q and dO loaded once by TMA and 64-key tiles
// of K and V streaming through a two-stage TMA ring kept by a producer
// warpgroup; each consumer warpgroup owns 64 rows.  S = Q K^T and dP =
// dO V^T are wgmma chains from shared memory, P and dS are formed in
// registers (lse and delta of the thread's two rows stay in registers),
// dS becomes the bf16 register A operand of dQ += dS K with K read
// MN-major from the same ring stage, and dQ stays in fp32 registers
// through the whole walk: nothing goes through shared memory but the TMA
// tiles, and each dq row is written once, by one block (deterministic,
// no atomics).  Rows and keys past the lengths arrive as TMA's zero fill
// and are masked; stores past sq are skipped.  At d 256 one consumer
// warpgroup holds dQ's 128 registers a thread.
//
// fp16 inputs take the same tensor-core kernels as bf16 (the element
// type T is a template parameter of each): the wgmma and mma.sync
// products in their .f16 forms, TMA maps of FLOAT16, the same tiles and
// shared memory (H100's dense fp16 and bf16 peaks are equal, so the
// bounds are bf16's).  Everything between the products is fp32; P and dS
// are rounded to T before the second products, as in bf16.  fp16's
// largest value is 65504: a scaled dS past it rounds to inf, which
// reaches dQ/dK/dV, so the loss scaler skips that step (the JAX kernels
// keep dS in fp32 and round only dQ/dK/dV).  No guard turns an inf or a
// NaN of the inputs into a finite value: a non-finite dO row gives
// non-finite gradients, which is what the scaler's skip reads.
//
// fp32 inputs (the checking path) keep CUDA-core products between
// shared-memory tiles (the generic kernels below), with tiles small enough
// for d = 256.  The path is chosen by dtype and head_dim alone.  The JAX
// FUSED_BWD_MAX_SLAB_BYTES cap is a VMEM limit with no counterpart here.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float* lse;           // [b, nh, sq]
  float* delta;         // [b, nh, sq]
  float* dkv_part;      // [splits, 2, b, sk, ng, d] fp32 when splits > 1
  long long qs[3], ks[3], vs[3], ds[3];  // batch, seq, head strides
  int b, sq, sk, nh, ng, d;
  float scale;
  int causal, window;   // window <= 0: none
  int splits;           // query-head splits of the backward's dK/dV grid
};

__device__ __forceinline__ bool visible(int q, int k, const Args& a) {
  bool ok = (q < a.sq) && (k < a.sk);
  if (a.causal) ok = ok && (k <= q);
  if (a.window > 0) ok = ok && (k > q - a.window);
  return ok;
}

// some pair of the [q0, q0 + R) x [k0, k0 + C) tile is not visible
__device__ __forceinline__ bool tile_needs_mask(const Args& a, int q0, int R,
                                                int k0, int C) {
  bool need = (q0 + R > a.sq) || (k0 + C > a.sk);
  if (a.causal) need = need || (k0 + C - 1 > q0);
  if (a.window > 0) need = need || (k0 <= q0 + R - 1 - a.window);
  return need;
}

// first and last k-tile that the causal band and the window let a q-tile
// starting at q0 reach
__device__ __forceinline__ void k_tile_range(const Args& a, int q0, int Br,
                                             int Bc, int* lo, int* hi) {
  *lo = 0;
  *hi = (a.sk - 1) / Bc;
  if (a.causal) *hi = min(*hi, (q0 + Br - 1) / Bc);
  if (a.window > 0) *lo = max(0, q0 - a.window + 1) / Bc;
}

// first and last q-tile that reach a k-tile starting at k0: causal needs
// q >= k0, the window q < k + window for some key of the tile
__device__ __forceinline__ void q_tile_range(const Args& a, int k0, int Br,
                                             int Bc, int* lo, int* hi) {
  *lo = a.causal ? k0 / Br : 0;
  *hi = (a.sq - 1) / Br;
  if (a.window > 0)
    *hi = min(*hi, (min(k0 + Bc, a.sk) - 1 + a.window - 1) / Br);
}

// the query heads [lo, hi) of KV group g that head split `split` owns
__device__ __forceinline__ void split_heads(const Args& a, int g, int split,
                                            int* lo, int* hi) {
  const int qpg = a.nh / a.ng;
  *lo = g * qpg + split * qpg / a.splits;
  *hi = g * qpg + (split + 1) * qpg / a.splits;
}

// dK (already scaled) and dV of columns (c, c + 1) of one key: into dk, dv
// in T when the heads are not split, else into the split's fp32 partials
template <typename T>
__device__ __forceinline__ void store_dkv2(const Args& a, int bb, int g,
                                           int split, int key, int c,
                                           float dk0, float dk1, float dv0,
                                           float dv1) {
  const long long off = (((long long)bb * a.sk + key) * a.ng + g) * a.d + c;
  if (a.splits == 1) {
    T* dk = static_cast<T*>(a.dk) + off;
    T* dv = static_cast<T*>(a.dv) + off;
    dk[0] = mlt::from_float<T>(dk0);
    dk[1] = mlt::from_float<T>(dk1);
    dv[0] = mlt::from_float<T>(dv0);
    dv[1] = mlt::from_float<T>(dv1);
  } else {
    const long long n = (long long)a.b * a.sk * a.ng * a.d;
    float* pk = a.dkv_part + 2 * split * n + off;
    *reinterpret_cast<float2*>(pk) = make_float2(dk0, dk1);
    *reinterpret_cast<float2*>(pk + n) = make_float2(dv0, dv1);
  }
}

// --------------------------------------------------------------------------
// Generic shared-memory kernels: every fp32 pass (the checking path).
// Products between shared-memory tiles over 4 warps on CUDA cores, so the
// fp32 path keeps full fp32 precision.
// --------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// tile shape per element type and head_dim (fp32 only), small enough that
// every kernel's tiles fit the 227 KB of shared memory at d = 256
template <typename T, int D> struct Tile;
template <int D> struct Tile<float, D> {
  static constexpr int kBr = D == 256 ? 16 : 32, kBc = kBr, kPad = 4;
};

constexpr size_t rnd(size_t x) { return (x + 127) / 128 * 128; }

// shared-memory tile geometry (leading dimensions in elements, buffer sizes
// in bytes rounded to 128 so every buffer starts 128-byte aligned)
template <typename T, int D> struct Geo {
  static constexpr int Br = Tile<T, D>::kBr, Bc = Tile<T, D>::kBc;
  static constexpr int LDT = D + Tile<T, D>::kPad;  // [rows][D] tiles of T
  static constexpr int LDS = Bc + 4;                // fp32 [Br][Bc] scores
  static constexpr int LDP = Bc + Tile<T, D>::kPad; // [Br][Bc] tiles of T
  static constexpr int LDO = D + 4;                 // fp32 [rows][D] sums
  static constexpr size_t kQ = rnd(sizeof(T) * Br * LDT);
  static constexpr size_t kK = rnd(sizeof(T) * Bc * LDT);
  static constexpr size_t kS = rnd(4 * Br * LDS);
  static constexpr size_t kP = rnd(sizeof(T) * Br * LDP);
  static constexpr size_t kOq = rnd(4 * Br * LDO);
  static constexpr size_t kOk = rnd(4 * Bc * LDO);
  static constexpr size_t kRow = rnd(4 * Br);
  // the fused backward's dQ product may reuse the two score tiles
  static constexpr bool kAliasDq = kOq <= 2 * kS;
  static constexpr size_t kFwd = kQ + 2 * kK + kS + kP + kOq + 3 * kRow;
  static constexpr size_t kBwdDq = 2 * kQ + 2 * kK + 2 * kS + kP + kOq
                                   + 2 * kRow;
  static constexpr size_t kBwdKv = 2 * kK + 2 * kQ + 2 * kS + 2 * kP
                                   + 2 * kOk + 2 * kRow;
  static constexpr size_t kBwdFused = kBwdKv + (kAliasDq ? 0 : kOq);
};

struct Carver {
  unsigned char* p;
  template <typename U>
  __device__ __forceinline__ U* take(size_t bytes) {
    U* r = reinterpret_cast<U*>(p);
    p += bytes;
    return r;
  }
};

// C[M][N] (fp32, ldc) = or += op(A) * op(B), over the block's 4 warps.
//   A_T false: A is [M][K]; true: A is stored [K][M] (A^T is used)
//   B_T false: B is [K][N]; true: B is stored [N][K] (B^T is used)
template <typename T, int M, int N, int K, bool A_T, bool B_T, bool ACC>
struct TileMM;

// fp32: CUDA cores, one output element per thread at a time
template <int M, int N, int K, bool A_T, bool B_T, bool ACC>
struct TileMM<float, M, N, K, A_T, B_T, ACC> {
  static __device__ __forceinline__ void run(float* C, int ldc,
                                             const float* A, int lda,
                                             const float* B, int ldb) {
    for (int e = threadIdx.x; e < M * N; e += kThreads) {
      const int m = e / N, n = e % N;
      float acc = ACC ? C[m * ldc + n] : 0.f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float x = A_T ? A[k * lda + m] : A[m * lda + k];
        const float y = B_T ? B[n * ldb + k] : B[k * ldb + n];
        acc = fmaf(x, y, acc);
      }
      C[m * ldc + n] = acc;
    }
  }
};

// rows [row0, row0 + R) of a strided [rows][D] slice into a shared tile,
// 16 bytes per thread per step; rows at or past nrows are zero
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          long long stride, int row0,
                                          int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVpr = D / kVec;
  for (int e = threadIdx.x; e < R * kVpr; e += kThreads) {
    const int r = e / kVpr, v = e % kVpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride
                                            + v * kVec);
    *reinterpret_cast<uint4*>(dst + r * ld + v * kVec) = val;
  }
}

__device__ __forceinline__ void zero(float* p, int count) {
  for (int e = threadIdx.x; e < count; e += kThreads) p[e] = 0.f;
}

// per-row softmax statistics of the backward (zero past the last row)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               int R, const Args& a, int bb,
                                               int h, int q0) {
  const long long base = ((long long)bb * a.nh + h) * a.sq;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool in = q0 + r < a.sq;
    lse_s[r] = in ? a.lse[base + q0 + r] : 0.f;
    delta_s[r] = in ? a.delta[base + q0 + r] : 0.f;
  }
}

// p = exp(s * scale - lse) where the pair is visible, else 0, and
// ds = p * (dp - delta), rounded into T tiles for the next products
template <typename T, int Br, int Bc, int LDS, int LDP>
__device__ __forceinline__ void probs_and_dscores(
    const float* Ss, const float* dPs, T* Ps, T* dSs, const float* lse_s,
    const float* delta_s, int q0, int k0, const Args& a) {
  for (int e = threadIdx.x; e < Br * Bc; e += kThreads) {
    const int r = e / Bc, c = e % Bc;
    float p = 0.f;
    if (visible(q0 + r, k0 + c, a))
      p = expf(Ss[r * LDS + c] * a.scale - lse_s[r]);
    const float ds = p * (dPs[r * LDS + c] - delta_s[r]);
    if (Ps != nullptr) Ps[r * LDP + c] = mlt::from_float<T>(p);
    dSs[r * LDP + c] = mlt::from_float<T>(ds);
  }
}

// F, fp32: one block of 4 warps per (q-tile, query head, batch)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  using G = Geo<T, D>;
  constexpr int Br = G::Br, Bc = G::Bc;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* Qs = cv.take<T>(G::kQ);
  T* Ks = cv.take<T>(G::kK);
  T* Vs = cv.take<T>(G::kK);
  float* Ss = cv.take<float>(G::kS);
  T* Ps = cv.take<T>(G::kP);
  float* Os = cv.take<float>(G::kOq);
  float* m_s = cv.take<float>(G::kRow);
  float* l_s = cv.take<float>(G::kRow);
  float* alpha_s = cv.take<float>(G::kRow);

  const int q0 = blockIdx.x * Br, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / (a.nh / a.ng);
  const T* qp = static_cast<const T*>(a.q) + bb * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + bb * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + bb * a.vs[0] + g * a.vs[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows<T, Br, D>(Qs, G::LDT, qp, a.qs[1], q0, a.sq);
  zero(Os, Br * G::LDO);
  for (int r = threadIdx.x; r < Br; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int kt_lo, kt_hi;
  k_tile_range(a, q0, Br, Bc, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * Bc;
    __syncthreads();
    load_rows<T, Bc, D>(Ks, G::LDT, kp, a.ks[1], k0, a.sk);
    load_rows<T, Bc, D>(Vs, G::LDT, vp, a.vs[1], k0, a.sk);
    __syncthreads();
    TileMM<T, Br, Bc, D, false, true, false>::run(Ss, G::LDS, Qs, G::LDT, Ks,
                                                  G::LDT);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < Br; r += kWarps) {
      float mx = kNegInf;
      for (int c = lane; c < Bc; c += 32) {
        const float s = visible(q0 + r, k0 + c, a)
                            ? Ss[r * G::LDS + c] * a.scale : kNegInf;
        Ss[r * G::LDS + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = mlt::warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < Bc; c += 32) {
        const float p = visible(q0 + r, k0 + c, a)
                            ? expf(Ss[r * G::LDS + c] - m_new) : 0.f;
        Ps[r * G::LDP + c] = mlt::from_float<T>(p);
        sum += p;
      }
      sum = mlt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Br * D; e += kThreads) {
      const int r = e / D, c = e % D;
      Os[r * G::LDO + c] *= alpha_s[r];
    }
    __syncthreads();
    TileMM<T, Br, D, Bc, false, false, true>::run(Os, G::LDO, Ps, G::LDP, Vs,
                                                  G::LDT);
  }
  __syncthreads();
  // o = acc / l and lse = m + log l; a row no key reaches gives o = 0 and
  // lse = NEG_INF (the guard of the Pallas kernel's `_finish`)
  T* op = static_cast<T*>(a.o) + (long long)bb * a.sq * a.nh * D + h * D;
  for (int e = threadIdx.x; e < Br * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (q0 + r < a.sq) {
      const float l = l_s[r];
      op[(long long)(q0 + r) * a.nh * D + c] =
          mlt::from_float<T>(l == 0.f ? 0.f : Os[r * G::LDO + c] / l);
    }
  }
  const long long lbase = ((long long)bb * a.nh + h) * a.sq;
  for (int r = threadIdx.x; r < Br; r += kThreads) {
    if (q0 + r < a.sq) {
      const float l = l_s[r];
      a.lse[lbase + q0 + r] = l == 0.f ? kNegInf : m_s[r] + logf(l);
    }
  }
}

// H, first pass: dQ over the k-tiles a q-tile reaches
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  using G = Geo<T, D>;
  constexpr int Br = G::Br, Bc = G::Bc;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* Qs = cv.take<T>(G::kQ);
  T* dOs = cv.take<T>(G::kQ);
  T* Ks = cv.take<T>(G::kK);
  T* Vs = cv.take<T>(G::kK);
  float* Ss = cv.take<float>(G::kS);
  float* dPs = cv.take<float>(G::kS);
  T* dSs = cv.take<T>(G::kP);
  float* dQs = cv.take<float>(G::kOq);
  float* lse_s = cv.take<float>(G::kRow);
  float* delta_s = cv.take<float>(G::kRow);

  const int q0 = blockIdx.x * Br, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / (a.nh / a.ng);
  const T* qp = static_cast<const T*>(a.q) + bb * a.qs[0] + h * a.qs[2];
  const T* dop = static_cast<const T*>(a.dout) + bb * a.ds[0] + h * a.ds[2];
  const T* kp = static_cast<const T*>(a.k) + bb * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + bb * a.vs[0] + g * a.vs[2];

  load_rows<T, Br, D>(Qs, G::LDT, qp, a.qs[1], q0, a.sq);
  load_rows<T, Br, D>(dOs, G::LDT, dop, a.ds[1], q0, a.sq);
  load_row_stats(lse_s, delta_s, Br, a, bb, h, q0);
  zero(dQs, Br * G::LDO);
  int kt_lo, kt_hi;
  k_tile_range(a, q0, Br, Bc, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * Bc;
    __syncthreads();
    load_rows<T, Bc, D>(Ks, G::LDT, kp, a.ks[1], k0, a.sk);
    load_rows<T, Bc, D>(Vs, G::LDT, vp, a.vs[1], k0, a.sk);
    __syncthreads();
    TileMM<T, Br, Bc, D, false, true, false>::run(Ss, G::LDS, Qs, G::LDT, Ks,
                                                  G::LDT);
    TileMM<T, Br, Bc, D, false, true, false>::run(dPs, G::LDS, dOs, G::LDT,
                                                  Vs, G::LDT);
    __syncthreads();
    probs_and_dscores<T, Br, Bc, G::LDS, G::LDP>(
        Ss, dPs, static_cast<T*>(nullptr), dSs, lse_s, delta_s, q0, k0, a);
    __syncthreads();
    TileMM<T, Br, D, Bc, false, false, true>::run(dQs, G::LDO, dSs, G::LDP,
                                                  Ks, G::LDT);
  }
  __syncthreads();
  T* dqp = static_cast<T*>(a.dq) + (long long)bb * a.sq * a.nh * D + h * D;
  for (int e = threadIdx.x; e < Br * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (q0 + r < a.sq)
      dqp[(long long)(q0 + r) * a.nh * D + c] =
          mlt::from_float<T>(dQs[r * G::LDO + c] * a.scale);
  }
}

// fp32 dK/dV over the query heads of one head split and the q-tiles that
// reach a k-tile: H's second pass, and with kFused the whole of G (dQ
// added by atomics)
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(Args a) {
  using G = Geo<T, D>;
  constexpr int Br = G::Br, Bc = G::Bc;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* Ks = cv.take<T>(G::kK);
  T* Vs = cv.take<T>(G::kK);
  T* Qs = cv.take<T>(G::kQ);
  T* dOs = cv.take<T>(G::kQ);
  float* Ss = cv.take<float>(G::kS);
  float* dPs = cv.take<float>(G::kS);
  T* Ps = cv.take<T>(G::kP);
  T* dSs = cv.take<T>(G::kP);
  float* dKs = cv.take<float>(G::kOk);
  float* dVs = cv.take<float>(G::kOk);
  float* lse_s = cv.take<float>(G::kRow);
  float* delta_s = cv.take<float>(G::kRow);
  float* dQs = nullptr;
  if constexpr (kFused) dQs = G::kAliasDq ? Ss : cv.take<float>(G::kOq);

  const int k0 = blockIdx.x * Bc, bb = blockIdx.z;
  const int g = blockIdx.y / a.splits, split = blockIdx.y % a.splits;
  const T* kp = static_cast<const T*>(a.k) + bb * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + bb * a.vs[0] + g * a.vs[2];

  load_rows<T, Bc, D>(Ks, G::LDT, kp, a.ks[1], k0, a.sk);
  load_rows<T, Bc, D>(Vs, G::LDT, vp, a.vs[1], k0, a.sk);
  zero(dKs, Bc * G::LDO);
  zero(dVs, Bc * G::LDO);
  int qt_lo, qt_hi, h_lo, h_hi;
  q_tile_range(a, k0, Br, Bc, &qt_lo, &qt_hi);
  split_heads(a, g, split, &h_lo, &h_hi);
  for (int h = h_lo; h < h_hi; ++h) {
    const T* qp = static_cast<const T*>(a.q) + bb * a.qs[0] + h * a.qs[2];
    const T* dop =
        static_cast<const T*>(a.dout) + bb * a.ds[0] + h * a.ds[2];
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * Br;
      __syncthreads();
      load_rows<T, Br, D>(Qs, G::LDT, qp, a.qs[1], q0, a.sq);
      load_rows<T, Br, D>(dOs, G::LDT, dop, a.ds[1], q0, a.sq);
      load_row_stats(lse_s, delta_s, Br, a, bb, h, q0);
      __syncthreads();
      TileMM<T, Br, Bc, D, false, true, false>::run(Ss, G::LDS, Qs, G::LDT,
                                                    Ks, G::LDT);
      TileMM<T, Br, Bc, D, false, true, false>::run(dPs, G::LDS, dOs,
                                                    G::LDT, Vs, G::LDT);
      __syncthreads();
      probs_and_dscores<T, Br, Bc, G::LDS, G::LDP>(Ss, dPs, Ps, dSs, lse_s,
                                                   delta_s, q0, k0, a);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q (scaled at the end)
      TileMM<T, Bc, D, Br, true, false, true>::run(dVs, G::LDO, Ps, G::LDP,
                                                   dOs, G::LDT);
      TileMM<T, Bc, D, Br, true, false, true>::run(dKs, G::LDO, dSs, G::LDP,
                                                   Qs, G::LDT);
      if constexpr (kFused) {
        // this pair's dQ = dS K into shared memory (the score tiles are
        // free again), then added into the fp32 dq buffer
        TileMM<T, Br, D, Bc, false, false, false>::run(dQs, G::LDO, dSs,
                                                       G::LDP, Ks, G::LDT);
        __syncthreads();
        float* dqp = static_cast<float*>(a.dq)
                     + (long long)bb * a.sq * a.nh * D + h * D;
        constexpr int kV4 = D / 4;
        for (int e = threadIdx.x; e < Br * kV4; e += kThreads) {
          const int r = e / kV4, c = (e % kV4) * 4;
          if (q0 + r < a.sq) {
            float4 val = *reinterpret_cast<const float4*>(dQs + r * G::LDO
                                                          + c);
            val.x *= a.scale;
            val.y *= a.scale;
            val.z *= a.scale;
            val.w *= a.scale;
            atomicAdd(reinterpret_cast<float4*>(
                          dqp + (long long)(q0 + r) * a.nh * D + c),
                      val);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < Bc * D / 2; e += kThreads) {
    const int r = e / (D / 2), c = (e % (D / 2)) * 2;
    if (k0 + r < a.sk)
      store_dkv2<T>(a, bb, g, split, k0 + r, c,
                    dKs[r * G::LDO + c] * a.scale,
                    dKs[r * G::LDO + c + 1] * a.scale, dVs[r * G::LDO + c],
                    dVs[r * G::LDO + c + 1]);
  }
}

// --------------------------------------------------------------------------
// Around the backward: delta = rowsum(dO * O) (and the zeroed dq buffer of
// G), then the fixed-order sum of the head splits' partial dK/dV
// --------------------------------------------------------------------------

// one warp per (batch, position, head) row; o is contiguous
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(Args a, int zero_dq) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.b * a.sq * a.nh) return;
  const int h = row % a.nh;
  const long long bs = row / a.nh;
  const int s = bs % a.sq, bb = bs / a.sq;
  const T* dop = static_cast<const T*>(a.dout) + bb * a.ds[0]
                 + s * a.ds[1] + h * a.ds[2];
  const T* op = static_cast<const T*>(a.o) + row * a.d;
  float acc = 0.f;
  for (int c = lane; c < a.d; c += 32)
    acc = fmaf(mlt::to_float(dop[c]), mlt::to_float(op[c]), acc);
  acc = mlt::warp_sum(acc);
  if (lane == 0) a.delta[((long long)bb * a.nh + h) * a.sq + s] = acc;
  if (zero_dq) {
    float* dq = static_cast<float*>(a.dq) + row * a.d;
    for (int c = lane * 4; c < a.d; c += 128)
      *reinterpret_cast<float4*>(dq + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dk, dv = the sums over the splits of dkv_part, in split order
template <typename T>
__global__ void __launch_bounds__(256) flash_dkv_sum_kernel(Args a) {
  const long long n = (long long)a.b * a.sk * a.ng * a.d;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n) return;
  const int which = i >= n;
  const long long j = i - which * n;
  float acc = 0.f;
  for (int sp = 0; sp < a.splits; ++sp)
    acc += a.dkv_part[(2LL * sp + which) * n + j];
  T* out = static_cast<T*>(which ? a.dv : a.dk);
  out[j] = mlt::from_float<T>(acc);
}

// --------------------------------------------------------------------------
// F, bf16 and fp16 (T): warp-specialised wgmma + TMA
// --------------------------------------------------------------------------

template <int D> struct FwdTile {
  static constexpr int kBr = 128;                  // 2 consumer warpgroups
  static constexpr int kBc = D == 256 ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kAtoms = D / 64;            // 64-column swizzle atoms
  static constexpr int kThreads = 384;
  static constexpr uint32_t kQBytes = kBr * D * 2;
  static constexpr uint32_t kKvBytes = kBc * D * 2;
  // Q, the K and V rings, their barriers, and slack to align to 1024
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKvBytes
                                  + 8 * (1 + 3 * kStages);
};

struct FwdMaps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = sm90::smem_u32(p);
  return p + ((1024 - (s & 1023)) & 1023);
}

template <typename T, int D>
__global__ void __launch_bounds__(384, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ FwdMaps maps, const Args a) {
  using C = FwdTile<D>;
  constexpr int Br = C::kBr, Bc = C::kBc, S = C::kStages;
  constexpr int kAtomQ = Br * 64, kAtomKv = Bc * 64;  // elements
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* Qs = reinterpret_cast<T*>(base);                // [atom][Br][64]
  T* Ks = reinterpret_cast<T*>(base + C::kQBytes);   // [S][atom][Bc][64]
  T* Vs = Ks + S * C::kAtoms * kAtomKv;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + C::kQBytes + 2 * S * C::kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* kv_empty = v_full + S;

  const int nqt = (a.sq + Br - 1) / Br;
  const int q0 = (nqt - 1 - (int)blockIdx.z) * Br;  // heaviest tiles first
  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / (a.nh / a.ng);
  int kt_lo, kt_hi;
  k_tile_range(a, q0, Br, Bc, &kt_lo, &kt_hi);
  const int n_tiles = max(0, kt_hi - kt_lo + 1);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 8);  // each consumer warp arrives
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread loads Q, then keeps the K/V ring filled
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, C::kQBytes);
      for (int at = 0; at < C::kAtoms; ++at)
        sm90::tma_load_4d(Qs + at * kAtomQ, &maps.q, q_full, at * 64, q0, h,
                          bb);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        const int k0 = (kt_lo + it) * Bc;
        sm90::mbar_wait(&kv_empty[s], ((it / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&k_full[s], C::kKvBytes);
        for (int at = 0; at < C::kAtoms; ++at)
          sm90::tma_load_4d(Ks + (s * C::kAtoms + at) * kAtomKv, &maps.k,
                            &k_full[s], at * 64, k0, g, bb);
        sm90::mbar_expect_tx(&v_full[s], C::kKvBytes);
        for (int at = 0; at < C::kAtoms; ++at)
          sm90::tma_load_4d(Vs + (s * C::kAtoms + at) * kAtomKv, &maps.v,
                            &v_full[s], at * 64, k0, g, bb);
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64)
    sm90::reg_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + 16 * warp + lane / 4;  // rows row0, row0 + 8
    const float sl = a.scale * kLog2e;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S;
      const uint32_t ph = (it / S) & 1;
      const int k0 = (kt_lo + it) * Bc;
      const T* Kt = Ks + s * C::kAtoms * kAtomKv;
      const T* Vt = Vs + s * C::kAtoms * kAtomKv;

      // S = Q K^T (raw scores)
      float sc[Bc / 2];
#pragma unroll
      for (int i = 0; i < Bc / 2; ++i) sc[i] = 0.f;
      sm90::mbar_wait(&k_full[s], ph);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sm90::desc_sw128(
            Qs + (kk / 4) * kAtomQ + wg * 64 * 64 + (kk % 4) * 16, 16, 1024);
        const uint64_t db = sm90::desc_sw128(
            Kt + (kk / 4) * kAtomKv + (kk % 4) * 16, 16, 1024);
        sm90::Wgmma<Bc, T>::ss(sc, da, db, kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // mask, online softmax; element i of the accumulator is row
      // row0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1)
      if (tile_needs_mask(a, qw0, 64, k0, Bc)) {
#pragma unroll
        for (int i = 0; i < Bc / 2; ++i) {
          const int r = row0 + 8 * ((i >> 1) & 1);
          const int c = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
          if (!visible(r, c, a)) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < Bc / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = m[r] == -INFINITY ? 0.f : exp2f((m[r] - mx[r]) * sl);
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl;
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < Bc / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], sl, -ms[r]));
        rs[r] += sc[i];
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P as the m64k16 A fragments of O += P V
      uint32_t pa[Bc / 16][4];
#pragma unroll
      for (int kk = 0; kk < Bc / 16; ++kk) {
        pa[kk][0] = sm90::pack<T>(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = sm90::pack<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = sm90::pack<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = sm90::pack<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V, V MN-major from the ring
      sm90::mbar_wait(&v_full[s], ph);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Bc / 16; ++kk) {
        const uint64_t db =
            sm90::desc_sw128(Vt + kk * 16 * 64, Bc * 128, 1024);
        sm90::Wgmma<D, T>::rs(o, pa[kk], db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (lane == 0) sm90::mbar_arrive(&kv_empty[s]);
    }

    // o = acc / l and lse = m scale + log l; a row no key reaches gives
    // o = 0 and lse = NEG_INF (the guard of the Pallas kernel's `_finish`)
    T* op = static_cast<T*>(a.o) + (long long)bb * a.sq * a.nh * D
               + h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row < a.sq) {
        const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(op + (long long)row * a.nh * D);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          dst[4 * j + lane % 4] = sm90::pack<T>(o[4 * j + 2 * r] * inv,
                                                  o[4 * j + 2 * r + 1] * inv);
        if (lane % 4 == 0)
          a.lse[((long long)bb * a.nh + h) * a.sq + row] =
              l[r] == 0.f ? kNegInf : m[r] * a.scale + logf(l[r]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// G at d 256 and H's second pass, bf16 and fp16: dK/dV in registers,
// mma.sync
// products
// --------------------------------------------------------------------------

template <int D> struct BwdTile {
  static constexpr int kThreads = 256;
  static constexpr int kBr = 64;
  static constexpr int kBc = D == 256 ? 32 : 64;
  static constexpr int kKg = kBc / 16;      // 16-key row groups
  static constexpr int kPart = 8 / kKg;     // warps sharing a key group
  static constexpr int kWq = kBr / kPart;   // S, dP: queries of a warp
  static constexpr int kWd = D / kPart;     // dK, dV: columns of a warp
  static constexpr int kWdq = D / 2;        // dQ: 4 query groups x 2 halves
  static constexpr int kKv = kBc * D;       // elements of a K or V tile
  static constexpr int kQ = kBr * D;        // elements of a Q or dO tile
  static constexpr int kP = kBc * kBr;      // elements of P^T or dS^T
  static constexpr size_t kSmem = 2 * (2 * kKv + 4 * kQ + 2 * kP)
                                  + 4 * 4 * kBr;
};

template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(256, 1) flash_bwd_kv_mma_kernel(Args a) {
  using C = BwdTile<D>;
  using sm90::swz;
  constexpr int Br = C::kBr, Bc = C::kBc;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [Bc][D], swizzled
  T* Vs = Ks + C::kKv;
  T* Qs = Vs + C::kKv;                    // [2][Br][D] ring
  T* dOs = Qs + 2 * C::kQ;                // [2][Br][D] ring
  T* Ps = dOs + 2 * C::kQ;                // [Bc][Br]: P^T
  T* dSs = Ps + C::kP;                    // [Bc][Br]: dS^T
  float* lse_s = reinterpret_cast<float*>(dSs + C::kP);  // [2][Br]
  float* delta_s = lse_s + 2 * Br;                       // [2][Br]

  const int k0 = blockIdx.z * Bc, bb = blockIdx.y;
  const int g = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  int qt_lo, qt_hi, h_lo, h_hi;
  q_tile_range(a, k0, Br, Bc, &qt_lo, &qt_hi);
  split_heads(a, g, split, &h_lo, &h_hi);
  const int nq = max(0, qt_hi - qt_lo + 1);
  const int n_iter = nq * (h_hi - h_lo);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float sl = a.scale * kLog2e;

  // K and V of this k-tile, once (rows past sk are zero)
  {
    const T* kp = static_cast<const T*>(a.k) + bb * a.ks[0]
                     + g * a.ks[2];
    const T* vp = static_cast<const T*>(a.v) + bb * a.vs[0]
                     + g * a.vs[2];
    for (int e = tid; e < Bc * D / 8; e += C::kThreads) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool in = k0 + r < a.sk;
      const long long row = in ? k0 + r : 0;
      sm90::cp_async16(Ks + swz(r, c, D), kp + row * a.ks[1] + c,
                       in ? 16 : 0);
      sm90::cp_async16(Vs + swz(r, c, D), vp + row * a.vs[1] + c,
                       in ? 16 : 0);
    }
  }
  // Q, dO, lse and delta of iteration `it` into ring stage it & 1
  auto issue = [&](int it) {
    const int h = h_lo + it / nq, q0 = (qt_lo + it % nq) * Br, st = it & 1;
    const T* qp = static_cast<const T*>(a.q) + bb * a.qs[0]
                     + h * a.qs[2];
    const T* dop = static_cast<const T*>(a.dout) + bb * a.ds[0]
                      + h * a.ds[2];
    for (int e = tid; e < Br * D / 8; e += C::kThreads) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      const bool in = q0 + r < a.sq;
      const long long row = in ? q0 + r : 0;
      sm90::cp_async16(Qs + st * C::kQ + swz(r, c, D),
                       qp + row * a.qs[1] + c, in ? 16 : 0);
      sm90::cp_async16(dOs + st * C::kQ + swz(r, c, D),
                       dop + row * a.ds[1] + c, in ? 16 : 0);
    }
    if (tid < 2 * Br) {
      const int r = tid % Br;
      const bool in = q0 + r < a.sq;
      const long long off =
          ((long long)bb * a.nh + h) * a.sq + (in ? q0 + r : 0);
      if (tid < Br)
        sm90::cp_async4(lse_s + st * Br + r, a.lse + off, in ? 4 : 0);
      else
        sm90::cp_async4(delta_s + st * Br + r, a.delta + off, in ? 4 : 0);
    }
  };
  if (n_iter > 0) issue(0);
  sm90::cp_async_commit();

  // warp roles: S/dP and dK/dV over 16 keys (kr) and a slice of the
  // queries (qc) or of the columns (dc); dQ over 16 queries (qr) and half
  // of the columns (dqc)
  const int kr = 16 * (warp % C::kKg), part = warp / C::kKg;
  const int qc = part * C::kWq, dc = part * C::kWd;
  const int qr = 16 * (warp % 4), dqc = (warp / 4) * C::kWdq;
  float dk[C::kWd / 8][4], dv[C::kWd / 8][4];
#pragma unroll
  for (int n = 0; n < C::kWd / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    const int h = h_lo + it / nq, q0 = (qt_lo + it % nq) * Br;
    // this iteration's tiles have landed, and every warp is done with the
    // previous one (so its ring stage and P^T/dS^T are free)
    sm90::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_iter) issue(it + 1);
    sm90::cp_async_commit();
    const T* Qt = Qs + st * C::kQ;
    const T* dOt = dOs + st * C::kQ;
    const float* lse_t = lse_s + st * Br;
    const float* delta_t = delta_s + st * Br;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kWq queries a warp
    float s[C::kWq / 8][4], dp[C::kWq / 8][4];
#pragma unroll
    for (int n = 0; n < C::kWq / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      const int ar = kr + (lane & 15), ac = 16 * kk + (lane >> 4) * 8;
      sm90::ldsm_x4(ak, Ks + swz(ar, ac, D));
      sm90::ldsm_x4(av, Vs + swz(ar, ac, D));
#pragma unroll
      for (int n2 = 0; n2 < C::kWq / 16; ++n2) {
        uint32_t bq[4], bo[4];
        const int br = qc + 16 * n2 + (lane & 7) + ((lane >> 4) << 3);
        const int bc = 16 * kk + ((lane >> 3) & 1) * 8;
        sm90::ldsm_x4(bq, Qt + swz(br, bc, D));
        sm90::ldsm_x4(bo, dOt + swz(br, bc, D));
        sm90::mma16816<T>(s[2 * n2], ak, bq[0], bq[1]);
        sm90::mma16816<T>(s[2 * n2 + 1], ak, bq[2], bq[3]);
        sm90::mma16816<T>(dp[2 * n2], av, bo[0], bo[1]);
        sm90::mma16816<T>(dp[2 * n2 + 1], av, bo[2], bo[3]);
      }
    }
    // P^T = exp(S^T scale - lse) where visible, dS^T = P^T (dP^T - delta),
    // rounded to T into shared memory
    const bool need = tile_needs_mask(a, q0, Br, k0, Bc);
#pragma unroll
    for (int n = 0; n < C::kWq / 8; ++n) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = kr + lane / 4 + 8 * hf;
        const int qq = qc + 8 * n + 2 * (lane % 4);
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pv = exp2f(fmaf(s[n][2 * hf + e], sl,
                                -lse_t[qq + e] * kLog2e));
          if (need && !visible(q0 + qq + e, k0 + key, a)) pv = 0.f;
          p[e] = pv;
          ds[e] = pv * (dp[n][2 * hf + e] - delta_t[qq + e]);
        }
        *reinterpret_cast<uint32_t*>(Ps + swz(key, qq, Br)) =
            sm90::pack<T>(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSs + swz(key, qq, Br)) =
            sm90::pack<T>(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: 16 keys x kWd columns a warp
#pragma unroll
    for (int kk = 0; kk < Br / 16; ++kk) {
      uint32_t ap[4], as[4];
      const int ar = kr + (lane & 15), ac = 16 * kk + (lane >> 4) * 8;
      sm90::ldsm_x4(ap, Ps + swz(ar, ac, Br));
      sm90::ldsm_x4(as, dSs + swz(ar, ac, Br));
#pragma unroll
      for (int n2 = 0; n2 < C::kWd / 16; ++n2) {
        uint32_t bo[4], bq[4];
        const int br = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int bc = dc + 16 * n2 + (lane >> 4) * 8;
        sm90::ldsm_x4_t(bo, dOt + swz(br, bc, D));
        sm90::ldsm_x4_t(bq, Qt + swz(br, bc, D));
        sm90::mma16816<T>(dv[2 * n2], ap, bo[0], bo[1]);
        sm90::mma16816<T>(dv[2 * n2 + 1], ap, bo[2], bo[3]);
        sm90::mma16816<T>(dk[2 * n2], as, bq[0], bq[1]);
        sm90::mma16816<T>(dk[2 * n2 + 1], as, bq[2], bq[3]);
      }
    }
    if constexpr (kFused) {
      // dQ = dS K: 16 queries x kWdq columns a warp, added into fp32 dq
      float acc[C::kWdq / 8][4];
#pragma unroll
      for (int n = 0; n < C::kWdq / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < Bc / 16; ++kk) {
        uint32_t ad[4];
        sm90::ldsm_x4_t(ad, dSs + swz(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                      qr + ((lane >> 3) & 1) * 8, Br));
#pragma unroll
        for (int n2 = 0; n2 < C::kWdq / 16; ++n2) {
          uint32_t bk[4];
          sm90::ldsm_x4_t(bk, Ks + swz(16 * kk + (lane & 7)
                                           + ((lane >> 3) & 1) * 8,
                                       dqc + 16 * n2 + (lane >> 4) * 8, D));
          sm90::mma16816<T>(acc[2 * n2], ad, bk[0], bk[1]);
          sm90::mma16816<T>(acc[2 * n2 + 1], ad, bk[2], bk[3]);
        }
      }
      float* dqp = static_cast<float*>(a.dq)
                   + (long long)bb * a.sq * a.nh * D + h * D;
#pragma unroll
      for (int n = 0; n < C::kWdq / 8; ++n) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = q0 + qr + lane / 4 + 8 * hf;
          const int col = dqc + 8 * n + 2 * (lane % 4);
          if (row < a.sq)
            atomicAdd(reinterpret_cast<float2*>(
                          dqp + (long long)row * a.nh * D + col),
                      make_float2(acc[n][2 * hf] * a.scale,
                                  acc[n][2 * hf + 1] * a.scale));
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < C::kWd / 8; ++n) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + kr + lane / 4 + 8 * hf;
      const int col = dc + 8 * n + 2 * (lane % 4);
      if (key < a.sk)
        store_dkv2<T>(a, bb, g, split, key, col,
                         dk[n][2 * hf] * a.scale,
                         dk[n][2 * hf + 1] * a.scale, dv[n][2 * hf],
                         dv[n][2 * hf + 1]);
    }
  }
}

// --------------------------------------------------------------------------
// G, bf16 and fp16, d 64 and 128: warp-specialised wgmma + TMA
// --------------------------------------------------------------------------

// kCons consumer warpgroups of 64 keys each, and a producer warpgroup
template <int D> struct BwdWgTile {
  static constexpr int kCons = D == 64 ? 2 : 1;
  static constexpr int kBr = 64;                   // queries of a q-tile
  static constexpr int kBc = 64 * kCons;
  static constexpr int kStages = 2;
  static constexpr int kAtoms = D / 64;
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr uint32_t kKvBytes = kBc * D * 2;   // K or V
  static constexpr uint32_t kQBytes = kBr * D * 2;    // Q or dO, a stage
  static constexpr uint32_t kDsBytes = kBc * kBr * 2; // dS^T, a buffer
  static constexpr uint32_t kRowBytes = kBr * 4;      // lse or delta
  // K, V, the Q/dO/lse/delta ring, two dS^T buffers, barriers, and slack
  // to align to 1024
  static constexpr size_t kSmem = 1024 + 2 * kKvBytes
                                  + kStages * (2 * kQBytes + 2 * kRowBytes)
                                  + 2 * kDsBytes + 8 * (1 + 2 * kStages);
};

struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <typename T, int D>
__global__ void __launch_bounds__(BwdWgTile<D>::kThreads, 1)
flash_bwd_kv_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                          const Args a) {
  using C = BwdWgTile<D>;
  constexpr int Br = C::kBr, Bc = C::kBc, S = C::kStages;
  constexpr int kAtomKv = Bc * 64, kAtomQ = Br * 64;  // elements
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* Ks = reinterpret_cast<T*>(base);           // [atom][Bc][64]
  T* Vs = Ks + C::kAtoms * kAtomKv;
  T* Qs = Vs + C::kAtoms * kAtomKv;                // [S][atom][Br][64]
  T* dOs = Qs + S * C::kAtoms * kAtomQ;
  T* dSs = dOs + S * C::kAtoms * kAtomQ;           // [2][Bc][Br]
  float* lse_s = reinterpret_cast<float*>(dSs + 2 * Bc * Br);  // [S][Br]
  float* delta_s = lse_s + S * Br;                             // [S][Br]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + S * Br);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + S;

  const int k0 = blockIdx.z * Bc, bb = blockIdx.y;
  const int g = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  int qt_lo, qt_hi, h_lo, h_hi;
  q_tile_range(a, k0, Br, Bc, &qt_lo, &qt_hi);
  split_heads(a, g, split, &h_lo, &h_hi);
  const int nq = max(0, qt_hi - qt_lo + 1);
  const int n_iter = nq * (h_hi - h_lo);

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&q_full[s], 1);
      sm90::mbar_init(&q_empty[s], 4 * C::kCons);  // each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * C::kCons) {
    // producer: one thread loads K and V, then keeps the ring of Q, dO,
    // lse and delta filled
    if constexpr (C::kCons > 1) sm90::reg_dealloc<24>();
    if (threadIdx.x == 128 * C::kCons) {
      sm90::mbar_expect_tx(kv_full, 2 * C::kKvBytes);
      for (int at = 0; at < C::kAtoms; ++at) {
        sm90::tma_load_4d(Ks + at * kAtomKv, &maps.k, kv_full, at * 64, k0,
                          g, bb);
        sm90::tma_load_4d(Vs + at * kAtomKv, &maps.v, kv_full, at * 64, k0,
                          g, bb);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % S;
        const int h = h_lo + it / nq, q0 = (qt_lo + it % nq) * Br;
        sm90::mbar_wait(&q_empty[s], ((it / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&q_full[s],
                             2 * C::kQBytes + 2 * C::kRowBytes);
        for (int at = 0; at < C::kAtoms; ++at) {
          sm90::tma_load_4d(Qs + (s * C::kAtoms + at) * kAtomQ, &maps.q,
                            &q_full[s], at * 64, q0, h, bb);
          sm90::tma_load_4d(dOs + (s * C::kAtoms + at) * kAtomQ,
                            &maps.dout, &q_full[s], at * 64, q0, h, bb);
        }
        const long long row = ((long long)bb * a.nh + h) * a.sq + q0;
        sm90::bulk_load(lse_s + s * Br, a.lse + row, C::kRowBytes,
                        &q_full[s]);
        sm90::bulk_load(delta_s + s * Br, a.delta + row, C::kRowBytes,
                        &q_full[s]);
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64)
    if constexpr (C::kCons > 1) sm90::reg_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int kr0 = 64 * wg + 16 * warp + lane / 4;  // rows kr0, kr0 + 8
    const float sl = a.scale * kLog2e;
    const T* Kw = Ks + wg * 64 * 64;  // this warpgroup's rows, atom 0
    const T* Vw = Vs + wg * 64 * 64;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    sm90::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % S;
      const uint32_t ph = (it / S) & 1;
      const int h = h_lo + it / nq, q0 = (qt_lo + it % nq) * Br;
      const T* Qt = Qs + s * C::kAtoms * kAtomQ;
      const T* dOt = dOs + s * C::kAtoms * kAtomQ;
      const float* lse_t = lse_s + s * Br;
      const float* delta_t = delta_s + s * Br;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      sm90::mbar_wait(&q_full[s], ph);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off_kv = (kk / 4) * kAtomKv + (kk % 4) * 16;
        const int off_q = (kk / 4) * kAtomQ + (kk % 4) * 16;
        sm90::Wgmma<64, T>::ss(st, sm90::desc_sw128(Kw + off_kv, 16, 1024),
                            sm90::desc_sw128(Qt + off_q, 16, 1024), kk > 0);
        sm90::Wgmma<64, T>::ss(dpt, sm90::desc_sw128(Vw + off_kv, 16, 1024),
                            sm90::desc_sw128(dOt + off_q, 16, 1024),
                            kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // P^T = exp(S^T scale - lse) where visible, dS^T = P^T (dP^T -
      // delta); element i is key row kr0 + 8 ((i >> 1) & 1), query column
      // 8 (i >> 2) + 2 (lane % 4) + (i & 1)
      const bool need = tile_needs_mask(a, q0, Br, k0 + 64 * wg, 64);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        float p = exp2f(fmaf(st[i], sl, -lse_t[qi] * kLog2e));
        if (need && !visible(q0 + qi, k0 + kr0 + 8 * ((i >> 1) & 1), a))
          p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - delta_t[qi]);
      }
      // as the m64k16 A fragments of the products over the queries
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = sm90::pack<T>(st[8 * kk + 2 * r],
                                      st[8 * kk + 2 * r + 1]);
          da[kk][r] = sm90::pack<T>(dpt[8 * kk + 2 * r],
                                      dpt[8 * kk + 2 * r + 1]);
        }
      // dS^T into this iteration's buffer, 128-byte swizzled rows of 64
      // queries: the MN-major A operand of dQ = dS K.  Register r of k-step
      // kk holds row kr0 + 8 (r & 1), 16-byte chunk 2 kk + r / 2.
      unsigned char* ds_buf = reinterpret_cast<unsigned char*>(
          dSs + (it & 1) * Bc * Br);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = kr0 + 8 * (r & 1);
          const int chunk = 2 * kk + (r >> 1);
          *reinterpret_cast<uint32_t*>(
              ds_buf + row * 128 + ((chunk ^ (row & 7)) << 4)
              + 4 * (lane % 4)) = da[kk][r];
        }
      sm90::fence_proxy_async();

      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major from the ring)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::Wgmma<D, T>::rs(dv, pa[kk],
                           sm90::desc_sw128(dOt + kk * 16 * 64, Br * 128,
                                            1024), 1);
        sm90::Wgmma<D, T>::rs(dk, da[kk],
                           sm90::desc_sw128(Qt + kk * 16 * 64, Br * 128,
                                            1024), 1);
      }
      sm90::wgmma_commit();

      // dQ = dS K over this warpgroup's 64 keys (every warp's dS^T rows
      // are in shared memory after the warpgroup's barrier); K MN-major
      sm90::named_barrier(1 + wg, 128);
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      sm90::wgmma_fence();
      const T* ds_rows = dSs + (it & 1) * Bc * Br + 64 * wg * 64;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D, T>::ss_tt(
            dq, sm90::desc_sw128(ds_rows + kk * 16 * 64, 16, 1024),
            sm90::desc_sw128(Kw + kk * 16 * 64, Bc * 128, 1024), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::fence_regs(dk);
      sm90::fence_regs(dv);
      if (lane == 0) sm90::mbar_arrive(&q_empty[s]);

      float* dqp = static_cast<float*>(a.dq)
                   + (long long)bb * a.sq * a.nh * D + h * D;
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int row = q0 + 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * (lane % 4);
        if (row < a.sq)
          atomicAdd(reinterpret_cast<float2*>(
                        dqp + (long long)row * a.nh * D + col),
                    make_float2(dq[i] * a.scale, dq[i + 1] * a.scale));
      }
    }

#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int key = k0 + kr0 + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane % 4);
      if (key < a.sk)
        store_dkv2<T>(a, bb, g, split, key, col, dk[i] * a.scale,
                         dk[i + 1] * a.scale, dv[i], dv[i + 1]);
    }
  }
}

// --------------------------------------------------------------------------
// H's dQ pass, bf16 and fp16: warp-specialised wgmma + TMA
// --------------------------------------------------------------------------

// kCons consumer warpgroups of 64 query rows each, and a producer
// warpgroup; 64-key tiles of K and V stream through a two-stage ring
template <int D> struct DqTile {
  static constexpr int kCons = D == 256 ? 1 : 2;
  static constexpr int kBr = 64 * kCons;           // queries of a q-tile
  static constexpr int kBc = 64;
  static constexpr int kStages = 2;
  static constexpr int kAtoms = D / 64;
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr uint32_t kQBytes = kBr * D * 2;   // Q or dO
  static constexpr uint32_t kKvBytes = kBc * D * 2;  // K or V, a stage
  // Q, dO, the K and V ring, barriers, and slack to align to 1024
  static constexpr size_t kSmem = 1024 + 2 * kQBytes
                                  + 2 * kStages * kKvBytes
                                  + 8 * (1 + 2 * kStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(DqTile<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps,
                          const Args a) {
  using C = DqTile<D>;
  constexpr int Br = C::kBr, Bc = C::kBc, S = C::kStages;
  constexpr int kAtomQ = Br * 64, kAtomKv = Bc * 64;  // elements
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* Qs = reinterpret_cast<T*>(base);                // [atom][Br][64]
  T* dOs = Qs + C::kAtoms * kAtomQ;
  T* Ks = dOs + C::kAtoms * kAtomQ;                     // [S][atom][Bc][64]
  T* Vs = Ks + S * C::kAtoms * kAtomKv;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + S * C::kAtoms
                                                 * kAtomKv);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + S;

  const int nqt = (a.sq + Br - 1) / Br;
  const int q0 = (nqt - 1 - (int)blockIdx.z) * Br;  // heaviest tiles first
  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / (a.nh / a.ng);
  int kt_lo, kt_hi;
  k_tile_range(a, q0, Br, Bc, &kt_lo, &kt_hi);
  const int n_tiles = max(0, kt_hi - kt_lo + 1);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 4 * C::kCons);  // each consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * C::kCons) {
    // producer: one thread loads Q and dO, then keeps the K/V ring filled
    if constexpr (C::kCons > 1) sm90::reg_dealloc<24>();
    if (threadIdx.x == 128 * C::kCons) {
      sm90::mbar_expect_tx(q_full, 2 * C::kQBytes);
      for (int at = 0; at < C::kAtoms; ++at) {
        sm90::tma_load_4d(Qs + at * kAtomQ, &maps.q, q_full, at * 64, q0, h,
                          bb);
        sm90::tma_load_4d(dOs + at * kAtomQ, &maps.dout, q_full, at * 64,
                          q0, h, bb);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % S;
        const int k0 = (kt_lo + it) * Bc;
        sm90::mbar_wait(&kv_empty[s], ((it / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&kv_full[s], 2 * C::kKvBytes);
        for (int at = 0; at < C::kAtoms; ++at) {
          sm90::tma_load_4d(Ks + (s * C::kAtoms + at) * kAtomKv, &maps.k,
                            &kv_full[s], at * 64, k0, g, bb);
          sm90::tma_load_4d(Vs + (s * C::kAtoms + at) * kAtomKv, &maps.v,
                            &kv_full[s], at * 64, k0, g, bb);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [q0 + 64 wg, q0 + 64 wg + 64)
    if constexpr (C::kCons > 1) sm90::reg_alloc<240>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int qw0 = q0 + 64 * wg;
    const int row0 = qw0 + 16 * warp + lane / 4;  // rows row0, row0 + 8
    const float sl = a.scale * kLog2e;
    // this thread's rows' lse (times log2 e) and delta; 0 past sq, where
    // every pair is masked
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long off = ((long long)bb * a.nh + h) * a.sq + row;
      lse2[r] = row < a.sq ? a.lse[off] * kLog2e : 0.f;
      dl[r] = row < a.sq ? a.delta[off] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    sm90::mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % S;
      const int k0 = (kt_lo + it) * Bc;
      const T* Kt = Ks + s * C::kAtoms * kAtomKv;
      const T* Vt = Vs + s * C::kAtoms * kAtomKv;
      sm90::mbar_wait(&kv_full[s], (it / S) & 1);
      // a tile that no pair of this warpgroup's rows sees (rows past sq,
      // the block's causal diagonal beyond them, or keys the window left
      // behind): no products, but the stage is still waited for and
      // released, so the ring's phases stay in step
      const bool none = qw0 >= a.sq || (a.causal && k0 > qw0 + 63)
                        || (a.window > 0 && k0 + Bc - 1 <= qw0 - a.window);
      if (!none) {
        // S = Q K^T and dP = dO V^T (K and V K-major from the ring)
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off_q = (kk / 4) * kAtomQ + wg * 64 * 64 + (kk % 4) * 16;
          const int off_kv = (kk / 4) * kAtomKv + (kk % 4) * 16;
          sm90::Wgmma<64, T>::ss(sc, sm90::desc_sw128(Qs + off_q, 16, 1024),
                              sm90::desc_sw128(Kt + off_kv, 16, 1024),
                              kk > 0);
          sm90::Wgmma<64, T>::ss(dp, sm90::desc_sw128(dOs + off_q, 16, 1024),
                              sm90::desc_sw128(Vt + off_kv, 16, 1024),
                              kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);

        // P = exp(S scale - lse) where visible, dS = P (dP - delta);
        // element i is row row0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2)
        // + 2 (lane % 4) + (i & 1)
        const bool need = tile_needs_mask(a, qw0, 64, k0, Bc);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          float p = exp2f(fmaf(sc[i], sl, -lse2[r]));
          if (need && !visible(row0 + 8 * r,
                               k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1),
                               a))
            p = 0.f;
          dp[i] = p * (dp[i] - dl[r]);
        }
        // dS as the m64k16 A fragments of dQ += dS K
        uint32_t da[Bc / 16][4];
#pragma unroll
        for (int kk = 0; kk < Bc / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            da[kk][r] = sm90::pack<T>(dp[8 * kk + 2 * r],
                                        dp[8 * kk + 2 * r + 1]);

        // dQ += dS K, K MN-major from the ring
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Bc / 16; ++kk)
          sm90::Wgmma<D, T>::rs(dq, da[kk],
                             sm90::desc_sw128(Kt + kk * 16 * 64, Bc * 128,
                                              1024), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
      }
      if (lane == 0) sm90::mbar_arrive(&kv_empty[s]);
    }

    // dq = scale * sum dS K, in T; rows past sq are not stored
    T* dqp = static_cast<T*>(a.dq) + (long long)bb * a.sq * a.nh * D
                + h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.sq) {
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(dqp + (long long)row * a.nh * D);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          dst[4 * j + lane % 4] =
              sm90::pack<T>(dq[4 * j + 2 * r] * a.scale,
                              dq[4 * j + 2 * r + 1] * a.scale);
      }
    }
  }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t st, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// the TMA element type of T
template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a [b, rows, heads, d] tensor of T (bf16 or fp16) read through its
// strides (elements: batch, seq, head), in boxes of 64 columns x box_rows
// rows with the 128-byte swizzle that wgmma reads; rows past the end read
// as zero
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int d, int rows,
                int heads, int batch, const long long* st, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, tma_type<T>(), 4,
            const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t fwd_tc(const Args& a, cudaStream_t st) {
  using C = FwdTile<D>;
  FwdMaps maps;
  if (!encode_map<T>(&maps.q, a.q, D, a.sq, a.nh, a.b, a.qs, C::kBr) ||
      !encode_map<T>(&maps.k, a.k, D, a.sk, a.ng, a.b, a.ks, C::kBc) ||
      !encode_map<T>(&maps.v, a.v, D, a.sk, a.ng, a.b, a.vs, C::kBc))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.nh, a.b, (a.sq + C::kBr - 1) / C::kBr);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_fused_wgmma(const Args& a, cudaStream_t st) {
  using C = BwdWgTile<D>;
  BwdMaps maps;
  if (!encode_map<T>(&maps.q, a.q, D, a.sq, a.nh, a.b, a.qs, C::kBr) ||
      !encode_map<T>(&maps.dout, a.dout, D, a.sq, a.nh, a.b, a.ds, C::kBr) ||
      !encode_map<T>(&maps.k, a.k, D, a.sk, a.ng, a.b, a.ks, C::kBc) ||
      !encode_map<T>(&maps.v, a.v, D, a.sk, a.ng, a.b, a.vs, C::kBc))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_kv_wgmma_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.ng * a.splits, a.b, (a.sk + C::kBc - 1) / C::kBc);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq_wgmma(const Args& a, cudaStream_t st) {
  using C = DqTile<D>;
  BwdMaps maps;
  if (!encode_map<T>(&maps.q, a.q, D, a.sq, a.nh, a.b, a.qs, C::kBr) ||
      !encode_map<T>(&maps.dout, a.dout, D, a.sq, a.nh, a.b, a.ds, C::kBr) ||
      !encode_map<T>(&maps.k, a.k, D, a.sk, a.ng, a.b, a.ks, C::kBc) ||
      !encode_map<T>(&maps.v, a.v, D, a.sk, a.ng, a.b, a.vs, C::kBc))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.nh, a.b, (a.sq + C::kBr - 1) / C::kBr);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_prep(const Args& a, bool zero_dq, cudaStream_t st) {
  const long long rows = (long long)a.b * a.sq * a.nh;
  flash_bwd_prep_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      a, zero_dq ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv_sum(const Args& a, cudaStream_t st) {
  if (a.splits == 1) return cudaSuccess;
  const long long n = 2LL * a.b * a.sk * a.ng * a.d;
  flash_dkv_sum_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a);
  return cudaGetLastError();
}

// pass 0: forward; 1: fused backward (G); 2: two-pass backward (H), on
// the tensor cores for T = bf16 or fp16
template <typename T, int D>
cudaError_t run_tc(const Args& a, int pass, cudaStream_t st) {
  if (pass == 0) return fwd_tc<T, D>(a, st);
  using B = BwdTile<D>;
  const dim3 kv_grid(a.ng * a.splits, a.b, (a.sk + B::kBc - 1) / B::kBc);
  cudaError_t e = bwd_prep<T>(a, pass == 1, st);
  if (e != cudaSuccess) return e;
  if (pass == 1) {
    if constexpr (D <= 128)
      e = bwd_fused_wgmma<T, D>(a, st);
    else
      e = launch(flash_bwd_kv_mma_kernel<T, D, true>, kv_grid, B::kThreads,
                 B::kSmem, st, a);
  } else {
    e = bwd_dq_wgmma<T, D>(a, st);
    if (e != cudaSuccess) return e;
    e = launch(flash_bwd_kv_mma_kernel<T, D, false>, kv_grid, B::kThreads,
               B::kSmem, st, a);
  }
  if (e != cudaSuccess) return e;
  return dkv_sum<T>(a, st);
}

template <int D>
cudaError_t run_fp32(const Args& a, int pass, cudaStream_t st) {
  using G = Geo<float, D>;
  if (pass == 0) {
    const dim3 grid((a.sq + G::Br - 1) / G::Br, a.nh, a.b);
    return launch(flash_fwd_kernel<float, D>, grid, kThreads, G::kFwd, st,
                  a);
  }
  const dim3 kv_grid((a.sk + G::Bc - 1) / G::Bc, a.ng * a.splits, a.b);
  cudaError_t e = bwd_prep<float>(a, pass == 1, st);
  if (e != cudaSuccess) return e;
  if (pass == 1) {
    e = launch(flash_bwd_kv_kernel<float, D, true>, kv_grid, kThreads,
               G::kBwdFused, st, a);
  } else {
    const dim3 dq_grid((a.sq + G::Br - 1) / G::Br, a.nh, a.b);
    e = launch(flash_bwd_dq_kernel<float, D>, dq_grid, kThreads, G::kBwdDq,
               st, a);
    if (e != cudaSuccess) return e;
    e = launch(flash_bwd_kv_kernel<float, D, false>, kv_grid, kThreads,
               G::kBwdKv, st, a);
  }
  if (e != cudaSuccess) return e;
  return dkv_sum<float>(a, st);
}

cudaError_t dispatch(const Args& a, int dtype, int pass, cudaStream_t st) {
  if (dtype == mlt::kBFloat16) {
    if (a.d == 64) return run_tc<bf16, 64>(a, pass, st);
    if (a.d == 128) return run_tc<bf16, 128>(a, pass, st);
    if (a.d == 256) return run_tc<bf16, 256>(a, pass, st);
  } else if (dtype == mlt::kFloat16) {
    if (a.d == 64) return run_tc<__half, 64>(a, pass, st);
    if (a.d == 128) return run_tc<__half, 128>(a, pass, st);
    if (a.d == 256) return run_tc<__half, 256>(a, pass, st);
  } else if (dtype == mlt::kFloat32) {
    if (a.d == 64) return run_fp32<64>(a, pass, st);
    if (a.d == 128) return run_fp32<128>(a, pass, st);
    if (a.d == 256) return run_fp32<256>(a, pass, st);
  }
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v,
               const long long* strides, int b, int sq, int sk, int nh,
               int ng, int d, float scale, int causal, int window) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.ds[i] = strides[9 + i];
  }
  a.b = b;
  a.sq = sq;
  a.sk = sk;
  a.nh = nh;
  a.ng = ng;
  a.d = d;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.splits = 1;
  return a;
}

bool valid_shape(int b, int sq, int sk, int nh, int ng) {
  return b > 0 && sq > 0 && sk > 0 && ng > 0 && nh % ng == 0;
}

}  // namespace

// Tile shapes (rows of q, rows of k) of the kernels for a dtype code and
// head_dim, into out[8]: the forward, G, H's dQ pass and H's dK/dV pass.
// Returns 0, or cudaErrorInvalidValue for a pair with no kernel.
extern "C" int mlt_flash_tiles(int dtype, int d, int* out) {
  if (d != 64 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  if (dtype == mlt::kBFloat16 || dtype == mlt::kFloat16) {
    const int small = d == 256;
    const int g_keys = d == 64 ? 128 : small ? 32 : 64;
    const int v[8] = {128, small ? 64 : 128, 64, g_keys, small ? 64 : 128,
                      64, 64, small ? 32 : 64};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  }
  if (dtype == mlt::kFloat32) {
    const int t = d == 256 ? 16 : 32;
    for (int i = 0; i < 8; ++i) out[i] = t;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory in bytes of the kernels for a dtype code and
// head_dim, into out[4]: the forward, G's dK/dV kernel, H's dQ pass and
// H's dK/dV pass.  Returns 0, or cudaErrorInvalidValue.
extern "C" int mlt_flash_smem(int dtype, int d, long long* out) {
  if ((dtype == mlt::kBFloat16 || dtype == mlt::kFloat16)
      && (d == 64 || d == 128 || d == 256)) {
    const long long fwd = d == 64 ? FwdTile<64>::kSmem
                          : d == 128 ? FwdTile<128>::kSmem
                                     : FwdTile<256>::kSmem;
    const long long kv = d == 64 ? BwdTile<64>::kSmem
                         : d == 128 ? BwdTile<128>::kSmem
                                    : BwdTile<256>::kSmem;
    out[0] = fwd;
    out[1] = d == 64 ? BwdWgTile<64>::kSmem
             : d == 128 ? BwdWgTile<128>::kSmem : kv;
    out[3] = kv;
    out[2] = d == 64 ? DqTile<64>::kSmem
             : d == 128 ? DqTile<128>::kSmem : DqTile<256>::kSmem;
    return 0;
  }
  if (dtype == mlt::kFloat32 && (d == 64 || d == 128 || d == 256)) {
    using G64 = Geo<float, 64>;
    using G128 = Geo<float, 128>;
    using G256 = Geo<float, 256>;
    out[0] = d == 64 ? G64::kFwd : d == 128 ? G128::kFwd : G256::kFwd;
    out[1] = d == 64 ? G64::kBwdFused
             : d == 128 ? G128::kBwdFused : G256::kBwdFused;
    out[2] = d == 64 ? G64::kBwdDq : d == 128 ? G128::kBwdDq : G256::kBwdDq;
    out[3] = d == 64 ? G64::kBwdKv : d == 128 ? G128::kBwdKv : G256::kBwdKv;
    return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// Forward.  q [b, sq, nh, d], k and v [b, sk, ng, d] with the strides
// `strides` (12 values: batch, seq, head strides of q, k, v and dout, in
// elements; the last axis is contiguous); o [b, sq, nh, d] contiguous;
// lse [b, nh, sq] fp32.  window <= 0 means none.  Returns a cudaError_t.
extern "C" int mlt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             int b, int sq, int sk, int nh, int ng, int d,
                             float scale, int causal, int window, int dtype,
                             void* stream) {
  if (!valid_shape(b, sq, sk, nh, ng)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, strides, b, sq, sk, nh, ng, d, scale, causal,
                     window);
  a.o = o;
  a.lse = lse;
  return (int)dispatch(a, dtype, 0, static_cast<cudaStream_t>(stream));
}

// Backward.  dout as q (strides 9..11), o [b, sq, nh, d] contiguous, lse
// [b, nh, sq] fp32; delta [b, nh, sq] fp32 is written here (rowsum of
// dout * o); dk, dv [b, sk, ng, d] contiguous in the input type.  fused =
// 1 runs G and adds dq into an fp32 [b, sq, nh, d] buffer that it zeroes
// first; fused = 0 runs H and writes dq [b, sq, nh, d] in the input type.
// splits > 1 splits each KV group's query heads over that many blocks,
// which write fp32 partials into dkv_part [splits, 2, b, sk, ng, d] that
// are then summed in split order.
extern "C" int mlt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, float* lse,
                             float* delta, void* dq, void* dk, void* dv,
                             float* dkv_part, const long long* strides,
                             int b, int sq, int sk, int nh, int ng, int d,
                             float scale, int causal, int window, int fused,
                             int splits, int dtype, void* stream) {
  if (!valid_shape(b, sq, sk, nh, ng) || splits < 1 ||
      splits > nh / ng || (splits > 1 && dkv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, strides, b, sq, sk, nh, ng, d, scale, causal,
                     window);
  a.o = const_cast<void*>(o);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dkv_part = dkv_part;
  a.splits = splits;
  return (int)dispatch(a, dtype, fused ? 1 : 2,
                       static_cast<cudaStream_t>(stream));
}
