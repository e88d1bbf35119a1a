// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of
// megatron_llm_tpu/ops/pallas/flash_attention.py:
//   F  `_fwd_kernel` (through `_fwd_call`): flash_fwd_kernel
//   G  `_bwd_fused_kernel` (through `_bwd_fused_call`):
//      flash_bwd_kv_kernel<T, D, true>
//   H  `_bwd_dq_kernel` + `_bwd_dkv_kernel` (through `_bwd_call`):
//      flash_bwd_dq_kernel, then flash_bwd_kv_kernel<T, D, false>
// Causal and sliding-window attention with GQA/MQA (k and v carry ng <= nh
// heads), q [b, sq, nh, d], k and v [b, sk, ng, d] read in place through
// their batch, sequence and head strides (the JAX wrapper transposes to
// [b, heads, s, d] first; nothing is transposed here).  A key k is visible
// to query q when k < sk, q < sq, k <= q (causal) and k > q - window, the
// element-level mask of the Pallas kernels.
//
// Bound on this card: operations.  At Llama-2-7B training shapes (b = 1,
// s = 4096, nh = 32, d = 128) the causal forward does 4 * s^2 * nh * d / 2
// = 137 GFLOP (0.139 ms at 989 TFLOP/s bf16) against 2 * 4096 * 32 * 128 *
// 2 B * 2 = 134 MB of q, k, v and o (0.040 ms at 3.35 TB/s); the backward
// does 2.5 times the forward's products.
//
// Design.  One block of 4 warps per (q-tile, query head, batch) for the
// forward and the dQ pass, one block per (k-tile, KV group, batch) for the
// dK/dV pass and the fused backward.  The TPU's sequential innermost grid
// axis, with (m, l, acc) carried in VMEM scratch, becomes a loop inside the
// block over only the tiles the causal band and the window reach.  Tiles
// are staged in shared memory with 16-byte loads; the softmax state and
// every accumulator stay fp32.  Block products of bf16 tiles run on the
// tensor cores through nvcuda::wmma (16x16x16, fp32 accumulation) between
// shared-memory tiles; fp32 inputs take a CUDA-core product of the same
// tiles, so the fp32 path keeps full fp32 precision.  A kernel that is right
// comes first here: the round trip of every product through shared memory,
// 4 warps per block and no copy/compute overlap keep it far from its bound
// (wgmma, TMA and warp specialisation are the next steps).
//
// Backward.  delta = rowsum(dO * O) comes in precomputed, as the JAX wrapper
// leaves it to XLA.  The fused kernel (G) holds dK and dV of its k-tile in
// fp32 shared memory while it loops over the group's query heads and the
// q-tiles that reach it, so the JAX per-query-head dk/dv and their group
// sum disappear; dQ of each (q-tile, k-tile) pair is added into an fp32
// [b, sq, nh, d] buffer with 16-byte atomics (the counterpart of the
// VMEM-resident dq slab), so its rounding order varies from run to run.
// The two-pass backward (H) needs no atomics and is deterministic: a dQ
// pass over k-tiles, then the same dK/dV kernel without the dQ term.  The
// JAX FUSED_BWD_MAX_SLAB_BYTES cap is a VMEM limit with no counterpart here.

#include <stdint.h>

#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// tile shape per element type: bf16 tiles feed the tensor cores; fp32 tiles
// are smaller so that the backward's fp32 tiles fit shared memory
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int kBr = 64, kBc = 64, kPad = 8;
};
template <> struct Tile<float> {
  static constexpr int kBr = 32, kBc = 32, kPad = 4;
};

constexpr size_t rnd(size_t x) { return (x + 127) / 128 * 128; }

// shared-memory tile geometry (leading dimensions in elements, buffer sizes
// in bytes rounded to 128 so every buffer starts 128-byte aligned)
template <typename T, int D> struct Geo {
  static constexpr int Br = Tile<T>::kBr, Bc = Tile<T>::kBc;
  static constexpr int LDT = D + Tile<T>::kPad;   // [rows][D] tiles of T
  static constexpr int LDS = Bc + 4;              // fp32 [Br][Bc] scores
  static constexpr int LDP = Bc + Tile<T>::kPad;  // [Br][Bc] tiles of T
  static constexpr int LDO = D + 4;               // fp32 [rows][D] sums
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

struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float* lse;           // [b, nh, sq]
  const float* delta;   // [b, nh, sq]
  long long qs[3], ks[3], vs[3], ds[3];  // batch, seq, head strides
  int b, sq, sk, nh, ng;
  float scale;
  int causal, window;   // window <= 0: none
};

__device__ __forceinline__ bool visible(int q, int k, const Args& a) {
  bool ok = (q < a.sq) && (k < a.sk);
  if (a.causal) ok = ok && (k <= q);
  if (a.window > 0) ok = ok && (k > q - a.window);
  return ok;
}

// C[M][N] (fp32, ldc) = or += op(A) * op(B), over the block's 4 warps.
//   A_T false: A is [M][K]; true: A is stored [K][M] (A^T is used)
//   B_T false: B is [K][N]; true: B is stored [N][K] (B^T is used)
template <typename T, int M, int N, int K, bool A_T, bool B_T, bool ACC>
struct TileMM;

// bf16: tensor cores, one 16x16 output tile per warp at a time
template <int M, int N, int K, bool A_T, bool B_T, bool ACC>
struct TileMM<__nv_bfloat16, M, N, K, A_T, B_T, ACC> {
  static __device__ __forceinline__ void run(float* C, int ldc,
                                             const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B,
                                             int ldb) {
    using ALayout = typename std::conditional<A_T, wmma::col_major,
                                              wmma::row_major>::type;
    using BLayout = typename std::conditional<B_T, wmma::col_major,
                                              wmma::row_major>::type;
    constexpr int TM = M / 16, TN = N / 16;
    const int warp = threadIdx.x >> 5;
    for (int t = warp; t < TM * TN; t += kWarps) {
      const int i = t / TN, j = t % TN;
      float* c = C + i * 16 * ldc + j * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if constexpr (ACC) {
        wmma::load_matrix_sync(acc, c, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
        const __nv_bfloat16* ap =
            A_T ? A + kk * 16 * lda + i * 16 : A + i * 16 * lda + kk * 16;
        const __nv_bfloat16* bp =
            B_T ? B + j * 16 * ldb + kk * 16 : B + kk * 16 * ldb + j * 16;
        wmma::load_matrix_sync(fa, ap, lda);
        wmma::load_matrix_sync(fb, bp, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c, acc, ldc, wmma::mem_row_major);
    }
  }
};

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

// first and last k-tile that the causal band and the window let a q-tile
// starting at q0 reach
__device__ __forceinline__ void k_tile_range(const Args& a, int q0, int Br,
                                             int Bc, int* lo, int* hi) {
  *lo = 0;
  *hi = (a.sk - 1) / Bc;
  if (a.causal) *hi = min(*hi, (q0 + Br - 1) / Bc);
  if (a.window > 0) *lo = max(0, q0 - a.window + 1) / Bc;
}

// --------------------------------------------------------------------------
// F: forward
// --------------------------------------------------------------------------

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

// --------------------------------------------------------------------------
// H, first pass: dQ over the k-tiles a q-tile reaches
// --------------------------------------------------------------------------

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

// --------------------------------------------------------------------------
// dK/dV over the group's query heads and the q-tiles that reach a k-tile:
// H's second pass, and with kFused the whole of G (dQ added by atomics)
// --------------------------------------------------------------------------

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

  const int k0 = blockIdx.x * Bc, g = blockIdx.y, bb = blockIdx.z;
  const int qpg = a.nh / a.ng;
  const T* kp = static_cast<const T*>(a.k) + bb * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + bb * a.vs[0] + g * a.vs[2];

  load_rows<T, Bc, D>(Ks, G::LDT, kp, a.ks[1], k0, a.sk);
  load_rows<T, Bc, D>(Vs, G::LDT, vp, a.vs[1], k0, a.sk);
  zero(dKs, Bc * G::LDO);
  zero(dVs, Bc * G::LDO);
  // q-tiles that reach this k-tile: causal needs q >= k0, the window
  // q < k + window for some key of the tile
  int qt_lo = a.causal ? k0 / Br : 0;
  int qt_hi = (a.sq - 1) / Br;
  if (a.window > 0)
    qt_hi = min(qt_hi, (min(k0 + Bc, a.sk) - 1 + a.window - 1) / Br);
  for (int j = 0; j < qpg; ++j) {
    const int h = g * qpg + j;
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
  T* dkp = static_cast<T*>(a.dk) + (long long)bb * a.sk * a.ng * D + g * D;
  T* dvp = static_cast<T*>(a.dv) + (long long)bb * a.sk * a.ng * D + g * D;
  for (int e = threadIdx.x; e < Bc * D; e += kThreads) {
    const int r = e / D, c = e % D;
    if (k0 + r < a.sk) {
      const long long off = (long long)(k0 + r) * a.ng * D + c;
      dkp[off] = mlt::from_float<T>(dKs[r * G::LDO + c] * a.scale);
      dvp[off] = mlt::from_float<T>(dVs[r * G::LDO + c]);
    }
  }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, const Args& a,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const Args& a, cudaStream_t st) {
  using G = Geo<T, D>;
  const dim3 grid((a.sq + G::Br - 1) / G::Br, a.nh, a.b);
  return launch(flash_fwd_kernel<T, D>, grid, G::kFwd, a, st);
}

template <typename T, int D>
cudaError_t bwd(const Args& a, bool fused, cudaStream_t st) {
  using G = Geo<T, D>;
  const dim3 kv_grid((a.sk + G::Bc - 1) / G::Bc, a.ng, a.b);
  if (fused)
    return launch(flash_bwd_kv_kernel<T, D, true>, kv_grid, G::kBwdFused, a,
                  st);
  const dim3 dq_grid((a.sq + G::Br - 1) / G::Br, a.nh, a.b);
  cudaError_t e = launch(flash_bwd_dq_kernel<T, D>, dq_grid, G::kBwdDq, a,
                         st);
  if (e != cudaSuccess) return e;
  return launch(flash_bwd_kv_kernel<T, D, false>, kv_grid, G::kBwdKv, a, st);
}

template <typename T>
cudaError_t dispatch(const Args& a, int d, int pass, cudaStream_t st) {
  // pass 0: forward, 1: fused backward (G), 2: two-pass backward (H)
  if (d == 64)
    return pass == 0 ? fwd<T, 64>(a, st) : bwd<T, 64>(a, pass == 1, st);
  if (d == 128)
    return pass == 0 ? fwd<T, 128>(a, st) : bwd<T, 128>(a, pass == 1, st);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v,
               const long long* strides, int b, int sq, int sk, int nh,
               int ng, float scale, int causal, int window) {
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
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return a;
}

bool valid_shape(int b, int sq, int sk, int nh, int ng) {
  return b > 0 && sq > 0 && sk > 0 && ng > 0 && nh % ng == 0;
}

}  // namespace

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
  Args a = make_args(q, k, v, strides, b, sq, sk, nh, ng, scale, causal,
                     window);
  a.o = o;
  a.lse = lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mlt::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(a, d, 0, st);
  if (dtype == mlt::kFloat32) return (int)dispatch<float>(a, d, 0, st);
  return (int)cudaErrorInvalidValue;
}

// Backward.  dout as q (strides 9..11), lse and delta [b, nh, sq] fp32;
// dk, dv [b, sk, ng, d] contiguous in the input type.  fused = 1 runs G
// and adds dq into a zeroed fp32 [b, sq, nh, d] buffer; fused = 0 runs H
// and writes dq [b, sq, nh, d] in the input type.
extern "C" int mlt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, float* lse,
                             const float* delta, void* dq, void* dk,
                             void* dv, const long long* strides, int b,
                             int sq, int sk, int nh, int ng, int d,
                             float scale, int causal, int window, int fused,
                             int dtype, void* stream) {
  if (!valid_shape(b, sq, sk, nh, ng)) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, strides, b, sq, sk, nh, ng, scale, causal,
                     window);
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pass = fused ? 1 : 2;
  if (dtype == mlt::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(a, d, pass, st);
  if (dtype == mlt::kFloat32) return (int)dispatch<float>(a, d, pass, st);
  return (int)cudaErrorInvalidValue;
}
