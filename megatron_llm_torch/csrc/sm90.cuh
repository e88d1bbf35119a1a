// Hopper (sm_90a) building blocks of the flash-attention kernels: shared
// addresses, mbarriers, TMA tile loads, wgmma (descriptors, fences and one
// wrapper per output width, its operand lists written out), and the
// sm_80-style warp-level mma.sync / ldmatrix / cp.async of the backward
// kernel that d 256 and the two-pass backward use.  Only PTX, so the
// kernels need no CUTLASS.
#pragma once

#include <stdint.h>

#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed.  A phase that
// does not complete within 10 s (a lost TMA transfer, a miscounted
// arrival) traps, so a fault ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && (polls & 1023) == 1023) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// ---- TMA --------------------------------------------------------------------

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared (16-byte aligned, a multiple
// of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// makes this thread's shared-memory writes visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous product
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle.  K-major operands:
// sbo = 1024 (8 rows of 128 B), lbo unused; MN-major: lbo = the stride of
// the 64-element column atoms, sbo = 1024 (8 rows of the K dimension).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// D[64 x N] fp32 (+)= A[64 x 16] B[16 x N] in T (bf16 or fp16) over one
// warpgroup; `acc` 0 overwrites D.  ss (N = 64, 128): A and B K-major in shared
// memory.  rs: A the m64k16 register fragment, B MN-major in shared
// memory.  ss_tt (N = 64, 128): A and B MN-major in shared memory.
template <int N, typename T> struct Wgmma;

// every specialisation of one element type T, whose PTX name is TY
#define SM90_WGMMA(T, TY) \
template <>                                                                   \
struct Wgmma<64, T> {                                                         \
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,      \
                                            uint64_t db, int acc) {           \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31"                                                  \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                            \
        : "l"(da), "l"(db), "r"(acc));                                        \
  }                                                                           \
  static __device__ __forceinline__ void rs(float (&d)[32],                   \
                                            const uint32_t (&a)[4],           \
                                            uint64_t db, int acc) {           \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31"                                                  \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));     \
  }                                                                           \
  /* A and B both MN-major in shared memory */                                \
  static __device__ __forceinline__ void ss_tt(float (&d)[32], uint64_t da,   \
                                               uint64_t db, int acc) {        \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"          \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31"                                                  \
        "}, %32, %33, p, 1, 1, 1, 1;\n}\n"                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                            \
        : "l"(da), "l"(db), "r"(acc));                                        \
  }                                                                           \
\
};                                                                            \
\
template <>                                                                   \
struct Wgmma<128, T> {                                                        \
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,      \
                                            uint64_t db, int acc) {           \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                    \
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "l"(da), "l"(db), "r"(acc));                                        \
  }                                                                           \
  static __device__ __forceinline__ void rs(float (&d)[64],                   \
                                            const uint32_t (&a)[4],           \
                                            uint64_t db, int acc) {           \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                    \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));     \
  }                                                                           \
  /* A and B both MN-major in shared memory */                                \
  static __device__ __forceinline__ void ss_tt(float (&d)[64], uint64_t da,   \
                                               uint64_t db, int acc) {        \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                    \
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"                                    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "l"(da), "l"(db), "r"(acc));                                        \
  }                                                                           \
\
};                                                                            \
\
template <>                                                                   \
struct Wgmma<256, T> {                                                        \
  static __device__ __forceinline__ void rs(float (&d)[128],                  \
                                            const uint32_t (&a)[4],           \
                                            uint64_t db, int acc) {           \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                         \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"         \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "   \
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "   \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "   \
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "   \
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "  \
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "  \
        "%127"                                                                \
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                 \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),    \
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),    \
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),    \
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),    \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),    \
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),    \
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),    \
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),    \
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),             \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),             \
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),             \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),             \
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),             \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),             \
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])              \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));     \
  }                                                                           \
};                                                                            \

SM90_WGMMA(__nv_bfloat16, "bf16")
SM90_WGMMA(__half, "f16")
#undef SM90_WGMMA

// ---- warp-level products (mma.sync, ldmatrix, cp.async) ---------------------

// C[16 x 8] += A[16 x 16] B[16 x 8], T (bf16 or fp16) in, fp32 accumulate
#define SM90_MMA16816(TY)                                                   \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "            \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"  \
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    SM90_MMA16816("f16");
  else
    SM90_MMA16816("bf16");
}
#undef SM90_MMA16816

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// 16 (or `bytes` < 16, the rest zero) bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two floats rounded to T (bf16 or fp16; fp16 past 65504 becomes inf) in
// one 32-bit register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// element offset of (r, c) in a [rows][cols] 16-bit tile whose 16-byte
// chunks are XOR-swizzled by the row (cols >= 64): the 8 rows an
// ldmatrix reads at one column land in 8 different bank groups
__device__ __forceinline__ int swz(int r, int c, int cols) {
  return r * cols + ((((c >> 3) ^ r) & 7) | ((c >> 3) & ~7)) * 8 + (c & 7);
}

}  // namespace sm90
