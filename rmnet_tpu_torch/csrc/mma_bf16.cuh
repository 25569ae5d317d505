// bf16 tensor-core products and the copies that feed them, for Hopper
// (sm_90a): warpgroup products (wgmma.mma_async, float32 accumulation) with
// operands in shared memory described by matrix descriptors, tensor-map
// copies (TMA, cp.async.bulk.tensor) that complete on mbarriers, register
// hand-over between warpgroups (setmaxnreg), and the 16-byte cp.async
// copies of the float32 forward.
//
// wgmma layouts (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply"),
// for warpgroup thread t: warp w = t / 32 holds rows 16 w .. 16 w + 15 of the
// 64-row tile; with g = lane / 4 and q = lane % 4:
//   D (64 x N, f32): d[4 j + e] = D[16 w + g + 8 (e / 2)][8 j + 2 q + e % 2]
//   A (64 x 16 bf16, from registers): a0 = A[16w+g][2q, 2q+1],
//       a1 = A[16w+g+8][2q, 2q+1], a2 = A[16w+g][2q+8, 2q+9],
//       a3 = A[16w+g+8][2q+8, 2q+9], the lower index in the low half
// So D of a 64 x 64 product, columns 16 k .. 16 k + 15 rounded to bf16 and
// packed, is A of depth step k of the next product: P of Q K^T feeds P V
// from registers.
//
// Shared-memory operands use the 128-byte swizzle that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes (64 bf16), 8-row atoms of
// 1024 bytes aligned to 1024, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8). Depth-contiguous ("K-major") operands advance their
// descriptor by 32 bytes per depth step of 16 inside a row and by a whole
// box past it; the stride between 8-row groups (SBO) is 1024 bytes. An
// N-contiguous ("MN-major", transposed) B operand of 64-column boxes has its
// 8-row groups along the depth at SBO = 1024 bytes and the next 64 columns
// one box further on (LBO = the box's bytes).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to bf16 (to nearest), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16-byte asynchronous copy from global to shared memory; with fill false
// nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add ``bytes`` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed (a fresh barrier
// is in phase 0, so parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------- TMA
// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory at ``dst``; its bytes complete on ``bar``. Out-of-range elements
// are written as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------ setmaxnreg
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ----------------------------------------------------------------- wgmma
// Matrix descriptor of a 128-byte-swizzled operand at shared address
// ``addr`` (byte offsets LBO and SBO as above).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait (the wait names no register).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments, which an in-flight wgmma still reads.
template <int N, int K>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][K]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

#define MMA_BF16_F4(d, i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define MMA_BF16_F16(d, i) \
  MMA_BF16_F4(d, i), MMA_BF16_F4(d, (i) + 4), MMA_BF16_F4(d, (i) + 8), MMA_BF16_F4(d, (i) + 12)
#define MMA_BF16_F32(d, i) MMA_BF16_F16(d, i), MMA_BF16_F16(d, (i) + 16)
#define MMA_BF16_F128(d) \
  MMA_BF16_F32(d, 0), MMA_BF16_F32(d, 32), MMA_BF16_F32(d, 64), MMA_BF16_F32(d, 96)
#define MMA_BF16_REGS32                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31"
#define MMA_BF16_REGS128                                                                      \
  MMA_BF16_REGS32                                                                             \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "    \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127"

// d (64 x 64) = A B (+ d when accumulate), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MMA_BF16_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MMA_BF16_F32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 256) = A B (+ d when accumulate), A from registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" MMA_BF16_REGS128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : MMA_BF16_F128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef MMA_BF16_F4
#undef MMA_BF16_F16
#undef MMA_BF16_F32
#undef MMA_BF16_F128
#undef MMA_BF16_REGS32
#undef MMA_BF16_REGS128

}  // namespace mma_bf16
