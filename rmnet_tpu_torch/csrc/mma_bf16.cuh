// Warp-level bf16 tensor-core products for Hopper (sm_90a) through
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (float32 accumulation),
// with ldmatrix fragment loads from shared memory and 16-byte cp.async
// copies into it.
//
// Fragment layouts of m16n8k16 with .bf16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4; each 32-bit register
// holds two bf16 values, the lower depth index in the low half:
//   A (16 x 16): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8):  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):  c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// So the C fragments of two neighbouring 16 x 8 tiles (columns 16j .. 16j+7
// and 16j+8 .. 16j+15), rounded to bf16 and packed, are the A fragment of
// depth step j of the next product: P of Q K^T feeds P V from registers.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i .. 8i+7 give the row
// addresses of matrix i (16 bytes each) and register i receives matrix i,
// lane holding row g, elements 2t and 2t+1 (transposed with .trans: column
// g, rows 2t and 2t+1). The eight rows of one matrix fall in distinct bank
// groups when the row stride in bytes is 16 modulo 128.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices from the row addresses of this lane's group.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a b on one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace mma_bf16
