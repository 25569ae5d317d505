// Warp-level TF32 tensor-core products for Hopper (sm_90a) through
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with the 3xTF32 split
// that keeps float32 accuracy.
//
// A float32 operand x is split as hi = tf32(x), lo = tf32(x - hi) (both
// rounded to nearest, ties away); then a * b ~= hi_a hi_b + hi_a lo_b +
// lo_a hi_b with float32 accumulation, which drops only lo_a lo_b, about
// 2^-22 of the product. An operand that is exact in TF32 (a widened bf16
// value: 8 significant bits of TF32's 11) needs no split and no lo pass, so a
// product takes 1 pass when both operands are exact, 2 when one is, 3 when
// neither is.
//
// Fragment layouts of m16n8k8 with .tf32 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   A (16 x 8):  a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4], a3 = A[g + 8][t + 4]
//   B (8 x 8):   b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 x 8):  c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t], c3 = C[g + 8][2t + 1]

#pragma once

#include <stdint.h>

namespace mma_tf32 {

// Round to TF32 (cvt.rna), returned as the 32-bit register the mma takes.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Operand registers of one value: hi, and lo only where the value is not exact.
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
  } else {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
}

// c += a b on one 16 x 8 x 8 tile.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Element (i, k) of a shared-memory operand with row index i and depth k:
// depth contiguous (KMAJOR, p[i * ld + k]) or rows contiguous (p[k * ld + i]).
// The fragment loads are free of bank conflicts when ld % 32 == 4 for a
// KMAJOR operand and ld % 32 == 8 otherwise.
template <bool KMAJOR>
__device__ __forceinline__ float at(const float* p, int ld, int i, int k) {
  return KMAJOR ? p[i * ld + k] : p[k * ld + i];
}

// One warp: acc (a 32 x 32 tile at rows r0, columns c0 of the product) +=
// sum over k < K of A(r0 + i, k) B(k, c0 + j), both operands in shared memory
// as float32. A(i, k) = at<A_KMAJOR>(As, lda, i, k); B(k, j) =
// at<B_KMAJOR>(Bs, ldb, j, k). A_EXACT / B_EXACT: that operand is exact in
// TF32 (no lo pass). acc[mi][nj] is the C fragment of the 16 x 8 tile at rows
// r0 + 16 mi, columns c0 + 8 nj.
// Over a long sum (dP over Cv = 512: 80 mma steps) the tensor cores' own
// addition into their accumulator loses accuracy with the step count: up to
// 3.6e-5 of the largest gradient on the H100, against 5.0e-6 when the K-deep
// partial sum of one call starts from zero and is added to acc with float32
// adds, as here.
template <bool A_KMAJOR, bool B_KMAJOR, bool A_EXACT, bool B_EXACT, int K>
__device__ __forceinline__ void warp_tile_32x32(float acc[2][4][4], const float* As, int lda,
                                                const float* Bs, int ldb, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float part[2][4][4] = {};
  // unrolled whole: with `unroll 2` the partial sum made the dK/dV kernel
  // about 40% slower on the H100
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = r0 + 16 * mi + g;
      split<A_EXACT>(at<A_KMAJOR>(As, lda, r, k0 + t), ah[mi][0], al[mi][0]);
      split<A_EXACT>(at<A_KMAJOR>(As, lda, r + 8, k0 + t), ah[mi][1], al[mi][1]);
      split<A_EXACT>(at<A_KMAJOR>(As, lda, r, k0 + t + 4), ah[mi][2], al[mi][2]);
      split<A_EXACT>(at<A_KMAJOR>(As, lda, r + 8, k0 + t + 4), ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int c = c0 + 8 * nj + g;
      split<B_EXACT>(at<B_KMAJOR>(Bs, ldb, c, k0 + t), bh[nj][0], bl[nj][0]);
      split<B_EXACT>(at<B_KMAJOR>(Bs, ldb, c, k0 + t + 4), bh[nj][1], bl[nj][1]);
    }
    // the small terms first, then hi * hi
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        if constexpr (!A_EXACT) mma(part[mi][nj], al[mi], bh[nj]);
        if constexpr (!B_EXACT) mma(part[mi][nj], ah[mi], bl[nj]);
        mma(part[mi][nj], ah[mi], bh[nj]);
      }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[mi][nj][e];
}

}  // namespace mma_tf32
