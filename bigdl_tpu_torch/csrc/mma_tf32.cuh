// Inline-PTX helpers for the f32 tensor-core kernels of the port (sm_90a):
// the split of f32 values into tf32 pieces and the m16n8k8 tf32 product
// with f32 accumulators, three times per f32 product ("3xTF32"). Included
// by conv3x3_bn.cu (K6's "tf32x3" variant) and flash_fwd.cu (K1's).
//
// Fragment layouts of mma.m16n8k8 .tf32 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4; one 32-bit register per element):
//   A (16 x 8, row-major): a0 = A[g][t],   a1 = A[g+8][t],
//                          a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, "col"):      b0 = B[t][g],   b1 = B[t+4][g]
//   C (16 x 8, f32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// The sum over k does not care which of the 8 depth indices a column of A
// and a row of B stand for, as long as both agree; the kernels use that to
// read k indices t and t+4 from neighbouring addresses (one 8- or 16-byte
// load of A instead of two or four).
//
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both rounded
// to nearest (cvt.rna); x - hi is exact in f32, and hi + lo is x to about
// 2^-22 |x|. a * b is then hi_a hi_b + hi_a lo_b + lo_a hi_b (lo_a lo_b,
// about 2^-22 |a b|, is dropped): f32-accurate products at three times the
// tensor-core work, where one tf32 pass keeps only 2^-11.

#pragma once

#include <stdint.h>

namespace mma_tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as tf32 hi + lo (see above)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a * b over one 16 x 8 x 8 tile, tf32 in, f32 accumulators
__device__ __forceinline__ void mma_1688(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b to f32 accuracy from the pieces of a (ah, al) and of b
// (bh0, bh1; bl0, bl1): the two small products first, then the large one
__device__ __forceinline__ void mma3(float d[4], const uint32_t ah[4],
                                     const uint32_t al[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_1688(d, al, bh0, bh1);
  mma_1688(d, ah, bl0, bl1);
  mma_1688(d, ah, bh0, bh1);
}

}  // namespace mma_tf32
