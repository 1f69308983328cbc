// Inline-PTX helpers for the bf16 tensor-core kernels of the port
// (sm_90a): asynchronous copies into shared memory, ldmatrix fragment
// loads, the m16n8k16 bf16 product with f32 accumulators, and the split of
// f32 values into bf16 pieces. Included by conv3x3_bn.cu, flash_fwd.cu and
// flash_bwd.cu.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4; each 32-bit register holds two bf16, the lower column in
// the low half):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16 x 8, "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// ldmatrix.x4 loads four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row
// addresses (16 bytes each) of matrix i, and register i receives matrix i
// in the A/C layout (row g, columns 2t, 2t+1), or transposed with .trans.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; when !valid nothing is read and
// the 16 bytes are zero-filled (src-size 0). `src` must be a valid address
// either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (through L1), zero-filled when !valid; for f32
// rows whose start is not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// bf16 elements per row of a staged tile of D columns: 16 bytes of padding,
// so that ldmatrix reads it free of bank conflicts
template <int D>
__host__ __device__ constexpr int tile_pitch() { return D + 8; }

// ROWS rows of D bf16 (positions `stride` elements apart in global memory)
// into a shared tile of row pitch tile_pitch<D>(), by THREADS threads; rows
// at or past `rows` are zero-filled and read nothing. Commit the group
// after it.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long stride, int rows, int tid) {
  constexpr int PIECES = D / 8;  // 16-byte pieces per row
#pragma unroll
  for (int i = tid; i < ROWS * PIECES; i += THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 8;
    const bool in = r < rows;
    cp_async16(dst + r * tile_pitch<D>() + c, in ? src + r * stride + c : src, in);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The fragments of a warp's product from a staged tile of D columns (pitch
// tile_pitch<D>()), rows [r0, r0 + 16) x columns [c0, c0 + 16):
// as A (row-major, the tile itself)
template <int D>
__device__ __forceinline__ void frag_a(uint32_t r[4], const __nv_bfloat16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(r, tile + (r0 + lane % 16) * tile_pitch<D>() + c0 + (lane / 16) * 8);
}

// as two B operands whose columns are the tile's rows (S = Q K^T's K):
// b0, b1 = r[0], r[1] for rows r0 .. r0 + 7, r[2], r[3] for the next 8
template <int D>
__device__ __forceinline__ void frag_b_rows(uint32_t r[4], const __nv_bfloat16* tile,
                                            int r0, int c0, int lane) {
  ldmatrix_x4(r, tile + (r0 + lane % 8 + (lane / 16) * 8) * tile_pitch<D>() + c0
                     + ((lane / 8) % 2) * 8);
}

// as two B operands that are the tile itself, its rows the depth (P V's
// V): r[0], r[1] for columns c0 .. c0 + 7, r[2], r[3] for the next 8
template <int D>
__device__ __forceinline__ void frag_b_cols(uint32_t r[4], const __nv_bfloat16* tile,
                                            int r0, int c0, int lane) {
  ldmatrix_x4_trans(r, tile + (r0 + lane % 8 + ((lane / 8) % 2) * 8) * tile_pitch<D>()
                           + c0 + (lane / 16) * 8);
}

// d += a * b over one 16 x 8 x 16 tile, bf16 in, f32 accumulators
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 (x0 in the low half) as N packed bf16 pieces, largest first:
// piece i is the bf16 rounding of what pieces 0..i-1 left (each remainder
// is exact in f32), so the pieces sum to x within 2^-8N |x|
template <int N>
__device__ __forceinline__ void split_bf16(uint32_t out[N], float x0, float x1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

}  // namespace mma_bf16
