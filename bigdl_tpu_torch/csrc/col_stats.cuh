// The tensor-core tile, y epilogues and fixed-order column statistics
// shared by the "mma" variants of K5 (matmul_bn.cu) and K6 (conv3x3_bn.cu)
// and K6's "tf32x3" variant.
//
// Both compute y = A @ B with bf16 A (rows of the output, K deep) and B
// (K, N) row-major, f32 accumulation, y rounded to bf16, and from the f32
// values before rounding the per-column sum and sum of squares. A block's
// tile is BM x BN of y; four warps, WARPS_M along the rows and two along
// the columns, each own 64 x 32. K is walked in BK-deep steps through a
// shared-memory ring of A tiles (BM x BK, row pitch A_PITCH) and B tiles
// (BK x BN, row pitch B_PITCH); each kernel fills the ring its own way (K6
// gathers shifted rows, K5 reads plain rows) and calls mma_step on a slot.
//
// mma_step sums each BK-deep step on the tensor cores from zero and adds
// it to the f32 accumulators with an ordinary rounded add: over a long K
// the tensor cores' own f32 sums drift (K6, K = 4,608: bf16 y 8.7e-6 past
// one bf16 step, against a 1e-5 limit, when summed in them all the way).
//
// stage_y rounds the warp's accumulators to bf16 into a shared tile (the
// ring's space or a buffer of its own) and sums each column's values and
// squares over the warp's rows in a fixed shuffle tree; store_tile then
// writes the tile out in 16-byte pieces and the block's per-column partial
// (the WARPS_M row warps in turn) to one row of the partials. Rows past M
// hold zeros (their A rows were zero-filled) and are not stored. K6's
// "tf32x3" variant (f32 y; its own 3xTF32 step into the same Acc tile)
// takes store_y_f32 in place of stage_y, which writes y straight from the
// registers in 8-byte pieces (whole 32-byte sectors a row) with the same
// column sums, and then store_partials, store_tile's second half.
// reduce_two_pass sums the partials in two fixed-order passes (RED_SLABS
// slabs of rows, then the slabs): no atomics, the same bits on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace col_stats {

constexpr int BM = 128;              // rows of y per tile
constexpr int BN = 64;               // columns of y per tile
constexpr int BK = 32;               // K per ring step
constexpr int WARPS_M = 2;           // warps along the rows (2 along the columns)
constexpr int MMA_THREADS = WARPS_M * 2 * 32;
constexpr int WTM = BM / WARPS_M / 16;  // 16-row mma tiles per warp
constexpr int A_PITCH = BK + 8;      // bf16 per staged A row (80 bytes)
constexpr int B_PITCH = BN + 8;      // bf16 per staged B row (144 bytes)
constexpr int Y_PITCH = BN + 8;      // bf16 per staged y row
constexpr int A_STAGE = BM * A_PITCH;
constexpr int B_STAGE = BK * B_PITCH;
constexpr int Y_TILE = BM * Y_PITCH;
constexpr int RED_SLABS = 64;        // first pass of the statistics' reduction
constexpr int RED_COLS = 32;         // columns per reduction block
constexpr int RED_LANES = 16;        // row lanes per column
constexpr int B_ROW_STEP = MMA_THREADS / (BN / 8);
constexpr int B_ROWS_PER_THREAD = BK / B_ROW_STEP;

typedef float Acc[WTM][4][4];        // [m tile of 16][n tile of 8][fragment]

__device__ __forceinline__ void zero(Acc acc) {
#pragma unroll
  for (int i = 0; i < WTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// B rows [row0, row0 + BK) of the (rows, n) matrix b, columns
// [n0, n0 + BN), into one ring slot; rows at or past `rows` and columns
// past n are zero-filled (n is a multiple of 8)
__device__ __forceinline__ void load_b(__nv_bfloat16* bs, const __nv_bfloat16* b,
                                       long row0, int rows, int n, int n0, int tid) {
  const int piece = (tid % 8) * 8;
  const bool col_in = n0 + piece < n;
#pragma unroll
  for (int i = 0; i < B_ROWS_PER_THREAD; ++i) {
    const int r = tid / 8 + B_ROW_STEP * i;
    const bool in = col_in && r < rows;
    mma_bf16::cp_async16(bs + r * B_PITCH + piece,
                         in ? b + (row0 + r) * n + n0 + piece : b, in);
  }
}

// one BK step from ring slot (as, bs): the step's products summed by the
// tensor cores from zero, then added to the f32 accumulators
__device__ __forceinline__ void mma_step(Acc acc, const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int warp, int lane) {
  using namespace mma_bf16;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  as += wm * (BM / WARPS_M) * A_PITCH;
  bs += wn * 32;
  uint32_t bf[2][4][2];  // [k half][n tile][register]
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * B_PITCH
                               + np * 16 + (lane / 16) * 8);
      bf[kk][2 * np][0] = r[0];
      bf[kk][2 * np][1] = r[1];
      bf[kk][2 * np + 1][0] = r[2];
      bf[kk][2 * np + 1][1] = r[3];
    }
#pragma unroll
  for (int mt = 0; mt < WTM; ++mt) {
    uint32_t af[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4(af[kk], as + (mt * 16 + lane % 16) * A_PITCH + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_16816(part, af[0], bf[0][nt][0], bf[0][nt][1]);
      mma_16816(part, af[1], bf[1][nt][0], bf[1][nt][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
    }
  }
}

// cs / cq, a lane's sums over its rows of the columns it holds ([n tile]
// [column 2t + j] of the warp's 32), summed over the 8 lanes that share t
// in a fixed shuffle tree, into red_s / red_q [WARPS_M][BN]
__device__ __forceinline__ void warp_column_stats(float cs[4][2], float cq[4][2],
                                                  float (*red_s)[BN],
                                                  float (*red_q)[BN], int warp,
                                                  int lane) {
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        cs[nt][j] += __shfl_xor_sync(0xffffffffu, cs[nt][j], off);
        cq[nt][j] += __shfl_xor_sync(0xffffffffu, cq[nt][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        red_s[wm][wn * 32 + nt * 8 + 2 * t + j] = cs[nt][j];
        red_q[wm][wn * 32 + nt * 8 + 2 * t + j] = cq[nt][j];
      }
  }
}

// the warp's accumulators as bf16 into ys ([BM][Y_PITCH]), and its
// columns' sums and sums of squares into red_s / red_q [WARPS_M][BN]
__device__ __forceinline__ void stage_y(const Acc acc, __nv_bfloat16* ys,
                                        float (*red_s)[BN], float (*red_q)[BN],
                                        int warp, int lane) {
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, t = lane % 4;
  float cs[4][2], cq[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = wn * 32 + nt * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < 2; ++j) cs[nt][j] = cq[nt][j] = 0.f;
#pragma unroll
    for (int mt = 0; mt < WTM; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        const int r = wm * (BM / WARPS_M) + mt * 16 + g + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(ys + r * Y_PITCH + c) =
            __floats2bfloat162_rn(v0, v1);
        cs[nt][0] += v0;
        cs[nt][1] += v1;
        cq[nt][0] += v0 * v0;
        cq[nt][1] += v1 * v1;
      }
  }
  warp_column_stats(cs, cq, red_s, red_q, warp, lane);
}

// the warp's y as f32 straight from the registers to y (m, n), rows
// [m0, m0 + BM) x columns [n0, n0 + BN) of the tile (rows past m and
// columns past n not stored; n is a multiple of 8), and its columns' sums
// and sums of squares as stage_y's
__device__ __forceinline__ void store_y_f32(const Acc acc, float* y,
                                            float (*red_s)[BN], float (*red_q)[BN],
                                            int m0, int n0, int m, int n,
                                            int warp, int lane) {
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane / 4, t = lane % 4;
  float cs[4][2], cq[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < 2; ++j) cs[nt][j] = cq[nt][j] = 0.f;
#pragma unroll
    for (int mt = 0; mt < WTM; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        const int r = m0 + wm * (BM / WARPS_M) + mt * 16 + g + 8 * half;
        if (r < m && c < n)
          *reinterpret_cast<float2*>(y + (long)r * n + c) = make_float2(v0, v1);
        cs[nt][0] += v0;
        cs[nt][1] += v1;
        cq[nt][0] += v0 * v0;
        cq[nt][1] += v1 * v1;
      }
  }
  warp_column_stats(cs, cq, red_s, red_q, warp, lane);
}

// after a __syncthreads that follows every warp's stage_y or store_y_f32:
// the block's column partials (the row warps in turn) to row `prow` of
// psum / psq (rows of n)
__device__ __forceinline__ void store_partials(const float (*red_s)[BN],
                                               const float (*red_q)[BN],
                                               float* psum, float* psq, long prow,
                                               int n0, int n, int tid) {
  if (tid < BN && n0 + tid < n) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < WARPS_M; ++i) {
      s += red_s[i][tid];
      q += red_q[i][tid];
    }
    psum[prow * n + n0 + tid] = s;
    psq[prow * n + n0 + tid] = q;
  }
}

// after a __syncthreads that follows every warp's stage_y: the tile's rows
// [m0, m0 + BM) x columns [n0, n0 + BN) of y (m, n) in 16-byte pieces, and
// the block's column partials (store_partials)
__device__ __forceinline__ void store_tile(__nv_bfloat16* y, const __nv_bfloat16* ys,
                                           const float (*red_s)[BN],
                                           const float (*red_q)[BN],
                                           float* psum, float* psq, long prow,
                                           int m0, int n0, int m, int n, int tid) {
#pragma unroll
  for (int i = 0; i < BM * (BN / 8) / MMA_THREADS; ++i) {
    const int piece = tid + MMA_THREADS * i;
    const int r = piece / (BN / 8), c = (piece % (BN / 8)) * 8;
    if (m0 + r < m && n0 + c < n)
      *reinterpret_cast<uint4*>(y + (long)(m0 + r) * n + n0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * Y_PITCH + c);
  }
  store_partials(red_s, red_q, psum, psq, prow, n0, n, tid);
}

// sum[y, c] = sum_r psum[r, c] over slab y of the R rows (and the same for
// psq), in a fixed order: slab y is rows [y * per, (y + 1) * per) with
// per = ceil(R / gridDim.y); lane l adds the slab's rows l, l + 16, ... in
// turn, then lane 0 adds the 16 lanes. With one slab it is the whole sum.
__global__ void __launch_bounds__(RED_COLS * RED_LANES)
column_reduce_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                     float* __restrict__ sum, float* __restrict__ sumsq,
                     int R, int N) {
  __shared__ float ss[RED_LANES][RED_COLS + 1];
  __shared__ float qq[RED_LANES][RED_COLS + 1];
  const int c = blockIdx.x * RED_COLS + threadIdx.x;
  const int per = (R + gridDim.y - 1) / gridDim.y;
  const int r1 = min(R, (int)(blockIdx.y + 1) * per);
  float s = 0.f, q = 0.f;
  if (c < N) {
    for (int r = blockIdx.y * per + threadIdx.y; r < r1; r += RED_LANES) {
      s += psum[(long)r * N + c];
      q += psq[(long)r * N + c];
    }
  }
  ss[threadIdx.y][threadIdx.x] = s;
  qq[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < N) {
    float ts = 0.f, tq = 0.f;
    for (int l = 0; l < RED_LANES; ++l) {
      ts += ss[l][threadIdx.x];
      tq += qq[l][threadIdx.x];
    }
    sum[(long)blockIdx.y * N + c] = ts;
    sumsq[(long)blockIdx.y * N + c] = tq;
  }
}

// The column sums of the R partial rows of psum / psq (rows of n), which
// are followed by RED_SLABS rows of scratch: the rows in RED_SLABS slabs,
// then the slabs, each pass in a fixed order
inline cudaError_t reduce_two_pass(float* psum, float* psq, int R, int n,
                                   float* sum, float* sumsq, cudaStream_t stream) {
  const long slab_rows = (long)R * n;
  const dim3 block(RED_COLS, RED_LANES);
  const int cols = (n + RED_COLS - 1) / RED_COLS;
  column_reduce_kernel<<<dim3(cols, RED_SLABS), block, 0, stream>>>(
      psum, psq, psum + slab_rows, psq + slab_rows, R, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_reduce_kernel<<<dim3(cols), block, 0, stream>>>(
      psum + slab_rows, psq + slab_rows, sum, sumsq, RED_SLABS, n);
  return cudaGetLastError();
}

}  // namespace col_stats
