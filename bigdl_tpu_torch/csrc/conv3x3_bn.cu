// 3x3 convolution with batch-norm channel statistics for NVIDIA Hopper
// (sm_90a), kernel K6 of the port.
//
// Replaces the Pallas TPU kernel `_kernel`, called by `conv3x3_with_stats`
// in bigdl_tpu/ops/conv3x3_bn.py (the 3x3 conv + BN fusion). It computes
// the same function:
//   y = conv3x3(x, w)              stride 1, SAME padding (one zero pixel
//                                  on every side), f32 accumulation
//   col_sum[c]   = sum_{n,h,w} y[n, h, w, c]    (from the f32 accumulator)
//   col_sumsq[c] = sum_{n,h,w} y[n, h, w, c]^2
// with x (N, H, W, Cin) NHWC, w (9, Cin, Cout) (the HWIO taps, flattened
// as the reference does), y (N, H, W, Cout) in x's dtype (f32 or bf16; x
// and w share it) and both sums in f32.
//
// What bounds it on the H100: the bytes are x read once, w read once and y
// written once (bf16 ResNet-50 stage 1 at B=256, 56 x 56, 64 -> 64: 103 MB
// + 103 MB, 0.061 ms at 3.35 TB/s); the operations are
// 2 * N * H * W * 9 * Cin * Cout (59.2 GFLOP, 0.060 ms at 989 TFLOP/s), so
// the two bounds are about equal at stage 1 and the operations bound the
// deeper stages. Both variants keep from the TPU kernel what saves bytes:
// SAME padding never makes a padded or im2col copy of x in device memory,
// and the statistics are reduced from the f32 accumulator, so y is never
// re-read for them.
//
// Three variants; ops/conv3x3_bn.py:kernel_variant picks one: "mma" for
// bf16 and "tf32x3" for f32 when Cin and Cout are multiples of 8 (every
// 3x3 conv of ResNet-50 and VGG-16 but VGG's first, Cin = 3), "fma" for
// the rest in either dtype.
//
// "mma" (conv3x3_stats_mma_kernel, C entry bt_conv3x3_stats_mma): bf16 x
// and w with Cin and Cout multiples of 8. An implicit GEMM on the tensor cores: M is the output pixel
// index over N * H * W (a 128-row tile may cross images, so a 7 x 7 stage-4
// image no longer leaves most of a tile idle), N is Cout (64 a tile), K is
// 9 * Cin, walked in steps of one tap x 32 input channels, the nine taps of
// a channel chunk in turn, so a step's rows are neighbours of the previous
// step's in L2. Each step's A tile (128 pixels x 32 channels of one tap) is
// gathered with 16-byte cp.async; a row whose tap falls outside the image
// (or past N * H * W, or past Cin) is zero-filled by the copy itself
// (src-size 0): that is the SAME padding. The B tile is 32 rows of w viewed
// as (9 * Cin, Cout). Tiles go through a 4-stage shared-memory ring (rows
// padded by 16 bytes, so ldmatrix is free of bank conflicts); four warps,
// each 64 pixels x 32 channels, run mma.sync m16n8k16 bf16 -> f32 on
// fragments from ldmatrix (.trans for B). The tensor cores' own sums are
// taken over one step only (32 products, from zero) and added to the f32
// accumulators by ordinary rounded adds, so a long K (4,608 at 512
// channels) sums in f32 as the plain version does: summed in the tensor
// cores all the way, bf16 y passed one step by up to 8.7e-6 and the
// statistics erred by up to 7.9e-6 of their scale on an H100, against
// limits of 1e-5. The epilogue stages the bf16 y tile in the ring and
// writes it in 16-byte pieces. Bound: the tensor cores at the deeper
// stages; at 168 registers a thread, 3 blocks an SM, the mma.sync issue
// rate, not the data sheet's 989 TFLOP/s (which needs wgmma), is the
// ceiling. Stage 1 (K = 576) has 8x the tiles of stage 4 for the same
// operations and took 1.5x as long: there the per-tile costs, the ring's
// fill and the epilogue, take about a third of the time.
//
// "tf32x3" (conv3x3_stats_tf32x3_kernel, C entry bt_conv3x3_stats_tf32x3):
// f32 x and w with Cin and Cout multiples of 8. The mma variant's implicit
// GEMM, tile and fixed-order statistics over f32 operands, each product
// taken as three tf32 products on the tensor cores (mma.sync m16n8k8
// .tf32: hi * hi + hi * lo + lo * hi of operands split with
// cvt.rna.tf32.f32, mma_tf32.cuh), so y and the statistics keep f32
// accuracy (one tf32 pass lands past the f32 limits of both:
// tests/test_torch_tf32x3.py and chip_smoke.py's controls). A K step is one tap x 16 channels (64 bytes
// a row, as the mma variant's 32 bf16), summed on the tensor cores from
// zero and added to the f32 accumulators, as the mma variant does. Bound:
// the tensor cores' TF32 rate over three passes, 495 / 3 = 165 TFLOP/s
// by the data sheet (2.5x the CUDA cores' f32 FMA peak); mma.sync, not
// wgmma, and the splits in registers (three instructions an operand)
// hold it well below that. Details at the kernel.
//
// "fma" (conv3x3_stats_kernel, C entry bt_conv3x3_stats): f32 or bf16
// with Cin or Cout not a multiple of 8. It is the first port's design and
// is bound by its own arithmetic: f32 FMA on the CUDA cores (67 TFLOP/s).
// One block of 256 threads per (image, run of 128 output pixels of
// that image in row-major order, i.e. a band of output rows, 64 output
// channels); each thread owns 8 pixels x 4 channels. Cin is walked in
// chunks of 16: the chunk's input rows that the band needs, plus a
// one-pixel halo, are staged channel-major in shared memory as f32, with
// zeros written wherever the halo falls outside the image; the chunk's
// taps are staged as ws[tap][ci][co]. Each (ci, tap) step is then eight
// shared loads of x and one 16-byte load of w for 32 FMAs: the conv is the
// reference's nine shifted matmuls, with the shift an offset into the
// staged rows. Pixels past H*W and channels past Cout are bounds-checked.
// Shared memory is dynamic, (9*16*64 + 16*rows*(W+2)) floats, above 48 KB
// after cudaFuncSetAttribute.
//
// Epilogue and statistics, all variants: y rounded to x's dtype, one f32
// partial per (block, channel) summed over the block in a fixed order
// (mma, tf32x3: a fixed shuffle tree within a warp, then the two row warps
// in turn), then column_reduce_kernel sums the partials of each channel
// in a fixed order: in one pass for fma, in two for mma and tf32x3 (64
// slabs of rows, then the slabs: one pass over stage 1's 6,272 rows ran
// on 2 blocks and took 46 us). No atomics: y and the statistics are the
// same bits on every run. The mma and tf32x3 variants' tile, epilogues
// and both reduction passes live in col_stats.cuh, shared with K5's mma
// variant (matmul_bn.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "col_stats.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TP = 128;      // output pixels per block
constexpr int TC = 64;       // output channels per block
constexpr int CK = 16;       // input channels per staged chunk
constexpr int THREADS = 256; // 16 channel groups x 16 pixel groups
constexpr int TM = 8;        // pixels per thread
constexpr int TN = 4;        // channels per thread
constexpr int W_FLOATS = 9 * CK * TC;
constexpr int STATIC_SMEM = 2 * (THREADS / 16) * TC * 4;  // red_s, red_q
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// rows: output rows a band of TP pixels can touch, plus the two halo rows
__host__ __device__ __forceinline__ int staged_rows(int H, int W) {
  const int out_rows = (TP - 1 + W - 1) / W + 1;
  return (out_rows < H ? out_rows : H) + 2;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, float* __restrict__ psum,
                     float* __restrict__ psq, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_s[THREADS / 16][TC];
  __shared__ float red_q[THREADS / 16][TC];
  const int rows = staged_rows(H, W);
  const int pitch = W + 2;            // staged row: the image row and its halo
  const int plane = rows * pitch;     // one staged input channel
  float* ws = smem;                   // [9][CK][TC]
  float* xs = smem + W_FLOATS;        // [CK][plane]

  const int n = blockIdx.z;
  const int HW = H * W;
  const int p0 = blockIdx.y * TP;
  const int r0 = p0 / W;              // staged row 0 is input row r0 - 1
  const int c0 = blockIdx.x * TC;
  const int tx = threadIdx.x % 16;    // channels c0 + tx*4 .. + 3
  const int ty = threadIdx.x / 16;    // pixels p0 + ty*8 .. + 7
  const T* xn = x + (long)n * HW * Cin;

  // staged offset of each pixel's top-left tap
  int poff[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + ty * TM + i;
    poff[i] = p < HW ? (p / W - r0) * pitch + p % W : 0;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
    for (int i = threadIdx.x; i < W_FLOATS; i += THREADS) {
      const int co = i % TC, rest = i / TC;
      const int ci = rest % CK, tap = rest / CK;
      const int gci = ci0 + ci, gco = c0 + co;
      ws[i] = (gci < Cin && gco < Cout)
                  ? to_f(w[((long)tap * Cin + gci) * Cout + gco]) : 0.f;
    }
    for (int i = threadIdx.x; i < CK * plane; i += THREADS) {
      const int ci = i % CK, pos = i / CK;
      const int gr = r0 - 1 + pos / pitch, gc = pos % pitch - 1;
      const int gci = ci0 + ci;
      float v = 0.f;  // the SAME padding: zeros outside the image
      if (gr >= 0 && gr < H && gc >= 0 && gc < W && gci < Cin)
        v = to_f(xn[((long)gr * W + gc) * Cin + gci]);
      xs[ci * plane + pos] = v;
    }
    __syncthreads();
    for (int ci = 0; ci < CK; ++ci) {
      const float* xc = xs + ci * plane;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * pitch + tap % 3;
        const float4 bv =
            *reinterpret_cast<const float4*>(ws + (tap * CK + ci) * TC + tx * TN);
        const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
        float a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xc[poff[i] + toff];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: store y in x's dtype; channel sums of the f32 values
  float cs[TN], cq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) cs[j] = cq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = p0 + ty * TM + i;
    if (p >= HW) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      const float v = acc[i][j];
      if (c < Cout) store(y + ((long)n * HW + p) * Cout + c, v);
      cs[j] += v;
      cq[j] += v * v;
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    red_s[ty][tx * TN + j] = cs[j];
    red_q[ty][tx * TN + j] = cq[j];
  }
  __syncthreads();
  if (threadIdx.x < TC && c0 + threadIdx.x < Cout) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int t = 0; t < THREADS / 16; ++t) {  // fixed order
      s += red_s[t][threadIdx.x];
      q += red_q[t][threadIdx.x];
    }
    const long row = (long)n * gridDim.y + blockIdx.y;
    psum[row * Cout + c0 + threadIdx.x] = s;
    psq[row * Cout + c0 + threadIdx.x] = q;
  }
}

int dynamic_smem(int H, int W) {
  return (W_FLOATS + CK * staged_rows(H, W) * (W + 2)) * 4;
}

template <typename T>
int launch(const void* x, const void* w, void* y, void* psum, void* psq,
           void* sum, void* sumsq, int N, int H, int W, int Cin, int Cout,
           cudaStream_t stream) {
  const int smem = dynamic_smem(H, W);
  if (smem + STATIC_SMEM > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem + STATIC_SMEM > 48 * 1024) {
    // set on every launch: the attribute is per device, and the call is cheap
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Cout + TC - 1) / TC, (H * W + TP - 1) / TP, N);
  conv3x3_stats_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(psum), static_cast<float*>(psq), H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // one fixed-order pass over the block rows
  col_stats::column_reduce_kernel<<<dim3((Cout + col_stats::RED_COLS - 1) /
                                         col_stats::RED_COLS),
                                    dim3(col_stats::RED_COLS, col_stats::RED_LANES),
                                    0, stream>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sum), static_cast<float*>(sumsq), N * grid.y, Cout);
  return cudaGetLastError();
}

// ------------------------------------------------------------ mma variant
// The tile, the step's products, the y epilogue and the statistics' two
// passes are col_stats.cuh's (shared with K5's mma variant); what is K6's
// own is the A gather: the step's rows are the output pixels' neighbours
// under one tap.
using col_stats::A_PITCH;
using col_stats::A_STAGE;
using col_stats::B_STAGE;
using col_stats::MMA_THREADS;
constexpr int MBM = col_stats::BM;   // output pixels per block
constexpr int MBN = col_stats::BN;   // output channels per block
constexpr int MBK = col_stats::BK;   // input channels of one tap per K step
constexpr int MSTAGES = 4;           // shared-memory ring depth
constexpr int MMA_SMEM = MSTAGES * (A_STAGE + B_STAGE) * 2;
static_assert(col_stats::Y_TILE <= MSTAGES * A_STAGE, "the y tile fits in the ring");
constexpr int A_ROW_STEP = MMA_THREADS / (MBK / 8);  // rows between a thread's A rows
constexpr int A_ROWS_PER_THREAD = MBM / A_ROW_STEP;

__global__ void __launch_bounds__(MMA_THREADS)
conv3x3_stats_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ y, float* __restrict__ psum,
                         float* __restrict__ psq, int H, int W, int Cin,
                         int Cout, int M) {
  using namespace mma_bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + MSTAGES * A_STAGE;
  __shared__ float red_s[col_stats::WARPS_M][MBN];
  __shared__ float red_q[col_stats::WARPS_M][MBN];

  const int n0 = blockIdx.x * MBN;
  const int m0 = blockIdx.y * MBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the A rows this thread copies: rows tid/4 + A_ROW_STEP i, 8 channels at
  // (tid % 4) * 8; an image position, or h = -4 (always outside) past M
  const int a_piece = (tid % 4) * 8;
  int a_h[A_ROWS_PER_THREAD], a_w[A_ROWS_PER_THREAD];
  long a_off[A_ROWS_PER_THREAD];  // element offset of (n, h, w, 0) in x
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    const int p = m0 + tid / 4 + A_ROW_STEP * i;
    const int hw = p % (H * W);
    a_h[i] = p < M ? hw / W : -4;
    a_w[i] = hw % W;
    a_off[i] = (long)p * Cin;
  }

  const int chunks = (Cin + MBK - 1) / MBK;
  const int steps = 9 * chunks;

  // K step s: tap s % 9 of input channels (s / 9) * MBK ..; B is w viewed
  // as (9 * Cin, Cout)
  auto load_step = [&](int s, int slot) {
    const int tap = s % 9, ci0 = (s / 9) * MBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool ci_in = ci0 + a_piece < Cin;
    const long shift = ((long)dy * W + dx) * Cin + ci0 + a_piece;
    __nv_bfloat16* as = As + slot * A_STAGE;
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
      const int ih = a_h[i] + dy, iw = a_w[i] + dx;
      const bool in = ci_in && ih >= 0 && ih < H && iw >= 0 && iw < W;
      cp_async16(as + (tid / 4 + A_ROW_STEP * i) * A_PITCH + a_piece,
                 in ? x + a_off[i] + shift : x, in);
    }
    col_stats::load_b(Bs + slot * B_STAGE, w, (long)tap * Cin + ci0, Cin - ci0,
                      Cout, n0, tid);
  };

  col_stats::Acc acc;
  col_stats::zero(acc);

#pragma unroll
  for (int s = 0; s < MSTAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<MSTAGES - 2>();  // step s has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; slot of s-1 free
    const int next = s + MSTAGES - 1;
    if (next < steps) load_step(next, next % MSTAGES);
    cp_async_commit();
    const int slot = s % MSTAGES;
    col_stats::mma_step(acc, As + slot * A_STAGE, Bs + slot * B_STAGE, warp, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it now stages y

  col_stats::stage_y(acc, As, red_s, red_q, warp, lane);
  __syncthreads();
  col_stats::store_tile(y, As, red_s, red_q, psum, psq, blockIdx.y, m0, n0, M,
                        Cout, tid);
}

// psum and psq hold ceil(M / MBM) + RED_SLABS rows: one per block, then
// the first reduction pass's slab sums
int launch_mma(const void* x, const void* w, void* y, void* psum, void* psq,
               void* sum, void* sumsq, int N, int H, int W, int Cin, int Cout,
               cudaStream_t stream) {
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_stats_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MMA_SMEM);
  if (err != cudaSuccess) return err;
  const int M = N * H * W;
  const dim3 grid((Cout + MBN - 1) / MBN, (M + MBM - 1) / MBM);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  conv3x3_stats_mma_kernel<<<grid, MMA_THREADS, MMA_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), ps, pq, H, W, Cin, Cout, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return col_stats::reduce_two_pass(ps, pq, grid.y, Cout, static_cast<float*>(sum),
                                    static_cast<float*>(sumsq), stream);
}

// ---------------------------------------------------------- tf32x3 variant
// The mma variant's implicit GEMM and tile (col_stats' Acc, 4 warps of
// 64 x 32) over f32 operands: a K step is one tap x TBK = 16 input
// channels (64 bytes a row, as the mma variant's 32 bf16), the sums of a
// step taken by the tensor cores from zero and added to the f32
// accumulators, y stored as f32 from the registers.
//
// The ring holds f32 as it lands (cp.async, zero-fill as the SAME
// padding); a warp splits its fragments into tf32 hi + lo in registers.
// Neither operand can go through ldmatrix (32-bit elements, and B wanted
// column-major), so both are read with plain shared loads, laid out so
// that no load of a warp meets a bank twice:
//  - A rows are 16 floats, unpadded. The mma k indices (kk, t) and
//    (kk, t + 4) of the step's two k8 halves kk stand for channels
//    4t + 2kk and 4t + 2kk + 1, so a lane's four A values of a row are one
//    16-byte load (a quarter warp's 8 loads cover the 32 banks once).
//  - B rows are 64 floats, their 16-byte chunks XOR-swizzled by
//    2 * (row / 4): the lanes of a B load read rows 4t + c for t = 0..3
//    and columns g = 0..7, which the swizzle spreads over the 32 banks.
constexpr int TBK = 16;                    // input channels of one tap per step
constexpr int TSTAGES = 4;                 // ring depth
constexpr int TA_STAGE = MBM * TBK;        // floats
constexpr int TB_STAGE = TBK * MBN;        // floats
constexpr int TF32_SMEM = TSTAGES * (TA_STAGE + TB_STAGE) * 4;
constexpr int TA_ROW_STEP = MMA_THREADS / (TBK / 4);   // rows between a thread's A rows
constexpr int TA_ROWS_PER_THREAD = MBM / TA_ROW_STEP;
constexpr int TB_ROW_STEP = MMA_THREADS / (MBN / 4);   // rows between a thread's B rows
constexpr int TB_ROWS_PER_THREAD = TBK / TB_ROW_STEP;

// the float offset of (row, column) in a B slot: the column's 16-byte chunk
// swizzled by 2 * (row / 4)
__device__ __forceinline__ int tb_offset(int row, int col) {
  return row * MBN + (((col >> 2) ^ (2 * ((row >> 2) & 3))) << 2) + (col & 3);
}

// one K step from ring slot (as, bs): 3xTF32 products summed on the tensor
// cores from zero for each 16 x 8 tile, then added to the f32 accumulators
__device__ __forceinline__ void tf32_step(col_stats::Acc acc, const float* as,
                                          const float* bs, int warp, int lane) {
  using namespace mma_tf32;
  const int wm = warp % col_stats::WARPS_M, wn = warp / col_stats::WARPS_M;
  const int g = lane / 4, t = lane % 4;
  uint32_t bh[2][4][2], bl[2][4][2];  // [k half][n tile][register]
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split(bs[tb_offset(4 * t + 2 * kk + j, wn * 32 + nt * 8 + g)], bh[kk][nt][j],
              bl[kk][nt][j]);
  as += wm * (MBM / col_stats::WARPS_M) * TBK;
#pragma unroll
  for (int mt = 0; mt < col_stats::WTM; ++mt) {
    const float4 top = *reinterpret_cast<const float4*>(as + (mt * 16 + g) * TBK + 4 * t);
    const float4 bot = *reinterpret_cast<const float4*>(as + (mt * 16 + g + 8) * TBK + 4 * t);
    uint32_t ah[2][4], al[2][4];
    split(top.x, ah[0][0], al[0][0]);
    split(bot.x, ah[0][1], al[0][1]);
    split(top.y, ah[0][2], al[0][2]);
    split(bot.y, ah[0][3], al[0][3]);
    split(top.z, ah[1][0], al[1][0]);
    split(bot.z, ah[1][1], al[1][1]);
    split(top.w, ah[1][2], al[1][2]);
    split(bot.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma3(part, ah[kk], al[kk], bh[kk][nt][0], bh[kk][nt][1], bl[kk][nt][0],
             bl[kk][nt][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
    }
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
conv3x3_stats_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            float* __restrict__ y, float* __restrict__ psum,
                            float* __restrict__ psq, int H, int W, int Cin,
                            int Cout, int M) {
  using mma_bf16::cp_async16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + TSTAGES * TA_STAGE;
  __shared__ float red_s[col_stats::WARPS_M][MBN];
  __shared__ float red_q[col_stats::WARPS_M][MBN];

  const int n0 = blockIdx.x * MBN;
  const int m0 = blockIdx.y * MBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the A rows this thread copies: rows tid/4 + TA_ROW_STEP i, 4 channels at
  // (tid % 4) * 4; an image position, or h = -4 (always outside) past M
  const int a_piece = (tid % 4) * 4;
  int a_h[TA_ROWS_PER_THREAD], a_w[TA_ROWS_PER_THREAD];
  long a_off[TA_ROWS_PER_THREAD];  // element offset of (n, h, w, 0) in x
#pragma unroll
  for (int i = 0; i < TA_ROWS_PER_THREAD; ++i) {
    const int p = m0 + tid / 4 + TA_ROW_STEP * i;
    const int hw = p % (H * W);
    a_h[i] = p < M ? hw / W : -4;
    a_w[i] = hw % W;
    a_off[i] = (long)p * Cin;
  }
  // the B pieces this thread copies: rows tid/16 + TB_ROW_STEP i, 4 columns
  // at (tid % 16) * 4
  const int b_piece = (tid % 16) * 4;
  const bool b_col_in = n0 + b_piece < Cout;

  const int chunks = (Cin + TBK - 1) / TBK;
  const int steps = 9 * chunks;

  // K step s: tap s % 9 of input channels (s / 9) * TBK ..; B is w viewed
  // as (9 * Cin, Cout)
  auto load_step = [&](int s, int slot) {
    const int tap = s % 9, ci0 = (s / 9) * TBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool ci_in = ci0 + a_piece < Cin;
    const long shift = ((long)dy * W + dx) * Cin + ci0 + a_piece;
    float* as = As + slot * TA_STAGE;
#pragma unroll
    for (int i = 0; i < TA_ROWS_PER_THREAD; ++i) {
      const int ih = a_h[i] + dy, iw = a_w[i] + dx;
      const bool in = ci_in && ih >= 0 && ih < H && iw >= 0 && iw < W;
      cp_async16(as + (tid / 4 + TA_ROW_STEP * i) * TBK + a_piece,
                 in ? x + a_off[i] + shift : x, in);
    }
    float* bs = Bs + slot * TB_STAGE;
    const long row0 = (long)tap * Cin + ci0;
#pragma unroll
    for (int i = 0; i < TB_ROWS_PER_THREAD; ++i) {
      const int r = tid / 16 + TB_ROW_STEP * i;
      const bool in = b_col_in && ci0 + r < Cin;
      cp_async16(bs + tb_offset(r, b_piece), in ? w + (row0 + r) * Cout + n0 + b_piece : w,
                 in);
    }
  };

  col_stats::Acc acc;
  col_stats::zero(acc);

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < steps) load_step(s, s);
    mma_bf16::cp_async_commit();
  }

  for (int s = 0; s < steps; ++s) {
    mma_bf16::cp_async_wait<TSTAGES - 2>();  // step s has landed (this thread's copies)
    __syncthreads();                         // ... and every thread's; slot of s-1 free
    const int next = s + TSTAGES - 1;
    if (next < steps) load_step(next, next % TSTAGES);
    mma_bf16::cp_async_commit();
    const int slot = s % TSTAGES;
    tf32_step(acc, As + slot * TA_STAGE, Bs + slot * TB_STAGE, warp, lane);
  }
  mma_bf16::cp_async_wait<0>();

  col_stats::store_y_f32(acc, y, red_s, red_q, m0, n0, M, Cout, warp, lane);
  __syncthreads();
  col_stats::store_partials(red_s, red_q, psum, psq, blockIdx.y, n0, Cout, tid);
}

// psum and psq as launch_mma's (the same BM)
int launch_tf32x3(const void* x, const void* w, void* y, void* psum, void* psq,
                  void* sum, void* sumsq, int N, int H, int W, int Cin, int Cout,
                  cudaStream_t stream) {
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_stats_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TF32_SMEM);
  if (err != cudaSuccess) return err;
  const int M = N * H * W;
  const dim3 grid((Cout + MBN - 1) / MBN, (M + MBM - 1) / MBM);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  conv3x3_stats_tf32x3_kernel<<<grid, MMA_THREADS, TF32_SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), ps, pq, H, W, Cin, Cout, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return col_stats::reduce_two_pass(ps, pq, grid.y, Cout, static_cast<float*>(sum),
                                    static_cast<float*>(sumsq), stream);
}

}  // namespace

// y (N, H, W, Cout) in x's dtype; psum, psq f32 (N * ceil(H*W / 128), Cout)
// scratch; sum, sumsq f32 (Cout,). is_bf16 selects bf16 x, w and y, else
// f32. Returns a cudaError_t (0 on success; cudaErrorInvalidValue for a
// bad shape or an image whose staged rows do not fit shared memory).
extern "C" int bt_conv3x3_stats(const void* x, const void* w, void* y,
                                void* psum, void* psq, void* sum, void* sumsq,
                                int N, int H, int W, int Cin, int Cout,
                                int is_bf16, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0)
    return cudaErrorInvalidValue;
  if (N > 65535 || (H * W + TP - 1) / TP > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? launch<__nv_bfloat16>(x, w, y, psum, psq, sum, sumsq, N, H, W, Cin, Cout, s)
      : launch<float>(x, w, y, psum, psq, sum, sumsq, N, H, W, Cin, Cout, s);
}

// Rows of the partials scratch: one per (image, band of 128 pixels).
extern "C" int bt_conv3x3_stats_row_blocks(int N, int H, int W) {
  return N * ((H * W + TP - 1) / TP);
}

// The "mma" variant: bf16 x, w and y, Cin and Cout multiples of 8; the
// other arguments as bt_conv3x3_stats's, with psum and psq
// (bt_conv3x3_stats_mma_row_blocks(N, H, W), Cout).
extern "C" int bt_conv3x3_stats_mma(const void* x, const void* w, void* y,
                                    void* psum, void* psq, void* sum, void* sumsq,
                                    int N, int H, int W, int Cin, int Cout,
                                    void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 != 0 ||
      Cout % 8 != 0)
    return cudaErrorInvalidValue;
  if ((long)N * H * W > (long)MBM * 65535) return cudaErrorInvalidValue;
  return launch_mma(x, w, y, psum, psq, sum, sumsq, N, H, W, Cin, Cout,
                    static_cast<cudaStream_t>(stream));
}

// Rows of the mma variant's partials scratch: one per 128 output pixels,
// then RED_SLABS for the first pass of the statistics' reduction.
extern "C" int bt_conv3x3_stats_mma_row_blocks(int N, int H, int W) {
  return (N * H * W + MBM - 1) / MBM + col_stats::RED_SLABS;
}

// The "tf32x3" variant: f32 x, w and y, Cin and Cout multiples of 8; the
// other arguments and the partials' rows (bt_conv3x3_stats_mma_row_blocks)
// as bt_conv3x3_stats_mma's.
extern "C" int bt_conv3x3_stats_tf32x3(const void* x, const void* w, void* y,
                                       void* psum, void* psq, void* sum,
                                       void* sumsq, int N, int H, int W, int Cin,
                                       int Cout, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 != 0 ||
      Cout % 8 != 0)
    return cudaErrorInvalidValue;
  if ((long)N * H * W > (long)MBM * 65535) return cudaErrorInvalidValue;
  return launch_tf32x3(x, w, y, psum, psq, sum, sumsq, N, H, W, Cin, Cout,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
