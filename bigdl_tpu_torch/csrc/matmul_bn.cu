// Matmul with batch-norm column statistics for NVIDIA Hopper (sm_90a),
// kernel K5 of the port.
//
// Replaces the Pallas TPU kernel `_kernel`, called by `matmul_with_stats`
// in bigdl_tpu/ops/matmul_bn.py (the 1x1 conv + BN fusion). It computes the
// same function:
//   y = x @ w                        (x (M, K), w (K, N), f32 accumulation)
//   col_sum[j]   = sum_m y[m, j]     (from the f32 product, before rounding)
//   col_sumsq[j] = sum_m y[m, j]^2
// with y stored in x's dtype (f32 or bf16; x and w share it, the wrapper
// promotes mixed dtypes first) and both sums in f32.
//
// What bounds it on the H100: the bytes are x read once, w read once and y
// written once (bf16 ResNet-50 at B=256, stage 1's 64 -> 256 expansion:
// M = 802,816, K = 64, N = 256, 103 MB + 411 MB, 0.153 ms at 3.35 TB/s);
// the operations are 2*M*K*N (26.3 GFLOP, 0.027 ms at 989 TFLOP/s). So the
// bytes bound the wide, shallow shapes of stage 1, and the operations the
// deep ones (stage 4's 512 -> 2048 at M = 12,544: 66 MB, 0.020 ms, against
// 26.3 GFLOP, 0.027 ms). Both variants keep from the TPU kernel what saves
// bytes: y is written once and never re-read for the statistics, which are
// reduced from the f32 tile while it is still in registers.
//
// Two variants; ops/matmul_bn.py:kernel_variant picks one.
//
// "mma" (matmul_stats_mma_kernel, C entry bt_matmul_stats_mma): bf16 x and
// w with K and N multiples of 8, 16-byte aligned, which is every 1x1 conv
// of ResNet-50. Products on the tensor cores (mma.sync m16n8k16 bf16 ->
// f32 on ldmatrix fragments, .trans for w) through a 2-stage cp.async ring
// of 128 x 32 x-tiles and 32 x 64 w-tiles; a row past M or a column past K
// is zero-filled by the copy (src-size 0), adds nothing to either sum and
// is not stored. The tile, the step, the y epilogue and the statistics are
// col_stats.cuh's, shared with K6's mma variant: each 32-deep step is
// summed from zero on the tensor cores and added to the f32 accumulators
// with a rounded add (over K = 2,048 the tensor cores' own sums would
// drift); bf16 y is staged in shared memory and written in 16-byte pieces;
// the per-column partials are a fixed shuffle tree, then the two row warps
// in turn. What is K5's own is the grid: persistent, one block per free
// slot (4 an SM), walking tiles N fastest, with the (tile, K step) pairs of
// a block as one stream through the ring. At stage 1, K = 64 is two ring
// steps, so a tile's fill and epilogue would otherwise be most of its
// time: here the next tile's loads are in flight while the current tile's
// y is staged in a buffer of its own and written out. Neighbouring tiles
// in flight share their rows of x, so the N-tiles of a row block read x
// from L2 after the first. Bound: the bytes at stage 1 (chip_smoke.py's
// kernels line on an H100: 0.246 ms, 62% of the data sheet's bound); at
// stage 4 the mma.sync issue rate, not the data sheet's 989 TFLOP/s, which
// needs wgmma: 0.155 ms, 170 TFLOP/s (K6 reaches 240 on the same tile over
// a 9x longer K, with fewer epilogues per product).
//
// "fma" (matmul_stats_kernel, C entry bt_matmul_stats): f32, and bf16 with
// K or N off the multiple of 8 (the reference tests' K = 3 and K = 12). It
// is the first port's design, bound by its own arithmetic: f32 FMA on the
// CUDA cores (67 TFLOP/s peak). One block of 256 threads per 128 x 64 tile
// of y; each thread owns 8 rows x 4 columns. K is walked in chunks of 16:
// the x chunk is staged transposed (xs[k][m]) and the w chunk as is
// (ws[k][n]), both widened to f32, so the inner step is three 16-byte
// shared loads for 32 FMAs. x is read with 16-byte vector loads when K and
// x's address allow (K % 4 == 0 for f32, K % 8 == 0 for bf16, 16-byte
// aligned) and by a scalar path of the same kernel otherwise. Ragged rows
// and columns are bounds-checked, not padded. Its epilogue rounds y to x's
// dtype; each thread sums its 8 rows' values and squares per column, and
// the block adds its 16 row groups in a fixed order.
//
// Statistics, both variants: one f32 partial per (row block, column) in a
// (row_blocks, N) scratch, then col_stats.cuh's two fixed-order passes
// (RED_SLABS slabs of rows, then the slabs; one pass over stage 1's 6,272
// rows would run on 8 blocks). No atomics: the statistics are the same
// bits on every run, as on the TPU's sequential grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "col_stats.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 128;      // rows of y per block
constexpr int BN = 64;       // columns of y per block
constexpr int BK = 16;       // K-chunk staged in shared memory
constexpr int THREADS = 256; // 16 column groups x 16 row groups
constexpr int TM = 8;        // rows per thread
constexpr int TN = 4;        // columns per thread
constexpr int XPAD = 4;      // keeps xs rows 16-byte aligned, shifts banks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The values of one 16-byte vector, widened exactly to f32.
__device__ __forceinline__ void widen(const uint4& u, float* out, const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float* out, const __nv_bfloat16*) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);          // low bf16
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);  // high bf16
  }
}

// Stage x[m0:m0+BM, k0:k0+BK] into xs[k][m] as f32 (zeros outside x).
template <typename T, bool VEC>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float (*xs)[BM + XPAD],
                                        int m0, int k0, int M, int K) {
  if (VEC) {
    // 16-byte vectors: 4 f32 or 8 bf16 consecutive k of one row. K is a
    // multiple of the vector, so a vector is wholly inside x or outside.
    constexpr int V = 16 / sizeof(T);
    constexpr int PER_ROW = BK / V;
    for (int i = threadIdx.x; i < BM * PER_ROW; i += THREADS) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      const int gm = m0 + r, gk = k0 + c;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (gm < M && gk < K)
        u = __ldg(reinterpret_cast<const uint4*>(x + (long)gm * K + gk));
      float v[V];
      widen(u, v, static_cast<const T*>(nullptr));
#pragma unroll
      for (int e = 0; e < V; ++e) xs[c + e][r] = v[e];
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f(x[(long)gm * K + gk]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
matmul_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ psum,
                    float* __restrict__ psq, int M, int K, int N) {
  __shared__ __align__(16) float xs[BK][BM + XPAD];
  __shared__ __align__(16) float ws[BK][BN];
  __shared__ float red_s[THREADS / 16][BN];
  __shared__ float red_q[THREADS / 16][BN];
  const int tx = threadIdx.x % 16;  // column group: columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // row group: rows ty*8 .. ty*8+7
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage_x<T, VEC>(x, xs, m0, k0, M, K);
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      ws[r][c] = (gk < K && gn < N) ? to_f(w[(long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: store y in x's dtype; column sums of the f32 values
  float cs[TN], cq[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) cs[j] = cq[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      const float v = acc[i][j];
      if (gn < N) store(y + (long)gm * N + gn, v);
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
  if (threadIdx.x < BN && n0 + threadIdx.x < N) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int t = 0; t < THREADS / 16; ++t) {  // fixed order
      s += red_s[t][threadIdx.x];
      q += red_q[t][threadIdx.x];
    }
    psum[(long)blockIdx.y * N + n0 + threadIdx.x] = s;
    psq[(long)blockIdx.y * N + n0 + threadIdx.x] = q;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, void* psum, void* psq,
           void* sum, void* sumsq, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  constexpr int V = 16 / sizeof(T);
  const bool vec = K % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  if (vec)
    matmul_stats_kernel<T, true><<<grid, THREADS, 0, stream>>>(xt, wt, yt, ps, pq, M, K, N);
  else
    matmul_stats_kernel<T, false><<<grid, THREADS, 0, stream>>>(xt, wt, yt, ps, pq, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return col_stats::reduce_two_pass(ps, pq, grid.y, N, static_cast<float*>(sum),
                                    static_cast<float*>(sumsq), stream);
}

// ------------------------------------------------------------ mma variant
namespace cs = col_stats;

// A persistent grid over 128 x 64 tiles of y (col_stats.cuh's tile, step,
// y epilogue and statistics, shared with K6), N fastest: the blocks in
// flight at once hold neighbouring tiles, so the N-tiles of a row block
// read x from L2 after its first read from device memory. Block b takes
// tiles b, b + grid, ...; its (tile, K step) pairs form one stream through
// the cp.async ring, so the next tile's first steps are in flight while
// the current tile's epilogue stages y in its own buffer and writes it.
// 2 stages: 48 KB a block, so 4 blocks an SM (128 registers allow 4). On an
// H100, over the ResNet-50 step's shapes, 2 stages (4 blocks an SM) were
// faster than 3 (3 blocks) or 4 (2 blocks): resident warps hide more than a
// deeper ring does.
constexpr int K5_STAGES = 2;
constexpr int K5_SMEM =
    (K5_STAGES * (cs::A_STAGE + cs::B_STAGE) + cs::Y_TILE) * 2;
constexpr int K5_A_ROW_STEP = cs::MMA_THREADS / (cs::BK / 8);
constexpr int K5_A_ROWS_PER_THREAD = cs::BM / K5_A_ROW_STEP;

__global__ void __launch_bounds__(cs::MMA_THREADS)
matmul_stats_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ psum,
                        float* __restrict__ psq, int M, int K, int N,
                        int n_tiles, int tiles) {
  using namespace mma_bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + K5_STAGES * cs::A_STAGE;
  __nv_bfloat16* Ys = Bs + K5_STAGES * cs::B_STAGE;
  __shared__ float red_s[cs::WARPS_M][cs::BN];
  __shared__ float red_q[cs::WARPS_M][cs::BN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ksteps = (K + cs::BK - 1) / cs::BK;
  const int grid = gridDim.x, block = blockIdx.x;
  const int total = (tiles - block + grid - 1) / grid * ksteps;
  const int a_piece = (tid % 4) * 8;  // 8 columns of each of the thread's A rows

  // stream position g: K step g % ksteps of this block's tile g / ksteps;
  // A rows past M and columns past K are zero-filled by the copy
  auto load_step = [&](int g, int slot) {
    const int tile = block + (g / ksteps) * grid;
    const int k0 = (g % ksteps) * cs::BK;
    const int m0 = (tile / n_tiles) * cs::BM, n0 = (tile % n_tiles) * cs::BN;
    const bool k_in = k0 + a_piece < K;
    __nv_bfloat16* as = As + slot * cs::A_STAGE;
#pragma unroll
    for (int i = 0; i < K5_A_ROWS_PER_THREAD; ++i) {
      const int r = tid / 4 + K5_A_ROW_STEP * i;
      const bool in = k_in && m0 + r < M;
      cp_async16(as + r * cs::A_PITCH + a_piece,
                 in ? x + (long)(m0 + r) * K + k0 + a_piece : x, in);
    }
    cs::load_b(Bs + slot * cs::B_STAGE, w, k0, K - k0, N, n0, tid);
  };

  cs::Acc acc;
  cs::zero(acc);
#pragma unroll
  for (int s = 0; s < K5_STAGES - 1; ++s) {
    if (s < total) load_step(s, s);
    cp_async_commit();
  }
  for (int g = 0; g < total; ++g) {
    cp_async_wait<K5_STAGES - 2>();  // position g has landed (this thread's)
    __syncthreads();                 // ... and every thread's; slot of g-1 free
    const int next = g + K5_STAGES - 1;
    if (next < total) load_step(next, next % K5_STAGES);
    cp_async_commit();
    const int slot = g % K5_STAGES;
    cs::mma_step(acc, As + slot * cs::A_STAGE, Bs + slot * cs::B_STAGE, warp, lane);
    if (g % ksteps == ksteps - 1) {
      // the tile is done: Ys and red_* were last read before this
      // iteration's __syncthreads, so they are free
      const int tile = block + (g / ksteps) * grid;
      const int mt = tile / n_tiles;
      cs::stage_y(acc, Ys, red_s, red_q, warp, lane);
      __syncthreads();
      cs::store_tile(y, Ys, red_s, red_q, psum, psq, mt, mt * cs::BM,
                     (tile % n_tiles) * cs::BN, M, N, tid);
      cs::zero(acc);
    }
  }
  cp_async_wait<0>();
}

// psum and psq hold ceil(M / 128) + RED_SLABS rows: one per row block, then
// the first reduction pass's slab sums
int launch_mma(const void* x, const void* w, void* y, void* psum, void* psq,
               void* sum, void* sumsq, int M, int K, int N, cudaStream_t stream) {
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      matmul_stats_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K5_SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, matmul_stats_mma_kernel, cs::MMA_THREADS, K5_SMEM);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + cs::BM - 1) / cs::BM, n_tiles = (N + cs::BN - 1) / cs::BN;
  const long tiles = (long)m_tiles * n_tiles;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const long resident = (long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < resident ? tiles : resident);
  float* ps = static_cast<float*>(psum);
  float* pq = static_cast<float*>(psq);
  matmul_stats_mma_kernel<<<grid, cs::MMA_THREADS, K5_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(y), ps, pq, M, K, N, n_tiles, (int)tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cs::reduce_two_pass(ps, pq, m_tiles, N, static_cast<float*>(sum),
                             static_cast<float*>(sumsq), stream);
}

}  // namespace

// y (M, N) in x's dtype; psum, psq f32 (bt_matmul_stats_row_blocks(M), N)
// scratch; sum,
// sumsq f32 (N,). is_bf16 selects bf16 x, w and y, else f32. Returns a
// cudaError_t (0 on success).
extern "C" int bt_matmul_stats(const void* x, const void* w, void* y,
                               void* psum, void* psq, void* sum, void* sumsq,
                               int M, int K, int N, int is_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, w, y, psum, psq, sum, sumsq, M, K, N, s)
                 : launch<float>(x, w, y, psum, psq, sum, sumsq, M, K, N, s);
}

// The "mma" variant: bf16 x, w and y, K and N multiples of 8, x and w
// 16-byte aligned; the other arguments as bt_matmul_stats's.
extern "C" int bt_matmul_stats_mma(const void* x, const void* w, void* y,
                                   void* psum, void* psq, void* sum, void* sumsq,
                                   int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 8 != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorMisalignedAddress;
  return launch_mma(x, w, y, psum, psq, sum, sumsq, M, K, N,
                    static_cast<cudaStream_t>(stream));
}

// Rows of the partials scratch, both variants: one per 128 rows of x, then
// RED_SLABS for the first pass of the statistics' reduction.
extern "C" int bt_matmul_stats_row_blocks(int M) {
  return (M + BM - 1) / BM + col_stats::RED_SLABS;
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
