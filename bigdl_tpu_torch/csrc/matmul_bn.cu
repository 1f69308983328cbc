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
// M = 802,816, K = 64, N = 256, 103 MB + 411 MB, 0.15 ms at 3.35 TB/s);
// the operations are 2*M*K*N (26.3 GFLOP, 0.027 ms at 989 TFLOP/s). So the
// bytes bound the wide, shallow shapes of stage 1, and the operations the
// deep ones (stage 4's 512 -> 2048 at M = 12,544: 66 MB, 0.020 ms, against
// 26.3 GFLOP, 0.027 ms). This simple
// design does not reach it: products are f32 FMA on the CUDA cores (67
// TFLOP/s peak, not the tensor cores), so at these shapes it is bound by
// its own arithmetic. What it does about the bytes is what the TPU kernel
// does: y is written once and never re-read for the statistics, which are
// reduced from the f32 tile while it is still in registers.
//
// Design. One block of 256 threads per 128 x 64 tile of y; each thread
// owns 8 rows x 4 columns. K is walked in chunks of 16: the x chunk is
// staged transposed (xs[k][m]) and the w chunk as is (ws[k][n]), both
// widened to f32, so the inner step is three 16-byte shared loads for 32
// FMAs. x is read with 16-byte vector loads when K and x's address allow
// (K % 4 == 0 for f32, K % 8 == 0 for bf16, 16-byte aligned) and by a
// scalar path of the same kernel otherwise (K = 3, K = 12). Ragged rows
// and columns are bounds-checked, not padded: the zeros staged for them add
// nothing to either sum, and nothing is stored for them.
//
// Epilogue: y rounded to x's dtype; each thread sums its 8 rows' values
// and squares per column, the block adds its 16 row groups in a fixed
// order and writes one f32 partial per column to a (row_blocks, N)
// scratch. A second kernel in this file sums the partials of each column,
// again in a fixed order. No atomics: the statistics are the same bits on
// every run, as on the TPU's sequential grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int RED_COLS = 32;   // columns per reduction block
constexpr int RED_LANES = 16;  // row lanes per column

// sum[c] = sum_r psum[r, c] (and the same for psq), in a fixed order:
// lane l adds rows l, l + 16, ... in turn, then lane 0 adds the 16 lanes.
__global__ void __launch_bounds__(RED_COLS * RED_LANES)
column_reduce_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
                     float* __restrict__ sum, float* __restrict__ sumsq,
                     int R, int N) {
  __shared__ float ss[RED_LANES][RED_COLS + 1];
  __shared__ float qq[RED_LANES][RED_COLS + 1];
  const int c = blockIdx.x * RED_COLS + threadIdx.x;
  float s = 0.f, q = 0.f;
  if (c < N) {
    for (int r = threadIdx.y; r < R; r += RED_LANES) {
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
    sum[c] = ts;
    sumsq[c] = tq;
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
  const dim3 rgrid((N + RED_COLS - 1) / RED_COLS);
  column_reduce_kernel<<<rgrid, dim3(RED_COLS, RED_LANES), 0, stream>>>(
      ps, pq, static_cast<float*>(sum), static_cast<float*>(sumsq), grid.y, N);
  return cudaGetLastError();
}

}  // namespace

// y (M, N) in x's dtype; psum, psq f32 (ceil(M / 128), N) scratch; sum,
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

extern "C" int bt_matmul_stats_row_blocks(int M) { return (M + BM - 1) / BM; }

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
