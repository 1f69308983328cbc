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
// deeper stages. This simple design does not reach either: its products
// are f32 FMA on the CUDA cores (67 TFLOP/s peak), so it is bound by its
// own arithmetic. What it keeps from the TPU kernel is what saves bytes:
// SAME padding happens in shared memory (no padded or im2col copy of x is
// ever written to device memory), and the statistics are reduced from the
// f32 accumulator, so y is never re-read for them.
//
// Design. One block of 256 threads per (image, run of 128 output pixels of
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
// Epilogue and statistics as in matmul_bn.cu: y rounded to x's dtype, one
// f32 partial per (block, channel) summed over the block in a fixed order,
// then a second kernel in this file sums the partials of each channel in a
// fixed order. No atomics: the statistics are the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int RED_COLS = 32;   // channels per reduction block
constexpr int RED_LANES = 16;  // row lanes per channel

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
    static int allowed = 0;  // per instantiation: the largest size set so far
    if (smem > allowed) {
      cudaError_t err = cudaFuncSetAttribute(
          conv3x3_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      allowed = smem;
    }
  }
  const dim3 grid((Cout + TC - 1) / TC, (H * W + TP - 1) / TP, N);
  conv3x3_stats_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(psum), static_cast<float*>(psq), H, W, Cin, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_reduce_kernel<<<dim3((Cout + RED_COLS - 1) / RED_COLS),
                         dim3(RED_COLS, RED_LANES), 0, stream>>>(
      static_cast<const float*>(psum), static_cast<const float*>(psq),
      static_cast<float*>(sum), static_cast<float*>(sumsq), N * grid.y, Cout);
  return cudaGetLastError();
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

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
