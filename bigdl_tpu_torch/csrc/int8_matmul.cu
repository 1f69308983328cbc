// Weight-only int8 matmul for NVIDIA Hopper (sm_90a), kernel K4 of the port.
//
// Replaces the Pallas TPU kernel `_kernel`, called by `_int8_matmul_pallas`
// in bigdl_tpu/ops/int8_matmul.py. It computes the same function:
//   y[m, o] = (sum_k x[m, k] * w[o, k]) * s[o]
// with x already rounded to bfloat16 by the caller (the reference rounds x
// to bf16 before the product, whatever the compute dtype), w int8 (O, K),
// s the f32 per-output-row scale, the sum in f32, the scale applied once
// after the K sum, and y float32 (M, O).
//
// What bounds it on the H100: decode-shaped M (the served step has M = 4,
// at most 256 by the wrapper's rule) does 2*M operations per weight byte,
// far below the ~295 the card needs before its arithmetic is the limit, so
// the bytes bound it: 0.06-0.7 us for 84 of a decode token's 85 launches
// (0.2-2.4 MB of weights each), 7.3 us for the LM head (24.6 MB). Below a
// few microseconds a launch's fixed costs set its time (an empty kernel in
// the same CUDA graph takes about 1 us), so the design is about latency:
//
// - One memory round trip. A block owns 16 output rows (one mma tile's
//   height) and all of K, in 64-deep chunks; warp i takes chunks i,
//   i + warps, ... Each warp issues the cp.async copies of all its chunks
//   (at most 8, every decode shape's in one batch) and of x for them at
//   once, then waits once. Each lane copies only the bytes it later reads
//   back itself, so no barrier comes before the products.
// - x through L1. Every block reads the same few kilobytes of x; copied
//   around L1 (cp.async.cg), those few L2 lines set the time of the large
//   grids on an H100 (the head most); copied through it (cp.async.ca), the
//   blocks resident on an SM share them.
// - No cluster, no second pass. A first design split K over a thread-block
//   cluster to put blocks on every SM, summing the split through
//   distributed shared memory; on an H100 its cluster barriers cost more a
//   launch than the idle SMs did. So K is split only over a block's warps:
//   8, or 4 where the grid holds at least two blocks an SM (the head).
// - Tensor cores, weights read once for every M <= 256. y^T = W x^T on
//   mma.sync m16n8k16 bf16 -> f32: A is a 16-row x 16-deep weight tile
//   converted int8 -> bf16 in registers (exact for every int8, -128 too),
//   B is x^T, one n8 column per 8 rows of M. K is permuted alike in A and
//   B, which leaves the sum unchanged: lane (g, t) reads 16 contiguous
//   weights of rows g and g + 8 and 16 contiguous x values at k = 16t of a
//   chunk, and its mma j takes their elements 4j .. 4j + 3, so both
//   operands come straight from 16-byte copies with no shuffle. M > 8 runs
//   the chunk's n8 tiles (eight at a time, 64 rows of M) against the held
//   A fragments; x is copied again for each 64 rows, the weights are not.
// - Fixed-order sums, no atomics. Each 64-deep chunk is summed on the
//   tensor cores from zero and added to an f32 register sum; each batch of
//   a warp's chunks is added to its partials in shared memory; the block
//   adds its warps in turn and applies the scale. The same bits every run.
//
// Requirements (checked by the wrapper and here): K % 16 == 0 and 16-byte
// aligned x and w, so every copy is one aligned 16-byte piece (the pieces
// of a last, partial chunk past K are zero-filled); M <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int ROWS = 16;          // output rows per block: one mma tile
constexpr int CHUNK = 64;         // K per chunk: 4 lanes x 16 bytes
constexpr int MAX_BATCH = 8;      // chunks a warp copies before it waits
constexpr int M_MAX = 256;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr int PIECES = 32 * 16;   // bytes of one 16-byte piece for each lane

// 16 bytes global -> shared through L1 (x: every block of the launch reads
// the same few kilobytes, which the blocks resident on an SM then share)
__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(mma_bf16::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// bytes 2p and 2p + 1 of u (int8) as a bf16 pair, byte 2p in the low half;
// exact: b + 128 is put in an f32 mantissa and the bias taken off
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t u, int p) {
  const uint32_t v = u ^ 0x80808080u;
  const float lo = __uint_as_float(0x4B000000u | ((v >> (16 * p)) & 0xffu)) - 8388736.f;
  const float hi = __uint_as_float(0x4B000000u | ((v >> (16 * p + 8)) & 0xffu)) - 8388736.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// shared memory: the warps' partials [WARPS][Mr][ROWS] f32, the block's 16
// scales, then each warp's copies: per chunk of its batch, the two weight
// pieces of every lane, then NT x 2 pieces of x
__host__ __device__ __forceinline__ int smem_bytes(int warps, int Mr, int nt, int batch) {
  return (warps * Mr * ROWS + ROWS) * 4 + warps * batch * (2 + 2 * nt) * PIECES;
}

template <int NT, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   float* __restrict__ y, int M, int K, int O, int batch) {
  using namespace mma_bf16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int Mr = (M + 7) & ~7;
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][Mr][ROWS]
  float* scale = red + WARPS * Mr * ROWS;
  uint4* wpieces = reinterpret_cast<uint4*>(scale + ROWS) + warp * batch * (2 + 2 * NT) * 32;
  uint4* xpieces = wpieces + batch * 2 * 32;

  const int o0 = blockIdx.x * ROWS;
  const int chunks = (K + CHUNK - 1) / CHUNK;
  const int mine = warp < chunks ? (chunks - warp + WARPS - 1) / WARPS : 0;
  const int m_chunks = (M + 8 * NT - 1) / (8 * NT);

  if (warp == 0 && lane < ROWS) {
    const bool in = o0 + lane < O;
    cp_async4(scale + lane, in ? s + o0 + lane : s, in);
  }
  cp_async_commit();
  float* my_red = red + warp * Mr * ROWS;
  for (int i = lane; i < Mr * ROWS; i += 32) my_red[i] = 0.f;

  for (int b0 = 0; b0 < mine; b0 += batch) {
    const int nb = min(batch, mine - b0);
    for (int i = 0; i < nb; ++i) {  // rows g and g + 8, k = 16t of the chunk
      const int k = (warp + WARPS * (b0 + i)) * CHUNK + 16 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + g + 8 * h;
        const bool in = o < O && k < K;
        cp_async16(wpieces + (i * 2 + h) * 32 + lane, in ? w + (long)o * K + k : w, in);
      }
    }
    for (int mc = 0; mc < m_chunks; ++mc) {
      for (int i = 0; i < nb; ++i) {  // x rows g of each n8 tile, k = 16t
        const int k = (warp + WARPS * (b0 + i)) * CHUNK + 16 * t;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int m = mc * 8 * NT + nt * 8 + g;
          const bool in = m < M && k < K;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            cp_async16_l1(xpieces + ((i * NT + nt) * 2 + h) * 32 + lane,
                          in ? x + (long)m * K + k + 8 * h : x, in);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();  // this lane's copies; no other lane reads them

      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int i = 0; i < nb; ++i) {
        const uint4 wg = wpieces[(i * 2) * 32 + lane];
        const uint4 wh = wpieces[(i * 2 + 1) * 32 + lane];
        const uint32_t rg[4] = {wg.x, wg.y, wg.z, wg.w};
        const uint32_t rh[4] = {wh.x, wh.y, wh.z, wh.w};
        uint32_t a[4][4];  // mma j: elements 4j .. 4j + 3 of the lane's 16
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j][0] = i8x2_bf16(rg[j], 0);
          a[j][1] = i8x2_bf16(rh[j], 0);
          a[j][2] = i8x2_bf16(rg[j], 1);
          a[j][3] = i8x2_bf16(rh[j], 1);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (mc * 8 * NT + nt * 8 >= M) break;
          const uint4 xa = xpieces[((i * NT + nt) * 2) * 32 + lane];
          const uint4 xb = xpieces[((i * NT + nt) * 2 + 1) * 32 + lane];
          const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
          float part[4] = {0.f, 0.f, 0.f, 0.f};  // the chunk, from zero
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_16816(part, a[j], xw[2 * j], xw[2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
        }
      }
      // C fragment: c0, c1 = (row g, m 2t, 2t + 1), c2, c3 = (row g + 8, ...)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int m = mc * 8 * NT + nt * 8 + 2 * t;
        if (m >= Mr) break;
        my_red[m * ROWS + g] += acc[nt][0];
        my_red[(m + 1) * ROWS + g] += acc[nt][1];
        my_red[m * ROWS + g + 8] += acc[nt][2];
        my_red[(m + 1) * ROWS + g + 8] += acc[nt][3];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the block's warps in turn, then the scale; m-major, so stores run along o
  for (int e = tid; e < M * ROWS; e += WARPS * 32) {
    float v = red[e];
#pragma unroll
    for (int q = 1; q < WARPS; ++q) v += red[q * Mr * ROWS + e];
    const int m = e / ROWS, r = e % ROWS;
    if (o0 + r < O) y[(long)m * O + o0 + r] = v * scale[r];
  }
}

template <int NT, int WARPS>
int launch(const void* x, const void* w, const void* s, void* y, int M, int K,
           int O, cudaStream_t stream) {
  const int tiles = (O + ROWS - 1) / ROWS;
  const int chunks = (K + CHUNK - 1) / CHUNK;
  const int per_warp = (chunks + WARPS - 1) / WARPS;
  const int Mr = (M + 7) & ~7;
  int batch = per_warp < MAX_BATCH ? per_warp : MAX_BATCH;
  while (batch > 1 && smem_bytes(WARPS, Mr, NT, batch) > MAX_SMEM) --batch;
  const int smem = smem_bytes(WARPS, Mr, NT, batch);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<NT, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int8_matmul_kernel<NT, WARPS><<<tiles, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(y), M, K, O, batch);
  return cudaGetLastError();
}

// 4 warps a block where the grid holds at least two blocks an SM (the LM
// head: more blocks resident, faster on an H100), else 8, so that each warp
// of a short grid has fewer chunks to copy and sum
template <int NT>
int launch_for(const void* x, const void* w, const void* s, void* y, int M,
               int K, int O, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return (O + ROWS - 1) / ROWS >= 2 * sms ? launch<NT, 4>(x, w, s, y, M, K, O, stream)
                                          : launch<NT, 8>(x, w, s, y, M, K, O, stream);
}

__global__ void empty_kernel() {}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int bt_int8_matmul(const void* x, const void* w, const void* s,
                              void* y, int M, int K, int O, void* stream) {
  if (M <= 0 || M > M_MAX || K <= 0 || O <= 0 || K % 16 != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return M <= 8 ? launch_for<1>(x, w, s, y, M, K, O, st)
                : launch_for<8>(x, w, s, y, M, K, O, st);
}

// One launch of an empty kernel of K4's block size: the least time a launch
// takes, for the timing table (it is no part of the function).
extern "C" int bt_int8_empty_launch(void* stream) {
  empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
