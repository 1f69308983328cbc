// Weight-only int8 matmul for NVIDIA Hopper (sm_90a), kernel K4 of the port.
//
// Replaces the Pallas TPU kernel `_kernel`, called by `_int8_matmul_pallas`
// in bigdl_tpu/ops/int8_matmul.py. It computes the same function:
//   y[m, o] = (sum_k x[m, k] * w[o, k]) * s[o]
// with x already rounded to bfloat16 by the caller (the reference rounds x
// to bf16 before the product, whatever the compute dtype), w int8 (O, K),
// s the f32 per-output-row scale, the sum in f32, the scale applied once
// after the K loop, and y float32 (M, O).
//
// What bounds it on the H100: decode-shaped M (the serving step has M = the
// batch, at most 256 by the wrapper's rule) does 2*M operations per weight
// byte, far below the ~295 the card needs before its arithmetic is the
// limit, so the int8 weight read from device memory is the bound. The design
// streams every weight byte exactly once with 16-byte loads: each warp owns
// four output rows and its lanes read 16 consecutive int8 values of each row
// per step (a warp covers 512 bytes of a row per step); x for up to eight
// rows of M is staged in shared memory in K-chunks and each staged value is
// reused against the warp's four weight rows; products accumulate in f32
// registers and a warp shuffle reduces each row's partial sums once at the
// end, where the scale is applied. Grid: (ceil(O / 16), ceil(M / 8)).
// Requirements (checked by the wrapper and here): K % 16 == 0 and 16-byte
// aligned x and w, so every load is one aligned 16-byte vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;          // warps per block
constexpr int ROWS_PER_WARP = 4;  // output rows per warp
constexpr int MT = 8;             // rows of x per block
constexpr int KC = 1024;          // K-chunk of x staged in shared memory
constexpr int ROWS_PER_BLOCK = WARPS * ROWS_PER_WARP;

// low / high bf16 of a packed pair, widened exactly to f32
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
// byte i (0..3) of a packed word as a signed int8, widened exactly to f32
__device__ __forceinline__ float i8(uint32_t u, int i) {
  return static_cast<float>(static_cast<int32_t>(u << (24 - 8 * i)) >> 24);
}

__global__ void __launch_bounds__(WARPS * 32)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   float* __restrict__ y, int M, int K, int O) {
  constexpr int KV = KC / 8;  // 16-byte vectors (8 bf16) per staged row
  __shared__ uint4 xs[MT * KV];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int o0 = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS_PER_WARP;

  float acc[ROWS_PER_WARP][MT];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) acc[r][mm] = 0.f;

  for (int kc = 0; kc < K; kc += KC) {
    const int klen = min(KC, K - kc);  // a multiple of 16
    const int vecs = klen / 8;         // 16-byte vectors per staged row
    __syncthreads();                   // the previous chunk is consumed
    for (int i = threadIdx.x; i < MT * vecs; i += WARPS * 32) {
      const int r = i / vecs, c = i - (i / vecs) * vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < mrows)
        val = *reinterpret_cast<const uint4*>(x + (long)(m0 + r) * K + kc + c * 8);
      xs[r * KV + c] = val;
    }
    __syncthreads();

    for (int kk = lane * 16; kk < klen; kk += 32 * 16) {
      uint4 wv[ROWS_PER_WARP];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) {
        const int o = o0 + r;
        wv[r] = o < O ? __ldg(reinterpret_cast<const uint4*>(w + (long)o * K + kc + kk))
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) {
        if (mm >= mrows) break;
        const uint4* xp = xs + mm * KV + kk / 8;
        const uint4 xa = xp[0], xb = xp[1];
        const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
        float xf[16];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xf[2 * i] = bf16_lo(xw[i]);
          xf[2 * i + 1] = bf16_hi(xw[i]);
        }
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const uint32_t ww[4] = {wv[r].x, wv[r].y, wv[r].z, wv[r].w};
          float a = acc[r][mm];
#pragma unroll
          for (int i = 0; i < 16; ++i) a = fmaf(xf[i], i8(ww[i >> 2], i & 3), a);
          acc[r][mm] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int o = o0 + r;
    const float so = o < O ? s[o] : 0.f;
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
      float a = acc[r][mm];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0 && o < O && mm < mrows) y[(long)(m0 + mm) * O + o] = a * so;
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int bt_int8_matmul(const void* x, const void* w, const void* s,
                              void* y, int M, int K, int O, void* stream) {
  if (M <= 0 || K <= 0 || O <= 0 || K % 16 != 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorMisalignedAddress;
  if ((M + MT - 1) / MT > 65535) return cudaErrorInvalidValue;
  const dim3 grid((O + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, (M + MT - 1) / MT);
  int8_matmul_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(y), M, K, O);
  return cudaGetLastError();
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
