// Flash-attention forward for NVIDIA Hopper (sm_90a), kernel K1 of the port.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, called by `_flash_fwd_lse`
// in bigdl_tpu/ops/flash_attention.py. It computes the same function:
// O = softmax(scale * Q K^T [causal mask]) V and the row log-sum-exp LSE of
// the scaled, masked logits, with f32 running (max, sum, accumulator). A row
// whose logits are all masked (or all below float32.min / 2) is "dead": its
// O is 0 and its LSE is the finite sentinel -FLT_MAX, never -inf.
//
// Layouts (all contiguous): q, o (B, Sq, N, D); k, v (B, Sk, N, D);
// lse (B, N, Sq) f32. q/k/v/o are float32 or bfloat16; D is 64 or 128.
// Causal masking is top-left aligned (query i sees keys <= i).
//
// What bounds it on the H100: at the serving prefill shapes (S <= 512,
// D = 64) the work is ~S/2 multiply-adds per loaded element, so the card's
// arithmetic rate is the bound, not its memory. This first version is the
// simple design: one block per (batch*head, 64-row query tile); the key/value
// loop runs inside the block in place of the TPU's sequential grid axis;
// key tiles above the diagonal are skipped; K and V tiles are staged in
// shared memory as f32 with a padded row stride (conflict-free column
// walks); the two products run as f32 FMA on the CUDA cores, four threads
// per query row. Tensor cores (mma.sync / wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr float NEG = -FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return 3 * BQ * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int sq, int sk,
                 float scale, int causal) {
  constexpr int DP = D + 1;   // padded row stride of the Q/K/V tiles
  constexpr int PP = BK + 1;  // padded row stride of the P tile
  constexpr int SJ = BK / 4;  // logits per thread per key tile
  constexpr int AJ = D / 4;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x DP, pre-scaled
  float* ks = qs + BQ * DP;    // BK x DP
  float* vs = ks + BK * DP;    // BK x DP
  float* ps = vs + BK * DP;    // BQ x PP, probabilities of the current tile

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;   // this thread's query row in the tile
  const int part = tid & 3;   // its quarter of the row (4 lanes of one warp)
  const int qi = q0 + row;
  const long stride = (long)n_heads * D;  // elements between sequence positions
  const T* qb = q + (long)b * sq * stride + (long)h * D;
  const T* kb = k + (long)b * sk * stride + (long)h * D;
  const T* vb = v + (long)b * sk * stride + (long)h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - (i / D) * D;
    const int pos = q0 + r;
    qs[r * DP + d] = pos < sq ? to_f32(qb[pos * stride + d]) * scale : 0.f;
  }

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    // key tiles strictly above the diagonal hold nothing this tile can see
    const int last_q = min(q0 + BQ - 1, sq - 1);
    nkb = min(nkb, last_q / BK + 1);
  }

  float m = NEG, l = 0.f;
  float acc[AJ];
#pragma unroll
  for (int j = 0; j < AJ; ++j) acc[j] = 0.f;

  for (int t = 0; t < nkb; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q staged (first tile) / last tile's K, V, P consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - (i / D) * D;
      const int pos = k0 + r;
      const bool in = pos < sk;
      ks[r * DP + d] = in ? to_f32(kb[pos * stride + d]) : 0.f;
      vs[r * DP + d] = in ? to_f32(vb[pos * stride + d]) : 0.f;
    }
    __syncthreads();

    float s[SJ];
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * DP + d];
#pragma unroll
      for (int j = 0; j < SJ; ++j) s[j] = fmaf(qv, ks[(part + 4 * j) * DP + d], s[j]);
    }

    float bmax = NEG;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int kj = k0 + part + 4 * j;
      const bool valid = kj < sk && (!causal || kj <= qi);
      s[j] = valid ? s[j] : NEG;
      bmax = fmaxf(bmax, s[j]);
    }
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 1));
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 2));
    const float m_new = fmaxf(m, bmax);
    const bool dead = m_new <= NEG * 0.5f;  // every logit so far masked
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const float p = dead ? 0.f : expf(s[j] - m_new);
      ps[row * PP + part + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = dead ? 1.f : expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's P was written by the 4 lanes that read it

#pragma unroll
    for (int j = 0; j < AJ; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = ps[row * PP + c];
#pragma unroll
      for (int j = 0; j < AJ; ++j) acc[j] = fmaf(p, vs[c * DP + part + 4 * j], acc[j]);
    }
  }

  if (qi < sq) {
    const bool dead = m <= NEG * 0.5f;
    const float l_safe = fmaxf(l, 1e-37f);
    T* ob = o + ((long)b * sq + qi) * stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < AJ; ++j) ob[part + 4 * j] = from_f32<T>(acc[j] / l_safe);
    if (part == 0) {
      lse[((long)b * n_heads + h) * sq + qi] = dead ? NEG : m + logf(l_safe);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int n_heads, int sq, int sk,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n_heads, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int bt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int batch, int n_heads,
                            int sq, int sk, int head_dim, float scale,
                            int causal, int dtype, void* stream) {
  if (batch <= 0 || n_heads <= 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if ((sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
