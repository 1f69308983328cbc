// Flash-attention backward for NVIDIA Hopper (sm_90a), kernels K2 and K3 of
// the port.
//
// Replaces the two Pallas TPU kernels that `_flash_bwd` in
// bigdl_tpu/ops/flash_attention.py launches:
//   K2 `_bwd_dq_kernel`  -> flash_bwd_dq_kernel  (dQ, one block per query tile)
//   K3 `_bwd_dkv_kernel` -> flash_bwd_dkv_kernel (dK and dV, one block per key tile)
// They compute the same function. With the forward's row log-sum-exp LSE and
// delta_i = rowsum(dO_i * O_i) - g_lse_i (computed by the wrapper):
//   p_ij  = exp(scale * q_i.k_j - LSE_i)       (recomputed, never stored)
//   dS_ij = p_ij * (dO_i.v_j - delta_i) * scale
//   dQ_i  = sum_j dS_ij k_j,  dK_j = sum_i dS_ij q_i,  dV_j = sum_i p_ij dO_i
// q, k, v and dO are read as float32 (bfloat16 inputs are widened on load);
// p, dS and every sum stay float32, as in the reference, and only the stored
// dQ/dK/dV round to the input type. The exponent is guarded BEFORE exp: a
// masked position (causal, key past Sk, query past Sq) takes exponent 0 and
// p = 0, so a padded or dead row's LSE sentinel (-FLT_MAX) can never make
// inf * 0 = NaN.
//
// Layouts (all contiguous): q, dO, dQ (B, Sq, N, D); k, v, dK, dV
// (B, Sk, N, D); LSE and delta (B, N, Sq) float32. Reads and writes go
// through the (B, S, N, D) strides, so the wrapper copies nothing. q/k/v are
// float32 or bfloat16 (all the same); D is 64 or 128 (a template parameter).
// Causal masking is top-left aligned (query i sees keys <= i).
//
// No atomics: K2 owns a query tile's dQ and K3 a key tile's dK and dV, so no
// block adds into another's output. Each output element is one sum in a fixed
// order, and the kernels are deterministic from run to run.
//
// What bounds them on the H100. Per causal (q, k) pair, K2 does three
// products of depth D (q.k, dO.v, dS.k) and K3 four (q.k, dO.v, p.dO, dS.q).
// At the training shape B=8, S=512, N=12, D=64 in bf16 there are
// 8*12*512*513/2 = 12.6M causal pairs:
//   K2: 3 * 2 * 64 * 12.6M = 4.84 GFLOP -> 4.9 us at 989 TFLOP/s (bf16 dense);
//       bytes: q, k, v, dO read (4 * 6.29 MB), LSE and delta (0.39 MB), dQ
//       written (6.29 MB) = 31.9 MB -> 9.5 us at 3.35 TB/s. Bound by bytes.
//   K3: 4 * 2 * 64 * 12.6M = 6.45 GFLOP -> 6.5 us; bytes 25.6 MB read plus
//       dK, dV written (12.6 MB) = 38.2 MB -> 11.4 us. Bound by bytes.
// This first version is the simple design and reaches neither bound: each
// block stages its own tile (64 rows) and the streamed tiles (64 rows at a
// time) in shared memory as float32 with a padded row stride (conflict-free
// column walks), and every product runs as float32 FMA on the CUDA cores,
// four threads per row, each FMA reading one operand from shared memory. So
// the kernels are bound by shared-memory traffic and FMA issue, far above
// both bounds; the tensor cores (mma.sync, then wgmma with TMA) are the later
// work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per tile row
constexpr int PP = BK + 1;    // padded row stride of the P / dS tiles

static_assert(BQ == BK, "K3's first causal query tile is its key tile index");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stage `rows` sequence positions starting at `p0` of one (batch, head) into
// a float32 tile with row stride D + 1; positions at or past `len` read 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int p0, int len,
                                      long stride) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i - (i / D) * D;
    const int pos = p0 + r;
    dst[r * DP + d] = pos < len ? to_f32(src[pos * stride + d]) : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() { return 4 * 64 * (D + 1) + BQ * PP; }

template <int D>
constexpr int dkv_smem_floats() { return 4 * 64 * (D + 1) + 2 * BK * PP + 2 * BQ; }

// K2: one block per (batch * head, 64-row query tile); the loop over key
// tiles runs inside the block (the TPU kernel's sequential grid axis).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int n_heads, int sq, int sk,
                    float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int SJ = BK / 4;  // keys per thread per tile
  constexpr int AJ = D / 4;   // dQ columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // BQ x DP
  float* dos = qs + BQ * DP;   // BQ x DP
  float* ks = dos + BQ * DP;   // BK x DP
  float* vs = ks + BK * DP;    // BK x DP
  float* dss = vs + BK * DP;   // BQ x PP, dS of the current key tile

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;   // this thread's query row in the tile
  const int part = tid & 3;   // its quarter of the row (4 lanes of one warp)
  const int qi = q0 + row;
  const long stride = (long)n_heads * D;
  const long qoff = (long)b * sq * stride + (long)h * D;
  const long koff = (long)b * sk * stride + (long)h * D;

  stage<T, D>(qs, q + qoff, q0, sq, stride);
  stage<T, D>(dos, dout + qoff, q0, sq, stride);
  float lse_r = 0.f, delta_r = 0.f;  // rows past Sq: finite, never stored
  if (qi < sq) {
    lse_r = lse[(long)bh * sq + qi];
    delta_r = delta[(long)bh * sq + qi];
  }

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    // key tiles strictly above the diagonal hold nothing this tile can see
    const int last_q = min(q0 + BQ - 1, sq - 1);
    nkb = min(nkb, last_q / BK + 1);
  }

  float acc[AJ];
#pragma unroll
  for (int j = 0; j < AJ; ++j) acc[j] = 0.f;

  for (int t = 0; t < nkb; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // Q/dO staged (first tile) / last tile's K, V, dS consumed
    stage<T, D>(ks, k + koff, k0, sk, stride);
    stage<T, D>(vs, v + koff, k0, sk, stride);
    __syncthreads();

    float s[SJ], dp[SJ];
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = qs[row * DP + d];
      const float gv = dos[row * DP + d];
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[j] = fmaf(qv, ks[(part + 4 * j) * DP + d], s[j]);
        dp[j] = fmaf(gv, vs[(part + 4 * j) * DP + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int kj = k0 + part + 4 * j;
      const bool valid = kj < sk && (!causal || kj <= qi);
      const float expo = valid ? s[j] * scale - lse_r : 0.f;
      const float p = valid ? expf(expo) : 0.f;
      dss[row * PP + part + 4 * j] = p * (dp[j] - delta_r) * scale;
    }
    __syncwarp();  // the row's dS was written by the 4 lanes that read it

    for (int c = 0; c < BK; ++c) {
      const float g = dss[row * PP + c];
#pragma unroll
      for (int j = 0; j < AJ; ++j) acc[j] = fmaf(g, ks[c * DP + part + 4 * j], acc[j]);
    }
  }

  if (qi < sq) {
    T* out = dq + qoff + (long)qi * stride;
#pragma unroll
    for (int j = 0; j < AJ; ++j) out[part + 4 * j] = from_f32<T>(acc[j]);
  }
}

// K3: one block per (batch * head, 64-key tile); the loop over query tiles
// runs inside the block and, under causal masking, starts at the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int n_heads,
                     int sq, int sk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int SJ = BQ / 4;  // query rows per thread per tile
  constexpr int AJ = D / 4;   // dK / dV columns per thread
  extern __shared__ float smem[];
  float* ks = smem;            // BK x DP
  float* vs = ks + BK * DP;    // BK x DP
  float* qs = vs + BK * DP;    // BQ x DP
  float* dos = qs + BQ * DP;   // BQ x DP
  float* ps = dos + BQ * DP;   // BK x PP, p transposed (key row, query)
  float* dss = ps + BK * PP;   // BK x PP, dS transposed
  float* ls = dss + BK * PP;   // BQ, LSE of the query tile
  float* dl = ls + BQ;         // BQ, delta of the query tile

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int row = tid >> 2;   // this thread's key row in the tile
  const int part = tid & 3;
  const int kr = k0 + row;
  const long stride = (long)n_heads * D;
  const long qoff = (long)b * sq * stride + (long)h * D;
  const long koff = (long)b * sk * stride + (long)h * D;

  stage<T, D>(ks, k + koff, k0, sk, stride);
  stage<T, D>(vs, v + koff, k0, sk, stride);

  const int nqb = (sq + BQ - 1) / BQ;
  // query tiles strictly before this key tile's first row see none of its keys
  const int first = causal ? blockIdx.y : 0;

  float acc_k[AJ], acc_v[AJ];
#pragma unroll
  for (int j = 0; j < AJ; ++j) acc_k[j] = acc_v[j] = 0.f;

  for (int qb = first; qb < nqb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // K/V staged (first tile) / last tile's Q, dO, P, dS consumed
    stage<T, D>(qs, q + qoff, q0, sq, stride);
    stage<T, D>(dos, dout + qoff, q0, sq, stride);
    if (tid < BQ) {
      const int pos = q0 + tid;
      // padded query rows: finite values, masked below before exp
      ls[tid] = pos < sq ? lse[(long)bh * sq + pos] : 0.f;
      dl[tid] = pos < sq ? delta[(long)bh * sq + pos] : 0.f;
    }
    __syncthreads();

    float s[SJ], dp[SJ];
#pragma unroll
    for (int j = 0; j < SJ; ++j) s[j] = dp[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[row * DP + d];
      const float vv = vs[row * DP + d];
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        s[j] = fmaf(kv, qs[(part + 4 * j) * DP + d], s[j]);
        dp[j] = fmaf(vv, dos[(part + 4 * j) * DP + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int r = part + 4 * j;
      const int qj = q0 + r;
      const bool valid = kr < sk && qj < sq && (!causal || kr <= qj);
      const float expo = valid ? s[j] * scale - ls[r] : 0.f;
      const float p = valid ? expf(expo) : 0.f;
      ps[row * PP + r] = p;
      dss[row * PP + r] = p * (dp[j] - dl[r]) * scale;
    }
    __syncwarp();  // the key row's P and dS were written by the 4 lanes that read them

    for (int c = 0; c < BQ; ++c) {
      const float p = ps[row * PP + c];
      const float g = dss[row * PP + c];
#pragma unroll
      for (int j = 0; j < AJ; ++j) {
        acc_v[j] = fmaf(p, dos[c * DP + part + 4 * j], acc_v[j]);
        acc_k[j] = fmaf(g, qs[c * DP + part + 4 * j], acc_k[j]);
      }
    }
  }

  if (kr < sk) {
    T* ok = dk + koff + (long)kr * stride;
    T* ov = dv + koff + (long)kr * stride;
#pragma unroll
    for (int j = 0; j < AJ; ++j) {
      ok[part + 4 * j] = from_f32<T>(acc_k[j]);
      ov[part + 4 * j] = from_f32<T>(acc_v[j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int n_heads, int sq, int sk,
                      float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), n_heads, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int n_heads, int sq,
                       int sk, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), n_heads, sq, sk, scale,
      causal);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n_heads, int sq, int sk) {
  return batch <= 0 || n_heads <= 0 || sq <= 0 || sk <= 0
         || (sq + BQ - 1) / BQ > 65535 || (sk + BK - 1) / BK > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 on success).
extern "C" int bt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int batch,
                               int n_heads, int sq, int sk, int head_dim,
                               float scale, int causal, int dtype, void* stream) {
  if (bad_shape(batch, n_heads, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int bt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int batch, int n_heads, int sq, int sk,
                                int head_dim, float scale, int causal,
                                int dtype, void* stream) {
  if (bad_shape(batch, n_heads, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
