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
// What bounds it on the H100: by the data sheet, the bytes (q, k, v and o
// once each: 0.0028 ms at B=4 S=384 N=12 D=64 bf16), since causal work is
// only ~S/2 multiply-adds per loaded element; at these short lengths the
// real limit is latency: a block's chain of key tiles, each a product, a
// softmax and a product, with little work to hide it. Both variants run
// one block per (batch*head, 64-row query tile), the key/value loop inside
// the block in place of the TPU's sequential grid axis, and skip key tiles
// above the diagonal. ops/flash_attention.py:kernel_variant picks one.
//
// "mma" (flash_fwd_mma_kernel, C entry bt_flash_fwd_mma): bf16, D 64 or
// 128. FA2-style on the tensor cores: 4 warps of 16 query rows, the query
// tiles taken last first (under a causal mask the longest blocks start
// first and the short ones fill the tail); the Q tile
// is copied once with cp.async and held in registers as ldmatrix
// fragments; K and V tiles of 64 keys go through a cp.async double buffer
// (rows past Sk zero-filled by the copy, rows padded by 16 bytes so
// ldmatrix is free of bank conflicts). S = Q K^T by mma.sync m16n8k16 bf16
// -> f32, scaled in f32; the mask and the online softmax stay in the
// accumulator registers, a row's max and sum shuffled over the 4 lanes
// that hold it. p stays f32 for the row sum; for P V it is split into
// bf16 hi + lo, both multiplied by V (ldmatrix.trans) into the f32 output
// accumulator, so the products are those of f32 p to about 2^-17 and only
// the order of the sums differs from the plain version (one bf16 p would
// miss the bf16 check by up to 2e-3 at S=384).
//
// "fma" (flash_fwd_kernel, C entry bt_flash_fwd): float32, the first
// port's design. K and V tiles are staged in shared memory as f32 with a
// padded row stride (conflict-free column walks); the two products run as
// f32 FMA on the CUDA cores, four threads per query row. It is bound by
// that arithmetic (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 4 threads per query row
constexpr float NEG = -FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ------------------------------------------------------------ mma variant
constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (BQ + 4 * BK) * mma_bf16::tile_pitch<D>() * 2;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int n_heads, int sq, int sk, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int P = tile_pitch<D>();
  constexpr int KD = D / 16;   // k16 steps of Q K^T
  constexpr int NT = BK / 8;   // 8-key tiles of S
  constexpr int OT = D / 8;    // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x P
  __nv_bfloat16* ks = qs + BQ * P;                                  // 2 x BK x P
  __nv_bfloat16* vs = ks + 2 * BK * P;                              // 2 x BK x P

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  // the query tiles in reverse, so that under a causal mask the tiles with
  // the most key tiles are scheduled first and the short ones fill the tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long stride = (long)n_heads * D;  // elements between sequence positions
  const __nv_bfloat16* kb = k + (long)b * sk * stride + (long)h * D;
  const __nv_bfloat16* vb = v + (long)b * sk * stride + (long)h * D;

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    // key tiles strictly above the diagonal hold nothing this tile can see
    const int last_q = min(q0 + BQ - 1, sq - 1);
    nkb = min(nkb, last_q / BK + 1);
  }

  stage_rows<BQ, D, MMA_THREADS>(qs, q + ((long)b * sq + q0) * stride + (long)h * D,
                                 stride, sq - q0, tid);
  stage_rows<BK, D, MMA_THREADS>(ks, kb, stride, sk, tid);
  stage_rows<BK, D, MMA_THREADS>(vs, vb, stride, sk, tid);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  uint32_t qf[KD][4];
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < nkb; ++it) {
    const int buf = it & 1;
    if (it + 1 < nkb) {
      const int k1 = (it + 1) * BK;
      stage_rows<BK, D, MMA_THREADS>(ks + (buf ^ 1) * BK * P, kb + k1 * stride, stride,
                                     sk - k1, tid);
      stage_rows<BK, D, MMA_THREADS>(vs + (buf ^ 1) * BK * P, vb + k1 * stride, stride,
                                     sk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        frag_a<D>(qf[kk], qs, warp * 16, kk * 16, lane);
    }
    const __nv_bfloat16* kt = ks + buf * BK * P;
    const __nv_bfloat16* vt = vs + buf * BK * P;

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        frag_b_rows<D>(r, kt, np * 16, kk * 16, lane);
        mma_16816(s[2 * np], qf[kk], r[0], r[1]);
        mma_16816(s[2 * np + 1], qf[kk], r[2], r[3]);
      }

    // scale in f32, mask, and the online softmax; e / 2 picks the row
    const int k0 = it * BK;
    float bmax[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        const int qi = row0 + 8 * (e / 2);
        const bool valid = kj < sk && (!causal || kj <= qi);
        s[j][e] = valid ? s[j][e] * scale : NEG;
        bmax[e / 2] = fmaxf(bmax[e / 2], s[j][e]);
      }
    float m_new[2], corr[2];
    bool dead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 1));
      bmax[r] = fmaxf(bmax[r], __shfl_xor_sync(0xffffffffu, bmax[r], 2));
      m_new[r] = fmaxf(m[r], bmax[r]);
      dead[r] = m_new[r] <= NEG * 0.5f;  // every logit so far masked
      corr[r] = dead[r] ? 1.f : expf(m[r] - m_new[r]);
      m[r] = m_new[r];
    }
    // p in f32; the A fragments of P (hi and lo) for k16 step j2 come from
    // S tiles 2 j2 (keys 0-7) and 2 j2 + 1 (keys 8-15)
    float psum[2] = {0.f, 0.f};
    uint32_t ph[NT / 2][4], pl[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = dead[r] ? 0.f : expf(s[j][2 * r] - m_new[r]);
        const float p1 = dead[r] ? 0.f : expf(s[j][2 * r + 1] - m_new[r]);
        psum[r] += p0 + p1;
        uint32_t pieces[2];
        split_bf16<2>(pieces, p0, p1);
        ph[j / 2][2 * (j % 2) + r] = pieces[0];
        pl[j / 2][2 * (j % 2) + r] = pieces[1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e / 2];

    // O += (P_hi + P_lo) V
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2)
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t r[4];
        frag_b_cols<D>(r, vt, j2 * 16, dp * 16, lane);
        mma_16816(acc[2 * dp], ph[j2], r[0], r[1]);
        mma_16816(acc[2 * dp], pl[j2], r[0], r[1]);
        mma_16816(acc[2 * dp + 1], ph[j2], r[2], r[3]);
        mma_16816(acc[2 * dp + 1], pl[j2], r[2], r[3]);
      }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    const float l_safe = fmaxf(l[r], 1e-37f);
    __nv_bfloat16* ob = o + ((long)b * sq + qi) * stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + j * 8 + 2 * t) = __floats2bfloat162_rn(
          acc[j][2 * r] / l_safe, acc[j][2 * r + 1] / l_safe);
    if (t == 0) {
      const bool dead_row = m[r] <= NEG * 0.5f;
      lse[((long)b * n_heads + h) * sq + qi] = dead_row ? NEG : m[r] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int batch, int n_heads, int sq, int sk,
                       float scale, int causal, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + BQ - 1) / BQ);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n_heads, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The "mma" variant: bf16 q, k, v and o, head_dim 64 or 128; the other
// arguments as bt_flash_fwd's. Returns a cudaError_t (0 on success).
extern "C" int bt_flash_fwd_mma(const void* q, const void* k, const void* v,
                                void* o, void* lse, int batch, int n_heads,
                                int sq, int sk, int head_dim, float scale,
                                int causal, void* stream) {
  if (batch <= 0 || n_heads <= 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if ((sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_mma<64>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  if (head_dim == 128)
    return launch_mma<128>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

// The "fma" variant. dtype: 0 = float32 (bfloat16, 1, takes
// bt_flash_fwd_mma). Returns a cudaError_t (0 on success).
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
  return cudaErrorInvalidValue;
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
