// Flash-attention backward for NVIDIA Hopper (sm_90a), kernels K2 and K3 of
// the port.
//
// Replaces the two Pallas TPU kernels that `_flash_bwd` in
// bigdl_tpu/ops/flash_attention.py launches:
//   K2 `_bwd_dq_kernel`  -> flash_bwd_dq_mma_kernel (bf16) and
//                           flash_bwd_dq_kernel (f32): dQ, one block per query tile
//   K3 `_bwd_dkv_kernel` -> flash_bwd_dkv_mma_kernel (bf16) and
//                           flash_bwd_dkv_kernel (f32): dK and dV, one block per key tile
// They compute the same function. With the forward's row log-sum-exp LSE and
// delta_i = rowsum(dO_i * O_i) - g_lse_i (computed by the wrapper):
//   p_ij  = exp(scale * q_i.k_j - LSE_i)       (recomputed, never stored)
//   dS_ij = p_ij * (dO_i.v_j - delta_i) * scale
//   dQ_i  = sum_j dS_ij k_j,  dK_j = sum_i dS_ij q_i,  dV_j = sum_i p_ij dO_i
// p, dS and every sum are float32, as in the reference, and only the stored
// dQ/dK/dV round to the input type. The exponent is guarded BEFORE exp: a
// masked position (causal, key past Sk, query past Sq) takes exponent 0 and
// p = 0, so a padded or dead row's LSE sentinel (-FLT_MAX) can never make
// inf * 0 = NaN.
//
// Layouts (all contiguous): q, dO, dQ (B, Sq, N, D); k, v, dK, dV
// (B, Sk, N, D); LSE and delta (B, N, Sq) float32. Reads and writes go
// through the (B, S, N, D) strides, so the wrapper copies nothing. D is 64
// or 128 (a template parameter). Causal masking is top-left aligned (query
// i sees keys <= i): K2 stops at the diagonal key tile, K3 starts at the
// diagonal query tile.
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
// Each kernel has two variants; ops/flash_attention.py:kernel_variant picks
// one (bf16 -> "mma", float32 -> "fma").
//
// "mma" (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel; C entries
// bt_flash_bwd_dq_mma, bt_flash_bwd_dkv_mma): bf16, D 64 or 128, on the
// tensor cores (mma.sync m16n8k16 bf16 -> f32) in K1's mma design: 4 warps
// of 16 rows; the block's own tile (K2: Q and dO; K3: K and V) copied once
// with cp.async and taken as ldmatrix A fragments (held in registers at
// D=64; at D=128 reloaded from shared memory every tile, which frees 64
// registers a thread); the other operands streamed in tiles of 64 rows
// through a cp.async double buffer (rows past the sequence zero-filled,
// rows padded by 16 bytes for conflict-free ldmatrix), K3's with each query
// tile's LSE and delta. S and dP (K3: S^T = K Q^T, dP^T = V dO^T) come out
// of the tensor cores in f32; p and dS are formed in the accumulator
// registers, the exponent guarded as above, and go back into A fragments in
// the C -> A layout of K1's P; the right-hand operands (K for dQ, dO for
// dV, Q for dK) come from ldmatrix.trans. K2 takes its query tiles last
// first, as K1 does (under a causal mask the longest blocks start first);
// K3's key tile 0, which sees every query tile, is among the first blocks
// scheduled. What bounds them: neither the bytes nor the tensor cores'
// rate; a tile pair costs K2 4 and K3 8 products of 64 x 64 x D (the bf16
// pieces counted), on mma.sync at the 2 (K3) or 3 (K2) blocks an SM that
// their registers allow, so each block's chain of tiles, with the f32 work
// between its products (exp, the splits), sets the time.
// Precision: q, k, v and dO are bf16, so S and dP are exact products summed
// in f32. p and dS are f32, and one bf16 rounding of either would miss the
// bf16 check by about 3e-3 (tests/test_torch_flash_bwd_mma.py emulates the
// splits on the CPU). So they enter the products as sums of bf16 pieces,
// each piece the rounding of what the earlier ones left: two pieces hold a
// value to 2^-16, three to 2^-24. dQ = dS K takes dS as hi + lo (sums over
// at most Sk keys; on an H100 the largest excess over one bf16 step was
// 3.0e-6, under half the check's 1e-5 atol). dV = P^T dO and dK = dS^T Q
// take three pieces: their column sums run over up to Sq queries with
// large weights on the early keys, and two pieces read 9.9e-6 for dV in
// the CPU emulation and 5.2e-6 for dK on an H100, past half the atol.
// Every product adds straight into the running f32 accumulators: summing
// each 16-deep step's pieces from zero first (what K6 needs over its long
// sums) moved no gradient's excess by more than 1e-7 on an H100, cost time
// in both kernels and spilled in K3.
//
// "fma" (flash_bwd_dq_kernel, flash_bwd_dkv_kernel; C entries
// bt_flash_bwd_dq, bt_flash_bwd_dkv): float32, the first port's design.
// Each block stages its own tile and the streamed tiles (64 rows at a
// time) in shared memory as float32 with a padded row stride (conflict-free
// column walks); every product runs as float32 FMA on the CUDA cores, four
// threads per row, each FMA reading one operand from shared memory. It is
// bound by shared-memory traffic and FMA issue, far above both bounds. p,
// dS and every sum stay float32, as in the reference, and only the stored
// dQ/dK/dV round to the input type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 4 threads per tile row
constexpr int PP = BK + 1;    // padded row stride of the P / dS tiles

static_assert(BQ == BK, "K3's first causal query tile is its key tile index");

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// ------------------------------------------------------------ mma variant
constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows
typedef __nv_bfloat16 bf16;

template <int D>
__host__ __device__ constexpr int mma_tile_bytes() {
  return BK * mma_bf16::tile_pitch<D>() * 2;
}

// K2: Q, dO and two (K, V) buffers; K3: K, V and two (Q, dO, LSE, delta) buffers
template <int D>
__host__ __device__ constexpr int dq_mma_smem_bytes() { return 6 * mma_tile_bytes<D>(); }

template <int D>
__host__ __device__ constexpr int dkv_mma_smem_bytes() {
  return 6 * mma_tile_bytes<D>() + 2 * 2 * BQ * 4;
}

// K2 on the tensor cores: one block per (batch * head, 64-row query tile),
// the query tiles last first; the key tiles stream through a double buffer.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n_heads, int sq, int sk,
                        float scale, int causal) {
  using namespace mma_bf16;
  constexpr int P = tile_pitch<D>();
  constexpr int KD = D / 16;     // k16 steps of S and dP
  constexpr int NT = BK / 8;     // 8-key tiles of S and dP
  constexpr int OT = D / 8;      // 8-column tiles of dQ
  constexpr bool HOLD = D == 64; // Q and dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x P
  bf16* gs = qs + BQ * P;                        // BQ x P, dO
  bf16* ks = gs + BQ * P;                        // 2 x BK x P
  bf16* vs = ks + 2 * BK * P;                    // 2 x BK x P

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long stride = (long)n_heads * D;
  const long qoff = ((long)b * sq + q0) * stride + (long)h * D;
  const bf16* kb = k + (long)b * sk * stride + (long)h * D;
  const bf16* vb = v + (long)b * sk * stride + (long)h * D;

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    // key tiles strictly above the diagonal hold nothing this tile can see
    const int last_q = min(q0 + BQ - 1, sq - 1);
    nkb = min(nkb, last_q / BK + 1);
  }

  stage_rows<BQ, D, MMA_THREADS>(qs, q + qoff, stride, sq - q0, tid);
  stage_rows<BQ, D, MMA_THREADS>(gs, dout + qoff, stride, sq - q0, tid);
  stage_rows<BK, D, MMA_THREADS>(ks, kb, stride, sk, tid);
  stage_rows<BK, D, MMA_THREADS>(vs, vb, stride, sk, tid);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  float lse_r[2], delta_r[2];           // rows past Sq: finite, never stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    lse_r[r] = qi < sq ? lse[(long)bh * sq + qi] : 0.f;
    delta_r[r] = qi < sq ? delta[(long)bh * sq + qi] : 0.f;
  }
  uint32_t qf[KD][4], gf[KD][4];
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
    if (HOLD && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        frag_a<D>(qf[kk], qs, warp * 16, kk * 16, lane);
        frag_a<D>(gf[kk], gs, warp * 16, kk * 16, lane);
      }
    }
    const bf16* kt = ks + buf * BK * P;
    const bf16* vt = vs + buf * BK * P;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], c[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e], c[e] = gf[kk][e];
      } else {
        frag_a<D>(a, qs, warp * 16, kk * 16, lane);
        frag_a<D>(c, gs, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        frag_b_rows<D>(r, kt, np * 16, kk * 16, lane);
        mma_16816(s[2 * np], a, r[0], r[1]);
        mma_16816(s[2 * np + 1], a, r[2], r[3]);
        frag_b_rows<D>(r, vt, np * 16, kk * 16, lane);
        mma_16816(dp[2 * np], c, r[0], r[1]);
        mma_16816(dp[2 * np + 1], c, r[2], r[3]);
      }
    }

    // p and dS in f32 (e / 2 picks the row); dS as bf16 hi + lo A fragments,
    // k16 step j2 from the S tiles 2 j2 (keys 0-7) and 2 j2 + 1 (keys 8-15)
    const int k0 = it * BK;
    uint32_t dsf[NT / 2][2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float sv = s[j][2 * r + c], dpv = dp[j][2 * r + c];
          const int kj = k0 + j * 8 + 2 * t + c;
          const bool valid = kj < sk && (!causal || kj <= row0 + 8 * r);
          const float expo = valid ? sv * scale - lse_r[r] : 0.f;
          const float p = valid ? expf(expo) : 0.f;
          ds[c] = p * (dpv - delta_r[r]) * scale;
        }
        uint32_t pieces[2];
        split_bf16<2>(pieces, ds[0], ds[1]);
        dsf[j / 2][0][2 * (j % 2) + r] = pieces[0];
        dsf[j / 2][1][2 * (j % 2) + r] = pieces[1];
      }

    // dQ += (dS_hi + dS_lo) K
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2)
#pragma unroll
      for (int nd = 0; nd < OT / 2; ++nd) {
        uint32_t r[4];
        frag_b_cols<D>(r, kt, j2 * 16, nd * 16, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_16816(acc[2 * nd], dsf[j2][i], r[0], r[1]);
          mma_16816(acc[2 * nd + 1], dsf[j2][i], r[2], r[3]);
        }
      }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= sq) continue;
    bf16* out = dq + ((long)b * sq + qi) * stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

// K3 on the tensor cores: one block per (batch * head, 64-key tile), key
// tile 0 (under a causal mask the most work) among the first scheduled; the
// query tiles, from the diagonal on, stream through a double buffer with
// their LSE and delta.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n_heads,
                         int sq, int sk, float scale, int causal) {
  using namespace mma_bf16;
  constexpr int P = tile_pitch<D>();
  constexpr int KD = D / 16;     // k16 steps of S^T and dP^T
  constexpr int NT = BQ / 8;     // 8-query tiles of S^T and dP^T
  constexpr int OT = D / 8;      // 8-column tiles of dK and dV
  constexpr bool HOLD = D == 64; // K and V fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // BK x P
  bf16* vs = ks + BK * P;                        // BK x P
  bf16* qs = vs + BK * P;                        // 2 x BQ x P
  bf16* gs = qs + 2 * BQ * P;                    // 2 x BQ x P, dO
  float* ls = reinterpret_cast<float*>(gs + 2 * BQ * P);  // 2 x BQ, LSE
  float* dl = ls + 2 * BQ;                                // 2 x BQ, delta

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long stride = (long)n_heads * D;
  const long koff = ((long)b * sk + k0) * stride + (long)h * D;
  const bf16* qb = q + (long)b * sq * stride + (long)h * D;
  const bf16* gb = dout + (long)b * sq * stride + (long)h * D;
  const float* lb = lse + (long)bh * sq;
  const float* db = delta + (long)bh * sq;

  const int nqb = (sq + BQ - 1) / BQ;
  // query tiles strictly before this key tile's first row see none of its keys
  const int first = causal ? blockIdx.y : 0;

  // query tile qt (and its LSE and delta) into buffer `buf`; rows past Sq
  // read nothing and are zero-filled (masked below before exp)
  auto stage_query_tile = [&](int qt, int buf) {
    const int q1 = qt * BQ;
    stage_rows<BQ, D, MMA_THREADS>(qs + buf * BQ * P, qb + q1 * stride, stride, sq - q1,
                                   tid);
    stage_rows<BQ, D, MMA_THREADS>(gs + buf * BQ * P, gb + q1 * stride, stride, sq - q1,
                                   tid);
    const int i = tid % BQ, pos = q1 + i;
    const float* src = tid < BQ ? lb : db;
    cp_async4((tid < BQ ? ls : dl) + buf * BQ + i, src + (pos < sq ? pos : 0), pos < sq);
  };
  static_assert(MMA_THREADS == 2 * BQ, "one thread per LSE and per delta value");

  const int row0 = k0 + warp * 16 + g;  // this lane's key rows: row0, row0 + 8
  uint32_t kf[KD][4], vf[KD][4];
  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  if (first < nqb) {
    stage_rows<BK, D, MMA_THREADS>(ks, k + koff, stride, sk - k0, tid);
    stage_rows<BK, D, MMA_THREADS>(vs, v + koff, stride, sk - k0, tid);
    stage_query_tile(first, 0);
    cp_async_commit();
  }

  for (int qt = first; qt < nqb; ++qt) {
    const int it = qt - first, buf = it & 1;
    if (qt + 1 < nqb) {
      stage_query_tile(qt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (HOLD && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        frag_a<D>(kf[kk], ks, warp * 16, kk * 16, lane);
        frag_a<D>(vf[kk], vs, warp * 16, kk * 16, lane);
      }
    }
    const bf16* qtile = qs + buf * BQ * P;
    const bf16* gtile = gs + buf * BQ * P;
    const float* lt = ls + buf * BQ;
    const float* dt = dl + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 64 queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], c[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = kf[kk][e], c[e] = vf[kk][e];
      } else {
        frag_a<D>(a, ks, warp * 16, kk * 16, lane);
        frag_a<D>(c, vs, warp * 16, kk * 16, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        frag_b_rows<D>(r, qtile, np * 16, kk * 16, lane);
        mma_16816(s[2 * np], a, r[0], r[1]);
        mma_16816(s[2 * np + 1], a, r[2], r[3]);
        frag_b_rows<D>(r, gtile, np * 16, kk * 16, lane);
        mma_16816(dp[2 * np], c, r[0], r[1]);
        mma_16816(dp[2 * np + 1], c, r[2], r[3]);
      }
    }

    // p^T and dS^T in f32 with each column's (query's) LSE and delta; per
    // k16 step j2 (queries 16 j2 .. +15), p^T and dS^T each in three bf16
    // pieces as A fragments, then dV += P^T dO and dK += dS^T Q
    const int q0 = qt * BQ;
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      uint32_t pf[3][4], dsf[3][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = 2 * j2 + half;
          const int kr = row0 + 8 * r;
          float p[2], ds[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = j * 8 + 2 * t + c, qj = q0 + col;
            const bool valid = kr < sk && qj < sq && (!causal || kr <= qj);
            const float expo = valid ? s[j][2 * r + c] * scale - lt[col] : 0.f;
            p[c] = valid ? expf(expo) : 0.f;
            ds[c] = p[c] * (dp[j][2 * r + c] - dt[col]) * scale;
          }
          uint32_t pp[3], dd[3];
          split_bf16<3>(pp, p[0], p[1]);
          split_bf16<3>(dd, ds[0], ds[1]);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            pf[i][2 * half + r] = pp[i];
            dsf[i][2 * half + r] = dd[i];
          }
        }
#pragma unroll
      for (int nd = 0; nd < OT / 2; ++nd) {
        uint32_t r[4];
        frag_b_cols<D>(r, gtile, j2 * 16, nd * 16, lane);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_16816(acc_v[2 * nd], pf[i], r[0], r[1]);
          mma_16816(acc_v[2 * nd + 1], pf[i], r[2], r[3]);
        }
        frag_b_cols<D>(r, qtile, j2 * 16, nd * 16, lane);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma_16816(acc_k[2 * nd], dsf[i], r[0], r[1]);
          mma_16816(acc_k[2 * nd + 1], dsf[i], r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = row0 + 8 * r;
    if (kr >= sk) continue;
    bf16* ok = dk + ((long)b * sk + kr) * stride + (long)h * D;
    bf16* ov = dv + ((long)b * sk + kr) * stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ok + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc_k[j][2 * r], acc_k[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ov + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc_v[j][2 * r], acc_v[j][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* delta,
                          void* dq, int batch, int n_heads, int sq, int sk,
                          float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dq_mma_smem_bytes<D>();
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + BQ - 1) / BQ);
  flash_bwd_dq_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), n_heads, sq, sk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* delta,
                           void* dk, void* dv, int batch, int n_heads, int sq,
                           int sk, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = dkv_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sk + BK - 1) / BK);
  flash_bwd_dkv_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_heads, sq, sk, scale,
      causal);
  return cudaGetLastError();
}

bool bad_shape(int batch, int n_heads, int sq, int sk) {
  return batch <= 0 || n_heads <= 0 || sq <= 0 || sk <= 0
         || (sq + BQ - 1) / BQ > 65535 || (sk + BK - 1) / BK > 65535;
}

}  // namespace

// The "mma" variants: bf16 q, k, v, dO and outputs, head_dim 64 or 128; the
// other arguments as the "fma" entries'. Each returns a cudaError_t (0 on
// success).
extern "C" int bt_flash_bwd_dq_mma(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, int batch,
                                   int n_heads, int sq, int sk, int head_dim,
                                   float scale, int causal, void* stream) {
  if (bad_shape(batch, n_heads, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dq_mma<64>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, scale, causal, s);
  if (head_dim == 128)
    return launch_dq_mma<128>(q, k, v, dout, lse, delta, dq, batch, n_heads, sq, sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

extern "C" int bt_flash_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    int batch, int n_heads, int sq, int sk,
                                    int head_dim, float scale, int causal,
                                    void* stream) {
  if (bad_shape(batch, n_heads, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dkv_mma<64>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, scale, causal, s);
  if (head_dim == 128)
    return launch_dkv_mma<128>(q, k, v, dout, lse, delta, dk, dv, batch, n_heads, sq, sk, scale, causal, s);
  return cudaErrorInvalidValue;
}

// The "fma" variants. dtype: 0 = float32 (bfloat16, 1, takes the mma
// entries). Each returns a cudaError_t (0 on success).
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
  return cudaErrorInvalidValue;
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
