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
// one block per (batch*head, 64-row query tile) of 4 warps of 16 query
// rows, FA2-style: the query tiles taken last first (under a causal mask
// the longest blocks start first and the short ones fill the tail), the
// key/value loop inside the block in place of the TPU's sequential grid
// axis, K and V tiles of 64 keys through a cp.async double buffer (rows
// past Sk zero-filled by the copy), key tiles above the diagonal skipped,
// the mask and the online softmax in the accumulator registers, a row's
// f32 max and sum shuffled over the 4 lanes that hold it.
// One C entry, bt_flash_fwd, launches either: the dtype picks it, as
// ops/flash_attention.py:kernel_variant says.
//
// "mma" (flash_fwd_mma_kernel): bf16, D 64 or 128, on the tensor cores in
// bf16. The Q tile is copied once with cp.async and held in registers as
// ldmatrix fragments; K and V rows are padded by 16 bytes so ldmatrix is free of bank conflicts. S = Q K^T by
// mma.sync m16n8k16 bf16 -> f32, scaled in f32. p stays f32 for the row
// sum; for P V it is split into bf16 hi + lo, both multiplied by V
// (ldmatrix.trans) into the f32 output accumulator, so the products are
// those of f32 p to about 2^-17 and only the order of the sums differs
// from the plain version (one bf16 p would miss the bf16 check by up to
// 2e-3 at S=384). Bound: the tensor cores' issue rate through mma.sync and
// the softmax between the products.
//
// "tf32x3" (flash_fwd_tf32x3_kernel): f32, D 64 or 128, on the tensor
// cores at f32 accuracy: both products as 3xTF32 mma.sync m16n8k8 (mma_tf32.cuh: hi * hi + hi * lo + lo * hi of
// operands split with cvt.rna.tf32.f32, f32 accumulators). One tf32 pass
// would keep 2^-11 of each operand and miss FLASH_ATOL (5e-5) on O and
// LSE; the split keeps about 2^-22. Q is scaled in f32 (as the plain
// version does) and split once into shared hi and lo tiles, re-read for
// each key tile (held in registers it would take 128 of them at D = 128);
// K, V and P are split in registers where they are read. With 32-bit
// elements ldmatrix's transposes do not apply, so every fragment is read
// with plain shared loads from padded rows (see the kernel). Bound: the
// 3xTF32 products (a third of the 495 TFLOP/s TF32 peak, 165) against the
// CUDA cores' 67 TFLOP/s f32 FMA peak that the first port's f32 design,
// this variant's predecessor, was held to; in practice the splits, the
// scalar loads of V and the softmax share the issue slots with the
// mma.sync. K2 and K3 read its LSE as they read the mma variant's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr float NEG = -FLT_MAX;

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

// --------------------------------------------------------- tf32x3 variant
// f32 tiles, row pitches in floats: Q and K D + 8 (8-byte fragment loads
// meet no bank twice in a half warp), V D + 4 (its scalar loads of rows
// 2t, 2t + 1 and columns g meet no bank twice in a warp).
template <int D> __host__ __device__ constexpr int qk_pitch() { return D + 8; }
template <int D> __host__ __device__ constexpr int v_pitch() { return D + 4; }

template <int D>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return (2 * BQ * qk_pitch<D>() + 2 * BK * qk_pitch<D>() + 2 * BK * v_pitch<D>()) * 4;
}

// ROWS rows of D floats (positions `stride` elements apart in global
// memory) into a shared tile of row pitch P floats; rows at or past `rows`
// are zero-filled and read nothing. Commit the group after it.
template <int ROWS, int D, int P>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, long stride,
                                               int rows, int tid) {
  constexpr int PIECES = D / 4;  // 16-byte pieces per row
#pragma unroll
  for (int i = tid; i < ROWS * PIECES; i += MMA_THREADS) {
    const int r = i / PIECES, c = (i % PIECES) * 4;
    const bool in = r < rows;
    mma_bf16::cp_async16(dst + r * P + c, in ? src + r * stride + c : src, in);
  }
}

// FA2 as the mma variant (4 warps of 16 query rows, query tiles last first,
// K and V tiles of 64 keys double-buffered, key tiles above the diagonal
// skipped, the mask and the online softmax in the accumulator registers)
// with both products as 3xTF32 m16n8k8 (mma_tf32.cuh). The depth index of
// each k8 product is permuted so that a lane's two k values sit side by
// side: in S = Q K^T, k indices t and t + 4 of dims step kk are dims
// 8kk + 2t and 8kk + 2t + 1 (one 8-byte load from Q's and from K's row);
// in P V, they are keys 2t and 2t + 1 of the step's 8, which is where the
// S accumulator already holds them, so P's A fragments are the softmax's
// own registers. Q is scaled (in f32, as the plain version does) and split
// into tf32 hi and lo tiles once; K, V and P are split where they are read.
// S of a key tile is summed on the tensor cores from zero over D; P V of a
// tile too, for each 8 columns of O, before it is added, rescaled, to the
// f32 output accumulator.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int n_heads, int sq, int sk,
                        float scale, int causal) {
  using namespace mma_bf16;
  using namespace mma_tf32;
  constexpr int PQ = qk_pitch<D>(), PV = v_pitch<D>();
  constexpr int KD = D / 8;    // k8 steps of Q K^T
  constexpr int NT = BK / 8;   // 8-key tiles of S (and k8 steps of P V)
  constexpr int OT = D / 8;    // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qh = reinterpret_cast<float*>(smem_raw);  // BQ x PQ, tf32 hi of scale * q
  float* ql = qh + BQ * PQ;                        // BQ x PQ, its lo
  float* ks = ql + BQ * PQ;                        // 2 x BK x PQ
  float* vs = ks + 2 * BK * PQ;                    // 2 x BK x PV

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last tiles first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long stride = (long)n_heads * D;  // elements between sequence positions
  const float* kb = k + (long)b * sk * stride + (long)h * D;
  const float* vb = v + (long)b * sk * stride + (long)h * D;

  int nkb = (sk + BK - 1) / BK;
  if (causal) {
    // key tiles strictly above the diagonal hold nothing this tile can see
    const int last_q = min(q0 + BQ - 1, sq - 1);
    nkb = min(nkb, last_q / BK + 1);
  }

  stage_rows_f32<BQ, D, PQ>(qh, q + ((long)b * sq + q0) * stride + (long)h * D, stride,
                            sq - q0, tid);
  cp_async_commit();
  stage_rows_f32<BK, D, PQ>(ks, kb, stride, sk, tid);
  stage_rows_f32<BK, D, PV>(vs, vb, stride, sk, tid);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed (this thread's copies) ...
  __syncthreads();     // ... and every thread's
  for (int i = tid; i < BQ * D; i += MMA_THREADS) {
    const int at = (i / D) * PQ + i % D;
    uint32_t hi, lo;
    split(qh[at] * scale, hi, lo);
    qh[at] = __uint_as_float(hi);
    ql[at] = __uint_as_float(lo);
  }  // read after the loop's first __syncthreads

  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const float* qhw = qh + (warp * 16 + g) * PQ + 2 * t;
  const float* qlw = ql + (warp * 16 + g) * PQ + 2 * t;
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
      stage_rows_f32<BK, D, PQ>(ks + (buf ^ 1) * BK * PQ, kb + k1 * stride, stride,
                                sk - k1, tid);
      stage_rows_f32<BK, D, PV>(vs + (buf ^ 1) * BK * PV, vb + k1 * stride, stride,
                                sk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * BK * PQ + g * PQ + 2 * t;
    const float* vt = vs + buf * BK * PV + 2 * t * PV + g;

    // S = (scale Q) K^T for the warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
      const float2 h0 = *reinterpret_cast<const float2*>(qhw + kk * 8);
      const float2 h1 = *reinterpret_cast<const float2*>(qhw + 8 * PQ + kk * 8);
      const float2 l0 = *reinterpret_cast<const float2*>(qlw + kk * 8);
      const float2 l1 = *reinterpret_cast<const float2*>(qlw + 8 * PQ + kk * 8);
      ah[0] = __float_as_uint(h0.x);
      ah[1] = __float_as_uint(h1.x);
      ah[2] = __float_as_uint(h0.y);
      ah[3] = __float_as_uint(h1.y);
      al[0] = __float_as_uint(l0.x);
      al[1] = __float_as_uint(l1.x);
      al[2] = __float_as_uint(l0.y);
      al[3] = __float_as_uint(l1.y);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(kt + nt * 8 * PQ + kk * 8);
        uint32_t bh0, bl0, bh1, bl1;
        split(kv.x, bh0, bl0);
        split(kv.y, bh1, bl1);
        mma3(s[nt], ah, al, bh0, bh1, bl0, bl1);
      }
    }

    // mask and the online softmax; e / 2 picks the row
    const int k0 = it * BK;
    float bmax[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        const int qi = row0 + 8 * (e / 2);
        const bool valid = kj < sk && (!causal || kj <= qi);
        s[j][e] = valid ? s[j][e] : NEG;
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
    // p in f32 for the row sums; its tf32 pieces are P's A fragments: for
    // k8 step j (keys 8j ..), a0 / a2 = row g's keys 2t / 2t + 1 = s[j][0] /
    // s[j][1], a1 / a3 the same of row g + 8
    float psum[2] = {0.f, 0.f};
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = dead[r] ? 0.f : expf(s[j][2 * r] - m_new[r]);
        const float p1 = dead[r] ? 0.f : expf(s[j][2 * r + 1] - m_new[r]);
        psum[r] += p0 + p1;
        split(p0, ph[j][r], pl[j][r]);
        split(p1, ph[j][2 + r], pl[j][2 + r]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];

    // O = corr O + P V, each 8 columns' P V summed over the tile first
#pragma unroll
    for (int dt = 0; dt < OT; ++dt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(vt[j * 8 * PV + dt * 8], bh0, bl0);
        split(vt[j * 8 * PV + PV + dt * 8], bh1, bl1);
        mma3(part, ph[j], pl[j], bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = acc[dt][e] * corr[e / 2] + part[e];
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
    float* ob = o + ((long)b * sq + qi) * stride + (long)h * D;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<float2*>(ob + j * 8 + 2 * t) =
          make_float2(acc[j][2 * r] / l_safe, acc[j][2 * r + 1] / l_safe);
    if (t == 0) {
      const bool dead_row = m[r] <= NEG * 0.5f;
      lse[((long)b * n_heads + h) * sq + qi] = dead_row ? NEG : m[r] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                          void* lse, int batch, int n_heads, int sq, int sk,
                          float scale, int causal, cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes<D>();
  // set on every launch: the attribute is per device, and the call is cheap
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_heads, (sq + BQ - 1) / BQ);
  flash_fwd_tf32x3_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      n_heads, sq, sk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o (B, Sq|Sk, N, D) and lse (B, N, Sq) as the header lays them
// out, on `stream`; batch = B, n_heads = N, sq and sk the query and key
// lengths, head_dim = D (64 or 128), scale the logits' factor, causal 0 or
// 1. is_bf16 picks the variant: bf16 q, k, v and o take "mma", f32 ones
// "tf32x3". Returns a cudaError_t (0 on success).
extern "C" int bt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int batch, int n_heads,
                            int sq, int sk, int head_dim, float scale,
                            int causal, int is_bf16, void* stream) {
  if (batch <= 0 || n_heads <= 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  if ((sq + BQ - 1) / BQ > 65535) return cudaErrorInvalidValue;
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return head_dim == 64
        ? launch_mma<64>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s)
        : launch_mma<128>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
  return head_dim == 64
      ? launch_tf32x3<64>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s)
      : launch_tf32x3<128>(q, k, v, o, lse, batch, n_heads, sq, sk, scale, causal, s);
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
