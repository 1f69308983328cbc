// HBM streaming probes for NVIDIA Hopper (sm_90a), kernel K7 of the port.
//
// Replaces the Pallas TPU kernels of scripts/roofline_pallas.py, which
// measure the best streaming rate a hand-written kernel gets from device
// memory:
//   bench_auto    (K7a)  copy  out = x
//                        read  acc = seed + sum(f32(x))
//                        triad out = a + b * 2
//   bench_manual  (K7b)  copy staged through fast on-chip memory in `nbuf`
//                        slots, each refilled only after its drain is done
//   bench_hbm_dma (K7c)  copy from device memory to device memory with no
//                        staging, over `nstreams` disjoint ranges at once
// All data is bf16; read's seed and sum are f32.
//
// What bounds them on the H100: bytes, by construction. Each moves every
// input byte once and writes every output byte once and does at most two
// flops per element (copy 2 x 2 bytes, read 2 bytes, triad 3 x 2 bytes per
// element against 295 bf16 flops per byte at the data sheet's rates). So
// the design only has to keep enough bytes in flight: every load and store
// of K7a and K7c is a 16-byte vector, neighbouring threads on neighbouring
// addresses, and each thread keeps V such vectors in flight before it uses
// any (V = 1, 2 or 4). The kernels walk the data in a grid-stride loop, on
// one of two grids that the wrapper picks: persistent, as many blocks as
// the SMs hold at once (from the occupancy calculator), each looping over
// the data; or full, one tile of threads x V vectors a block, each thread
// touching its vectors once. The probe sweeps threads per block, V and the
// grid, this card's knobs in place of the TPU's block sizes.
//
// K7a read: blocks run in no order on the card, where the TPU carries one
// sum across its sequential grid. Each thread sums its vectors in f32 (a
// thread covers n / (blocks x threads) elements: thousands at 1 GiB on the
// persistent grid, 8 V on the full one, so a run of ones stays far below
// 2^24, where an f32 sum of ones stops growing), each block adds its
// threads in a fixed order (warp butterfly,
// then warps in turn) into an f32 partial, and a second kernel adds the
// partials in a fixed order and the seed last. No atomics: the same bits on
// every run. triad widens a and b to f32 and rounds a + b * 2 once to bf16.
//
// K7b: the counterpart of make_async_copy and DMA semaphores is the Hopper
// bulk asynchronous copy. One thread of each block issues cp.async.bulk
// from device to shared memory, completing on the slot's mbarrier with the
// byte count; when the slot has landed it issues cp.async.bulk from shared
// to device memory in a bulk group, and refills the slot only after
// cp.async.bulk.wait_group.read says that drain has read it (the
// reference's order). Each block owns one contiguous range, cut into
// `chunk`-byte pieces with a smaller last piece; the slots live in dynamic
// shared memory (up to 227 KB, allowed by cudaFuncSetAttribute). The bulk
// copy needs 16-byte addresses and sizes: the range covers the largest
// multiple of 16 bytes, and the last (at most 14) bytes are copied by one
// thread with plain loads.
//
// K7c is K7a's register copy launched once per range, each launch on its
// own stream with its share of the persistent grid (the wrapper in ops/hbm_roof.py
// joins the streams), as the TPU runs its DMA engines side by side.
//
// Every entry returns a cudaError_t (0 on success); the *_blocks entries
// return the persistent grid, or minus the error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int FINISH_THREADS = 1024;
constexpr int STAGED_THREADS = 32;  // one warp; its first thread issues every copy
constexpr int MAX_NBUF = 8;

enum Kind { COPY = 0, READ = 1, TRIAD = 2 };

// The sum of one 16-byte vector of 8 bf16 values, widened exactly, in f32.
__device__ __forceinline__ float vec_sum(const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += __uint_as_float(w[i] << 16) + __uint_as_float(w[i] & 0xffff0000u);
  return s;
}

// a + b * 2 for two packed bf16 pairs: f32 arithmetic, one rounding.
__device__ __forceinline__ uint32_t triad2(uint32_t a, uint32_t b) {
  const float lo = __uint_as_float(a << 16) + __uint_as_float(b << 16) * 2.f;
  const float hi = __uint_as_float(a & 0xffff0000u) + __uint_as_float(b & 0xffff0000u) * 2.f;
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 triad_vec(const uint4& a, const uint4& b) {
  return make_uint4(triad2(a.x, b.x), triad2(a.y, b.y), triad2(a.z, b.z), triad2(a.w, b.w));
}

// The block's sum of v, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[MAX_THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)blockDim.x / 32; ++w) s += warp_sums[w];
  return s;
}

// K7a copy (and K7c): out = x over nvec 16-byte vectors, then `tail` bf16
// values past them.
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long nvec, int tail) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long i0 = (long long)blockIdx.x * blockDim.x * V + threadIdx.x; i0 < nvec; i0 += stride) {
    uint4 r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = i0 + (long long)j * blockDim.x;
      if (i < nvec) r[j] = __ldcs(x + i);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = i0 + (long long)j * blockDim.x;
      if (i < nvec) __stcs(out + i, r[j]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const uint16_t* xe = reinterpret_cast<const uint16_t*>(x + nvec);
    reinterpret_cast<uint16_t*>(out + nvec)[threadIdx.x] = xe[threadIdx.x];
  }
}

// K7a read, first pass: one f32 partial sum per block.
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
read_kernel(const uint4* __restrict__ x, long long nvec, int tail, float* __restrict__ partials) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  float acc = 0.f;
  for (long long i0 = (long long)blockIdx.x * blockDim.x * V + threadIdx.x; i0 < nvec; i0 += stride) {
    uint4 r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = i0 + (long long)j * blockDim.x;
      r[j] = i < nvec ? __ldcs(x + i) : make_uint4(0u, 0u, 0u, 0u);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) s += vec_sum(r[j]);
    acc += s;
  }
  if (blockIdx.x == 0 && threadIdx.x < tail)
    acc += __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x + nvec)[threadIdx.x]);
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// K7a read, second pass: out = seed + the partials' sum, in a fixed order.
__global__ void __launch_bounds__(FINISH_THREADS)
read_finish_kernel(const float* __restrict__ seed, const float* __restrict__ partials, int nparts,
                   float* __restrict__ out) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < nparts; i += FINISH_THREADS) acc += partials[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[0] = seed[0] + s;
}

// K7a triad: out = a + b * 2.
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
triad_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out,
             long long nvec, int tail) {
  const long long stride = (long long)gridDim.x * blockDim.x * V;
  for (long long i0 = (long long)blockIdx.x * blockDim.x * V + threadIdx.x; i0 < nvec; i0 += stride) {
    uint4 ra[V], rb[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = i0 + (long long)j * blockDim.x;
      if (i < nvec) {
        ra[j] = __ldcs(a + i);
        rb[j] = __ldcs(b + i);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = i0 + (long long)j * blockDim.x;
      if (i < nvec) __stcs(out + i, triad_vec(ra[j], rb[j]));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const __nv_bfloat16* ae = reinterpret_cast<const __nv_bfloat16*>(a + nvec);
    const __nv_bfloat16* be = reinterpret_cast<const __nv_bfloat16*>(b + nvec);
    reinterpret_cast<__nv_bfloat16*>(out + nvec)[threadIdx.x] = __float2bfloat16_rn(
        __bfloat162float(ae[threadIdx.x]) + __bfloat162float(be[threadIdx.x]) * 2.f);
  }
}

// ------------------------------------------------------------------ K7b

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A fill that has not landed after this many clock cycles (about 10 s)
// aborts the kernel with an error instead of hanging the card.
constexpr long long WAIT_LIMIT_CYCLES = 20000000000LL;

// Wait until the phase of parity `parity` of the mbarrier at `bar` is done.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  } while (!done);
}

// Copy `bytes` from device memory at src to the shared-memory slot at
// `slot`, completing on the mbarrier at `bar` with the byte count.
__device__ __forceinline__ void bulk_load(uint32_t slot, const unsigned char* src, int bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(slot), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(unsigned char* dst, uint32_t slot, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(slot), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(STAGED_THREADS)
staged_copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                   long long nbytes16, int tail_bytes, long long per_block, int chunk, int nbuf) {
  extern __shared__ __align__(128) unsigned char slots[];
  __shared__ __align__(8) uint64_t full[MAX_NBUF];
  if (threadIdx.x != 0) return;
  if (blockIdx.x == 0)
    for (int i = 0; i < tail_bytes; ++i) out[nbytes16 + i] = x[nbytes16 + i];
  const long long begin = (long long)blockIdx.x * per_block;
  const long long end = begin + per_block < nbytes16 ? begin + per_block : nbytes16;
  if (begin >= end) return;
  const long long range = end - begin;
  const long long nchunks = (range + chunk - 1) / chunk;
  for (int s = 0; s < nbuf; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t base = smem_addr(slots);
  auto bytes_of = [&](long long idx) {
    const long long left = range - idx * chunk;
    return (int)(left < chunk ? left : chunk);
  };
  const long long first = nchunks < nbuf ? nchunks : nbuf;
  for (long long s = 0; s < first; ++s)
    bulk_load(base + (uint32_t)(s * chunk), x + begin + s * chunk, bytes_of(s),
              smem_addr(&full[s]));
  for (long long idx = 0; idx < nchunks; ++idx) {
    const int s = (int)(idx % nbuf);
    const uint32_t slot = base + (uint32_t)s * chunk;
    // the slot's (idx / nbuf)-th fill: mbarrier phases alternate 0, 1, 0, ...
    mbar_wait(smem_addr(&full[s]), (uint32_t)((idx / nbuf) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + begin + idx * chunk, slot, bytes_of(idx));
    if (idx + nbuf < nchunks) {
      // refill only after this drain has read the slot
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bulk_load(slot, x + begin + (idx + nbuf) * chunk, bytes_of(idx + nbuf), smem_addr(&full[s]));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <typename K>
int persistent_blocks(K kernel, int threads, size_t smem) {
  int sms = 0, per_sm = 0;
  int err = sm_count(&sms);
  if (err != cudaSuccess) return -err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -err;
  if (per_sm < 1) return -cudaErrorInvalidConfiguration;
  return sms * per_sm;
}

bool valid_shape(int threads, int vecs) {
  return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0 &&
         (vecs == 1 || vecs == 2 || vecs == 4);
}

template <int V>
int blocks_of(int kind, int threads) {
  switch (kind) {
    case COPY: return persistent_blocks(copy_kernel<V>, threads, 0);
    case READ: return persistent_blocks(read_kernel<V>, threads, 0);
    case TRIAD: return persistent_blocks(triad_kernel<V>, threads, 0);
  }
  return -cudaErrorInvalidValue;
}

template <int V>
void launch_copy(const void* x, void* out, long long n, int threads, int blocks, cudaStream_t s) {
  copy_kernel<V><<<blocks, threads, 0, s>>>(static_cast<const uint4*>(x), static_cast<uint4*>(out),
                                            n / 8, (int)(n % 8));
}

template <int V>
void launch_read(const void* x, void* partials, long long n, int threads, int blocks,
                 cudaStream_t s) {
  read_kernel<V><<<blocks, threads, 0, s>>>(static_cast<const uint4*>(x), n / 8, (int)(n % 8),
                                            static_cast<float*>(partials));
}

template <int V>
void launch_triad(const void* a, const void* b, void* out, long long n, int threads, int blocks,
                  cudaStream_t s) {
  triad_kernel<V><<<blocks, threads, 0, s>>>(static_cast<const uint4*>(a),
                                             static_cast<const uint4*>(b),
                                             static_cast<uint4*>(out), n / 8, (int)(n % 8));
}

bool valid_staged(int chunk, int nbuf) {
  return chunk >= 16 && chunk % 16 == 0 && nbuf >= 1 && nbuf <= MAX_NBUF;
}

int allow_staged_smem(int chunk, int nbuf) {
  const long long smem = (long long)chunk * nbuf;
  if (smem > 0x7fffffff) return cudaErrorInvalidValue;
  // above 48 KB only after this, or the launch is refused
  return cudaFuncSetAttribute(staged_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// The persistent grid of a K7a kernel (kind 0 copy, 1 read, 2 triad) at
// `threads` threads a block and `vecs` 16-byte vectors a thread: SMs times
// the blocks an SM holds at once. Negative: minus a cudaError_t.
extern "C" int bt_hbm_blocks(int kind, int threads, int vecs) {
  if (!valid_shape(threads, vecs)) return -cudaErrorInvalidValue;
  switch (vecs) {
    case 1: return blocks_of<1>(kind, threads);
    case 2: return blocks_of<2>(kind, threads);
    default: return blocks_of<4>(kind, threads);
  }
}

// out = x for n bf16 values; x and out 16-byte aligned.
extern "C" int bt_hbm_copy(const void* x, void* out, long long n, int threads, int vecs,
                           int blocks, void* stream) {
  if (n <= 0 || blocks <= 0 || !valid_shape(threads, vecs)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vecs) {
    case 1: launch_copy<1>(x, out, n, threads, blocks, s); break;
    case 2: launch_copy<2>(x, out, n, threads, blocks, s); break;
    default: launch_copy<4>(x, out, n, threads, blocks, s); break;
  }
  return cudaGetLastError();
}

// out[0] = seed[0] + sum(f32(x)) for n bf16 values; partials: f32 scratch
// of `blocks` values.
extern "C" int bt_hbm_read(const void* seed, const void* x, void* partials, void* out,
                           long long n, int threads, int vecs, int blocks, void* stream) {
  if (n <= 0 || blocks <= 0 || !valid_shape(threads, vecs)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vecs) {
    case 1: launch_read<1>(x, partials, n, threads, blocks, s); break;
    case 2: launch_read<2>(x, partials, n, threads, blocks, s); break;
    default: launch_read<4>(x, partials, n, threads, blocks, s); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  read_finish_kernel<<<1, FINISH_THREADS, 0, s>>>(static_cast<const float*>(seed),
                                                  static_cast<const float*>(partials), blocks,
                                                  static_cast<float*>(out));
  return cudaGetLastError();
}

// out = a + b * 2 for n bf16 values (f32 arithmetic, one rounding).
extern "C" int bt_hbm_triad(const void* a, const void* b, void* out, long long n, int threads,
                            int vecs, int blocks, void* stream) {
  if (n <= 0 || blocks <= 0 || !valid_shape(threads, vecs)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vecs) {
    case 1: launch_triad<1>(a, b, out, n, threads, blocks, s); break;
    case 2: launch_triad<2>(a, b, out, n, threads, blocks, s); break;
    default: launch_triad<4>(a, b, out, n, threads, blocks, s); break;
  }
  return cudaGetLastError();
}

// The persistent grid of K7b at `nbuf` slots of `chunk` bytes.
extern "C" int bt_hbm_staged_blocks(int chunk, int nbuf) {
  if (!valid_staged(chunk, nbuf)) return -cudaErrorInvalidValue;
  const int err = allow_staged_smem(chunk, nbuf);
  if (err != cudaSuccess) return -err;
  return persistent_blocks(staged_copy_kernel, STAGED_THREADS, (size_t)chunk * nbuf);
}

// out = x for nbytes bytes through `nbuf` shared-memory slots of `chunk`
// bytes a block; `blocks` blocks, each owning one contiguous range.
extern "C" int bt_hbm_staged_copy(const void* x, void* out, long long nbytes, int chunk, int nbuf,
                                  int blocks, void* stream) {
  if (nbytes <= 0 || blocks <= 0 || !valid_staged(chunk, nbuf)) return cudaErrorInvalidValue;
  int err = allow_staged_smem(chunk, nbuf);
  if (err != cudaSuccess) return err;
  const long long nbytes16 = nbytes / 16 * 16;
  const long long per_block = ((nbytes16 + blocks - 1) / blocks + 15) / 16 * 16;
  staged_copy_kernel<<<blocks, STAGED_THREADS, (size_t)chunk * nbuf,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), nbytes16,
      (int)(nbytes - nbytes16), per_block, chunk, nbuf);
  return cudaGetLastError();
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
