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
// to device memory in a bulk group, and refills a slot only after
// cp.async.bulk.wait_group.read says the store that drains it has read it
// (the reference's order). The first port streamed ~7% slower than
// Tensor.copy_ on an H100, held back by:
//   (1) its persistent grid's fixed split: each block owned 1/G of the
//       bytes, but blocks stream at unequal rates (stamped on an H100 at
//       1 GiB, of blocks given equal shares the first ended before half
//       the kernel's time), so the copy waited out the slowest while the
//       memory idled;
//   (2) one contiguous range a block: hundreds of address streams ~1 MB
//       apart;
//   (3) each refill waited for the store just issued from its own slot.
// Now a block's n-th fill goes to slot n mod nbuf and holds the chunk that
// `take(n)` returns:
//   - deal DYNAMIC: the next value of a counter that all blocks share
//     (zeroed on the stream by the C entry), so a faster block takes more
//     chunks, every block ends within a few us of the others, and the
//     chunks in flight sit on neighbouring addresses. The atomic is issued
//     before the slot's wait, which hides its round trip.
//   - deals ROUND_ROBIN (chunk c to block c mod G) and CONTIGUOUS (a run
//     of whole chunks a block) keep the fixed split, for the probe to show
//     what it costs.
//   - the refill lags the store by `lag` fills: after committing the store
//     of fill j, wait_group.read `lag` (every store but the newest `lag` has
//     read its slot) and refill the slot of fill j - lag, so `lag` stores
//     and nbuf - lag loads stay in flight; lag 0 is the reference's order
//     (0 <= lag < nbuf). On an H100 a lag gains ~1.5% at 3 slots and
//     little at 4.
//   - the slots' bytes set the blocks an SM (occupancy calculator); on an
//     H100 one block of 128-192 KB of slots an SM reads best, against
//     Little's law's ~26 KB of loads an SM (3.35 TB/s x ~1 us over 132 SMs).
// An L2 evict-first policy on both bulk copies read slower on an H100 at
// every point tried, so the copies carry none. The chunks are `chunk`-byte pieces of
// the largest multiple of 16 bytes (the bulk copy needs 16-byte addresses
// and sizes), the last one shorter; the last (at most 14) bytes are copied
// by one thread with plain loads. Fill j is its slot's (j / nbuf)-th, so
// the wait for it is on mbarrier phase parity (j / nbuf) & 1.
//
// K7c: the first port launched K7a's register copy once per range, each on
// its own stream behind an event, with a 1/nstreams share of the
// persistent grid: the same fixed split. Now one launch gives every range
// a full grid (one tile of threads x V vectors a block, which the hardware
// hands to whichever SM frees first): block b copies tile b / nstreams of
// range b mod nstreams, so the ranges run side by side by construction
// with no stream or event (`ranged_copy_kernel`). One launch per range on
// its own stream, also on full grids, read no faster.
//
// Both can stamp %globaltimer into a buffer that only a check passes: K7b
// at the start and end of every block, K7c at the start of each range's
// first block and the end of its last.
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

// Copy `bytes` from the slot at `slot` to device memory at dst, as one bulk
// group.
__device__ __forceinline__ void bulk_store(unsigned char* dst, uint32_t slot, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(slot), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every bulk store group but the newest `lag` has read its
// shared memory (wait_group.read takes its count as an immediate).
__device__ __forceinline__ void bulk_wait_read(int lag) {
  switch (lag) {
#define BT_WAIT_READ(n) \
  case n: asm volatile("cp.async.bulk.wait_group.read " #n ";\n" ::: "memory"); break;
    BT_WAIT_READ(1) BT_WAIT_READ(2) BT_WAIT_READ(3) BT_WAIT_READ(4)
    BT_WAIT_READ(5) BT_WAIT_READ(6) BT_WAIT_READ(7)  // lag < nbuf <= MAX_NBUF
#undef BT_WAIT_READ
    default: asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

enum Deal { CONTIGUOUS = 0, ROUND_ROBIN = 1, DYNAMIC = 2 };

__global__ void __launch_bounds__(STAGED_THREADS)
staged_copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                   long long nbytes16, int tail_bytes, int chunk, int nbuf, int lag, int deal,
                   unsigned long long* __restrict__ counter,
                   unsigned long long* __restrict__ stamps) {
  extern __shared__ __align__(128) unsigned char slots[];
  __shared__ __align__(8) uint64_t full[MAX_NBUF];
  if (threadIdx.x != 0) return;
  if (stamps) stamps[2 * blockIdx.x] = globaltimer();
  if (blockIdx.x == 0)
    for (int i = 0; i < tail_bytes; ++i) out[nbytes16 + i] = x[nbytes16 + i];
  const long long nchunks = (nbytes16 + chunk - 1) / chunk;
  // the static deals: this block's n-th chunk is first + n * step, n < count
  const long long blocks = gridDim.x, b = blockIdx.x;
  const long long per = (nchunks + blocks - 1) / blocks;
  const long long first = deal == CONTIGUOUS ? b * per : b;
  const long long step = deal == CONTIGUOUS ? 1 : blocks;
  const long long count = deal == CONTIGUOUS ? nchunks - first < per ? nchunks - first : per
                                             : b < nchunks ? (nchunks - 1 - b) / blocks + 1 : 0;
  // the chunk of this block's n-th fill, nchunks when there is none
  auto take = [&](long long n) -> long long {
    if (deal == DYNAMIC) return (long long)atomicAdd(counter, 1ull);
    return n < count ? first + n * step : nchunks;
  };
  for (int s = 0; s < nbuf; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t base = smem_addr(slots);
  long long held[MAX_NBUF];  // the chunk in each slot
  auto bytes_of = [&](long long c) {
    const long long left = nbytes16 - c * chunk;
    return (int)(left < chunk ? left : chunk);
  };
  auto load = [&](int s, long long c) {
    held[s] = c;
    bulk_load(base + (uint32_t)s * chunk, x + c * chunk, bytes_of(c), smem_addr(&full[s]));
  };
  long long n = 0;  // fills issued; fill n goes to slot n mod nbuf
  for (; n < nbuf; ++n) {
    const long long c = take(n);
    if (c >= nchunks) break;
    load((int)n, c);
  }
  bool more = n == nbuf;
  for (long long j = 0; j < n; ++j) {
    const int s = (int)(j % nbuf);
    // fill n refills the slot of fill j - lag, whose store has then read it
    const bool refill = more && j >= lag;
    const long long next = refill ? take(n) : nchunks;  // before the wait: hides an atomic
    // fill j is its slot's (j / nbuf)-th: mbarrier phases alternate 0, 1, 0, ...
    mbar_wait(smem_addr(&full[s]), (uint32_t)((j / nbuf) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + held[s] * chunk, base + (uint32_t)s * chunk, bytes_of(held[s]));
    if (next < nchunks) {
      bulk_wait_read(lag);
      load((int)(n % nbuf), next);
      ++n;
    } else if (refill) {
      more = false;
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (stamps) stamps[2 * blockIdx.x + 1] = globaltimer();
}

// K7c, one launch: block b copies tile b / nranges of range b mod nranges,
// each range `span` 16-byte vectors; a full grid, one tile of
// threads x V vectors a block. With `stamps`, thread 0 of each range's first
// block writes its start and of its last block its end (after the block's
// stores are issued) at stamps[2 r] and stamps[2 r + 1].
template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
ranged_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long span,
                   int nranges, unsigned long long* __restrict__ stamps) {
  const int r = (int)(blockIdx.x % nranges);
  const long long tile = blockIdx.x / nranges;
  if (stamps && tile == 0 && threadIdx.x == 0) stamps[2 * r] = globaltimer();
  const uint4* xr = x + r * span;
  uint4* outr = out + r * span;
  const long long i0 = tile * blockDim.x * V + threadIdx.x;
  uint4 v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long i = i0 + (long long)j * blockDim.x;
    if (i < span) v[j] = __ldcs(xr + i);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long i = i0 + (long long)j * blockDim.x;
    if (i < span) __stcs(outr + i, v[j]);
  }
  if (stamps && tile == gridDim.x / nranges - 1) {
    __syncthreads();
    if (threadIdx.x == 0) stamps[2 * r + 1] = globaltimer();
  }
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

template <int V>
void launch_ranged(const void* x, void* out, long long span, int nranges, int threads,
                   int blocks_per_range, unsigned long long* stamps, cudaStream_t s) {
  ranged_copy_kernel<V><<<(unsigned)((long long)nranges * blocks_per_range), threads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), span, nranges, stamps);
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
// bytes a block, refilling each slot `lag` stores after its own, on
// `blocks` blocks; `deal` 0 gives each block a contiguous run of chunks, 1
// chunk c to block c mod blocks, 2 each block the next chunk of `counter`
// (8 bytes of device scratch, zeroed on the stream here). `stamps`: null,
// or 2 x blocks u64 for each block's start and end %globaltimer.
extern "C" int bt_hbm_staged_copy(const void* x, void* out, long long nbytes, int chunk, int nbuf,
                                  int lag, int deal, int blocks, void* counter, void* stamps,
                                  void* stream) {
  if (nbytes <= 0 || blocks <= 0 || !valid_staged(chunk, nbuf) || lag < 0 || lag >= nbuf ||
      deal < CONTIGUOUS || deal > DYNAMIC || (deal == DYNAMIC && !counter))
    return cudaErrorInvalidValue;
  int err = allow_staged_smem(chunk, nbuf);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (deal == DYNAMIC) {
    err = cudaMemsetAsync(counter, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  const long long nbytes16 = nbytes / 16 * 16;
  staged_copy_kernel<<<blocks, STAGED_THREADS, (size_t)chunk * nbuf, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), nbytes16,
      (int)(nbytes - nbytes16), chunk, nbuf, lag, deal,
      static_cast<unsigned long long*>(counter), static_cast<unsigned long long*>(stamps));
  return cudaGetLastError();
}

// out = x over `nranges` ranges of `span` 16-byte vectors each, in one
// launch of nranges x blocks_per_range blocks (K7c); `stamps` null, or
// 2 x nranges u64 for each range's first start and last end.
extern "C" int bt_hbm_ranged_copy(const void* x, void* out, long long span, int nranges,
                                  int threads, int vecs, int blocks_per_range, void* stamps,
                                  void* stream) {
  if (span <= 0 || nranges <= 0 || blocks_per_range <= 0 || !valid_shape(threads, vecs) ||
      (long long)nranges * blocks_per_range > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<unsigned long long*>(stamps);
  switch (vecs) {
    case 1: launch_ranged<1>(x, out, span, nranges, threads, blocks_per_range, st, s); break;
    case 2: launch_ranged<2>(x, out, span, nranges, threads, blocks_per_range, st, s); break;
    default: launch_ranged<4>(x, out, span, nranges, threads, blocks_per_range, st, s); break;
  }
  return cudaGetLastError();
}

extern "C" const char* bt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
