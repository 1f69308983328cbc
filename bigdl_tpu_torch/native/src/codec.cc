// bf16 compression codec (counterpart of bigdl_tpu/native/src/codec.cc,
// itself after BigDL's parameters/FP16CompressedTensor.scala): fp32
// truncated to its top 16 bits (== bfloat16), with multithreaded compress /
// decompress / accumulate-add over std::thread.
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

std::atomic<int> g_threads{0};  // 0 = hardware_concurrency

int num_threads(size_t n, size_t grain) {
  int t = g_threads.load();
  if (t <= 0) t = static_cast<int>(std::thread::hardware_concurrency());
  if (t < 1) t = 1;
  size_t max_by_grain = n / grain + 1;
  if (static_cast<size_t>(t) > max_by_grain) t = static_cast<int>(max_by_grain);
  return t;
}

template <typename F>
void parallel_for(size_t n, size_t grain, F&& body) {
  int t = num_threads(n, grain);
  if (t <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> workers;
  size_t chunk = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    size_t lo = i * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    workers.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

inline uint16_t truncate(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  return static_cast<uint16_t>(bits >> 16);  // fp32 high half == bfloat16
}

inline float widen(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

}  // namespace

extern "C" {

void bt_set_num_threads(int n) { g_threads.store(n); }

// fp32 -> bf16 by truncation (reference truncate(), FP16CompressedTensor.scala:271)
void bt_fp32_to_bf16(const float* src, uint16_t* dst, size_t n) {
  parallel_for(n, 1 << 16, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) dst[i] = truncate(src[i]);
  });
}

// bf16 -> fp32 (reference deCompress, FP16CompressedTensor.scala:121-180)
void bt_bf16_to_fp32(const uint16_t* src, float* dst, size_t n) {
  parallel_for(n, 1 << 16, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) dst[i] = widen(src[i]);
  });
}

// dst += src in the bf16 domain (reference add/parAdd,
// FP16CompressedTensor.scala:181-245): widen both, add in fp32, re-truncate.
void bt_bf16_add(uint16_t* dst, const uint16_t* src, size_t n) {
  parallel_for(n, 1 << 16, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i)
      dst[i] = truncate(widen(dst[i]) + widen(src[i]));
  });
}

// fp32 dst += bf16 src — fused decompress-accumulate for slice aggregation
void bt_bf16_accumulate(float* dst, const uint16_t* src, size_t n) {
  parallel_for(n, 1 << 16, [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) dst[i] += widen(src[i]);
  });
}

}  // extern "C"
