// Packed-shard scanner for dataset/shards.py (counterpart of
// bigdl_tpu/native/src/shard.cc; BigDL reads Hadoop SequenceFiles): one
// C++ pass indexes and CRC-verifies a whole shard instead of a Python loop
// framing it record by record.
//
// Framing (visualization/tensorboard.py RecordWriter, TFRecord-compatible):
//   uint64 length (LE) | uint32 masked_crc32c(length bytes)
//   payload            | uint32 masked_crc32c(payload)
// masked_crc = rotr15(crc32c(x)) + 0xa282ead8 (mod 2^32).
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" uint32_t bt_crc32c(const uint8_t* data, size_t n);  // crc32c.cc

namespace {

constexpr uint32_t kMaskDelta = 0xa282ead8u;

inline uint32_t masked(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

inline uint32_t load_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

}  // namespace

extern "C" {

// Scan a whole in-memory shard, writing each payload's (offset, length)
// into the caller-provided arrays.  Returns the record count, or
//   -1  corrupt record header (masked length-CRC mismatch)
//   -2  corrupt record payload (masked payload-CRC mismatch)
//   -3  more than max_records records
// A truncated tail (crashed writer) terminates the scan cleanly, matching
// FileReader.read_records.  Header CRCs are checked inline (12 bytes each);
// payload CRCs are verified across records with std::thread when
// validate != 0.
int64_t bt_shard_scan(const uint8_t* buf, size_t n, uint64_t* offsets,
                      uint64_t* lengths, size_t max_records, int validate) {
  size_t pos = 0, count = 0;
  while (n - pos >= 12) {
    uint64_t len = load_u64(buf + pos);
    if (validate && masked(bt_crc32c(buf + pos, 8)) != load_u32(buf + pos + 8))
      return -1;
    size_t body = pos + 12;
    if (len > n - body || n - body - len < 4) break;  // truncated tail
    if (count >= max_records) return -3;
    offsets[count] = body;
    lengths[count] = len;
    ++count;
    pos = body + len + 4;
  }
  if (validate && count) {
    unsigned hw = std::thread::hardware_concurrency();
    size_t t = hw ? hw : 1;
    if (t > count) t = count;
    if (t > 16) t = 16;
    std::vector<int> bad(t, 0);
    std::vector<std::thread> workers;
    size_t chunk = (count + t - 1) / t;
    for (size_t i = 0; i < t; ++i) {
      size_t lo = i * chunk, hi = lo + chunk < count ? lo + chunk : count;
      if (lo >= hi) break;
      workers.emplace_back([&, lo, hi, i] {
        for (size_t r = lo; r < hi; ++r) {
          const uint8_t* p = buf + offsets[r];
          if (masked(bt_crc32c(p, lengths[r])) != load_u32(p + lengths[r]))
            bad[i] = 1;
        }
      });
    }
    for (auto& w : workers) w.join();
    for (size_t i = 0; i < t; ++i)
      if (bad[i]) return -2;
  }
  return static_cast<int64_t>(count);
}

}  // extern "C"
