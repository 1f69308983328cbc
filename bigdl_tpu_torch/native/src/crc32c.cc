// CRC32C (Castagnoli), slice-by-8 (counterpart of
// bigdl_tpu/native/src/crc32c.cc; BigDL's java/netty/Crc32c.java), used for
// the TFRecord masked-CRC framing of event files and record shards.
#include <cstddef>
#include <cstdint>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Tables kTables;

}  // namespace

extern "C" uint32_t bt_crc32c(const uint8_t* data, size_t n) {
  const uint32_t(*t)[256] = kTables.t;
  uint32_t crc = 0xFFFFFFFFu;
  // head: align to 8
  while (n && (reinterpret_cast<uintptr_t>(data) & 7u)) {
    crc = (crc >> 8) ^ t[0][(crc ^ *data++) & 0xFF];
    --n;
  }
  while (n >= 8) {
    uint64_t word = *reinterpret_cast<const uint64_t*>(data) ^ crc;
    crc = t[7][word & 0xFF] ^ t[6][(word >> 8) & 0xFF] ^
          t[5][(word >> 16) & 0xFF] ^ t[4][(word >> 24) & 0xFF] ^
          t[3][(word >> 32) & 0xFF] ^ t[2][(word >> 40) & 0xFF] ^
          t[1][(word >> 48) & 0xFF] ^ t[0][(word >> 56) & 0xFF];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}
