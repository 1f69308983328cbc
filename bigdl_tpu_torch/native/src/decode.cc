// Threaded image-record decode and normalize (counterpart of
// bigdl_tpu/native/src/decode.cc; BigDL's threaded JVM pipeline is
// dataset/image/MTLabeledBGRImgToBatch.scala). One native call per batch:
//
//   u8 interleaved BGR -> f32, fused (x - mean[c]) * (1/std[c]),
//   written straight into the caller's (N, H*W*3) batch buffer,
//   std::thread-parallel over records, inner loop written for the
//   compiler's auto-vectorizer (contiguous, no branches).

#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// One record: len bytes of interleaved C-channel data.
static void decode_one(const uint8_t* in, float* out, int64_t len,
                       const float* mean, const float* rstd, int channels) {
  if (channels == 3) {
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    const float r0 = rstd[0], r1 = rstd[1], r2 = rstd[2];
    int64_t px = len / 3;
    for (int64_t p = 0; p < px; ++p) {
      out[3 * p + 0] = (static_cast<float>(in[3 * p + 0]) - m0) * r0;
      out[3 * p + 1] = (static_cast<float>(in[3 * p + 1]) - m1) * r1;
      out[3 * p + 2] = (static_cast<float>(in[3 * p + 2]) - m2) * r2;
    }
  } else {
    const float m = mean[0], r = rstd[0];
    for (int64_t i = 0; i < len; ++i)
      out[i] = (static_cast<float>(in[i]) - m) * r;
  }
}

// in: n contiguous records of rec_len bytes; out: n * rec_len floats.
// mean/rstd: per-channel mean and RECIPROCAL std (channels entries).
void bt_decode_normalize(const uint8_t* in, int64_t n, int64_t rec_len,
                         const float* mean, const float* rstd, int channels,
                         float* out, int threads) {
  if (n <= 0 || rec_len <= 0) return;
  int nt = std::max(1, threads);
  nt = static_cast<int>(std::min<int64_t>(nt, n));
  if (nt == 1) {
    for (int64_t i = 0; i < n; ++i)
      decode_one(in + i * rec_len, out + i * rec_len, rec_len, mean, rstd,
                 channels);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([=]() {
      for (int64_t i = t; i < n; i += nt)
        decode_one(in + i * rec_len, out + i * rec_len, rec_len, mean, rstd,
                   channels);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
