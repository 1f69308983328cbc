// Small native utilities (counterpart of bigdl_tpu/native/src/util.cc):
// quickselect kth-largest (BigDL's utils/Util.scala:20, the straggler-drop
// threshold).
#include <algorithm>
#include <cstddef>
#include <vector>

extern "C" {

// k is 1-based: k=1 returns the maximum (matching the reference's contract).
double bt_kth_largest(const double* data, size_t n, size_t k) {
  if (n == 0 || k == 0 || k > n) return 0.0;
  std::vector<double> buf(data, data + n);
  std::nth_element(buf.begin(), buf.begin() + (k - 1), buf.end(),
                   std::greater<double>());
  return buf[k - 1];
}

}  // extern "C"
