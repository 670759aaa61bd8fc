// Host-side threshold compression codec.
//
// Reference: the ND4J NATIVE ops behind EncodingHandler.java:64-66
// (Nd4j.getExecutioner().thresholdEncode/thresholdDecode) — the reference's
// sparse sign+threshold quantizer is C++ in libnd4j; this is the TPU build's
// native equivalent for the host/DCN boundary (the on-device variant is
// ops/compression.py). Semantics are kept bit-identical to the XLA path:
// a SINGLE PASS takes every entry clearing `threshold` in index order until
// the payload is full (the reference encodes all >=threshold entries with
// no magnitude ordering — EncodingHandler.java:64-66; the capacity bound is
// the static-shape adaptation, and what doesn't fit stays in the residual
// for the next round, the Strom error feedback). Taken entries are
// quantized to +-threshold and subtracted from the residual.
//
// Built with: g++ -O3 -shared -fPIC threshold_codec.cpp -o libthreshold_codec.so
// Loaded via ctypes (deeplearning4j_tpu/native/__init__.py) — no pybind11.

#include <cmath>
#include <cstdint>

extern "C" {

// Encode entries of residual[n] clearing `threshold`, in index order, up
// to `capacity`. Unused payload slots get index 0 / sign 0 (decode adds
// nothing for sign 0, mirroring the XLA payload layout). Residual is
// updated IN PLACE (sent mass subtracted). Returns the encoded count.
int threshold_encode(float* residual, int64_t n, float threshold,
                     int64_t capacity, int32_t* idx_out, int8_t* sign_out) {
  if (capacity > n) capacity = n;
  int64_t k = 0;
  for (int64_t i = 0; i < n && k < capacity; ++i) {
    float v = residual[i];
    if (std::fabs(v) >= threshold) {
      int8_t s = (v > 0.0f) ? 1 : ((v < 0.0f) ? -1 : 0);
      if (s == 0) continue;   // threshold == 0 with v == 0
      idx_out[k] = static_cast<int32_t>(i);
      sign_out[k] = s;
      residual[i] -= s * threshold;
      ++k;
    }
  }
  for (int64_t r = k; r < capacity; ++r) {
    idx_out[r] = 0;
    sign_out[r] = 0;
  }
  return static_cast<int>(k);
}

// Reconstruct the dense update a payload represents (SilentTrainingDriver
// thresholdDecode): out[idx[k]] += sign[k] * threshold. `out` must be
// zero-initialized by the caller (or hold a partial sum to accumulate into —
// the receiving-accumulator semantics of the reference).
void threshold_decode(const int32_t* idx, const int8_t* signs,
                      int64_t capacity, float threshold, float* out,
                      int64_t n) {
  for (int64_t k = 0; k < capacity; ++k) {
    int32_t i = idx[k];
    if (i >= 0 && i < n && signs[k] != 0) {
      out[i] += signs[k] * threshold;
    }
  }
}

}  // extern "C"
