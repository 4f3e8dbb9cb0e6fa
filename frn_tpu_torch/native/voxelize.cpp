// Native host kernels for the frn_tpu_torch data pipeline (a copy of the JAX
// package's native/voxelize.cpp; the port builds its own).
//
// The event->voxel scatter is the input-pipeline hot spot (the reference runs it
// as an interpreted Python loop, dsec_data.py:380-381). This C++ version is
// memory-bandwidth-bound: one fma per event into a (C,H,W) accumulator.
//
// Built as a plain shared library (no pybind11 in the image) and called through
// ctypes with raw pointers; see frn_tpu_torch/utils/native.py.

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Scatter-add polarities into voxel[bin, y, x]. Assumes inputs pre-filtered to
// 0 <= x < width, 0 <= y < height, 0 <= bin < num_bins (the Python wrapper
// guarantees this); defensively skips out-of-range entries anyway.
void frn_voxelize(const int32_t* x, const int32_t* y, const int32_t* t_bin,
                  const float* pol, int64_t n, int32_t num_bins, int32_t height,
                  int32_t width, float* out /* (num_bins*height*width) zeroed */) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t xi = x[i], yi = y[i], bi = t_bin[i];
    if (static_cast<uint32_t>(xi) >= static_cast<uint32_t>(width) ||
        static_cast<uint32_t>(yi) >= static_cast<uint32_t>(height) ||
        static_cast<uint32_t>(bi) >= static_cast<uint32_t>(num_bins)) {
      continue;
    }
    out[bi * plane + static_cast<int64_t>(yi) * width + xi] += pol[i];
  }
}

// Full preprocess_events pipeline in one pass: time normalization + nearest-bin
// + polarity mapping + scatter (dsec_data.py:347-381). t is raw microsecond
// timestamps of the (sorted) window.
void frn_voxelize_raw(const int32_t* x, const int32_t* y, const int64_t* t,
                      const int8_t* p /* >0 => +1 else -1 */, int64_t n,
                      int32_t num_bins, int32_t height, int32_t width,
                      float* out) {
  if (n <= 0) return;
  const double t0 = static_cast<double>(t[0]);
  const double denom = static_cast<double>(t[n - 1]) - t0 + 1e-6;
  const double scale = (num_bins - 1) / denom;
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t xi = x[i], yi = y[i];
    if (static_cast<uint32_t>(xi) >= static_cast<uint32_t>(width) ||
        static_cast<uint32_t>(yi) >= static_cast<uint32_t>(height)) {
      continue;
    }
    int32_t bi = static_cast<int32_t>((static_cast<double>(t[i]) - t0) * scale);
    bi = bi < 0 ? 0 : (bi >= num_bins ? num_bins - 1 : bi);
    const float pol = p[i] > 0 ? 1.0f : -1.0f;
    out[bi * plane + static_cast<int64_t>(yi) * width + xi] += pol;
  }
}

// Bilinear event subsampling for zoom augmentation (reference augment.py:13-36,
// numba kernels _add_event/_subsample): each fractional-coordinate event splats
// bilinear weights into the 4 neighboring integer cells of a polarity
// accumulator; when a cell's accumulated charge crosses the threshold, one
// integer-coordinate event is emitted at that cell and the charge is drained.
// pos is (n,2) float32 xy (modified in place to the emitted integer coords),
// mask (n) uint8 output marks emitted events. Sequential by construction.
void frn_event_subsample(float* pos, const float* polarity, uint8_t* mask,
                         float* count /* (height*width) zeroed */, int64_t n,
                         int32_t height, int32_t width, float threshold) {
  auto add_event = [&](float x, float y, int32_t xl, int32_t yl, float p,
                       int64_t i) {
    if (xl < 0 || xl >= width || yl < 0 || yl >= height) return;
    const int64_t idx = static_cast<int64_t>(yl) * width + xl;
    count[idx] += p * (1.0f - std::fabs(x - xl)) * (1.0f - std::fabs(y - yl));
    const float pol = count[idx] > 0 ? 1.0f : -1.0f;
    if (pol * count[idx] > threshold) {
      count[idx] -= pol * threshold;
      mask[i] = 1;
      pos[2 * i] = static_cast<float>(xl);
      pos[2 * i + 1] = static_cast<float>(yl);
    }
  };
  for (int64_t i = 0; i < n; ++i) {
    const float x = pos[2 * i], y = pos[2 * i + 1];
    const float p = polarity[i];
    const int32_t x0 = static_cast<int32_t>(x), x1 = x0 + 1;
    const int32_t y0 = static_cast<int32_t>(y), y1 = y0 + 1;
    add_event(x, y, x0, y0, p, i);
    add_event(x, y, x1, y0, p, i);
    add_event(x, y, x0, y1, p, i);
    add_event(x, y, x1, y1, p, i);
  }
}

// In-place tanh(v/thr) normalization if max|v| > thr (dsec_data.py:461-462).
void frn_tanh_normalize(float* v, int64_t n, float thr) {
  float maxabs = 0.0f;
  for (int64_t i = 0; i < n; ++i) {
    const float a = std::fabs(v[i]);
    if (a > maxabs) maxabs = a;
  }
  if (maxabs <= thr) return;
  const float inv = 1.0f / thr;
  for (int64_t i = 0; i < n; ++i) v[i] = std::tanh(v[i] * inv);
}

}  // extern "C"
