// Native host-side image resampling for the data pipeline.
//
// Lanczos-3 separable resize with PIL-compatible semantics (the reference's
// host path is PIL LANCZOS everywhere): when downscaling, the filter widens
// by the scale factor; per-output-pixel weights are renormalized over the
// clipped support window. float32, channels-last, C-contiguous.
//
// Built with g++ into a shared library at first use and called through
// ctypes (ransacflow_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double kA = 3.0;  // Lanczos support (PIL LANCZOS == lanczos3)

inline double sinc(double x) {
  if (x == 0.0) return 1.0;
  const double px = M_PI * x;
  return std::sin(px) / px;
}

inline double lanczos3(double x) {
  if (x <= -kA || x >= kA) return 0.0;
  return sinc(x) * sinc(x / kA);
}

struct Weights {
  // For each output index: start input index + normalized taps.
  std::vector<int> start;
  std::vector<int> count;
  std::vector<double> taps;   // flattened, max_count stride
  int max_count;
};

Weights precompute(int in_size, int out_size) {
  Weights w;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = kA * filterscale;
  w.max_count = static_cast<int>(std::ceil(support)) * 2 + 1;
  w.start.resize(out_size);
  w.count.resize(out_size);
  w.taps.assign(static_cast<size_t>(out_size) * w.max_count, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    double sum = 0.0;
    double* taps = &w.taps[static_cast<size_t>(xx) * w.max_count];
    for (int j = 0; j < n; ++j) {
      const double t = lanczos3((xmin + j - center + 0.5) / filterscale);
      taps[j] = t;
      sum += t;
    }
    if (sum != 0.0) {
      for (int j = 0; j < n; ++j) taps[j] /= sum;
    }
    w.start[xx] = xmin;
    w.count[xx] = n;
  }
  return w;
}

void resize_rows(const float* src, int in_h, int width_c, float* dst,
                 int out_h, const Weights& wy, int row_begin, int row_end) {
  for (int y = row_begin; y < row_end; ++y) {
    const double* taps = &wy.taps[static_cast<size_t>(y) * wy.max_count];
    const int start = wy.start[y];
    const int n = wy.count[y];
    float* out_row = dst + static_cast<size_t>(y) * width_c;
    std::memset(out_row, 0, sizeof(float) * width_c);
    for (int j = 0; j < n; ++j) {
      const float t = static_cast<float>(taps[j]);
      const float* in_row = src + static_cast<size_t>(start + j) * width_c;
      for (int i = 0; i < width_c; ++i) out_row[i] += t * in_row[i];
    }
  }
}

void resize_cols(const float* src, int height, int in_w, int channels,
                 float* dst, int out_w, const Weights& wx, int row_begin,
                 int row_end) {
  for (int y = row_begin; y < row_end; ++y) {
    const float* in_row = src + static_cast<size_t>(y) * in_w * channels;
    float* out_row = dst + static_cast<size_t>(y) * out_w * channels;
    for (int x = 0; x < out_w; ++x) {
      const double* taps = &wx.taps[static_cast<size_t>(x) * wx.max_count];
      const int start = wx.start[x];
      const int n = wx.count[x];
      for (int c = 0; c < channels; ++c) {
        float acc = 0.0f;
        for (int j = 0; j < n; ++j) {
          acc += static_cast<float>(taps[j]) *
                 in_row[(start + j) * channels + c];
        }
        out_row[x * channels + c] = acc;
      }
    }
  }
}

void parallel_for(int total, int n_threads,
                  const std::function<void(int, int)>& fn) {
  if (n_threads <= 1 || total < 64) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> threads;
  const int chunk = (total + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int b = t * chunk;
    const int e = std::min(total, b + chunk);
    if (b >= e) break;
    threads.emplace_back(fn, b, e);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// src: (in_h, in_w, channels) float32 C-contiguous -> dst: (out_h, out_w, c)
void lanczos_resize_f32(const float* src, int in_h, int in_w, int channels,
                        float* dst, int out_h, int out_w, int n_threads) {
  const Weights wy = precompute(in_h, out_h);
  const Weights wx = precompute(in_w, out_w);

  // vertical pass into a temp buffer, then horizontal
  std::vector<float> tmp(static_cast<size_t>(out_h) * in_w * channels);
  const int width_c = in_w * channels;
  parallel_for(out_h, n_threads, [&](int b, int e) {
    resize_rows(src, in_h, width_c, tmp.data(), out_h, wy, b, e);
  });
  parallel_for(out_h, n_threads, [&](int b, int e) {
    resize_cols(tmp.data(), out_h, in_w, channels, dst, out_w, wx, b, e);
  });
}

}  // extern "C"
