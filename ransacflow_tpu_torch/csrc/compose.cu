// Compose tail of the fine stage, one thread per output pixel.
//
// Replaces: ransacflow_tpu/pipeline/fine.py:61-92, the end of
// pred_flow_mask. For target pixel (i, j) of an Ht x Wt map:
//   1. flow_up = bilinear upsampling of the stride-8 residual flow to
//      Ht x Wt (torch's align_corners=False rule: source index
//      scale * (dst + 0.5) - 0.5 clamped at 0, i1 = min(i0 + 1, in - 1));
//      match12 likewise;
//   2. flow_up += the corner-anchored grid (torch's linspace(-1, 1)), then
//      clipped to [-1, 1];
//   3. flow12 = flow_coarse sampled bilinearly at flow_up (align_corners=
//      True, zeros outside);
//   4. with cycle_match, the upsampled match21 sampled at the same point:
//      each of the four corners is rebuilt from the stride-8 map with the
//      rule of step 1, so the two-step interpolate-then-sample numbers are
//      kept (no analytic shortcut);
//   5. match = match12 (* sampled match21) * [flow12 inside [-1, 1]^2].
//
// What bounds it on the H100: at 480x640 the tail reads the grid-sized
// flow_coarse (2.5 MB) and tiny stride-8 maps (L2-resident) and writes
// 3.7 MB: a few microseconds of memory traffic. The plain version
// writes and reads three full-size upsampled maps, a concatenation and a
// sampled map besides; fused here they never leave registers, so the kernel
// is bound by the latency of its gathers.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Axis {
  int i0, i1;       // the two source indices
  float l0, l1;     // their weights
};

// torch's upsample_bilinear2d source index, align_corners=False, no scale
// factor given: scale = in / out.
__device__ __forceinline__ Axis upsample_axis(int dst, int in, float scale) {
  const float src = fmaxf(scale * (dst + 0.5f) - 0.5f, 0.f);
  Axis a;
  a.i0 = static_cast<int>(src);
  a.i1 = a.i0 + ((a.i0 < in - 1) ? 1 : 0);
  a.l1 = src - a.i0;
  a.l0 = 1.f - a.l1;
  return a;
}

// One channel of an (h, w, C) map upsampled at output pixel (y, x).
__device__ __forceinline__ float upsampled(const float* __restrict__ m, int w,
                                           int C, int c, const Axis& ay,
                                           const Axis& ax) {
  return ay.l0 * (ax.l0 * m[(ay.i0 * w + ax.i0) * C + c] +
                  ax.l1 * m[(ay.i0 * w + ax.i1) * C + c]) +
         ay.l1 * (ax.l0 * m[(ay.i1 * w + ax.i0) * C + c] +
                  ax.l1 * m[(ay.i1 * w + ax.i1) * C + c]);
}

// torch.linspace(-1, 1, n)[i]: from the start below the midpoint, from the
// end above it.
__device__ __forceinline__ float linspace_pm1(int i, int n) {
  if (n == 1) return -1.f;
  const float step = 2.f / static_cast<float>(n - 1);
  return (i < n / 2) ? -1.f + step * i : 1.f - step * (n - i - 1);
}

__global__ void __launch_bounds__(kThreads) compose_kernel(
    const float* __restrict__ flow8, const float* __restrict__ m12_8,
    const float* __restrict__ m21_8, const float* __restrict__ flow_coarse,
    float* __restrict__ flow_out, float* __restrict__ match_out, int h8,
    int w8, int Ht, int Wt, int cycle_match, long long total) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= total) return;
  const int HW = Ht * Wt;
  const int b = static_cast<int>(p / HW);
  const int pix = static_cast<int>(p - static_cast<long long>(b) * HW);
  const int i = pix / Wt, j = pix - (pix / Wt) * Wt;
  const float sh = static_cast<float>(h8) / Ht, sw = static_cast<float>(w8) / Wt;
  const float* f8 = flow8 + static_cast<long long>(b) * h8 * w8 * 2;
  const float* a8 = m12_8 + static_cast<long long>(b) * h8 * w8;
  const float* c8 = m21_8 + static_cast<long long>(b) * h8 * w8;
  const float* fc = flow_coarse + static_cast<long long>(b) * HW * 2;

  const Axis ay = upsample_axis(i, h8, sh), ax = upsample_axis(j, w8, sw);
  const float gx = fminf(fmaxf(upsampled(f8, w8, 2, 0, ay, ax) +
                               linspace_pm1(j, Wt), -1.f), 1.f);
  const float gy = fminf(fmaxf(upsampled(f8, w8, 2, 1, ay, ax) +
                               linspace_pm1(i, Ht), -1.f), 1.f);
  float match = upsampled(a8, w8, 1, 0, ay, ax);

  // bilinear sample at (gx, gy), align_corners=True; gx, gy lie in [-1, 1]
  const float ix = ((gx + 1.f) / 2) * (Wt - 1);
  const float iy = ((gy + 1.f) / 2) * (Ht - 1);
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
  const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
  const float wts[4] = {(fx + 1.f - ix) * (fy + 1.f - iy),
                        (ix - fx) * (fy + 1.f - iy),
                        (fx + 1.f - ix) * (iy - fy),
                        (ix - fx) * (iy - fy)};
  float f12x = 0.f, f12y = 0.f, m21 = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ys[k] < 0 || ys[k] >= Ht || xs[k] < 0 || xs[k] >= Wt) continue;
    const int q = ys[k] * Wt + xs[k];
    f12x += fc[q * 2] * wts[k];
    f12y += fc[q * 2 + 1] * wts[k];
    if (cycle_match) {
      const Axis cy = upsample_axis(ys[k], h8, sh), cx = upsample_axis(xs[k], w8, sw);
      m21 += upsampled(c8, w8, 1, 0, cy, cx) * wts[k];
    }
  }
  if (cycle_match) match = match * m21;
  const bool in_bounds = f12x >= -1.f && f12x <= 1.f && f12y >= -1.f && f12y <= 1.f;
  flow_out[p * 2] = f12x;
  flow_out[p * 2 + 1] = f12y;
  match_out[p] = match * (in_bounds ? 1.f : 0.f);
}

}  // namespace

// flow8: (B, h8, w8, 2), m12_8 and m21_8: (B, h8, w8, 1), flow_coarse:
// (B, Ht, Wt, 2), all fp32; flow_out: (B, Ht, Wt, 2); match_out: (B, Ht, Wt).
RF_API int rf_compose_tail(const float* flow8, const float* m12_8,
                           const float* m21_8, const float* flow_coarse,
                           float* flow_out, float* match_out, int B, int h8,
                           int w8, int Ht, int Wt, int cycle_match,
                           cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * Ht * Wt;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  compose_kernel<<<blocks, kThreads, 0, stream>>>(
      flow8, m12_8, m21_8, flow_coarse, flow_out, match_out, h8, w8, Ht, Wt,
      cycle_match, total);
  return static_cast<int>(cudaGetLastError());
}
