// Compose tail of the fine stage, one thread per output pixel.
//
// Replaces: ransacflow_tpu/pipeline/fine.py:46,61-92, the end of
// pred_flow_mask. The coarse grid flow_coarse is Hc x Wc; the output is
// Ht x Wt (out_hw, by default the coarse size). For output pixel (i, j):
//   1. flow_up = bilinear upsampling of the stride-8 residual flow to
//      Ht x Wt (torch's align_corners=False rule: source index
//      scale * (dst + 0.5) - 0.5 clamped at 0, i1 = min(i0 + 1, in - 1));
//      match12 likewise;
//   2. flow_up += the corner-anchored Ht x Wt grid (torch's linspace(-1,
//      1)), then clipped to [-1, 1];
//   3. flow12 = flow_coarse sampled bilinearly at flow_up (align_corners=
//      True, zeros outside), at its own Hc x Wc;
//   4. with cycle_match, match21 upsampled to Ht x Wt and sampled at the
//      same point with the Ht x Wt corner weights: each of the four corners
//      is rebuilt from the stride-8 map with the rule of step 1, so the
//      two-step interpolate-then-sample numbers are kept (no analytic
//      shortcut). This is the reference's split branch; when the sizes
//      agree its weights are step 3's, which is the reference's one sample
//      of [flow_coarse, match21];
//   5. match = match12 (* sampled match21) * [flow12 inside [-1, 1]^2].
//
// Every multiply and add is an explicit round-to-nearest intrinsic, each
// product fused into an FMA or not as written, so that no compiler choice
// moves a bit between builds, and out_hw equal to the coarse size gives the
// bits of out_hw = None. The order is the one the kernel's builds before
// out_hw computed, including their fusing the first-row pair of flow's x
// channel and of every match21 corner from its second term (`swap`).
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
  const float src = fmaxf(__fmaf_rn(scale, __fadd_rn(dst, 0.5f), -0.5f), 0.f);
  Axis a;
  a.i0 = static_cast<int>(src);
  a.i1 = a.i0 + ((a.i0 < in - 1) ? 1 : 0);
  a.l1 = __fsub_rn(src, a.i0);
  a.l0 = __fsub_rn(1.f, a.l1);
  return a;
}

// a * x + b * y as fma(a, x, b * y)
__device__ __forceinline__ float dot2(float a, float x, float b, float y) {
  return __fmaf_rn(a, x, __fmul_rn(b, y));
}

// One channel of an (h, w, C) map upsampled at output pixel (y, x); `swap`
// sums the first row's pair from its second term.
__device__ __forceinline__ float upsampled(const float* __restrict__ m, int w,
                                           int C, int c, const Axis& ay,
                                           const Axis& ax, bool swap) {
  const float a = m[(ay.i0 * w + ax.i0) * C + c], b = m[(ay.i0 * w + ax.i1) * C + c];
  const float r0 = swap ? dot2(ax.l1, b, ax.l0, a) : dot2(ax.l0, a, ax.l1, b);
  const float r1 = dot2(ax.l0, m[(ay.i1 * w + ax.i0) * C + c], ax.l1,
                        m[(ay.i1 * w + ax.i1) * C + c]);
  return dot2(ay.l0, r0, ay.l1, r1);
}

// torch.linspace(-1, 1, n)[i]: from the start below the midpoint, from the
// end above it.
__device__ __forceinline__ float linspace_pm1(int i, int n) {
  if (n == 1) return -1.f;
  const float step = 2.f / static_cast<float>(n - 1);
  return (i < n / 2) ? __fmaf_rn(step, i, -1.f) : __fmaf_rn(-step, n - i - 1, 1.f);
}

// The four corners of an align_corners=True bilinear sample at (gx, gy) in
// [-1, 1]^2 on an h x w map, with their weights; valid[k] is false outside.
struct Corners {
  int y[4], x[4];
  float wt[4];
  bool valid[4];
};

__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  const float ix = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), w - 1);
  const float iy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), h - 1);
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  Corners c = {{y0, y0, y0 + 1, y0 + 1}, {x0, x0 + 1, x0, x0 + 1}};
  const float wx0 = __fsub_rn(__fadd_rn(fx, 1.f), ix), wx1 = __fsub_rn(ix, fx);
  const float wy0 = __fsub_rn(__fadd_rn(fy, 1.f), iy), wy1 = __fsub_rn(iy, fy);
  c.wt[0] = __fmul_rn(wx0, wy0);
  c.wt[1] = __fmul_rn(wx1, wy0);
  c.wt[2] = __fmul_rn(wx0, wy1);
  c.wt[3] = __fmul_rn(wx1, wy1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.valid[k] = c.y[k] >= 0 && c.y[k] < h && c.x[k] >= 0 && c.x[k] < w;
  }
  return c;
}

__global__ void __launch_bounds__(kThreads) compose_kernel(
    const float* __restrict__ flow8, const float* __restrict__ m12_8,
    const float* __restrict__ m21_8, const float* __restrict__ flow_coarse,
    float* __restrict__ flow_out, float* __restrict__ match_out, int h8,
    int w8, int Hc, int Wc, int Ht, int Wt, int cycle_match, long long total) {
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
  const float* fc = flow_coarse + static_cast<long long>(b) * Hc * Wc * 2;

  const Axis ay = upsample_axis(i, h8, sh), ax = upsample_axis(j, w8, sw);
  const float gx = fminf(fmaxf(__fadd_rn(upsampled(f8, w8, 2, 0, ay, ax, true),
                                         linspace_pm1(j, Wt)), -1.f), 1.f);
  const float gy = fminf(fmaxf(__fadd_rn(upsampled(f8, w8, 2, 1, ay, ax, false),
                                         linspace_pm1(i, Ht)), -1.f), 1.f);
  float match = upsampled(a8, w8, 1, 0, ay, ax, false);

  // flow_coarse sampled at (gx, gy) on its own Hc x Wc grid
  const Corners cc = corners(gx, gy, Hc, Wc);
  float f12x = 0.f, f12y = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!cc.valid[k]) continue;
    const int q = cc.y[k] * Wc + cc.x[k];
    f12x = __fmaf_rn(fc[q * 2], cc.wt[k], f12x);
    f12y = __fmaf_rn(fc[q * 2 + 1], cc.wt[k], f12y);
  }
  if (cycle_match) {  // match21 upsampled to Ht x Wt, sampled there
    const Corners ct = corners(gx, gy, Ht, Wt);
    float m21 = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!ct.valid[k]) continue;
      const Axis cy = upsample_axis(ct.y[k], h8, sh), cx = upsample_axis(ct.x[k], w8, sw);
      m21 = __fmaf_rn(upsampled(c8, w8, 1, 0, cy, cx, true), ct.wt[k], m21);
    }
    match = __fmul_rn(match, m21);
  }
  const bool in_bounds = f12x >= -1.f && f12x <= 1.f && f12y >= -1.f && f12y <= 1.f;
  flow_out[p * 2] = f12x;
  flow_out[p * 2 + 1] = f12y;
  match_out[p] = match * (in_bounds ? 1.f : 0.f);
}

}  // namespace

// flow8: (B, h8, w8, 2), m12_8 and m21_8: (B, h8, w8, 1), flow_coarse:
// (B, Hc, Wc, 2), all fp32; flow_out: (B, Ht, Wt, 2); match_out: (B, Ht, Wt).
RF_API int rf_compose_tail(const float* flow8, const float* m12_8,
                           const float* m21_8, const float* flow_coarse,
                           float* flow_out, float* match_out, int B, int h8,
                           int w8, int Hc, int Wc, int Ht, int Wt,
                           int cycle_match, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * Ht * Wt;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  compose_kernel<<<blocks, kThreads, 0, stream>>>(
      flow8, m12_8, m21_8, flow_coarse, flow_out, match_out, h8, w8, Hc, Wc,
      Ht, Wt, cycle_match, total);
  return static_cast<int>(cudaGetLastError());
}
