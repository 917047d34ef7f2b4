// Source warp: bilinear sampling of a channels-last image at a grid of
// normalized (x, y) points, one thread per output pixel.
//
// Replaces: ransacflow_tpu/ops/sampler.py:240 grid_sample as the fine
// stage's source warp (ransacflow_tpu/pipeline/fine.py:48): the (B, Hs, Ws,
// C) source sampled on the (B, Ho, Wo, 2) homography grid, align_corners=True,
// zeros outside. The arithmetic is torch's grid_sampler_2d (bilinear, zeros):
// x = ((gx + 1) / 2) * (W - 1), the four corners of floor(x), floor(y), each
// corner counted only when it lies inside the image, summed in the order
// nw, ne, sw, se.
//
// What bounds it on the H100: at the fine stage's shape (480x640 grid,
// 3 channels from a 480x640 source) it reads 2.5 MB of grid, at most 4 x 12
// bytes of source per pixel (mostly from L1/L2: neighbouring pixels share
// corners) and writes 3.7 MB: memory traffic of a few microseconds at
// 3.35 TB/s, so it is bound by the latency of its gathers. Reading the grid
// as one float2 per thread and keeping all channels of a pixel in one thread
// keeps every load of a warp on neighbouring addresses.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

__global__ void __launch_bounds__(kThreads) warp_sample_kernel(
    const float* __restrict__ img, const float2* __restrict__ grid,
    float* __restrict__ out, int H, int W, int C, int HWo, int total) {
  // 32-bit index arithmetic: the wrapper keeps every tensor below 2^31
  // elements
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const int b = p / HWo;
  const float2 g = grid[p];
  const float ix = ((g.x + 1.f) / 2) * (W - 1);
  const float iy = ((g.y + 1.f) / 2) * (H - 1);
  float* o = out + p * C;
  // a point this far out (or NaN) touches no pixel; it would also overflow
  // the integer corner indices
  if (!(fabsf(ix) < 1e9f && fabsf(iy) < 1e9f)) {
    for (int c = 0; c < C; ++c) o[c] = 0.f;
    return;
  }
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  const float nw = (fx + 1.f - ix) * (fy + 1.f - iy);
  const float ne = (ix - fx) * (fy + 1.f - iy);
  const float sw = (fx + 1.f - ix) * (iy - fy);
  const float se = (ix - fx) * (iy - fy);
  const float* base = img + b * H * W * C;
  const bool in_nw = inside(y0, x0, H, W), in_ne = inside(y0, x0 + 1, H, W);
  const bool in_sw = inside(y0 + 1, x0, H, W), in_se = inside(y0 + 1, x0 + 1, H, W);
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    if (in_nw) acc += base[(y0 * W + x0) * C + c] * nw;
    if (in_ne) acc += base[(y0 * W + x0 + 1) * C + c] * ne;
    if (in_sw) acc += base[((y0 + 1) * W + x0) * C + c] * sw;
    if (in_se) acc += base[((y0 + 1) * W + x0 + 1) * C + c] * se;
    o[c] = acc;
  }
}

}  // namespace

// img: (B, H, W, C) fp32; grid: (B, Ho, Wo, 2) fp32; out: (B, Ho, Wo, C);
// each below 2^31 elements.
RF_API int rf_warp_sample(const float* img, const float* grid, float* out,
                          int B, int H, int W, int C, int Ho, int Wo,
                          cudaStream_t stream) {
  const int total = B * Ho * Wo;
  warp_sample_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      img, reinterpret_cast<const float2*>(grid), out, H, W, C, Ho * Wo, total);
  return static_cast<int>(cudaGetLastError());
}
