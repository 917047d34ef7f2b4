// Backward of bilinear grid sampling (align_corners=True, zeros outside),
// channels-last: the image cotangent as a bilinear splat and the analytic
// grid cotangent. Its forward is warp_sample.cu.
//
// Replaces: ransacflow_tpu/ops/sampler.py:211 _grid_sample_bwd, the
// custom VJP of grid_sample, whose image cotangent was chunked one-hot
// matmuls on the TPU's matrix unit (a TPU has no fast scatter) and whose
// grid cotangent re-gathered the four corners.
//
//   d_image[b, corner, c] += w_corner * g[b, p, c]   (corners inside only)
//   d_grid[b, p, 0] = (W - 1) / 2 * sum_c g * ((1 - fy)(v10 - v00) + fy (v11 - v01))
//   d_grid[b, p, 1] = (H - 1) / 2 * sum_c g * ((1 - fx)(v01 - v00) + fx (v11 - v10))
//
// What bounds it on the H100: at the training step's three calls
// (32 x 224 x 224 points, 1-3 channels) it reads the cotangent, the grid
// and 4 corners per point, and adds 4 values per channel into the image
// cotangent: ~20-40 MB, so memory traffic and the contention of the atomic
// adds bound it, not arithmetic. One thread per output point, all channels
// of a point in that thread; fp32 atomicAdd into the four corners (an
// order that changes from run to run: the image cotangent is not bit-wise
// deterministic). The splat is skipped when the image needs no cotangent.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

__global__ void __launch_bounds__(kThreads) grid_sample_bwd_kernel(
    const float* __restrict__ img, const float2* __restrict__ grid,
    const float* __restrict__ g, float* __restrict__ d_img,
    float2* __restrict__ d_grid, int H, int W, int C, int HWo, int total) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const int b = p / HWo;
  const float2 gp = grid[p];
  const float ix = ((gp.x + 1.f) / 2) * (W - 1);
  const float iy = ((gp.y + 1.f) / 2) * (H - 1);
  if (!(fabsf(ix) < 1e9f && fabsf(iy) < 1e9f)) {  // touches no pixel
    d_grid[p] = make_float2(0.f, 0.f);
    return;
  }
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const int x0 = static_cast<int>(fx0), y0 = static_cast<int>(fy0);
  const float fx = ix - fx0, fy = iy - fy0;
  const bool in00 = inside(y0, x0, H, W), in10 = inside(y0, x0 + 1, H, W);
  const bool in01 = inside(y0 + 1, x0, H, W), in11 = inside(y0 + 1, x0 + 1, H, W);
  const size_t base = static_cast<size_t>(b) * H * W;
  const size_t o00 = (base + static_cast<size_t>(y0) * W + x0) * C;
  const size_t o10 = o00 + C;
  const size_t o01 = o00 + static_cast<size_t>(W) * C;
  const size_t o11 = o01 + C;
  const float* gq = g + static_cast<size_t>(p) * C;
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float gc = gq[c];
    const float v00 = in00 ? img[o00 + c] : 0.f;
    const float v10 = in10 ? img[o10 + c] : 0.f;
    const float v01 = in01 ? img[o01 + c] : 0.f;
    const float v11 = in11 ? img[o11 + c] : 0.f;
    gx += gc * ((1.f - fy) * (v10 - v00) + fy * (v11 - v01));
    gy += gc * ((1.f - fx) * (v01 - v00) + fx * (v11 - v10));
    if (d_img != nullptr) {
      if (in00) atomicAdd(d_img + o00 + c, (1.f - fx) * (1.f - fy) * gc);
      if (in10) atomicAdd(d_img + o10 + c, fx * (1.f - fy) * gc);
      if (in01) atomicAdd(d_img + o01 + c, (1.f - fx) * fy * gc);
      if (in11) atomicAdd(d_img + o11 + c, fx * fy * gc);
    }
  }
  d_grid[p] = make_float2(gx * ((W - 1) * 0.5f), gy * ((H - 1) * 0.5f));
}

}  // namespace

// img: (B, H, W, C); grid: (B, Ho, Wo, 2); g: (B, Ho, Wo, C), the output's
// cotangent; d_img: (B, H, W, C) zeroed by the caller, or null to skip the
// splat; d_grid: (B, Ho, Wo, 2). All fp32, each below 2^31 elements.
RF_API int rf_grid_sample_bwd(const float* img, const float* grid, const float* g,
                              float* d_img, float* d_grid, int B, int H, int W,
                              int C, int Ho, int Wo, cudaStream_t stream) {
  const int total = B * Ho * Wo;
  grid_sample_bwd_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      img, reinterpret_cast<const float2*>(grid), g, d_img,
      reinterpret_cast<float2*>(d_grid), H, W, C, Ho * Wo, total);
  return static_cast<int>(cudaGetLastError());
}
