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
// cotangent: ~20-60 MB of traffic, so memory and the contention of the
// atomic adds bound it, not arithmetic. Adding every corner straight into
// device memory costs 4 * C atomics in L2 per point, and neighbouring points
// hit the same pixels. So a block owns a 32 x 8 tile of output points (one
// per thread), reads the four corners once for both cotangents, and reduces
// the box of pixels its corners touch. Where box * C floats fit the 24 KB
// shared budget the block splats into a shared accumulator with on-SM
// atomics and
// then adds the box into the image cotangent, one global atomic per touched
// (pixel, channel) (a float2 vector atomic at C = 2), skipping entries that
// stayed 0: on a smooth grid ~1.15 * C global atomics per point instead of
// 4 * C. A tile whose box does not fit (large displacements, folds) adds its
// corners straight into device memory, as before. Both orders change from
// run to run: the image cotangent is not bit-wise deterministic. Thread 0 of
// each splatting block counts its tile as shared (or empty) or global in
// `tiles`, a reading for the caller. The splat is skipped when the image
// needs no cotangent.
#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace {

constexpr int kTileX = 32, kTileY = 8, kThreads = kTileX * kTileY;
// The shared accumulator of a splatting block. Of the budgets tried on the
// H100 (16, 24, 32 and 48 KB), 24 KB is the smallest that keeps >= 90% of the
// tiles of an upsampled random flow's grid on the shared path; every tile of
// the training step's own grids fits at any of them. Below 48 KB a launch
// needs no opt-in, and 8 blocks of 256 threads still fit an SM.
constexpr int kSmemBytes = 24 * 1024, kSmemFloats = kSmemBytes / 4;

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// dst[0..C) += v[0..C): one vector atomic at C = 2, else one per channel.
template <int C>
__device__ __forceinline__ void add_pixel(float* dst, const float* v) {
  if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(dst + c, v[c]);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) grid_sample_bwd_kernel(
    const float* __restrict__ img, const float2* __restrict__ grid,
    const float* __restrict__ g, float* __restrict__ d_img,
    float2* __restrict__ d_grid, int H, int W, int Ho, int Wo,
    unsigned long long* __restrict__ tiles) {
  extern __shared__ float acc[];
  __shared__ int box[4];  // min x, min y, -max x, -max y of the touched pixels
  const int b = blockIdx.z;
  const int xo = blockIdx.x * kTileX + threadIdx.x;
  const int yo = blockIdx.y * kTileY + threadIdx.y;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const bool splat = d_img != nullptr;  // uniform over the launch
  if (splat && tid == 0) box[0] = box[1] = box[2] = box[3] = INT_MAX;

  // this point's corners, their weights times the cotangent, and d_grid
  const float* img_b = img + b * H * W * C;
  int x0 = 0, y0 = 0;
  bool in00 = false, in10 = false, in01 = false, in11 = false;
  float w00[C], w10[C], w01[C], w11[C];
  if (xo < Wo && yo < Ho) {
    const int p = (b * Ho + yo) * Wo + xo;
    const float2 gp = grid[p];
    const float ix = ((gp.x + 1.f) / 2) * (W - 1);
    const float iy = ((gp.y + 1.f) / 2) * (H - 1);
    if (!(fabsf(ix) < 1e9f && fabsf(iy) < 1e9f)) {  // touches no pixel
      d_grid[p] = make_float2(0.f, 0.f);
    } else {
      const float fx0 = floorf(ix), fy0 = floorf(iy);
      x0 = static_cast<int>(fx0);
      y0 = static_cast<int>(fy0);
      const float fx = ix - fx0, fy = iy - fy0;
      in00 = inside(y0, x0, H, W);
      in10 = inside(y0, x0 + 1, H, W);
      in01 = inside(y0 + 1, x0, H, W);
      in11 = inside(y0 + 1, x0 + 1, H, W);
      const float* gq = g + p * C;
      float gx = 0.f, gy = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float gc = __ldg(gq + c);
        const float v00 = in00 ? __ldg(img_b + (y0 * W + x0) * C + c) : 0.f;
        const float v10 = in10 ? __ldg(img_b + (y0 * W + x0 + 1) * C + c) : 0.f;
        const float v01 = in01 ? __ldg(img_b + ((y0 + 1) * W + x0) * C + c) : 0.f;
        const float v11 = in11 ? __ldg(img_b + ((y0 + 1) * W + x0 + 1) * C + c) : 0.f;
        gx += gc * ((1.f - fy) * (v10 - v00) + fy * (v11 - v01));
        gy += gc * ((1.f - fx) * (v01 - v00) + fx * (v11 - v10));
        w00[c] = (1.f - fx) * (1.f - fy) * gc;
        w10[c] = fx * (1.f - fy) * gc;
        w01[c] = (1.f - fx) * fy * gc;
        w11[c] = fx * fy * gc;
      }
      d_grid[p] = make_float2(gx * ((W - 1) * 0.5f), gy * ((H - 1) * 0.5f));
    }
  }
  if (!splat) return;

  // the box of the pixels the tile touches, clamped to the image
  const bool touch = in00 || in10 || in01 || in11;
  int lo_x = INT_MAX, lo_y = INT_MAX, nhi_x = INT_MAX, nhi_y = INT_MAX;
  if (touch) {
    lo_x = max(x0, 0);
    lo_y = max(y0, 0);
    nhi_x = -min(x0 + 1, W - 1);
    nhi_y = -min(y0 + 1, H - 1);
  }
  lo_x = __reduce_min_sync(0xffffffffu, lo_x);
  lo_y = __reduce_min_sync(0xffffffffu, lo_y);
  nhi_x = __reduce_min_sync(0xffffffffu, nhi_x);
  nhi_y = __reduce_min_sync(0xffffffffu, nhi_y);
  __syncthreads();  // box initialised
  if ((tid & 31) == 0 && lo_x != INT_MAX) {
    atomicMin(&box[0], lo_x);
    atomicMin(&box[1], lo_y);
    atomicMin(&box[2], nhi_x);
    atomicMin(&box[3], nhi_y);
  }
  __syncthreads();
  const int bx = box[0], by = box[1];
  float* dst = d_img + b * H * W * C;
  if (bx == INT_MAX) {  // no corner of the tile lies inside the image
    if (tid == 0) atomicAdd(tiles, 1ull);
    return;
  }
  const int bw = -box[2] - bx + 1, bh = -box[3] - by + 1;
  const bool fits = static_cast<long long>(bw) * bh * C <= kSmemFloats;  // uniform
  if (tid == 0) atomicAdd(tiles + (fits ? 0 : 1), 1ull);

  if (!fits) {  // global path: each corner straight into device memory
    if (in00) add_pixel<C>(dst + (y0 * W + x0) * C, w00);
    if (in10) add_pixel<C>(dst + (y0 * W + x0 + 1) * C, w10);
    if (in01) add_pixel<C>(dst + ((y0 + 1) * W + x0) * C, w01);
    if (in11) add_pixel<C>(dst + ((y0 + 1) * W + x0 + 1) * C, w11);
    return;
  }

  // shared path: zero the box, splat on the SM, add the box once
  const int n_px = bw * bh;
  for (int i = tid; i < n_px * C; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const int q00 = ((y0 - by) * bw + (x0 - bx)) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (in00) atomicAdd(acc + (q00 + c), w00[c]);
    if (in10) atomicAdd(acc + (q00 + C + c), w10[c]);
    if (in01) atomicAdd(acc + (q00 + bw * C + c), w01[c]);
    if (in11) atomicAdd(acc + (q00 + (bw + 1) * C + c), w11[c]);
  }
  __syncthreads();
  for (int q = tid; q < n_px; q += kThreads) {
    const int r = q / bw, col = q - r * bw;
    const float* s = acc + q * C;
    float v[C];
    bool any = false;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = s[c];
      any = any || v[c] != 0.f;
    }
    if (!any) continue;  // a pixel no corner reached (or a sum of zeros)
    float* d = dst + ((by + r) * W + bx + col) * C;
    if constexpr (C == 2) {
      add_pixel<2>(d, v);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (v[c] != 0.f) atomicAdd(d + c, v[c]);
    }
  }
}

template <int C>
int launch(const float* img, const float* grid, const float* g, float* d_img,
           float* d_grid, unsigned long long* tiles, int B, int H, int W,
           int Ho, int Wo, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 blocks((Wo + kTileX - 1) / kTileX, (Ho + kTileY - 1) / kTileY, B);
  const int smem = d_img != nullptr ? kSmemBytes : 0;
  grid_sample_bwd_kernel<C><<<blocks, block, smem, stream>>>(
      img, reinterpret_cast<const float2*>(grid), g, d_img,
      reinterpret_cast<float2*>(d_grid), H, W, Ho, Wo, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (B, H, W, C), C in 1..3; grid: (B, Ho, Wo, 2); g: (B, Ho, Wo, C), the
// output's cotangent; d_img: (B, H, W, C) zeroed by the caller, or null to
// skip the splat; d_grid: (B, Ho, Wo, 2). All fp32, each below 2^31
// elements, B below 65536, grid and d_img 8-byte aligned. tiles: 2 counters,
// the splatting tiles that took the shared path (or touched nothing) and
// those that took the global path.
RF_API int rf_grid_sample_bwd(const float* img, const float* grid, const float* g,
                              float* d_img, float* d_grid, unsigned long long* tiles,
                              int B, int H, int W, int C, int Ho, int Wo,
                              cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch<1>(img, grid, g, d_img, d_grid, tiles, B, H, W, Ho, Wo, stream);
    case 2:
      return launch<2>(img, grid, g, d_img, d_grid, tiles, B, H, W, Ho, Wo, stream);
    case 3:
      return launch<3>(img, grid, g, d_img, d_grid, tiles, B, H, W, Ho, Wo, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
