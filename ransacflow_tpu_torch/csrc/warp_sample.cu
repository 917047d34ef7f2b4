// Source warp (kernel 5): bilinear sampling of a channels-last image, in two
// forms that share one device function.
//
// Replaces: ransacflow_tpu/ops/homography.py:32 warp_grid followed by
// ransacflow_tpu/ops/sampler.py:240 grid_sample, the fine stage's source warp
// (ransacflow_tpu/pipeline/fine.py:48), and grid_sample alone in the training
// losses.
//   - homography form (rf_warp_homography): per output pixel (i, j) the
//     warp_grid point is evaluated in the kernel: the corner-anchored
//     coordinates (xs[j], ys[i]), handed in as the two torch.linspace(-1, 1)
//     vectors so that the border is exactly +-1, mapped through H (dst ->
//     src) in the order of a k-ascending fp32 dot product, then a plain IEEE
//     divide by the third component. The kernel writes the warped image and
//     that grid (kernel 8 reads the grid) in one launch; H stays on the
//     device.
//   - grid form (rf_warp_sample): the grid is read, as float4 pairs.
// The sampling is torch's grid_sampler_2d (bilinear, zeros, align_corners=
// True): x = ((gx + 1) / 2) * (W - 1), the four corners of floor(x),
// floor(y), each counted only when it lies inside the image, summed in the
// order nw, ne, sw, se.
//
// What bounds it on the H100: at the fine stage's shape (480x640 output,
// 3 channels from a 480x640 source) the homography form reads 3.7 MB of
// source (each byte ~2x, from L1/L2: neighbouring pixels share corners) and
// writes 3.7 MB of image and 2.5 MB of grid: ~3 us at 3.35 TB/s. The old
// form read a 2.5 MB grid built by eight PyTorch launches; here it never
// exists before the kernel. Each thread takes 4 adjacent pixels of a row and
// stores them as 16-byte vectors (C float4 of image, 2 float4 of grid), a
// block a 128 x 4 tile so that a warp's corners share L1 lines, and the
// source is read through the read-only path. A thread whose 4 pixels are not
// 16-byte aligned (a row width not a multiple of 4) or run past the row end
// stores them one by one.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPix = 4;     // adjacent output pixels per thread
constexpr int kTileX = 32;  // threads across a tile: 128 pixels
constexpr int kTileY = 4;   // rows of a tile

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

// The image (one batch entry, (H, W, C)) sampled at normalized (gx, gy).
template <int C>
__device__ __forceinline__ void sample(const float* __restrict__ img, int H,
                                       int W, float gx, float gy, float* v) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = 0.f;
  const float ix = ((gx + 1.f) / 2) * (W - 1);
  const float iy = ((gy + 1.f) / 2) * (H - 1);
  // a point this far out (or NaN) touches no pixel; it would also overflow
  // the integer corner indices
  if (!(fabsf(ix) < 1e9f && fabsf(iy) < 1e9f)) return;
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  const float nw = (fx + 1.f - ix) * (fy + 1.f - iy);
  const float ne = (ix - fx) * (fy + 1.f - iy);
  const float sw = (fx + 1.f - ix) * (iy - fy);
  const float se = (ix - fx) * (iy - fy);
  const bool in_nw = inside(y0, x0, H, W), in_ne = inside(y0, x0 + 1, H, W);
  const bool in_sw = inside(y0 + 1, x0, H, W), in_se = inside(y0 + 1, x0 + 1, H, W);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
    if (in_nw) acc += __ldg(img + (y0 * W + x0) * C + c) * nw;
    if (in_ne) acc += __ldg(img + (y0 * W + x0 + 1) * C + c) * ne;
    if (in_sw) acc += __ldg(img + ((y0 + 1) * W + x0) * C + c) * sw;
    if (in_se) acc += __ldg(img + ((y0 + 1) * W + x0 + 1) * C + c) * se;
    v[c] = acc;
  }
}

// hom != nullptr: the homography form (grid_out written); else the grid
// form (grid_in read). 32-bit index arithmetic: the wrapper keeps every
// tensor below 2^31 elements.
template <int C>
__global__ void __launch_bounds__(kTileX * kTileY) warp_sample_kernel(
    const float* __restrict__ img, const float* __restrict__ grid_in,
    const float* __restrict__ hom, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ out,
    float* __restrict__ grid_out, int H, int W, int Ho, int Wo, int vec) {
  const int b = blockIdx.z;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  const int x0 = (blockIdx.x * kTileX + threadIdx.x) * kPix;
  if (y >= Ho || x0 >= Wo) return;
  const int n = min(kPix, Wo - x0);  // pixels of this thread in the row
  const int p0 = (b * Ho + y) * Wo + x0;
  const bool vector = vec && n == kPix && (p0 % kPix) == 0;

  float gx[kPix], gy[kPix];
  if (hom != nullptr) {
    float m[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) m[k] = __ldg(hom + b * 9 + k);
    const float yv = __ldg(ys + y);
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const float xv = __ldg(xs + x0 + min(k, n - 1));
      // (H @ [x, y, 1])_r summed k-ascending, as the fp32 product does
      const float X = fmaf(m[1], yv, m[0] * xv) + m[2];
      const float Y = fmaf(m[4], yv, m[3] * xv) + m[5];
      const float Z = fmaf(m[7], yv, m[6] * xv) + m[8];
      gx[k] = __fdiv_rn(X, Z);
      gy[k] = __fdiv_rn(Y, Z);
    }
  } else if (vector) {
    const float4* g4 = reinterpret_cast<const float4*>(grid_in + 2 * p0);
    const float4 a = __ldg(g4), c = __ldg(g4 + 1);
    gx[0] = a.x; gy[0] = a.y; gx[1] = a.z; gy[1] = a.w;
    gx[2] = c.x; gy[2] = c.y; gx[3] = c.z; gy[3] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int q = p0 + min(k, n - 1);
      gx[k] = __ldg(grid_in + 2 * q);
      gy[k] = __ldg(grid_in + 2 * q + 1);
    }
  }

  const float* src = img + b * H * W * C;
  float v[kPix * C];
#pragma unroll
  for (int k = 0; k < kPix; ++k) sample<C>(src, H, W, gx[k], gy[k], v + k * C);

  float* o = out + p0 * C;
  if (vector) {
    float4* o4 = reinterpret_cast<float4*>(o);
#pragma unroll
    for (int q = 0; q < C; ++q)
      o4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    if (hom != nullptr) {
      float4* g4 = reinterpret_cast<float4*>(grid_out + 2 * p0);
      g4[0] = make_float4(gx[0], gy[0], gx[1], gy[1]);
      g4[1] = make_float4(gx[2], gy[2], gx[3], gy[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (k >= n) break;
#pragma unroll
      for (int c = 0; c < C; ++c) o[k * C + c] = v[k * C + c];
      if (hom != nullptr) {
        grid_out[2 * (p0 + k)] = gx[k];
        grid_out[2 * (p0 + k) + 1] = gy[k];
      }
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch(const float* img, const float* grid_in, const float* hom,
           const float* xs, const float* ys, float* out, float* grid_out,
           int B, int H, int W, int C, int Ho, int Wo, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 blocks((Wo + kTileX * kPix - 1) / (kTileX * kPix),
                    (Ho + kTileY - 1) / kTileY, B);
  const int vec = aligned16(grid_in) && aligned16(out) && aligned16(grid_out);
  switch (C) {
    case 1:
      warp_sample_kernel<1><<<blocks, block, 0, stream>>>(
          img, grid_in, hom, xs, ys, out, grid_out, H, W, Ho, Wo, vec);
      break;
    case 2:
      warp_sample_kernel<2><<<blocks, block, 0, stream>>>(
          img, grid_in, hom, xs, ys, out, grid_out, H, W, Ho, Wo, vec);
      break;
    case 3:
      warp_sample_kernel<3><<<blocks, block, 0, stream>>>(
          img, grid_in, hom, xs, ys, out, grid_out, H, W, Ho, Wo, vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (B, H, W, C) fp32, C in 1..3; grid: (B, Ho, Wo, 2) fp32; out:
// (B, Ho, Wo, C); each below 2^31 elements, B below 65536.
RF_API int rf_warp_sample(const float* img, const float* grid, float* out,
                          int B, int H, int W, int C, int Ho, int Wo,
                          cudaStream_t stream) {
  return launch(img, grid, nullptr, nullptr, nullptr, out, nullptr, B, H, W,
                C, Ho, Wo, stream);
}

// img: (B, H, W, C) fp32, C in 1..3; hom: (B, 3, 3) fp32 (dst -> src); xs:
// (Wo,) and ys: (Ho,) the torch.linspace(-1, 1) axes; out: (B, Ho, Wo, C);
// grid: (B, Ho, Wo, 2), written. Each below 2^31 elements, B below 65536.
RF_API int rf_warp_homography(const float* img, const float* hom,
                              const float* xs, const float* ys, float* out,
                              float* grid, int B, int H, int W, int C, int Ho,
                              int Wo, cudaStream_t stream) {
  return launch(img, nullptr, hom, xs, ys, out, grid, B, H, W, C, Ho, Wo,
                stream);
}
