// Masked SSIM reconstruction loss and its backward with respect to img1.
//
// Replaces: ransacflow_tpu/ops/ssim.py:57 masked_ssim_loss (ten separable
// depthwise XLA convolutions, products and a masked ratio reduction) and the
// TPU's autodiff of it in training.
//
//   mask = (box11(match) + 1e-7 > 0.5) + 1e-7          (zero "same" padding)
//   mu1 = G*x, mu2 = G*y, s11 = G*x^2 - mu1^2, s22 = G*y^2 - mu2^2,
//   s12 = G*xy - mu1 mu2      (G the 11-tap Gaussian, sigma 1.5, separable)
//   S = (2 mu1 mu2 + C1)(2 s12 + C2) / ((mu1^2 + mu2^2 + C1)(s11 + s22 + C2))
//   loss = sum((1 - S) * mask) / sum(mask) / 3
//
// What bounds it on the H100: at the training shape (32 x 224 x 224 x 3)
// the five blurred maps are 22 taps each per pixel and channel (~1 GFLOP),
// over 19 MB of input: neither bound is near, the plain version's cost is
// its ten convolution launches and the intermediate maps they write. Design:
// one block per (16 x 32 pixel tile, image). The block stages the tile with
// a 5-pixel halo in shared memory, runs the vertical then the horizontal
// pass of the box (mask) and Gaussian (five maps) filters from there, and
// writes only per-block partial sums of (1 - S) * mask and of mask; one
// block then adds the partials in a fixed order, so the loss is
// deterministic. When img1 needs a gradient, the forward also writes the
// per-pixel partials of (1 - S) * mask with respect to mu1, G*x^2 and G*xy
// (a, b, c). The backward blurs those with the same Gaussian (self-adjoint
// under zero "same" padding) and writes
//   dimg1 = g / (3 sum(mask)) * (G*a + 2 x G*b + y G*c),
// reading g and sum(mask) from the device, so nothing is read back.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 16, kTileW = 32;
constexpr int kR = 5;                          // halo: an 11-tap window
constexpr int kTaps = 2 * kR + 1;
constexpr int kInH = kTileH + 2 * kR;           // 26 staged rows
constexpr int kInW = kTileW + 2 * kR;           // 42 staged columns
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;  // 2
constexpr float kC1 = 0.01f * 0.01f, kC2 = 0.03f * 0.03f;

// Stage rows [y0 - kR, y0 + kTileH + kR) x cols [x0 - kR, x0 + kTileW + kR)
// of channel ch of a (H, W, C) map into s[kInH][kInW], zeros outside.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* s,
                                      int y0, int x0, int H, int W, int C, int ch) {
  for (int e = threadIdx.x; e < kInH * kInW; e += kThreads) {
    const int r = e / kInW, q = e % kInW;
    const int y = y0 - kR + r, x = x0 - kR + q;
    s[e] = (y >= 0 && y < H && x >= 0 && x < W)
               ? src[(static_cast<size_t>(y) * W + x) * C + ch] : 0.f;
  }
}

// Fixed-order sum of a block's values; the result is valid in thread 0.
__device__ float block_sum(float v, float* scratch) {
  scratch[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) scratch[threadIdx.x] += scratch[threadIdx.x + s];
    __syncthreads();
  }
  const float out = scratch[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads) ssim_fwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ match, const float* __restrict__ gauss, float box,
    float* __restrict__ partials, float* __restrict__ abc, int B, int H, int W) {
  __shared__ float s1[kInH * kInW], s2[kInH * kInW];
  __shared__ float sv[5][kTileH * kInW];
  __shared__ float scratch[kThreads];
  __shared__ float g[kTaps];
  if (threadIdx.x < kTaps) g[threadIdx.x] = gauss[threadIdx.x];
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int b = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;

  // the mask: box filter of match, thresholded
  stage(match + b * plane, s1, y0, x0, H, W, 1, 0);
  __syncthreads();
  for (int e = threadIdx.x; e < kTileH * kInW; e += kThreads) {
    const int r = e / kInW, q = e % kInW;
    float acc = 0.f;
    for (int t = 0; t < kTaps; ++t) acc = fmaf(box, s1[(r + t) * kInW + q], acc);
    sv[0][e] = acc;
  }
  __syncthreads();
  float mask[kRowsPerThread];
  float num = 0.f, den = 0.f;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * (kThreads / kTileW);
    float acc = 0.f;
    for (int t = 0; t < kTaps; ++t) acc = fmaf(box, sv[0][r * kInW + tx + t], acc);
    mask[k] = ((acc + 1e-7f > 0.5f) ? 1.f : 0.f) + 1e-7f;
    if (y0 + r < H && x0 + tx < W) den += mask[k];
  }
  __syncthreads();

  for (int ch = 0; ch < 3; ++ch) {
    stage(img1 + b * plane * 3, s1, y0, x0, H, W, 3, ch);
    stage(img2 + b * plane * 3, s2, y0, x0, H, W, 3, ch);
    __syncthreads();
    for (int e = threadIdx.x; e < kTileH * kInW; e += kThreads) {
      const int r = e / kInW, q = e % kInW;
      float m1 = 0.f, m2 = 0.f, e11 = 0.f, e22 = 0.f, e12 = 0.f;
      for (int t = 0; t < kTaps; ++t) {
        const float u = s1[(r + t) * kInW + q], v = s2[(r + t) * kInW + q];
        m1 = fmaf(g[t], u, m1);
        m2 = fmaf(g[t], v, m2);
        e11 = fmaf(g[t], u * u, e11);
        e22 = fmaf(g[t], v * v, e22);
        e12 = fmaf(g[t], u * v, e12);
      }
      sv[0][e] = m1; sv[1][e] = m2; sv[2][e] = e11; sv[3][e] = e22; sv[4][e] = e12;
    }
    __syncthreads();
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = ty + k * (kThreads / kTileW);
      const int y = y0 + r, x = x0 + tx;
      float f[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < kTaps; ++t) {
#pragma unroll
        for (int n = 0; n < 5; ++n) f[n] = fmaf(g[t], sv[n][r * kInW + tx + t], f[n]);
      }
      const float mu1 = f[0], mu2 = f[1];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float s11 = f[2] - mu1_sq, s22 = f[3] - mu2_sq, s12 = f[4] - mu1_mu2;
      const float a1 = 2.f * mu1_mu2 + kC1, a2 = 2.f * s12 + kC2;
      const float b1 = mu1_sq + mu2_sq + kC1, b2 = s11 + s22 + kC2;
      const float ssim = (a1 * a2) / (b1 * b2);
      if (y < H && x < W) {
        num += (1.f - ssim) * mask[k];
        if (abc != nullptr) {
          // partials of (1 - S) * mask w.r.t. mu1, G*x^2 and G*xy
          const float inv = 1.f / (b1 * b2);
          const float d_mu1 = 2.f * mu2 * (a2 - a1) * inv
                              - 2.f * mu1 * ssim * (1.f / b1 - 1.f / b2);
          const size_t o = ((b * plane) + static_cast<size_t>(y) * W + x) * 3 + ch;
          const size_t n3 = static_cast<size_t>(B) * plane * 3;
          abc[o] = -mask[k] * d_mu1;
          abc[n3 + o] = mask[k] * ssim / b2;
          abc[2 * n3 + o] = -mask[k] * 2.f * a1 * inv;
        }
      }
    }
    __syncthreads();
  }
  num = block_sum(num, scratch);
  den = block_sum(den, scratch);
  if (threadIdx.x == 0) {
    const size_t blk = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    partials[2 * blk] = num;
    partials[2 * blk + 1] = den;
  }
}

// One block: sums = (sum num, sum den), loss = num / den / 3, in a fixed
// order.
__global__ void __launch_bounds__(1024) ssim_reduce_kernel(
    const float* __restrict__ partials, int n_blocks, float* __restrict__ sums,
    float* __restrict__ loss) {
  __shared__ float sn[1024], sd[1024];
  float num = 0.f, den = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += 1024) {
    num += partials[2 * i];
    den += partials[2 * i + 1];
  }
  sn[threadIdx.x] = num;
  sd[threadIdx.x] = den;
  __syncthreads();
  for (int s = 512; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sn[threadIdx.x] += sn[threadIdx.x + s];
      sd[threadIdx.x] += sd[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[0] = sn[0];
    sums[1] = sd[0];
    loss[0] = sn[0] / sd[0] / 3.f;
  }
}

__global__ void __launch_bounds__(kThreads) ssim_bwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ abc, const float* __restrict__ gauss,
    const float* __restrict__ sums, const float* __restrict__ gout,
    float* __restrict__ d_img1, int B, int H, int W) {
  __shared__ float sa[3][kInH * kInW];
  __shared__ float sv[3][kTileH * kInW];
  __shared__ float g[kTaps];
  if (threadIdx.x < kTaps) g[threadIdx.x] = gauss[threadIdx.x];
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const int b = blockIdx.y;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t n3 = static_cast<size_t>(B) * plane * 3;
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const float scale = gout[0] / (3.f * sums[1]);

  for (int ch = 0; ch < 3; ++ch) {
    for (int n = 0; n < 3; ++n) stage(abc + n * n3 + b * plane * 3, sa[n], y0, x0, H, W, 3, ch);
    __syncthreads();
    for (int e = threadIdx.x; e < kTileH * kInW; e += kThreads) {
      const int r = e / kInW, q = e % kInW;
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        float acc = 0.f;
        for (int t = 0; t < kTaps; ++t) acc = fmaf(g[t], sa[n][(r + t) * kInW + q], acc);
        sv[n][e] = acc;
      }
    }
    __syncthreads();
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = ty + k * (kThreads / kTileW);
      const int y = y0 + r, x = x0 + tx;
      float f[3] = {0.f, 0.f, 0.f};
      for (int t = 0; t < kTaps; ++t) {
#pragma unroll
        for (int n = 0; n < 3; ++n) f[n] = fmaf(g[t], sv[n][r * kInW + tx + t], f[n]);
      }
      if (y < H && x < W) {
        const size_t o = ((b * plane) + static_cast<size_t>(y) * W + x) * 3 + ch;
        d_img1[o] = scale * (f[0] + 2.f * img1[o] * f[1] + img2[o] * f[2]);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// img1, img2: (B, H, W, 3); match: (B, H, W, 1); gauss: the 11 taps; box:
// the box tap (1/11); partials: 2 floats per block of kTileH x kTileW pixels
// of one image; abc: (3, B, H, W, 3) or
// null when img1 needs no gradient; sums: (2,) = (sum num, sum den); loss:
// a scalar.
// All fp32 on the device; each tensor below 2^31 elements.
RF_API int rf_ssim_fwd(const float* img1, const float* img2, const float* match,
                       const float* gauss, float box, float* partials, float* abc,
                       float* sums, float* loss, int B, int H, int W,
                       cudaStream_t stream) {
  const int tiles = ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  ssim_fwd_kernel<<<dim3(tiles, B), kThreads, 0, stream>>>(
      img1, img2, match, gauss, box, partials, abc, B, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_reduce_kernel<<<1, 1024, 0, stream>>>(partials, tiles * B, sums, loss);
  return static_cast<int>(cudaGetLastError());
}

// sums: rf_ssim_fwd's sums; gout: the loss's cotangent (a device scalar);
// d_img1: (B, H, W, 3).
RF_API int rf_ssim_bwd(const float* img1, const float* img2, const float* abc,
                       const float* gauss, const float* sums, const float* gout,
                       float* d_img1, int B, int H, int W, cudaStream_t stream) {
  const int tiles = ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  ssim_bwd_kernel<<<dim3(tiles, B), kThreads, 0, stream>>>(
      img1, img2, abc, gauss, sums, gout, d_img1, B, H, W);
  return static_cast<int>(cudaGetLastError());
}
