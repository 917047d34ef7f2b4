// PPM pooling of the sky-mask network: the adaptive average pools of every
// pyramid scale (1, 2, 3, 6: 50 bins) of a channels-last map in one launch.
//
// Replaces: ransacflow_tpu/models/segnet.py:148 _adaptive_avg_pool, torch
// AdaptiveAvgPool2d semantics (bin i of s spans [floor(i*H/s),
// ceil((i+1)*H/s)) on each axis), which the decoder calls once per scale and
// so reads conv5 four times.
//
// Route: CUDA C++ rather than Triton. It is a plain reduction that Triton
// would express as well, but this way it is compiled with the other kernels
// by the one nvcc build the library pays for, instead of a Triton compile
// per shape at its first launch on the card.
//
// What bounds it on the H100: conv5 is (1, 47, 63, 2048) fp32 for a 480x640
// image (24 MB) and (1, 38, 50, 2048) at the short side 300; the 50 bins are
// 400 KB. Each scale's bins cover the map once, so the four scales read it
// 4 times (~96 MB from L2 or HBM; the map is first read from HBM), ~7 us of
// HBM traffic for one read at 3.35 TB/s, and 4 adds per element. Design: one
// block per (bin, 32-channel slice, image) of 32 x 8 threads: a warp reads 32
// neighbouring channels of one cell (128 coalesced bytes), the 8 warps take
// every 8th row of the bin, each summing a row's cells in order and adding
// the row sums in order, and the first warp adds the 8 partial sums in warp
// order and divides by the cell count. The big bins of scale 1 and 2 so
// spread over 8 warps; a call is deterministic.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kRows = 8;    // warps, each over every kRows-th row of the bin

__global__ void __launch_bounds__(kLanes * kRows) ppm_pool_kernel(
    const float* __restrict__ in, int H, int W, int C,
    const int* __restrict__ bins, int n_bins, float* __restrict__ out) {
  __shared__ float part[kRows][kLanes];
  const int bin = blockIdx.x;
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = bins[4 * bin], r1 = bins[4 * bin + 1];
  const int c0 = bins[4 * bin + 2], c1 = bins[4 * bin + 3];
  float acc = 0.f;
  if (ch < C) {
    const float* img = in + static_cast<size_t>(b) * H * W * C + ch;
    for (int r = r0 + threadIdx.y; r < r1; r += kRows) {
      const float* row = img + static_cast<size_t>(r) * W * C;
      float rs = 0.f;
      for (int col = c0; col < c1; ++col) rs += row[static_cast<size_t>(col) * C];
      acc += rs;
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && ch < C) {
    float total = 0.f;
    for (int i = 0; i < kRows; ++i) total += part[i][threadIdx.x];
    out[(static_cast<size_t>(b) * n_bins + bin) * C + ch] =
        total / static_cast<float>((r1 - r0) * (c1 - c0));
  }
}

}  // namespace

// in: (B, H, W, C) fp32 channels-last; bins: (n_bins, 4) int32 rows of
// (r0, r1, c0, c1); out: (B, n_bins, C).
RF_API int rf_ppm_pool(const float* in, int B, int H, int W, int C,
                       const int* bins, int n_bins, float* out,
                       cudaStream_t stream) {
  const dim3 grid(n_bins, (C + kLanes - 1) / kLanes, B);
  ppm_pool_kernel<<<grid, dim3(kLanes, kRows), 0, stream>>>(in, H, W, C, bins,
                                                            n_bins, out);
  return static_cast<int>(cudaGetLastError());
}
