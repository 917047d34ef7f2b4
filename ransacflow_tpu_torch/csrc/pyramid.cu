// Lanczos-3 scale pyramid: every non-identity scale of a channels-last RGB
// batch in one launch, as a separable two-pass resize over per-output taps.
//
// Replaces: ransacflow_tpu/pipeline/fused.py:30 device_pyramid, which calls
// jax.image.resize(..., 'lanczos3') once per scale (XLA contracts the image
// with a dense weight matrix per axis, rows first, then columns).
//
// Each output row (column) of a scale reads `count` consecutive input rows
// (columns) from `start` with fp32 weights: the wrapper builds these taps
// once per (in size, out size) with the reference's rules (kernel widened by
// 1/scale on downscale, each column normalized, samples outside the input
// zeroed) and keeps them on the device.
//
// What bounds it on the H100: at the bench shapes (4 x 960x1280x3 into six
// scales down to 240x320) it reads 59 MB and writes ~25 MB, with 12-24 taps
// per axis: ~1 GFLOP, a few tens of microseconds of memory traffic, so a
// launch per scale and per axis (the plain version's 12 matrix products and
// the host time that builds their weights) is what costs. Design: one block
// per (16 x 32 output tile of one scale, image). The block runs the row
// pass for the input columns its tile needs into shared memory, then the
// column pass from there, each tap sum in tap order (a fixed order, so a
// call is deterministic). Blocks of all scales share one grid.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 16;
constexpr int kTileW = 32;
// per-scale metadata, int64 each (see kernels/pyramid.py)
constexpr int kMeta = 11;
enum {
  kH, kW, kRowIdx, kRowW, kRowT, kColIdx, kColW, kColT, kOut, kTile0, kTilesX
};

__global__ void __launch_bounds__(kThreads) pyramid_kernel(
    const float* __restrict__ in, float* __restrict__ out,
    const long long* __restrict__ meta, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ weights,
    int n_scales, int H, int W) {
  extern __shared__ float rows[];  // [kTileH][n_col * 3]
  int s = 0;
  while (s + 1 < n_scales && blockIdx.x >= meta[(s + 1) * kMeta + kTile0]) ++s;
  const long long* m = meta + s * kMeta;
  const int h = static_cast<int>(m[kH]), w = static_cast<int>(m[kW]);
  const int tile = static_cast<int>(blockIdx.x - m[kTile0]);
  const int tiles_x = static_cast<int>(m[kTilesX]);
  const int y0 = (tile / tiles_x) * kTileH, x0 = (tile % tiles_x) * kTileW;
  const int ny = min(kTileH, h - y0), nx = min(kTileW, w - x0);
  const int* rs = starts + m[kRowIdx];
  const int* rc = counts + m[kRowIdx];
  const float* rw = weights + m[kRowW];
  const int rT = static_cast<int>(m[kRowT]);
  const int* cs = starts + m[kColIdx];
  const int* cc = counts + m[kColIdx];
  const float* cw = weights + m[kColW];
  const int cT = static_cast<int>(m[kColT]);
  const int b = blockIdx.y;

  // the input columns [c0, c1) that the tile's output columns read
  int c0 = INT_MAX, c1 = 0;
  for (int x = x0; x < x0 + nx; ++x) {
    if (cc[x] > 0) {
      c0 = min(c0, cs[x]);
      c1 = max(c1, cs[x] + cc[x]);
    }
  }
  if (c1 <= c0) c0 = c1 = 0;
  const int n_q = (c1 - c0) * 3;  // (column, channel) pairs of a row

  // row pass: rows[r][q] = sum_t rw[y][t] * in[rs[y] + t][c0 + q / 3][q % 3]
  const float* img = in + static_cast<size_t>(b) * H * W * 3;
  for (int e = threadIdx.x; e < ny * n_q; e += kThreads) {
    const int r = e / n_q, q = e % n_q;
    const int y = y0 + r;
    const int cnt = rc[y];
    const float* wt = rw + static_cast<size_t>(y) * rT;
    const float* src = img + (static_cast<size_t>(rs[y]) * W + c0) * 3 + q;
    float acc = 0.f;
    for (int t = 0; t < cnt; ++t) {
      acc = fmaf(wt[t], src[static_cast<size_t>(t) * W * 3], acc);
    }
    rows[e] = acc;
  }
  __syncthreads();

  // column pass from shared memory
  // kOut is the scale's offset per image: the batch's scales lie back to back
  float* dst = out + m[kOut] * gridDim.y + static_cast<size_t>(b) * h * w * 3;
  for (int e = threadIdx.x; e < ny * nx * 3; e += kThreads) {
    const int r = e / (nx * 3), q = e % (nx * 3);
    const int x = x0 + q / 3, ch = q % 3;
    const int cnt = cc[x];
    const float* wt = cw + static_cast<size_t>(x) * cT;
    const float* src = rows + r * n_q + (cs[x] - c0) * 3 + ch;
    float acc = 0.f;
    for (int t = 0; t < cnt; ++t) acc = fmaf(wt[t], src[t * 3], acc);
    dst[(static_cast<size_t>(y0 + r) * w + x) * 3 + ch] = acc;
  }
}

}  // namespace

// in: (B, H, W, 3) fp32; out: the scales' (B, h, w, 3) outputs back to back,
// at the offsets `meta` gives; smem_bytes: kTileH * (widest column span) * 3
// floats, computed by the wrapper from the taps.
RF_API int rf_lanczos_pyramid(const float* in, float* out, const long long* meta,
                              const int* starts, const int* counts,
                              const float* weights, int n_scales, int n_tiles,
                              int B, int H, int W, int smem_bytes,
                              cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_tiles, B);
  pyramid_kernel<<<grid, kThreads, smem_bytes, stream>>>(
      in, out, meta, starts, counts, weights, n_scales, H, W);
  return static_cast<int>(cudaGetLastError());
}
