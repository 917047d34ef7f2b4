// PPM pooling of the sky-mask network: the adaptive average pools of every
// pyramid scale (1, 2, 3, 6: 50 bins) of a channels-last map in one call.
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
// 400 KB. Read once, that is ~7 us of HBM traffic at 3.35 TB/s (less where
// the encoder left the map in the 50 MB L2), and 4 adds per element.
//
// Design: the bins of the four scales overlap and do not nest, but the
// union of every bin edge on an axis cuts it into segments (11 rows and 9
// columns at 47 x 63) such that every bin is a rectangle of segment cells.
// The host builds that plan (`kernels/adaptive_pool.segment_plan`). Two
// device kernels, one call:
//   1. ppm_cells_kernel reads the map once: a block per (segment cell,
//      128-channel slice, image), 4 warps over the cell's pixels in
//      row-major order, 8 loads in flight a lane, a lane 4 channels by one
//      16-byte load (4-byte loads when C % 4 != 0 or the base is not 16-byte
//      aligned, a lane then one channel of a 32-channel slice). A cell holds
//      at most ~1/36 of the map (a scale-6 bin's), so no block reads much
//      more than its share (1584 blocks at 47 x 63); the warps' sums are
//      added in warp order into one partial per (cell, channel).
//   2. ppm_bins_kernel sums each bin's cells (6 warps over the cells in
//      row-major order, then in warp order) and divides by its pixel count;
//      its 800 blocks at 47 x 63 fit the card in one wave.
// Every sum runs in a fixed order, without atomics: a call is deterministic.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;     // a warp: 32 channels, or 32 float4 of channels
constexpr int kCellWarps = 4;  // a cells block: 4 warps over one cell's pixels
constexpr int kBinWarps = 6;   // a bins block: 6 warps over one bin's cells

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ float4 divide(const float4& a, float n) {
  return make_float4(a.x / n, a.y / n, a.z / n, a.w / n);
}
__device__ __forceinline__ float divide(float a, float n) { return a / n; }

// The W warps' partial sums added in warp order by the first warp, which
// returns true with the total in `acc`.
template <int W, class T>
__device__ __forceinline__ bool block_sum(T& acc) {
  __shared__ T part[W][kLanes];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0) return false;
#pragma unroll
  for (int w = 1; w < W; ++w) add(acc, part[w][threadIdx.x]);
  return true;
}

// T = float4: C4 = C / 4 groups of 4 channels; T = float: C4 = C.
template <class T>
__global__ void __launch_bounds__(kLanes * kCellWarps) ppm_cells_kernel(
    const T* __restrict__ in, int H, int W, int C4, const int* __restrict__ row_edges,
    const int* __restrict__ col_edges, int n_col_segs, int n_cells, T* __restrict__ cells) {
  const int cell = blockIdx.x;
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  const int b = blockIdx.z;
  const int rs = cell / n_col_segs, cs = cell - rs * n_col_segs;
  const int r0 = row_edges[rs], c0 = col_edges[cs];
  const int cw = col_edges[cs + 1] - c0;
  const int n_px = (row_edges[rs + 1] - r0) * cw;
  T acc = {};
  if (ch < C4) {
    const T* img = in + static_cast<size_t>(b) * H * W * C4 + ch;
#pragma unroll 8
    for (int p = threadIdx.y; p < n_px; p += kCellWarps) {
      const int dr = p / cw;
      add(acc, img[static_cast<size_t>((r0 + dr) * W + c0 + p - dr * cw) * C4]);
    }
  }
  if (block_sum<kCellWarps>(acc) && ch < C4) {
    cells[(static_cast<size_t>(b) * n_cells + cell) * C4 + ch] = acc;
  }
}

// bins: (n_bins, 4) rows of segment ranges (rs0, rs1, cs0, cs1).
template <class T>
__global__ void __launch_bounds__(kLanes * kBinWarps) ppm_bins_kernel(
    const T* __restrict__ cells, int C4, const int* __restrict__ row_edges,
    const int* __restrict__ col_edges, int n_col_segs, int n_cells,
    const int* __restrict__ bins, int n_bins, T* __restrict__ out) {
  const int bin = blockIdx.x;
  const int ch = blockIdx.y * kLanes + threadIdx.x;
  const int b = blockIdx.z;
  const int rs0 = bins[4 * bin], rs1 = bins[4 * bin + 1];
  const int cs0 = bins[4 * bin + 2], cs1 = bins[4 * bin + 3];
  const int ncs = cs1 - cs0, n = (rs1 - rs0) * ncs;
  T acc = {};
  if (ch < C4) {
    const T* img = cells + static_cast<size_t>(b) * n_cells * C4 + ch;
#pragma unroll 4
    for (int k = threadIdx.y; k < n; k += kBinWarps) {
      const int dr = k / ncs;
      add(acc, img[static_cast<size_t>((rs0 + dr) * n_col_segs + cs0 + k - dr * ncs) * C4]);
    }
  }
  if (block_sum<kBinWarps>(acc) && ch < C4) {
    const int count = (row_edges[rs1] - row_edges[rs0]) * (col_edges[cs1] - col_edges[cs0]);
    out[(static_cast<size_t>(b) * n_bins + bin) * C4 + ch] =
        divide(acc, static_cast<float>(count));
  }
}

template <class T>
int launch(const float* in, int B, int H, int W, int C4, const int* plan, int n_row_segs,
           int n_col_segs, int n_bins, float* cells, float* out, cudaStream_t stream) {
  const int* row_edges = plan;
  const int* col_edges = plan + n_row_segs + 1;
  const int* bins = col_edges + n_col_segs + 1;
  const int n_cells = n_row_segs * n_col_segs;
  const unsigned slices = (C4 + kLanes - 1) / kLanes;
  ppm_cells_kernel<T><<<dim3(n_cells, slices, B), dim3(kLanes, kCellWarps), 0, stream>>>(
      reinterpret_cast<const T*>(in), H, W, C4, row_edges, col_edges, n_col_segs, n_cells,
      reinterpret_cast<T*>(cells));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ppm_bins_kernel<T><<<dim3(n_bins, slices, B), dim3(kLanes, kBinWarps), 0, stream>>>(
      reinterpret_cast<const T*>(cells), C4, row_edges, col_edges, n_col_segs, n_cells, bins,
      n_bins, reinterpret_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: (B, H, W, C) fp32 channels-last; plan: int32, the row edges
// (n_row_segs + 1), the column edges (n_col_segs + 1) and (n_bins, 4) rows
// of (rs0, rs1, cs0, cs1); cells: (B, n_row_segs * n_col_segs, C) scratch;
// out: (B, n_bins, C). `in`, `cells` and `out` 16-byte aligned with C % 4
// == 0 take 16-byte loads.
RF_API int rf_ppm_pool(const float* in, int B, int H, int W, int C, const int* plan,
                       int n_row_segs, int n_col_segs, int n_bins, float* cells, float* out,
                       cudaStream_t stream) {
  const bool vec = C % 4 == 0 && (reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(cells) |
                                  reinterpret_cast<size_t>(out)) % 16 == 0;
  return vec ? launch<float4>(in, B, H, W, C / 4, plan, n_row_segs, n_col_segs, n_bins, cells,
                              out, stream)
             : launch<float>(in, B, H, W, C, plan, n_row_segs, n_col_segs, n_bins, cells, out,
                             stream);
}
