// Anchor-mode feature resample: a bilinear resize of a pre-normalization
// trunk map to another pyramid scale's grid, then the per-location L2
// normalization, written as bank rows.
//
// Replaces: ransacflow_tpu/pipeline/coarse.py:69-78 _anchor_resample_feats
// and the same step at ransacflow_tpu/pipeline/fused.py:116, which call
// jax.image.resize(fmap, (1, fh, fw, C), 'bilinear') (a triangle kernel with
// half-pixel centres, widened by 1/scale and renormalized on downscale, as a
// dense weight matrix per axis) and then l2_normalize over the channels.
//
// Each output row (column) reads `count` consecutive input rows (columns)
// from `start` with fp32 weights; the wrapper builds these taps once per
// (in size, out size) with the reference's rules and keeps them on the
// device (an axis whose size does not change has the identity tap).
//
// What bounds it on the H100: a serving pair resamples four maps of 1024
// channels (60x80 -> 50x66 and 30x40 -> 25x33 down, 30x40 -> 40x53 and
// 15x20 -> 20x26 up): ~26 MB read and ~28 MB written, ~16 us of HBM traffic
// at 3.35 TB/s, and a few MFLOP. Design: one block per output cell,
// threads over the contiguous channels (coalesced 4-byte loads; the input
// map fits in L2, so the 4-9 input cells a cell reads are mostly L2 hits).
// Each thread sums its channels' taps in tap order (rows inside, columns
// outside, as the plain version's two matrix products), the block reduces
// the square-sum in a fixed order, and the normalized row goes straight to
// its place in the caller's bank. Deterministic.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;  // channels per thread: C <= 2048
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) anchor_resample_kernel(
    const float* __restrict__ in, int w, int c, int fw,
    const int* __restrict__ row_start, const int* __restrict__ row_count,
    const float* __restrict__ row_w, int row_t,
    const int* __restrict__ col_start, const int* __restrict__ col_count,
    const float* __restrict__ col_w, int col_t, float* __restrict__ out) {
  __shared__ float warp_ss[kWarps];
  const int cell = blockIdx.x;
  const int y = cell / fw, x = cell % fw;
  const int r0 = row_start[y], nr = row_count[y];
  const int c0 = col_start[x], nc = col_count[x];
  const float* wr = row_w + static_cast<size_t>(y) * row_t;
  const float* wc = col_w + static_cast<size_t>(x) * col_t;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;
  for (int j = 0; j < nc; ++j) {
    float col[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) col[k] = 0.f;
    for (int i = 0; i < nr; ++i) {
      const float* src = in + (static_cast<size_t>(r0 + i) * w + (c0 + j)) * c;
      const float wi = wr[i];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int ch = threadIdx.x + k * kThreads;
        if (ch < c) col[k] += wi * src[ch];
      }
    }
    const float wj = wc[j];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) acc[k] += wj * col[k];
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) ss += acc[k] * acc[k];  // 0 past C
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) warp_ss[threadIdx.x / 32] = ss;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kWarps; ++i) total += warp_ss[i];  // the same order in every thread
  const float denom = fmaxf(sqrtf(total), 1e-12f);
  float* dst = out + static_cast<size_t>(cell) * c;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int ch = threadIdx.x + k * kThreads;
    if (ch < c) dst[ch] = acc[k] / denom;
  }
}

}  // namespace

// in: (h, w, c) fp32 channels-last; out: (fh * fw, c) rows, any place of a
// larger bank. Taps: row_start/row_count (fh,), row_w (fh, row_t); the same
// for the columns with fw. Needs 1 <= c <= 2048.
RF_API int rf_anchor_resample(const float* in, int w, int c, int fh, int fw,
                              const int* row_start, const int* row_count,
                              const float* row_w, int row_t,
                              const int* col_start, const int* col_count,
                              const float* col_w, int col_t, float* out,
                              cudaStream_t stream) {
  anchor_resample_kernel<<<fh * fw, kThreads, 0, stream>>>(
      in, w, c, fw, row_start, row_count, row_w, row_t, col_start, col_count,
      col_w, col_t, out);
  return static_cast<int>(cudaGetLastError());
}
