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
// What bounds it on the H100: at the serving pyramid (4 x 960x1280x3 into
// six scales down to 240x320) it reads 59 MB and writes 101 MB (bound ~0.048
// ms by bytes) and does ~0.8 G multiply-adds, 8 to 24 taps per axis: rows
// first, each scale's vertical taps run at the input's width, ~6 H W 3
// multiply-adds per image whatever the scale. A design that reads each tap
// from memory re-reads every input value about 6/r times (r the scale's
// ratio). Design: one block per (scale, strip of output columns, band of
// output rows, image), 256 threads. The block copies every input row its
// band reads (the floats [q0, q0 + nq) of each, W * 3 contiguous floats a
// row, the span widened to multiples of 4) into shared memory in one go, as
// 16-byte cp.async copies, and its row and column taps behind them; then
// each thread runs the vertical taps of (output row, float4 of the span)
// items into intermediate rows, and, after a barrier, the horizontal taps
// of (four output rows, column, channel) items, a weight read once for the
// four rows. A thread keeps its float4 (its column and channel) and steps
// over rows, so that no item costs a division, and the per-scale table is
// a kernel parameter (the constant bank): nothing on a block's way to its
// copies waits on device memory but its strip's and band's entries. The
// strip and band sizes are the wrapper's (`kernels/pyramid.schedule`: the
// widest strip whose span stays within 256 floats, the tallest band whose
// block fits 55 KB, so that 4 blocks share an SM and one block's copies
// overlap another's arithmetic); the CPU tests check that every tap lies
// among the staged rows. Neighbouring bands re-read their overlap (6/r
// rows) from L2. Each tap sum runs in tap order from 0 (rows first), one
// fmaf chain per output: deterministic.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQuad = 4;       // output rows of a horizontal item (tmp holds whole quads)
constexpr int kMaxScales = 16;  // MAX_SCALES in kernels/pyramid.py
constexpr int kMeta = 16;  // per-scale fields (META in kernels/pyramid.py)
enum {
  kH, kW, kRowIdx, kRowW, kRowT, kColIdx, kColW, kColT, kOut, kBlock0, kStrips,
  kStripW, kBandRows, kStride, kStrip, kBand
};

// The schedule's per-scale table, a kernel parameter: read from the constant
// bank, it costs a block no round trip to device memory.
struct Scales {
  long long f[kMaxScales][kMeta];
  int n;
};

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__global__ void __launch_bounds__(kThreads) pyramid_kernel(
    const float* __restrict__ in, float* __restrict__ out, const __grid_constant__ Scales sc,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ weights, const int* __restrict__ strips,
    const int* __restrict__ bands, int H, int W, bool vec) {
  extern __shared__ float4 smem4[];
  int s = 0;
  while (s + 1 < sc.n && blockIdx.x >= sc.f[s + 1][kBlock0]) ++s;
  const long long* m = sc.f[s];
  const int h = static_cast<int>(m[kH]), w = static_cast<int>(m[kW]);
  const int n_strips = static_cast<int>(m[kStrips]);
  const int sw = static_cast<int>(m[kStripW]);
  const int bh = static_cast<int>(m[kBandRows]);
  const int stride = static_cast<int>(m[kStride]);
  const int rT = static_cast<int>(m[kRowT]), cT = static_cast<int>(m[kColT]);
  const int blk = static_cast<int>(blockIdx.x - m[kBlock0]);
  const int strip = blk % n_strips, band = blk / n_strips;
  const int x0 = strip * sw, nx = min(sw, w - x0);
  const int y0 = band * bh, ny = min(bh, h - y0);
  const int2 span = reinterpret_cast<const int2*>(strips + m[kStrip])[strip];
  const int2 rows_read = reinterpret_cast<const int2*>(bands + m[kBand])[band];
  const int q0 = span.x, nq = span.y;
  const int lo = rows_read.x, n_rows = rows_read.y;  // the input rows the band reads
  const int tid = threadIdx.x;

  float* rows = reinterpret_cast<float*>(smem4);  // [n_rows][stride] the input rows
  float* tmp = rows + n_rows * stride;            // [bh rounded up to kQuad][stride]
  float* cwt = tmp + (bh + kQuad - 1) / kQuad * kQuad * stride;  // [sw][cT]
  float* rwt = cwt + sw * cT;                     // [bh][rT]
  int* coff = reinterpret_cast<int*>(rwt + bh * rT);  // [sw] first float in tmp
  int* ccnt = coff + sw;                               // [sw]
  int* roff = ccnt + sw;                               // [bh] first float in rows
  int* rcnt = roff + bh;                               // [bh]

  // the rows [lo, lo + n_rows), as asynchronous copies: `lanes` threads share
  // a row, each taking every lanes-th 16-byte copy (4-byte when !vec)
  const float* img = in + (static_cast<size_t>(blockIdx.y) * H + lo) * W * 3 + q0;
  const int n_units = vec ? nq / 4 : nq;  // copies per row
  const int lanes = max(1, min(n_units, kThreads));
  const int row_step = kThreads / lanes;
  if (tid < row_step * lanes) {
    for (int r = tid / lanes; r < n_rows; r += row_step) {
      float* dst_row = rows + r * stride;
      const float* src_row = img + static_cast<size_t>(r) * W * 3;
      for (int u = tid % lanes; u < n_units; u += lanes) {
        if (vec) {
          copy16(dst_row + 4 * u, src_row + 4 * u);
        } else {
          copy4(dst_row + u, src_row + u);
        }
      }
    }
  }
  // the block's taps, while its rows are in flight
  const float* cw = weights + m[kColW] + static_cast<size_t>(x0) * cT;
  const float* rw = weights + m[kRowW] + static_cast<size_t>(y0) * rT;
  for (int e = tid; e < nx * cT; e += kThreads) copy4(cwt + e, cw + e);
  for (int e = tid; e < ny * rT; e += kThreads) copy4(rwt + e, rw + e);
  asm volatile("cp.async.commit_group;\n" ::);
  const int* cs = starts + m[kColIdx] + x0;
  const int* cc = counts + m[kColIdx] + x0;
  const int* rs = starts + m[kRowIdx] + y0;
  const int* rc = counts + m[kRowIdx] + y0;
  for (int x = tid; x < nx; x += kThreads) {
    coff[x] = 3 * cs[x] - q0;
    ccnt[x] = cc[x];
  }
  for (int r = tid; r < ny; r += kThreads) {
    roff[r] = (rs[r] - lo) * stride;
    rcnt[r] = rc[r];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // vertical taps: tmp[r][q] = sum_t rw[y][t] * in[rs[y] + t][q0 + q], y = y0 + r;
  // a thread keeps one float4 of the span and takes every step-th row
  const int n4 = (nq + 3) / 4;
  const int v_lanes = max(1, min(n4, kThreads));
  const int v_step = kThreads / v_lanes;
  if (tid < v_step * v_lanes) {
    for (int v = tid % v_lanes; v < n4; v += v_lanes) {
      for (int r = tid / v_lanes; r < ny; r += v_step) {
        const int cnt = rcnt[r];
        const float* wt = rwt + r * rT;
        const float4* src = reinterpret_cast<const float4*>(rows + roff[r]) + v;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int t = 0; t < cnt; ++t) {
          const float wgt = wt[t];
          const float4 a = src[t * (stride / 4)];
          acc.x = fmaf(wgt, a.x, acc.x);
          acc.y = fmaf(wgt, a.y, acc.y);
          acc.z = fmaf(wgt, a.z, acc.z);
          acc.w = fmaf(wgt, a.w, acc.w);
        }
        reinterpret_cast<float4*>(tmp + r * stride)[v] = acc;
      }
    }
  }
  __syncthreads();

  // horizontal taps from the intermediate rows: a thread keeps one (column,
  // channel) and takes every step-th quad of rows, a weight read once for
  // the quad. kOut is the scale's offset per image (the batch's scales lie
  // back to back).
  float* dst = out + m[kOut] * gridDim.y + static_cast<size_t>(blockIdx.y) * h * w * 3;
  const int nq_out = nx * 3;
  const int h_lanes = max(1, min(nq_out, kThreads));
  const int h_step = kThreads / h_lanes;
  if (tid < h_step * h_lanes) {
    for (int q = tid % h_lanes; q < nq_out; q += h_lanes) {
      const int x = q / 3, ch = q - 3 * x;
      const float* cwx = cwt + x * cT;
      const int cnt = ccnt[x];
      for (int quad = tid / h_lanes; quad * kQuad < ny; quad += h_step) {
        const float* src = tmp + kQuad * quad * stride + coff[x] + ch;
        float acc[kQuad] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int t = 0; t < cnt; ++t) {
          const float wgt = cwx[t];
#pragma unroll
          for (int i = 0; i < kQuad; ++i) acc[i] = fmaf(wgt, src[i * stride + 3 * t], acc[i]);
        }
        float* row = dst + (static_cast<size_t>(y0 + kQuad * quad) * w + x0) * 3 + q;
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          if (kQuad * quad + i < ny) row[static_cast<size_t>(i) * w * 3] = acc[i];
        }
      }
    }
  }
}

}  // namespace

// in: (B, H, W, 3) fp32; out: the scales' (B, h, w, 3) outputs back to back,
// at the offsets of `meta` (host memory: n_scales rows of kMeta int64); the
// taps, strips, bands and smem_bytes from the wrapper's schedule
// (kernels/pyramid.schedule).
RF_API int rf_lanczos_pyramid(const float* in, float* out, const long long* meta,
                              const int* starts, const int* counts,
                              const float* weights, const int* strips, const int* bands,
                              int n_scales, int n_blocks, int B, int H, int W,
                              int smem_bytes, cudaStream_t stream) {
  if (n_scales > kMaxScales) return static_cast<int>(cudaErrorInvalidValue);
  Scales sc;
  sc.n = n_scales;
  for (int i = 0; i < n_scales; ++i) {
    for (int j = 0; j < kMeta; ++j) sc.f[i][j] = meta[i * kMeta + j];
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // rows of W * 3 floats start on 16 bytes when W * 3 is a multiple of 4
  const bool vec = (W * 3) % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0;
  pyramid_kernel<<<dim3(n_blocks, B), kThreads, smem_bytes, stream>>>(
      in, out, sc, starts, counts, weights, strips, bands, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}
