// Anchor-mode feature bank: every pyramid scale's rows in one launch. Each
// scale's rows are its nearest anchor's pre-normalization trunk map
// resized (bilinear) to the scale's grid, or taken as they are where the
// grids match, then L2-normalized per location and written at the scale's
// place in the bank.
//
// Replaces: ransacflow_tpu/pipeline/coarse.py:69-78 _anchor_resample_feats
// and the same step at ransacflow_tpu/pipeline/fused.py:105-120, which call
// jax.image.resize(fmap, (1, fh, fw, C), 'bilinear') (a triangle kernel with
// half-pixel centres, widened by 1/scale and renormalized on downscale, as a
// dense weight matrix per axis), or none where the grid matches, and then
// l2_normalize over the channels, once per scale.
//
// Each output row (column) reads `count` consecutive input rows (columns)
// from `start` with fp32 weights; the wrapper builds these taps once per
// (anchor sizes, scale grids) with the reference's rules, packed for all
// scales in one device array (an axis whose size does not change has the
// identity tap), and passes the per-scale table (input pointer, sizes, tap
// offsets, first bank row, first block, identity flag) as a kernel
// parameter.
//
// What bounds it on the H100: a serving pair's bank at anchor stride 3 (7
// scales, 13065 rows of 1024 channels from the anchors 60x80, 30x40 and
// 15x20) reads the three anchor maps (25.8 MB) and writes the bank (53.5
// MB): ~0.024 ms of HBM traffic at 3.35 TB/s, and a few MFLOP. The maps fit
// the 50 MB L2, but a resampled row read tap by tap re-reads 4-9 input
// cells of 4 KB each from L2 (~200 MB for a serving bank). Design: a block
// of 8 warps takes 8 neighbouring cells of one output row of a resampled
// scale. It first runs the row taps once for every input column the 8
// cells read (the tile's span, one float4 of channels a thread) into
// shared memory, then each warp sums its cell's column taps from there (a
// lane holds every 32nd float4 of the channels: coalesced 16-byte loads and
// stores). Sums run in tap order, rows inside and columns outside, as the
// plain version's two matrix products. An identity scale's block takes 8
// consecutive rows of the bank and only loads, normalizes and stores. The
// square-sum is a warp xor-shuffle in a fixed order, and the normalized row
// goes straight to its place in the bank. Deterministic. The blocks run in
// the wrapper's order, which spreads the resampled tiles (bound by L2
// re-reads and their staging) evenly among the identity blocks (bound by
// HBM), so that the two kinds overlap: scale by scale read slower.
//
// The batch form: k pairs' banks in one launch, each anchor map (k, h, w,
// C) and the bank (k, rows, C). The pair is blockIdx.y, and a block reads
// its pair's maps and writes its pair's rows with the single form's code,
// so each bank is the single launch's bit for bit. The single form is the
// batch form with k = 1.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxScales = 16;  // MAX_SCALES in kernels/anchor_resample.py
constexpr int kMaxSmem = 227 * 1024;  // MAX_SMEM: a block's shared memory on the H100
constexpr int kBatch = 4;  // staged items a thread has in flight at once
constexpr int kMeta = 15;       // per-scale fields (META in kernels/anchor_resample.py)
enum {
  kIn, kH, kW, kFh, kFw, kRowIdx, kRowW, kRowT, kColIdx, kColW, kColT, kCell0, kIdentity,
  kTilesX, kSpanIdx
};

// The per-scale table, a kernel parameter: read from the constant bank, it
// costs a warp no round trip to device memory.
struct Scales {
  long long f[kMaxScales][kMeta];
  int n;
};

__device__ __forceinline__ void fma4(float w, const float4& a, float4& acc) {
  acc.x = fmaf(w, a.x, acc.x);
  acc.y = fmaf(w, a.y, acc.y);
  acc.z = fmaf(w, a.z, acc.z);
  acc.w = fmaf(w, a.w, acc.w);
}

// kF4: float4s a lane holds, C <= 128 * kF4
template <int kF4>
__global__ void __launch_bounds__(kThreads) anchor_bank_kernel(
    const __grid_constant__ Scales sc, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ weights,
    const int* __restrict__ spans, const int* __restrict__ order, int c, int rows,
    float* __restrict__ bank) {
  extern __shared__ float4 stage[];  // [span][c / 4]: the tile's row-tap sums
  const int job = order[blockIdx.x];  // (scale << 24) | block of the scale
  const long long* m = sc.f[job >> 24];
  const size_t pair = blockIdx.y;
  const float* in = reinterpret_cast<const float*>(m[kIn]) + pair * m[kH] * m[kW] * c;
  bank += pair * rows * c;
  const int w = static_cast<int>(m[kW]), fh = static_cast<int>(m[kFh]);
  const int fw = static_cast<int>(m[kFw]);
  const int b = job & 0xFFFFFF;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c4 = c / 4;

  float4 acc[kF4];
#pragma unroll
  for (int k = 0; k < kF4; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  int local;  // the warp's cell within the scale
  if (m[kIdentity]) {
    local = b * kWarps + warp;
    if (local >= fh * fw) return;  // no barrier on this branch
    const float4* src = reinterpret_cast<const float4*>(in + static_cast<size_t>(local) * c);
#pragma unroll
    for (int k = 0; k < kF4; ++k) {
      const int q = lane + 32 * k;
      if (q < c4) acc[k] = __ldg(src + q);
    }
  } else {
    const int tiles_x = static_cast<int>(m[kTilesX]);
    const int y = b / tiles_x, tx = b - y * tiles_x;
    const int xa = spans[m[kSpanIdx] + 2 * tx], n_span = spans[m[kSpanIdx] + 2 * tx + 1];
    const int r0 = starts[m[kRowIdx] + y], nr = counts[m[kRowIdx] + y];
    const float* wr = weights + m[kRowW] + static_cast<size_t>(y) * m[kRowT];
    // row taps of every input column of the span, one float4 a thread
    const float4* top = reinterpret_cast<const float4*>(in) +
                        (static_cast<size_t>(r0) * w + xa) * c4;
    const size_t row_step = static_cast<size_t>(w) * c4;
    const int n_items = n_span * c4;  // item: column item / c4, float4 item % c4
    for (int base = threadIdx.x; base < n_items; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < nr; ++i) {
        const float wi = wr[i];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int item = base + b * kThreads;
          if (item < n_items) fma4(wi, __ldg(top + item + i * row_step), v[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (base + b * kThreads < n_items) stage[base + b * kThreads] = v[b];
      }
    }
    __syncthreads();
    const int x = tx * kWarps + warp;
    if (x >= fw) return;
    local = y * fw + x;
    const int x0 = starts[m[kColIdx] + x] - xa, nc = counts[m[kColIdx] + x];
    const float* wc = weights + m[kColW] + static_cast<size_t>(x) * m[kColT];
    for (int j = 0; j < nc; ++j) {
      const float wj = wc[j];
      const float4* col = stage + (x0 + j) * c4;
#pragma unroll
      for (int k = 0; k < kF4; ++k) {
        const int q = lane + 32 * k;
        if (q < c4) fma4(wj, col[q], acc[k]);
      }
    }
  }

  float ss = 0.f;  // zeros past C
#pragma unroll
  for (int k = 0; k < kF4; ++k) {
    ss = fmaf(acc[k].x, acc[k].x, ss);
    ss = fmaf(acc[k].y, acc[k].y, ss);
    ss = fmaf(acc[k].z, acc[k].z, ss);
    ss = fmaf(acc[k].w, acc[k].w, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float denom = fmaxf(sqrtf(ss), 1e-12f);
  float4* dst = reinterpret_cast<float4*>(bank + (m[kCell0] + local) * static_cast<size_t>(c));
#pragma unroll
  for (int k = 0; k < kF4; ++k) {
    const int q = lane + 32 * k;
    if (q < c4) {
      dst[q] = make_float4(acc[k].x / denom, acc[k].y / denom, acc[k].z / denom,
                           acc[k].w / denom);
    }
  }
}

template <int kF4>
cudaError_t launch(const Scales& sc, const int* starts, const int* counts,
                   const float* weights, const int* spans, const int* order, int n_blocks,
                   int n_pairs, int c, int rows, float* bank, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // the opt-in, set on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        anchor_bank_kernel<kF4>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  anchor_bank_kernel<kF4><<<dim3(n_blocks, n_pairs), kThreads, smem, stream>>>(
      sc, starts, counts, weights, spans, order, c, rows, bank);
  return cudaGetLastError();
}

}  // namespace

// meta: n_scales rows of kMeta int64 in host memory (the wrapper's plan,
// kernels/anchor_resample.bank_plan, with each scale's input pointer: an
// (n_pairs, h, w, c) fp32 channels-last map, 16-byte aligned);
// starts/counts/weights the packed taps, spans the tiles' (first input
// column, columns), order the block schedule ((scale << 24) | block of the
// scale, per block of a pair); bank: the (n_pairs, rows, c) output;
// smem_bytes: the largest span times c floats. Needs 1 <= n_scales <= 16,
// 1 <= n_pairs <= 65535, c % 4 == 0 and c <= 2048.
RF_API int rf_anchor_resample_bank(const long long* meta, int n_scales, const int* starts,
                                   const int* counts, const float* weights,
                                   const int* spans, const int* order, int n_blocks,
                                   int n_pairs, int c, int rows, float* bank, int smem_bytes,
                                   cudaStream_t stream) {
  if (n_scales < 1 || n_scales > kMaxScales || c % 4 != 0 || c > 2048 ||
      smem_bytes > kMaxSmem || n_pairs < 1 || n_pairs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Scales sc;
  sc.n = n_scales;
  for (int i = 0; i < n_scales; ++i) {
    for (int j = 0; j < kMeta; ++j) sc.f[i][j] = meta[i * kMeta + j];
  }
  const cudaError_t err =
      c <= 1024 ? launch<8>(sc, starts, counts, weights, spans, order, n_blocks, n_pairs, c,
                            rows, bank, smem_bytes, stream)
                : launch<16>(sc, starts, counts, weights, spans, order, n_blocks, n_pairs, c,
                             rows, bank, smem_bytes, stream);
  return static_cast<int>(err);
}
