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
// the five blurred maps are 22 taps each per pixel and channel (~1.25 GFLOP
// with the SSIM map, 0.019 ms at the fp32 peak) over 45 MB of input (0.013
// ms); with the per-pixel partials written for the backward, 103 MB (0.031
// ms). The backward moves 116 MB (0.035 ms) for ~0.6 GFLOP. On the card
// each kernel takes about as long for its arithmetic alone as for its
// staged copies alone, and the two overlap in part (PERF.md, K10).
//
// Forward design: a persistent block of 256 threads walks tiles of 32 x 32
// pixels of one image (tile k, k + gridDim.x, ...) for all three channels.
// It stages a tile's rows with their 5-pixel halo once: each row of img1
// and img2 is a contiguous NHWC run of 42 x 3 floats and each row of match
// one of 42. When W is a multiple of 4 a row is one bulk copy (the copy
// engine, completing on an mbarrier) of its window of whole float4s, the
// run at the same offset in every row; else float by float. Zeros outside
// the image. Then, for each channel, the vertical pass: a thread owns one
// staged column and 4 output rows, reads the 14 staged values of u and v
// once, forms u^2, v^2 and uv once each, and keeps the 5 x 4 sums in
// registers; after a barrier, the horizontal pass: a thread owns 4 adjacent
// outputs of a row and reads each map's 14 values as 4 float4 loads. The
// mask (the box filter of match) is made the same way first, and each
// thread keeps its 4 mask values in registers. The next tile's copies are
// issued as soon as their buffers are free, so they overlap this tile's
// passes. The taps are compile-time constants (the fp32 values of
// `kernels/ssim.gaussian_window`, checked bit for bit on the CPU), and every
// sum runs taps 0..10, vertical then horizontal, one fmaf chain per output.
// 72 KB of shared memory and at most 80 registers a thread: 3 blocks an SM.
// Each block writes its sums of (1 - S) * mask and of mask (a fixed
// warp-shuffle tree, then the 8 warps in order); a second launch adds the
// blocks' sums in a fixed order, so the loss is deterministic.
//
// When img1 needs a gradient, the forward also writes the per-pixel partials
// of (1 - S) * mask with respect to mu1, G*x^2 and G*xy (a, b, c) in a
// layout private to this pair: 9 planes, map-major then channel (a of
// channels 0-2, then b, then c), each plane the (B, H, W) pixels padded to a
// multiple of 4 floats, so that a run of 4 outputs is one 16-byte store
// when W is a multiple of 4 and every plane's rows align alike.
//
// Backward design: d_img1 = g / (3 sum(mask)) * (G*a + 2 x G*b + y G*c)
// (the Gaussian is self-adjoint under zero "same" padding), reading g and
// sum(mask) from the device, so nothing is read back. A persistent block
// walks the tiles' channels as stages: a stage is one channel's a, b and c
// planes with their halo, staged as above into a ring of two buffers, so
// that the next stage's copies overlap this one's passes; then the same two
// register-tiled passes (8 rows a vertical item). img1 and img2 are read at
// the thread's own 4 pixels as 12 contiguous floats (three 16-byte loads),
// and d_img1 is written the same way. No atomics: the gradient is
// deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32, kTileW = 32;        // output pixels of a block
constexpr int kR = 5;                          // halo: an 11-tap window
constexpr int kTaps = 2 * kR + 1;
constexpr int kInH = kTileH + 2 * kR;           // 42 staged rows
constexpr int kInW = kTileW + 2 * kR;           // 42 staged columns
constexpr int kRunVF = 4;                       // output rows of a vertical item: forward
constexpr int kRunVB = 8;                       // and backward
constexpr int kRunH = 4;                        // output columns of a horizontal item
constexpr int kItemsVF = kInW * (kTileH / kRunVF);   // 336
constexpr int kItemsVB = kInW * (kTileH / kRunVB);   // 168
constexpr int kItemsH = kTileH * (kTileW / kRunH);   // 256
constexpr int kLoadsH = (kRunH + 2 * kR + 3) / 4;   // float4s a horizontal item reads
// A staged row holds a window of whole float4s that covers the run from
// up to 3 floats before it.
constexpr int kImgStride = (kInW * 3 + 3 + 3) / 4 * 4;  // 132 floats (42 x 3 + 3)
constexpr int kMapStride = (kInW + 3 + 3) / 4 * 4;      // 48 floats (42 + 3)
constexpr int kVStride = (kTileW - kRunH + 4 * kLoadsH + 3) / 4 * 4;  // 44
constexpr int kVPlane = kTileH * kVStride;
constexpr float kC1 = 0.01f * 0.01f, kC2 = 0.03f * 0.03f;
// kernels/ssim.gaussian_window() and BOX_TAP in fp32, as immediates once the
// tap loops are unrolled (tests/test_torch_ops.py holds these literals to
// them bit for bit)
__device__ __forceinline__ float gauss_tap(int t) {
  const int d = t < kR ? kR - t : t - kR;
  return d == 0 ? 0x1.106562p-2f : d == 1 ? 0x1.b43c4p-3f : d == 2 ? 0x1.bff1p-4f
         : d == 3 ? 0x1.26eb18p-5f : d == 4 ? 0x1.f1fe04p-8f : 0x1.0d956ep-10f;
}
constexpr float kBox = 0x1.745d18p-4f;

static_assert(kItemsH <= kThreads && kItemsH % 32 == 0, "whole warps of horizontal items");
static_assert(kTileW % kRunH == 0 && kRunH % 4 == 0 && kTileH % kRunVF == 0 &&
              kTileH % kRunVB == 0, "whole items");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers: a staging completes when every thread of the block has arrived
// (after its own stores) and the bytes of its bulk copies have landed.
// Thread 0 makes n of them, seen by every thread and by the copy engine
// once the block has passed a barrier.
__device__ __forceinline__ void bar_init(unsigned long long* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(smem_addr(bars + i)), "r"(kThreads));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar, int bytes) {
  if (bytes > 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// that completes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Stage the tile's rows [y0 - kR, y0 + kTileH + kR) x pixels [x0 - kR,
// x0 + kTileW + kR) of kPlanes (B, H, W, C) arrays (plane n at `src(n)`)
// into kInH rows each of `dst`, kStride floats apart, zeros outside the
// image; each row's run of kInW C floats starts at float off = ((x0 - kR) C)
// & 3 of its row. When W is a multiple of 4, every row's run lies at that
// offset in its window of whole float4s: thread i takes row i of the
// planes, one bulk copy of the window's part inside the image (rows of
// kStride floats, 528 or 192 bytes) and zeros for the rest. Else float by
// float, every thread. Every thread then arrives on `bar` once. 32-bit
// offsets: every tensor holds fewer than 2^31 floats.
template <int C, int kStride, int kPlanes, class Src>
__device__ __forceinline__ void stage_tile(float* dst, Src src, int b, int y0, int x0, int H,
                                           int W, bool vec, unsigned long long* bar) {
  static_assert(kPlanes * kInH <= kThreads, "a row a thread");
  const int off = ((x0 - kR) * C) & 3;
  if (vec) {
    if (threadIdx.x < kPlanes * kInH) {
      const int n = threadIdx.x / kInH, r = threadIdx.x - n * kInH, y = y0 - kR + r;
      float* d = dst + (n * kInH + r) * kStride;
      const int lo = (b * H + y) * W * C, hi = lo + W * C;
      const int win = lo + (x0 - kR) * C - off;  // a multiple of 4, as lo is
      const int first = y >= 0 && y < H ? max(lo - win, 0) : kStride;
      const int last = y >= 0 && y < H ? min(hi - win, kStride) : kStride;
      if (first > 0 || last < kStride) {
        for (int k = 0; k < kStride; k += 4) {
          if (k < first || k >= last)
            *reinterpret_cast<float4*>(d + k) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (last > first) {
        const int bytes = (last - first) * 4;
        bar_arrive(bar, bytes);
        bulk_copy(d + first, src(n) + win + first, bytes, bar);
        return;
      }
    }
  } else {
    constexpr int kRun = kInW * C;
    for (int e = threadIdx.x; e < kPlanes * kInH * kRun; e += kThreads) {
      const int row = e / kRun, k = e - row * kRun, n = row / kInH, r = row - n * kInH;
      const int y = y0 - kR + r;
      const int lo = (b * H + y) * W * C, a = lo + (x0 - kR) * C + k;
      dst[row * kStride + off + k] =
          y >= 0 && y < H && a >= lo && a < lo + W * C ? __ldg(src(n) + a) : 0.f;
    }
  }
  bar_arrive(bar, 0);
}

// The origin of tile t of the batch: (image, first row, first column).
__device__ __forceinline__ void tile_origin(int t, int H, int W, int& b, int& y0, int& x0) {
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles = tiles_x * ((H + kTileH - 1) / kTileH);
  b = t / tiles;
  t -= b * tiles;
  y0 = (t / tiles_x) * kTileH;
  x0 = (t % tiles_x) * kTileW;
}

// Deterministic block sum (a fixed shuffle tree, then the warps in order);
// the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) out += s_warp[w];
  }
  return out;
}

// The 11 taps of `w` over kRunH adjacent outputs from the staged row at
// `row` (16-byte aligned): out[j] = sum_t w[t] row[j + t], t ascending.
template <bool kGaussian>
__device__ __forceinline__ void taps_h(const float* row, float out[kRunH]) {
  float v[4 * kLoadsH];
#pragma unroll
  for (int k = 0; k < kLoadsH; ++k) {
    const float4 f = reinterpret_cast<const float4*>(row)[k];
    v[4 * k] = f.x; v[4 * k + 1] = f.y; v[4 * k + 2] = f.z; v[4 * k + 3] = f.w;
  }
#pragma unroll
  for (int j = 0; j < kRunH; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) acc = fmaf(kGaussian ? gauss_tap(t) : kBox, v[j + t], acc);
    out[j] = acc;
  }
}

// A run of kRunH floats of a (B, H, W) plane from its pixel px (column x):
// 16-byte stores when W is a multiple of 4 (px then is too), else float by
// float, nothing past the row's end.
__device__ __forceinline__ void store_run(float* out, const float* v, int x, int W, bool vec) {
#pragma unroll
  for (int g = 0; g < kRunH / 4; ++g) {
    if (vec) {
      if (x + 4 * g < W)
        reinterpret_cast<float4*>(out)[g] =
            make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
    } else {
#pragma unroll
      for (int k = 4 * g; k < 4 * g + 4; ++k) {
        if (x + k < W) out[k] = v[k];
      }
    }
  }
}

// 3 kRunH floats of a (B, H, W, 3) array from its pixel px, loaded (zeros
// past the row's end) or, below, stored the same way.
__device__ __forceinline__ void load_run3(const float* in, float* v, int x, int W, bool vec) {
#pragma unroll
  for (int g = 0; g < kRunH / 4; ++g) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float* o = v + 12 * g + 4 * k;
      if (vec) {
        const float4 f = x + 4 * g < W ? reinterpret_cast<const float4*>(in)[3 * g + k]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 12 * g + 4 * k + e;
          o[e] = x + i / 3 < W ? in[i] : 0.f;
        }
      }
    }
  }
}

__device__ __forceinline__ void store_run3(float* out, const float* v, int x, int W, bool vec) {
#pragma unroll
  for (int g = 0; g < kRunH / 4; ++g) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* o = v + 12 * g + 4 * k;
      if (vec) {
        if (x + 4 * g < W)
          reinterpret_cast<float4*>(out)[3 * g + k] = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 12 * g + 4 * k + e;
          if (x + i / 3 < W) out[i] = o[e];
        }
      }
    }
  }
}

constexpr int kFwdSmemFloats = 2 * kInH * kImgStride + 5 * kVPlane;
constexpr int kFwdSmem = kFwdSmemFloats * 4 + (kThreads / 32) * 2 * 4 + 2 * 8;
// blocks an SM holds by shared memory (228 KB, 1 KB of it reserved per block), at most 3
constexpr int kFwdBlocks = 233472 / (kFwdSmem + 1024) < 3 ? 233472 / (kFwdSmem + 1024) : 3;

// Persistent: block k takes tiles k, k + gridDim.x, ... of the batch. The
// next tile's img1 and img2 are copied while this tile's last horizontal
// pass and the next mask run; its match (in s_v's memory) from the end of
// this tile's last horizontal pass on.
template <bool kPartials>
__global__ void __launch_bounds__(kThreads, kFwdBlocks) ssim_fwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ match, float* __restrict__ partials,
    float* __restrict__ abc, long long plane9, int B, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_img = smem;                               // [2][kInH][kImgStride]
  float* s_v = smem + 2 * kInH * kImgStride;         // [5][kTileH][kVStride]
  // [kInH][kMapStride], in s_v's last planes: read by the mask before the
  // channels, written again after the tile's last horizontal pass
  float* s_match = s_v + 5 * kVPlane - kInH * kMapStride;
  float* s_warp = smem + kFwdSmemFloats;             // [2][warps]
  // the stagings' mbarriers: match, images
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(s_warp + 2 * (kThreads / 32));
  const int n_tiles = B * ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  const int tid = threadIdx.x;
  const bool vec = (W & 3) == 0;  // 16-byte copies and stores
  // this thread's horizontal item (the first kItemsH threads): row r,
  // columns c0 .. c0 + kRunH - 1 of each tile
  const bool h_item = tid < kItemsH;
  const int r = tid / (kTileW / kRunH), c0 = (tid % (kTileW / kRunH)) * kRunH;
  float num = 0.f, den = 0.f;

  const auto match_src = [=](int) { return match; };
  const auto img_src = [=](int n) { return n ? img2 : img1; };
  bar_init(bars, 2);
  int b, y0, x0;
  tile_origin(blockIdx.x, H, W, b, y0, x0);
  stage_tile<1, kMapStride, 1>(s_match, match_src, b, y0, x0, H, W, vec, bars);
  stage_tile<3, kImgStride, 2>(s_img, img_src, b, y0, x0, H, W, vec, bars + 1);
  for (int t = blockIdx.x, k = 0; t < n_tiles; t += gridDim.x, ++k) {
    tile_origin(t, H, W, b, y0, x0);
    const int tn = t + gridDim.x;  // the next tile
    int bn = 0, y0n = 0, x0n = 0;
    if (tn < n_tiles) tile_origin(tn, H, W, bn, y0n, x0n);
    const int off_m = (x0 - kR) & 3, off_i = ((x0 - kR) * 3) & 3;  // the runs' offsets
    bar_wait(bars, k & 1);  // this tile's match
    __syncthreads();

    // the mask: the box filter of match, vertical pass into s_v's first plane
    for (int it = tid; it < kItemsVF; it += kThreads) {
      const int rg = it / kInW, q = it - rg * kInW, r0 = rg * kRunVF;
      float acc[kRunVF];
#pragma unroll
      for (int j = 0; j < kRunVF; ++j) acc[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kRunVF + 2 * kR; ++i) {
        const float u = s_match[(r0 + i) * kMapStride + off_m + q];
#pragma unroll
        for (int j = 0; j < kRunVF; ++j) {
          if (i - j >= 0 && i - j < kTaps) acc[j] = fmaf(kBox, u, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kRunVF; ++j) s_v[(r0 + j) * kVStride + q] = acc[j];
    }
    __syncthreads();
    const int y = y0 + r, x = x0 + c0;
    const bool row_out = h_item && y < H;  // a row of outputs to count and store
    float mask[kRunH];
    if (h_item) {
      taps_h<false>(s_v + r * kVStride + c0, mask);
#pragma unroll
      for (int j = 0; j < kRunH; ++j) {
        mask[j] = ((mask[j] + 1e-7f > 0.5f) ? 1.f : 0.f) + 1e-7f;
        if (row_out && x + j < W) den += mask[j];
      }
    }
    // with vec, px is a multiple of 4 and runs of 4 end by W
    const size_t px = (static_cast<size_t>(b) * H + y) * W + x;
    bar_wait(bars + 1, k & 1);  // this tile's img1 and img2
    __syncthreads();

    for (int ch = 0; ch < 3; ++ch) {
      // vertical pass of u, v, u^2, v^2 and uv into s_v's five planes
      for (int it = tid; it < kItemsVF; it += kThreads) {
        const int rg = it / kInW, q = it - rg * kInW, r0 = rg * kRunVF;
        float m1[kRunVF], m2[kRunVF], e11[kRunVF], e22[kRunVF], e12[kRunVF];
#pragma unroll
        for (int j = 0; j < kRunVF; ++j) m1[j] = m2[j] = e11[j] = e22[j] = e12[j] = 0.f;
#pragma unroll
        for (int i = 0; i < kRunVF + 2 * kR; ++i) {
          const int o = (r0 + i) * kImgStride + off_i + 3 * q + ch;
          const float u = s_img[o], v = s_img[kInH * kImgStride + o];
          const float uu = u * u, vv = v * v, uv = u * v;
#pragma unroll
          for (int j = 0; j < kRunVF; ++j) {
            const int tap = i - j;
            if (tap >= 0 && tap < kTaps) {
              m1[j] = fmaf(gauss_tap(tap), u, m1[j]);
              m2[j] = fmaf(gauss_tap(tap), v, m2[j]);
              e11[j] = fmaf(gauss_tap(tap), uu, e11[j]);
              e22[j] = fmaf(gauss_tap(tap), vv, e22[j]);
              e12[j] = fmaf(gauss_tap(tap), uv, e12[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRunVF; ++j) {
          const int o = (r0 + j) * kVStride + q;
          s_v[o] = m1[j];
          s_v[kVPlane + o] = m2[j];
          s_v[2 * kVPlane + o] = e11[j];
          s_v[3 * kVPlane + o] = e22[j];
          s_v[4 * kVPlane + o] = e12[j];
        }
      }
      __syncthreads();
      if (ch == 2 && tn < n_tiles)  // s_img is free: the next tile's images
        stage_tile<3, kImgStride, 2>(s_img, img_src, bn, y0n, x0n, H, W, vec, bars + 1);
      if (h_item) {
        float f[5][kRunH];
#pragma unroll
        for (int n = 0; n < 5; ++n) taps_h<true>(s_v + n * kVPlane + r * kVStride + c0, f[n]);
        float pa[kRunH], pb[kRunH], pc[kRunH];
#pragma unroll
        for (int j = 0; j < kRunH; ++j) {
          const float mu1 = f[0][j], mu2 = f[1][j];
          const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
          const float s11 = f[2][j] - mu1_sq, s22 = f[3][j] - mu2_sq, s12 = f[4][j] - mu1_mu2;
          const float a1 = 2.f * mu1_mu2 + kC1, a2 = 2.f * s12 + kC2;
          const float b1 = mu1_sq + mu2_sq + kC1, b2 = s11 + s22 + kC2;
          const float ssim = (a1 * a2) / (b1 * b2);
          if (row_out && x + j < W) num += (1.f - ssim) * mask[j];
          if (!kPartials) continue;
          // partials of (1 - S) * mask w.r.t. mu1, G*x^2 and G*xy, with one
          // division: 1 / b1 - 1 / b2 = (b2 - b1) inv and 1 / b2 = b1 inv
          const float inv = 1.f / (b1 * b2);
          pa[j] = -mask[j] * ((2.f * mu2 * (a2 - a1) - 2.f * mu1 * ssim * (b2 - b1)) * inv);
          pb[j] = mask[j] * (ssim * b1 * inv);
          pc[j] = -mask[j] * (2.f * a1 * inv);
        }
        if (kPartials && row_out) {
          float* out = abc + ch * plane9 + px;
          store_run(out, pa, x, W, vec);
          store_run(out + 3 * plane9, pb, x, W, vec);
          store_run(out + 6 * plane9, pc, x, W, vec);
        }
      }
      if (ch < 2) __syncthreads();  // s_v is the next channel's
    }
    __syncthreads();  // s_v is free: the next tile's match
    if (tn < n_tiles)
      stage_tile<1, kMapStride, 1>(s_match, match_src, bn, y0n, x0n, H, W, vec, bars);
  }
  num = block_sum(num, s_warp);
  den = block_sum(den, s_warp + kThreads / 32);
  if (tid == 0) reinterpret_cast<float2*>(partials)[blockIdx.x] = make_float2(num, den);
}

// One block: sums = (sum num, sum den), loss = num / den / 3, in a fixed
// order (each thread's blocks in turn, then a fixed shuffle tree, then the
// warps in order).
constexpr int kReduceThreads = 1024;
__global__ void __launch_bounds__(kReduceThreads) ssim_reduce_kernel(
    const float* __restrict__ partials, int n_blocks, float* __restrict__ sums,
    float* __restrict__ loss) {
  __shared__ float2 s_warp[kReduceThreads / 32];
  float num = 0.f, den = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += kReduceThreads) {
    const float2 p = reinterpret_cast<const float2*>(partials)[i];
    num += p.x;
    den += p.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = make_float2(num, den);
  __syncthreads();
  if (threadIdx.x == 0) {
    num = den = 0.f;
    for (int w = 0; w < kReduceThreads / 32; ++w) {
      num += s_warp[w].x;
      den += s_warp[w].y;
    }
    sums[0] = num;
    sums[1] = den;
    loss[0] = num / den / 3.f;
  }
}

// The backward stages one channel's a, b and c planes at a time into a ring
// of kRing buffers that runs across the block's tiles: the next (tile,
// channel)s' copies overlap this one's passes.
constexpr int kRing = 2;
constexpr int kBwdStage = 3 * kInH * kMapStride;  // floats
constexpr int kBwdSmemFloats = kRing * kBwdStage + 3 * kVPlane;
constexpr int kBwdSmem = kBwdSmemFloats * 4 + kRing * 8;
constexpr int kBwdBlocks = 233472 / (kBwdSmem + 1024) < 3 ? 233472 / (kBwdSmem + 1024) : 3;

// Stage s of this block (its tile blockIdx.x + (s / 3) gridDim.x, channel
// s % 3: abc planes ch, 3 + ch, 6 + ch) into buffer s % kRing, on its
// mbarrier.
__device__ __forceinline__ void stage_channel(float* s_stage, unsigned long long* bars,
                                              const float* abc, long long plane9, int s,
                                              int n_tiles, int H, int W, bool vec) {
  const int t = blockIdx.x + (s / 3) * gridDim.x, ch = s % 3;
  if (t >= n_tiles) return;
  int b, y0, x0;
  tile_origin(t, H, W, b, y0, x0);
  stage_tile<1, kMapStride, 3>(s_stage + (s % kRing) * kBwdStage,
                               [=](int n) { return abc + (3 * n + ch) * plane9; }, b, y0, x0, H,
                               W, vec, bars + s % kRing);
}

__global__ void __launch_bounds__(kThreads, kBwdBlocks) ssim_bwd_kernel(
    const float* __restrict__ img1, const float* __restrict__ img2,
    const float* __restrict__ abc, long long plane9, const float* __restrict__ sums,
    const float* __restrict__ gout, float* __restrict__ d_img1, int B, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_stage = smem;                  // [kRing][3][kInH][kMapStride]
  float* s_v = smem + kRing * kBwdStage;   // [3][kTileH][kVStride]
  // the stage buffers' mbarriers
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(s_v + 3 * kVPlane);
  const int n_tiles = B * ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  const int tid = threadIdx.x;
  // plane9 is a multiple of 4, so a row lies alike in every plane
  const bool vec = (W & 3) == 0;
  bar_init(bars, kRing);
  for (int s = 0; s < kRing; ++s) stage_channel(s_stage, bars, abc, plane9, s, n_tiles, H, W, vec);
  // this thread's horizontal item (the first kItemsH threads): kRunH pixels
  // of row r from column c0 of each tile, 3 channels each
  const bool h_item = tid < kItemsH;
  const int r = tid / (kTileW / kRunH), c0 = (tid % (kTileW / kRunH)) * kRunH;
  const float scale = gout[0] / (3.f * sums[1]);

  for (int k = 0; static_cast<int>(blockIdx.x + k * gridDim.x) < n_tiles; ++k) {
    int b, y0, x0;
    tile_origin(blockIdx.x + k * gridDim.x, H, W, b, y0, x0);
    const int off = (x0 - kR) & 3;  // the runs' offset in their rows
    const int y = y0 + r, x = x0 + c0;
    const bool row_out = h_item && y < H;
    // with vec, 3 px is a multiple of 4 and runs of 4 end by W
    const size_t px = (static_cast<size_t>(b) * H + y) * W + x;
    // the thread's img1 and img2 runs, loaded while the tile's first stage lands
    float d[3 * kRunH], i1[3 * kRunH], i2[3 * kRunH];
    if (row_out) {
      load_run3(img1 + 3 * px, i1, x, W, vec);
      load_run3(img2 + 3 * px, i2, x, W, vec);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int s = 3 * k + ch;
      bar_wait(bars + s % kRing, (s / kRing) & 1);  // stage s
      __syncthreads();
      const float* s_abc = s_stage + (s % kRing) * kBwdStage;
      // vertical pass of the channel's a, b and c planes into s_v
      for (int it = tid; it < kItemsVB; it += kThreads) {
        const int rg = it / kInW, q = it - rg * kInW, r0 = rg * kRunVB;
        float acc[3][kRunVB];
#pragma unroll
        for (int n = 0; n < 3; ++n) {
#pragma unroll
          for (int j = 0; j < kRunVB; ++j) acc[n][j] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kRunVB + 2 * kR; ++i) {
          const int o = (r0 + i) * kMapStride + off + q;
#pragma unroll
          for (int n = 0; n < 3; ++n) {
            const float u = s_abc[n * kInH * kMapStride + o];
#pragma unroll
            for (int j = 0; j < kRunVB; ++j) {
              if (i - j >= 0 && i - j < kTaps) acc[n][j] = fmaf(gauss_tap(i - j), u, acc[n][j]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 3; ++n) {
#pragma unroll
          for (int j = 0; j < kRunVB; ++j) s_v[n * kVPlane + (r0 + j) * kVStride + q] = acc[n][j];
        }
      }
      __syncthreads();
      stage_channel(s_stage, bars, abc, plane9, s + kRing, n_tiles, H, W, vec);  // s's buffer
      if (row_out) {
        float f[3][kRunH];
#pragma unroll
        for (int n = 0; n < 3; ++n) taps_h<true>(s_v + n * kVPlane + r * kVStride + c0, f[n]);
#pragma unroll
        for (int j = 0; j < kRunH; ++j) {
          const int e = 3 * j + ch;
          d[e] = scale * (f[0][j] + 2.f * i1[e] * f[1][j] + i2[e] * f[2][j]);
        }
      }
    }
    if (row_out) store_run3(d_img1 + 3 * px, d, x, W, vec);
  }
}

// The blocks of `kernel` resident on the current device at once.
template <class K>
cudaError_t resident_blocks(K kernel, int smem, int* n) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *n = sms * per_sm;
  return err;
}

}  // namespace

// The number of blocks rf_ssim_fwd sums (a launch's partials hold 2 floats
// each): the blocks resident on the current device, at most one per tile.
RF_API int rf_ssim_fwd_blocks(int B, int H, int W, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      ssim_fwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssim_fwd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  int resident = 0;
  if (err == cudaSuccess) err = resident_blocks(ssim_fwd_kernel<true>, kFwdSmem, &resident);
  const long long tiles =
      static_cast<long long>(B) * ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  *n = static_cast<int>(tiles < resident ? tiles : resident);
  return static_cast<int>(err);
}

// img1, img2: (B, H, W, 3); match: (B, H, W, 1); partials: 2 floats for each
// of the n_blocks blocks (rf_ssim_fwd_blocks); abc: 9 planes of plane9
// floats (plane9 = B H W rounded up to a multiple of 4), or null when img1
// needs no gradient; sums: (2,) = (sum num, sum den); loss: a scalar.
// All fp32 on the device; each tensor below 2^31 elements.
RF_API int rf_ssim_fwd(const float* img1, const float* img2, const float* match,
                       float* partials, int n_blocks, float* abc, long long plane9,
                       float* sums, float* loss, int B, int H, int W, cudaStream_t stream) {
  const auto kernel = abc != nullptr ? ssim_fwd_kernel<true> : ssim_fwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (abc != nullptr) {
    ssim_fwd_kernel<true><<<n_blocks, kThreads, kFwdSmem, stream>>>(
        img1, img2, match, partials, abc, plane9, B, H, W);
  } else {
    ssim_fwd_kernel<false><<<n_blocks, kThreads, kFwdSmem, stream>>>(
        img1, img2, match, partials, abc, plane9, B, H, W);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_reduce_kernel<<<1, kReduceThreads, 0, stream>>>(partials, n_blocks, sums, loss);
  return static_cast<int>(cudaGetLastError());
}

// The number of blocks rf_ssim_bwd launches, as rf_ssim_fwd_blocks.
RF_API int rf_ssim_bwd_blocks(int B, int H, int W, int* n) {
  cudaError_t err = cudaFuncSetAttribute(ssim_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  int resident = 0;
  if (err == cudaSuccess) err = resident_blocks(ssim_bwd_kernel, kBwdSmem, &resident);
  const long long tiles =
      static_cast<long long>(B) * ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH);
  *n = static_cast<int>(tiles < resident ? tiles : resident);
  return static_cast<int>(err);
}

// abc, plane9: rf_ssim_fwd's partials; sums: its sums; gout: the loss's
// cotangent (a device scalar); d_img1: (B, H, W, 3); n_blocks:
// rf_ssim_bwd_blocks.
RF_API int rf_ssim_bwd(const float* img1, const float* img2, const float* abc,
                       long long plane9, const float* sums, const float* gout,
                       float* d_img1, int n_blocks, int B, int H, int W, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_bwd_kernel<<<n_blocks, kThreads, kBwdSmem, stream>>>(img1, img2, abc, plane9, sums,
                                                            gout, d_img1, B, H, W);
  return static_cast<int>(cudaGetLastError());
}
