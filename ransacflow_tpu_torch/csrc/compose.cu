// Compose tail of the fine stage: a block per 64 x 8 tile of output pixels,
// two horizontally adjacent pixels a thread.
//
// Replaces: ransacflow_tpu/pipeline/fine.py:46,61-92, the end of
// pred_flow_mask. The coarse grid flow_coarse is Hc x Wc; the output is
// Ht x Wt (out_hw, by default the coarse size). For output pixel (i, j):
//   1. flow_up = bilinear upsampling of the stride-8 residual flow to
//      Ht x Wt (torch's align_corners=False rule: source index
//      scale * (dst + 0.5) - 0.5 clamped at 0, i1 = min(i0 + 1, in - 1));
//      match12 likewise;
//   2. flow_up += the corner-anchored Ht x Wt grid (torch's linspace(-1,
//      1)), then clipped to [-1, 1];
//   3. flow12 = flow_coarse sampled bilinearly at flow_up (align_corners=
//      True, zeros outside), at its own Hc x Wc;
//   4. with cycle_match, match21 upsampled to Ht x Wt and sampled at the
//      same point with the Ht x Wt corner weights: each of the four corners
//      is rebuilt from the stride-8 map with the rule of step 1, so the
//      two-step interpolate-then-sample numbers are kept (no analytic
//      shortcut). This is the reference's split branch; when the sizes
//      agree its weights are step 3's, which is the reference's one sample
//      of [flow_coarse, match21];
//   5. match = match12 (* sampled match21) * [flow12 inside [-1, 1]^2].
//
// Every multiply and add is an explicit round-to-nearest intrinsic, each
// product fused into an FMA or not as written, so that no compiler choice
// moves a bit between builds, and out_hw equal to the coarse size gives the
// bits of out_hw = None. The order is the one the kernel's builds before
// out_hw computed, including their fusing the first-row pair of flow's x
// channel and of every match21 corner from its second term (`swap`). Only
// where the operands come from, and which thread computes which pixel, may
// change: the outputs stay bit for bit those of the one-thread-a-pixel form.
//
// What bounds it on the H100: at 480x640 the tail reads the grid-sized
// flow_coarse (2.5 MB) and tiny stride-8 maps (L2-resident) and writes
// 3.7 MB: ~2 us of memory traffic. The plain version writes and reads three
// full-size upsampled maps, a concatenation and a sampled map besides; fused
// here they never leave registers, so what is left is each block's chain of
// dependent reads (the patch, then flow_coarse's corners) and the
// instructions of the index and corner arithmetic. Design: a block's rows
// and columns share their upsampling axes, computed once a block into shared
// memory (no divides a pixel); the patch of the stride-8 maps under the tile
// (flow8 as float2, match12) is staged once a block, and match21's with a
// halo of 4 rows and 8 columns, 32 and 64 output pixels at stride 8, all
// their loads in flight at once.
// cycle_match is a template argument, so that the kernel without it keeps
// its registers low; with it, a pixel's four match21 corners share two row
// and two column axes and are rebuilt from the staged patch when all four
// lie inside it, else read through the read-only cache (a large residual):
// a per-pixel branch. flow_coarse's corners are float2 loads, and a pair of
// pixels is one 16-byte store of flow_out. Both kernels are held to 48
// registers, 5 blocks an SM, so that the 600 blocks of a 480x640 tile grid
// run in one wave. A patch larger than the staging buffers (an output under
// ~3x the stride-8 map's width or ~1.3x its height) reads every map through
// the cache: a per-block branch.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kTileW = 64, kTileH = 8;   // output pixels a block
constexpr int kThreadsX = kTileW / 2;    // two adjacent pixels a thread
constexpr int kThreads = kThreadsX * kTileH;
constexpr int kBlocksPerSM = 5;          // 600 blocks at 480x640: one wave on 132 SMs
constexpr int kSR = 8, kSC = 24;         // the staged patch under a tile, at most
constexpr int kHaloR = 4, kHaloC = 8;    // match21's patch beyond it
constexpr int kWR = kSR + 2 * kHaloR, kWC = kSC + 2 * kHaloC;

struct Axis {
  int i0, i1;       // the two source indices
  float l0, l1;     // their weights
};

// torch's upsample_bilinear2d source index, align_corners=False, no scale
// factor given: scale = in / out.
__device__ __forceinline__ Axis upsample_axis(int dst, int in, float scale) {
  const float src = fmaxf(__fmaf_rn(scale, __fadd_rn(dst, 0.5f), -0.5f), 0.f);
  Axis a;
  a.i0 = static_cast<int>(src);
  a.i1 = a.i0 + ((a.i0 < in - 1) ? 1 : 0);
  a.l1 = __fsub_rn(src, a.i0);
  a.l0 = __fsub_rn(1.f, a.l1);
  return a;
}

// a * x + b * y as fma(a, x, b * y)
__device__ __forceinline__ float dot2(float a, float x, float b, float y) {
  return __fmaf_rn(a, x, __fmul_rn(b, y));
}

// A map upsampled at output pixel (y, x), its value at source cell (r, c)
// given by at(r, c); `swap` sums the first row's pair from its second term.
template <class At>
__device__ __forceinline__ float upsampled(const At& at, const Axis& ay, const Axis& ax,
                                           bool swap) {
  const float a = at(ay.i0, ax.i0), b = at(ay.i0, ax.i1);
  const float r0 = swap ? dot2(ax.l1, b, ax.l0, a) : dot2(ax.l0, a, ax.l1, b);
  const float r1 = dot2(ax.l0, at(ay.i1, ax.i0), ax.l1, at(ay.i1, ax.i1));
  return dot2(ay.l0, r0, ay.l1, r1);
}

// torch.linspace(-1, 1, n)[i]: from the start below the midpoint, from the
// end above it.
__device__ __forceinline__ float linspace_pm1(int i, int n) {
  if (n == 1) return -1.f;
  const float step = 2.f / static_cast<float>(n - 1);
  return (i < n / 2) ? __fmaf_rn(step, i, -1.f) : __fmaf_rn(-step, n - i - 1, 1.f);
}

// The four corners of an align_corners=True bilinear sample at (gx, gy) in
// [-1, 1]^2 on an h x w map, with their weights; valid[k] is false outside.
struct Corners {
  int y[4], x[4];
  float wt[4];
  bool valid[4];
};

__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  const float ix = __fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), w - 1);
  const float iy = __fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), h - 1);
  const float fx = floorf(ix), fy = floorf(iy);
  const int x0 = static_cast<int>(fx), y0 = static_cast<int>(fy);
  Corners c = {{y0, y0, y0 + 1, y0 + 1}, {x0, x0 + 1, x0, x0 + 1}};
  const float wx0 = __fsub_rn(__fadd_rn(fx, 1.f), ix), wx1 = __fsub_rn(ix, fx);
  const float wy0 = __fsub_rn(__fadd_rn(fy, 1.f), iy), wy1 = __fsub_rn(iy, fy);
  c.wt[0] = __fmul_rn(wx0, wy0);
  c.wt[1] = __fmul_rn(wx1, wy0);
  c.wt[2] = __fmul_rn(wx0, wy1);
  c.wt[3] = __fmul_rn(wx1, wy1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    c.valid[k] = c.y[k] >= 0 && c.y[k] < h && c.x[k] >= 0 && c.x[k] < w;
  }
  return c;
}

// A block's staging: the axes of its rows and columns, and the patches.
struct Stage {
  Axis ay[kTileH], ax[kTileW];
  float ly[kTileH], lx[kTileW];  // the identity grid's linspace values
  float2 f8[kSR * kSC];          // flow8 over rows [sr0, sr1) x cols [sc0, sc1)
  float m12[kSR * kSC];
  float m21[kWR * kWC];          // match21 over [wr0, wr1) x [wc0, wc1)
};

struct Args {
  const float* f8;  // this image's flow8 (h8, w8, 2)
  const float* a8;  // match12 (h8, w8)
  const float* c8;  // match21 (h8, w8)
  const float* fc;  // flow_coarse (Hc, Wc, 2)
  int h8, w8, Hc, Wc, Ht, Wt;
  float sh, sw;
  int sr0, sc0, wr0, wr1, wc0, wc1;
};

struct Px {
  float fx, fy, match;
};

// One output pixel of the tile: row `ty`, column `tx` within it.
template <bool kStaged, bool kCycle>
__device__ __forceinline__ Px compose_px(const Stage& s, const Args& a, int ty, int tx) {
  const Axis& ay = s.ay[ty];
  const Axis& ax = s.ax[tx];
  const auto fx8 = [&](int r, int c) {
    return kStaged ? s.f8[(r - a.sr0) * kSC + c - a.sc0].x : a.f8[(r * a.w8 + c) * 2];
  };
  const auto fy8 = [&](int r, int c) {
    return kStaged ? s.f8[(r - a.sr0) * kSC + c - a.sc0].y : a.f8[(r * a.w8 + c) * 2 + 1];
  };
  const auto m12 = [&](int r, int c) {
    return kStaged ? s.m12[(r - a.sr0) * kSC + c - a.sc0] : a.a8[r * a.w8 + c];
  };
  const float gx = fminf(fmaxf(__fadd_rn(upsampled(fx8, ay, ax, true), s.lx[tx]), -1.f), 1.f);
  const float gy = fminf(fmaxf(__fadd_rn(upsampled(fy8, ay, ax, false), s.ly[ty]), -1.f), 1.f);
  Px px;
  px.match = upsampled(m12, ay, ax, false);

  // flow_coarse sampled at (gx, gy) on its own Hc x Wc grid
  const Corners cc = corners(gx, gy, a.Hc, a.Wc);
  const float2* fc2 = reinterpret_cast<const float2*>(a.fc);
  px.fx = 0.f;
  px.fy = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!cc.valid[k]) continue;
    const float2 v = __ldg(fc2 + cc.y[k] * a.Wc + cc.x[k]);
    px.fx = __fmaf_rn(v.x, cc.wt[k], px.fx);
    px.fy = __fmaf_rn(v.y, cc.wt[k], px.fy);
  }
  if (kCycle) {  // match21 upsampled to Ht x Wt, sampled there
    const Corners ct = corners(gx, gy, a.Ht, a.Wt);
    const int y1 = ct.valid[2] ? ct.y[2] : ct.y[0], x1 = ct.valid[1] ? ct.x[1] : ct.x[0];
    const Axis Y0 = upsample_axis(ct.y[0], a.h8, a.sh), Y1 = upsample_axis(y1, a.h8, a.sh);
    const Axis X0 = upsample_axis(ct.x[0], a.w8, a.sw), X1 = upsample_axis(x1, a.w8, a.sw);
    const auto corner = [](const float* r0, const float* r1, const Axis& ya, const Axis& xa) {
      return dot2(ya.l0, dot2(xa.l1, r0[xa.i1], xa.l0, r0[xa.i0]), ya.l1,
                  dot2(xa.l0, r1[xa.i0], xa.l1, r1[xa.i1]));
    };
    float v[4];
    const bool inside = kStaged && Y0.i0 >= a.wr0 && Y1.i1 < a.wr1 && X0.i0 >= a.wc0 &&
                        X1.i1 < a.wc1;
    if (inside) {
      Axis X0s = X0, X1s = X1;
      X0s.i0 -= a.wc0, X0s.i1 -= a.wc0, X1s.i0 -= a.wc0, X1s.i1 -= a.wc0;
      const float *p00 = s.m21 + (Y0.i0 - a.wr0) * kWC, *p01 = s.m21 + (Y0.i1 - a.wr0) * kWC;
      const float *p10 = s.m21 + (Y1.i0 - a.wr0) * kWC, *p11 = s.m21 + (Y1.i1 - a.wr0) * kWC;
      v[0] = corner(p00, p01, Y0, X0s), v[1] = corner(p00, p01, Y0, X1s);
      v[2] = corner(p10, p11, Y1, X0s), v[3] = corner(p10, p11, Y1, X1s);
    } else {
      const float *p00 = a.c8 + Y0.i0 * a.w8, *p01 = a.c8 + Y0.i1 * a.w8;
      const float *p10 = a.c8 + Y1.i0 * a.w8, *p11 = a.c8 + Y1.i1 * a.w8;
      v[0] = corner(p00, p01, Y0, X0), v[1] = corner(p00, p01, Y0, X1);
      v[2] = corner(p10, p11, Y1, X0), v[3] = corner(p10, p11, Y1, X1);
    }
    float m21 = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ct.valid[k]) m21 = __fmaf_rn(v[k], ct.wt[k], m21);
    }
    px.match = __fmul_rn(px.match, m21);
  }
  const bool in_bounds = px.fx >= -1.f && px.fx <= 1.f && px.fy >= -1.f && px.fy <= 1.f;
  px.match = px.match * (in_bounds ? 1.f : 0.f);
  return px;
}

template <bool kStaged, bool kCycle>
__device__ __forceinline__ void compose_pair(const Stage& s, const Args& a, float* flow_out,
                                             float* match_out, int b, int i0t, int j0t) {
  const int ty = threadIdx.y, tx = 2 * threadIdx.x;
  const int i = i0t + ty, j = j0t + tx;
  if (i >= a.Ht || j >= a.Wt) return;
  const long long p = (static_cast<long long>(b) * a.Ht + i) * a.Wt + j;
  const Px q0 = compose_px<kStaged, kCycle>(s, a, ty, tx);
  if (j + 1 < a.Wt) {
    const Px q1 = compose_px<kStaged, kCycle>(s, a, ty, tx + 1);
    if ((p & 1) == 0) {  // 16 bytes of flow and 8 of match, aligned
      *reinterpret_cast<float4*>(flow_out + 2 * p) = make_float4(q0.fx, q0.fy, q1.fx, q1.fy);
      *reinterpret_cast<float2*>(match_out + p) = make_float2(q0.match, q1.match);
      return;
    }
    *reinterpret_cast<float2*>(flow_out + 2 * (p + 1)) = make_float2(q1.fx, q1.fy);
    match_out[p + 1] = q1.match;
  }
  *reinterpret_cast<float2*>(flow_out + 2 * p) = make_float2(q0.fx, q0.fy);
  match_out[p] = q0.match;
}

template <bool kCycle>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) compose_kernel(
    const float* __restrict__ flow8, const float* __restrict__ m12_8,
    const float* __restrict__ m21_8, const float* __restrict__ flow_coarse,
    float* __restrict__ flow_out, float* __restrict__ match_out, int h8, int w8, int Hc,
    int Wc, int Ht, int Wt) {
  __shared__ Stage s;
  const int b = blockIdx.z, i0t = blockIdx.y * kTileH, j0t = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  Args a;
  a.f8 = flow8 + static_cast<long long>(b) * h8 * w8 * 2;
  a.a8 = m12_8 + static_cast<long long>(b) * h8 * w8;
  a.c8 = m21_8 + static_cast<long long>(b) * h8 * w8;
  a.fc = flow_coarse + static_cast<long long>(b) * Hc * Wc * 2;
  a.h8 = h8, a.w8 = w8, a.Hc = Hc, a.Wc = Wc, a.Ht = Ht, a.Wt = Wt;
  a.sh = static_cast<float>(h8) / Ht;
  a.sw = static_cast<float>(w8) / Wt;

  // the tile's axes; a row or column past the output repeats the last one
  if (tid < kTileW) {
    const int j = min(j0t + tid, Wt - 1);
    s.ax[tid] = upsample_axis(j, w8, a.sw);
    s.lx[tid] = linspace_pm1(j, Wt);
  } else if (tid < kTileW + kTileH) {
    const int i = min(i0t + tid - kTileW, Ht - 1);
    s.ay[tid - kTileW] = upsample_axis(i, h8, a.sh);
    s.ly[tid - kTileW] = linspace_pm1(i, Ht);
  }
  // the source cells under the tile: the axes are monotonic in the pixel
  const int i_last = min(i0t + kTileH, Ht) - 1, j_last = min(j0t + kTileW, Wt) - 1;
  a.sr0 = upsample_axis(i0t, h8, a.sh).i0;
  a.sc0 = upsample_axis(j0t, w8, a.sw).i0;
  const int sr1 = upsample_axis(i_last, h8, a.sh).i1 + 1;
  const int sc1 = upsample_axis(j_last, w8, a.sw).i1 + 1;
  const bool staged = sr1 - a.sr0 <= kSR && sc1 - a.sc0 <= kSC;  // block-uniform
  a.wr0 = max(a.sr0 - kHaloR, 0), a.wr1 = min(sr1 + kHaloR, h8);
  a.wc0 = max(a.sc0 - kHaloC, 0), a.wc1 = min(sc1 + kHaloC, w8);
  // the patches: every load in flight at once, then the stores; slot k of
  // a patch buffer is its cell (k / pitch, k % pitch)
  {
    constexpr int kFU = (kSR * kSC + kThreads - 1) / kThreads;  // slots a thread
    constexpr int kCU = (kWR * kWC + kThreads - 1) / kThreads;
    const int nr = sr1 - a.sr0, nc = sc1 - a.sc0;
    const int wnr = a.wr1 - a.wr0, wnc = a.wc1 - a.wc0;
    const float2* f2 = reinterpret_cast<const float2*>(a.f8);
    float2 fv[kFU];
    float av[kFU], cv[kCU];
#pragma unroll
    for (int u = 0; u < kFU; ++u) {
      const int k = tid + u * kThreads, r = k / kSC, c = k - r * kSC;
      if (staged && r < nr && c < nc) {
        const int g = (a.sr0 + r) * w8 + a.sc0 + c;
        fv[u] = __ldg(f2 + g);
        av[u] = __ldg(a.a8 + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kCU; ++u) {
      const int k = tid + u * kThreads, r = k / kWC, c = k - r * kWC;
      if (kCycle && staged && r < wnr && c < wnc) {
        cv[u] = __ldg(a.c8 + (a.wr0 + r) * w8 + a.wc0 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kFU; ++u) {
      const int k = tid + u * kThreads, r = k / kSC, c = k - r * kSC;
      if (staged && r < nr && c < nc) s.f8[k] = fv[u], s.m12[k] = av[u];
    }
#pragma unroll
    for (int u = 0; u < kCU; ++u) {
      const int k = tid + u * kThreads, r = k / kWC, c = k - r * kWC;
      if (kCycle && staged && r < wnr && c < wnc) s.m21[k] = cv[u];
    }
  }
  __syncthreads();
  if (staged) {
    compose_pair<true, kCycle>(s, a, flow_out, match_out, b, i0t, j0t);
  } else {
    compose_pair<false, kCycle>(s, a, flow_out, match_out, b, i0t, j0t);
  }
}

}  // namespace

// flow8: (B, h8, w8, 2), m12_8 and m21_8: (B, h8, w8, 1), flow_coarse:
// (B, Hc, Wc, 2), all fp32, flow8 and flow_coarse 8-byte aligned; flow_out:
// (B, Ht, Wt, 2) and match_out: (B, Ht, Wt), 16- and 8-byte aligned.
RF_API int rf_compose_tail(const float* flow8, const float* m12_8,
                           const float* m21_8, const float* flow_coarse,
                           float* flow_out, float* match_out, int B, int h8,
                           int w8, int Hc, int Wc, int Ht, int Wt,
                           int cycle_match, cudaStream_t stream) {
  const dim3 grid((Wt + kTileW - 1) / kTileW, (Ht + kTileH - 1) / kTileH, B);
  const auto kernel = cycle_match ? compose_kernel<true> : compose_kernel<false>;
  kernel<<<grid, dim3(kThreadsX, kTileH), 0, stream>>>(
      flow8, m12_8, m21_8, flow_coarse, flow_out, match_out, h8, w8, Hc, Wc, Ht, Wt);
  return static_cast<int>(cudaGetLastError());
}
