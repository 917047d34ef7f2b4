// Blur-pool: reflect pad (1, 1), the normalized binomial-3 filter, stride 2,
// on each channel of an NCHW tensor held in NCHW or channels-last memory;
// and its backward.
//
// Replaces: ransacflow_tpu/ops/blurpool.py:42 blur_pool (a jnp.pad in
// reflect mode and a depthwise lax.conv_general_dilated with stride 2),
// inside the fine feature extractor, where the TPU's autodiff gave its
// backward.
//
//   out[i, j] = sum_{a, b} f[a] f[b] x[r(2i + a - 1), r(2j + b - 1)],
//   f = (1, 2, 1) / 4, r reflects: r(-1) = 1, r(n) = n - 2.
//
// What bounds it on the H100: 9 multiply-adds per output against 4 bytes
// written and ~9 reads that neighbouring threads share through L1, so it is
// bound by memory traffic: at the training stem (32 x 64 x 223 x 223 in,
// 112 x 112 out) 407 MB read and 103 MB written, ~0.15 ms at 3.35 TB/s. One
// thread per output (forward) or per input (backward) pixel, consecutive
// threads along the memory's fastest axis (W in NCHW, C in channels-last),
// so every warp reads and writes neighbouring addresses. The backward is a
// gather: each input pixel sums the outputs whose window covers a padded
// position that reflects onto it; no atomics, so it is deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

__device__ __forceinline__ float tap(int a) { return a == 1 ? 0.5f : 0.25f; }

// Offset of (n, c, y, x) in a tensor of C channels and H x W pixels.
__device__ __forceinline__ size_t offset(int n, int c, int y, int x, int C,
                                         int H, int W, bool channels_last) {
  return channels_last
             ? ((static_cast<size_t>(n) * H + y) * W + x) * C + c
             : ((static_cast<size_t>(n) * C + c) * H + y) * W + x;
}

// Decompose a linear index in memory order into (n, c, y, x).
__device__ __forceinline__ void position(long long e, int C, int H, int W,
                                         bool channels_last, int& n, int& c,
                                         int& y, int& x) {
  if (channels_last) {
    c = static_cast<int>(e % C);
    e /= C;
    x = static_cast<int>(e % W);
    e /= W;
    y = static_cast<int>(e % H);
    n = static_cast<int>(e / H);
  } else {
    x = static_cast<int>(e % W);
    e /= W;
    y = static_cast<int>(e % H);
    e /= H;
    c = static_cast<int>(e % C);
    n = static_cast<int>(e / C);
  }
}

__global__ void __launch_bounds__(kThreads) blurpool_fwd_kernel(
    const float* __restrict__ x, float* __restrict__ y, int C, int H, int W,
    int Ho, int Wo, long long total, bool channels_last) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  int n, c, i, j;
  position(e, C, Ho, Wo, channels_last, n, c, i, j);
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int r = reflect(2 * i + a - 1, H);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int q = reflect(2 * j + b - 1, W);
      acc = fmaf(tap(a) * tap(b), x[offset(n, c, r, q, C, H, W, channels_last)], acc);
    }
  }
  y[e] = acc;
}

// The outputs along one axis whose taps read input position r (after
// reflection), with the tap weight: up to 6 of them.
__device__ __forceinline__ int covering(int r, int n, int n_out, int* idx,
                                        float* wt) {
  int pads[3] = {r + 1, -1, -1};  // padded positions that reflect onto r
  if (r == 1) pads[1] = 0;
  if (r == n - 2) pads[2] = n + 1;
  int k = 0;
  for (int s = 0; s < 3; ++s) {
    const int p = pads[s];
    if (p < 0) continue;
    for (int a = 0; a < 3; ++a) {
      const int t = p - a;
      if (t >= 0 && (t & 1) == 0 && t / 2 < n_out) {
        idx[k] = t / 2;
        wt[k] = tap(a);
        ++k;
      }
    }
  }
  return k;
}

__global__ void __launch_bounds__(kThreads) blurpool_bwd_kernel(
    const float* __restrict__ g, float* __restrict__ dx, int C, int H, int W,
    int Ho, int Wo, long long total, bool channels_last) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  int n, c, r, q;
  position(e, C, H, W, channels_last, n, c, r, q);
  int ri[6], ci[6];
  float rw[6], cw[6];
  const int nr = covering(r, H, Ho, ri, rw);
  const int nc = covering(q, W, Wo, ci, cw);
  float acc = 0.f;
  for (int a = 0; a < nr; ++a) {
    for (int b = 0; b < nc; ++b) {
      acc = fmaf(rw[a] * cw[b], g[offset(n, c, ri[a], ci[b], C, Ho, Wo, channels_last)],
                 acc);
    }
  }
  dx[e] = acc;
}

}  // namespace

// x: (N, C, H, W) fp32 in NCHW or channels-last memory; y: (N, C, Ho, Wo) in
// the same memory format, Ho = (H - 1) / 2 + 1, Wo likewise; H, W >= 2.
RF_API int rf_blurpool_fwd(const float* x, float* y, int N, int C, int H, int W,
                           int channels_last, cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long total = static_cast<long long>(N) * C * Ho * Wo;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  blurpool_fwd_kernel<<<blocks, kThreads, 0, stream>>>(x, y, C, H, W, Ho, Wo, total,
                                                       channels_last != 0);
  return static_cast<int>(cudaGetLastError());
}

// g: (N, C, Ho, Wo) the output's cotangent; dx: (N, C, H, W), both in the
// memory format `channels_last` names.
RF_API int rf_blurpool_bwd(const float* g, float* dx, int N, int C, int H, int W,
                           int channels_last, cudaStream_t stream) {
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long total = static_cast<long long>(N) * C * H * W;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  blurpool_bwd_kernel<<<blocks, kThreads, 0, stream>>>(g, dx, C, H, W, Ho, Wo, total,
                                                       channels_last != 0);
  return static_cast<int>(cudaGetLastError());
}
