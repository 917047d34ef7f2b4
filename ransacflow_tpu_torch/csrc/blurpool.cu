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
// 112 x 112 out) 407 MB read and 103 MB written, ~0.15 ms at 3.35 TB/s.
//
// Forward: one thread per output, consecutive threads along the memory's
// fastest axis (W in NCHW, C in channels-last), so every warp reads and
// writes neighbouring addresses.
//
// Backward: a gather (no atomics, so it is deterministic) in closed form.
// The filter is separable, and along one axis of n inputs and n_out =
// (n - 1) / 2 + 1 outputs input r receives
//   r even: 0.5 g[r/2];
//   r odd:  0.25 (g[(r-1)/2] + g[(r+1)/2]), the second term only when
//           (r+1)/2 < n_out;
// and the reflect pad adds 0.25 g[0] to r = 1 and, when n is odd,
// 0.25 g[n_out-1] to r = n - 2. So input rows 2i and 2i+1 (columns
// likewise) read only g rows i and i+1: one thread owns a 2x2 input quad
// per channel (4 channels as a float4 in channels-last memory when
// C % 4 == 0), reads the 2x2 block of g in registers and writes its four
// values once; neighbouring quads share their g reads through L1 and L2
// (walking several quads down a column and carrying a g row between them
// was slower on the H100). Indices are 32-bit, from a 3-D grid
// (quad columns x channel vectors, quad rows, planes): no 64-bit division.
// The bound is the same bytes as the forward's, read and written the other
// way: 103 MB of g in, 407 MB of dx out at the stem.
#include "common.cuh"

#include <stdint.h>

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

// Along one axis, the weights with which input rows 2i and 2i+1 receive g
// rows i and i+1 (the even row takes 0.5 g[i] alone).
struct QuadAxis {
  float lo, hi;    // the odd row's weights on g[i] and g[i + 1]
  bool odd, next;  // row 2i+1 exists; g row i+1 exists
};

__device__ __forceinline__ QuadAxis quad_axis(int i, int n, int n_out) {
  QuadAxis a;
  a.odd = 2 * i + 1 < n;
  a.next = i + 1 < n_out;
  a.lo = i == 0 ? 0.5f : 0.25f;  // r = 1 takes the reflected g[0] too
  a.hi = !a.next ? 0.f : ((n & 1) && i == n_out - 2) ? 0.5f : 0.25f;  // r = n - 2
  return a;
}

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& r) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// One thread per 2x2 input quad (quad row i, quad column j) and channel
// vector `lane` of one plane. A plane is an (image, channel) pair in NCHW
// memory (step 1, lanes 1) and an image in channels-last memory (step C,
// lanes C / V).
template <int V>
__global__ void __launch_bounds__(kThreads) blurpool_bwd_kernel(
    const float* __restrict__ g, float* __restrict__ dx, int H, int W, int Ho,
    int Wo, int step, int lanes, int planes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (t >= Wo * lanes || i >= Ho) return;
  const int j = t / lanes;
  const int lane = t - j * lanes;
  const QuadAxis row = quad_axis(i, H, Ho), col = quad_axis(j, W, Wo);
  for (int plane = blockIdx.z; plane < planes; plane += gridDim.z) {
    const float* gp = g + static_cast<size_t>(plane) * Ho * Wo * step + lane * V;
    float* dp = dx + static_cast<size_t>(plane) * H * W * step + lane * V;
    const Vec<V> zero = {};
    // the 2x2 block g[i..i+1, j..j+1], zeros past the map
    const Vec<V> a0 = load<V>(gp + (i * Wo + j) * step);
    const Vec<V> a1 = col.next ? load<V>(gp + (i * Wo + j + 1) * step) : zero;
    const Vec<V> b0 = row.next ? load<V>(gp + ((i + 1) * Wo + j) * step) : zero;
    const Vec<V> b1 =
        row.next && col.next ? load<V>(gp + ((i + 1) * Wo + j + 1) * step) : zero;
    Vec<V> e0, e1, o0, o1;  // rows 2i, 2i+1 at columns 2j, 2j+1
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float ta = col.lo * a0.v[v] + col.hi * a1.v[v];  // row i, odd column
      const float tb = col.lo * b0.v[v] + col.hi * b1.v[v];  // row i+1, odd column
      e0.v[v] = 0.25f * a0.v[v];
      e1.v[v] = 0.5f * ta;
      o0.v[v] = 0.5f * (row.lo * a0.v[v] + row.hi * b0.v[v]);
      o1.v[v] = row.lo * ta + row.hi * tb;
    }
    float* d = dp + (2 * i * W + 2 * j) * step;
    store<V>(d, e0);
    if (col.odd) store<V>(d + step, e1);
    if (row.odd) {
      store<V>(d + W * step, o0);
      if (col.odd) store<V>(d + (W + 1) * step, o1);
    }
  }
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
  // channels-last: x runs over (quad column, channel vector), channels
  // fastest; NCHW: x over quad columns, z over (image, channel) planes
  const bool aligned = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int v = channels_last && C % 4 == 0 && aligned ? 4 : 1;
  const int lanes = channels_last ? C / v : 1;
  const int planes = channels_last ? N : N * C;
  const dim3 block = channels_last ? dim3(64, 4) : dim3(32, 8);
  const dim3 grid((Wo * lanes + block.x - 1) / block.x, (Ho + block.y - 1) / block.y,
                  planes < 65535 ? planes : 65535);
  const int step = channels_last ? C : 1;
  if (v == 4) {
    blurpool_bwd_kernel<4><<<grid, block, 0, stream>>>(g, dx, H, W, Ho, Wo, step, lanes,
                                                       planes);
  } else {
    blurpool_bwd_kernel<1><<<grid, block, 0, stream>>>(g, dx, H, W, Ho, Wo, step, lanes,
                                                       planes);
  }
  return static_cast<int>(cudaGetLastError());
}
