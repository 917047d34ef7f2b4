// Local correlation volume (CorrNeigh), channels-last fp32.
//
// Replaces: ransacflow_tpu/ops/correlation.py:21 correlation_volume (an XLA
// fusion of k*k shifted multiply + channel-sum slabs; its Pallas
// predecessor tiled x and a haloed y in VMEM).
//
//   out[b, i, j, di*k + dj] = sum_c x[b, i, j, c] * y[b, i+di-p, j+dj-p, c]
//   with p = k/2 and zeros outside the map.
//
// What bounds it on the H100: at the fine-stage shape (1, 60, 80, 256), k=7
// the kernel reads 2 x 4.9 MB and writes 0.9 MB, and does 60 M multiply-adds,
// so it is far from both the FLOP and the HBM roofline; what costs is the
// 49-fold reuse of every y element, which read from device memory per output
// would make it L2-bound. Design: one block per (row i, tile of 16 output
// columns). For each chunk of 32 channels the block stages the x tile and
// the k haloed y rows it needs in shared memory (zeros for the padding),
// then each thread accumulates its outputs from shared memory. Rows are
// padded to 33 floats so that neighbouring rows fall in different banks.
// Simple and right first: no tensor cores, no asynchronous copies.
//
// Its backward (rf_correlation_volume_bwd, the TPU's autodiff of the same
// op in training) is in gather form, with no atomics:
//   dx[b, i, j, c] = sum_d g[b, i, j, d] * y[b, i+di-p, j+dj-p, c]
//   dy[b, i, j, c] = sum_d g[b, i-di+p, j-dj+p, d] * x[b, i-di+p, j-dj+p, c]
// terms outside the map being zero. At the training shape (32, 28, 28, 256),
// k=7, it does 2 x 315 M multiply-adds whose operands come from L1/L2: one
// thread per (pixel, channel), consecutive threads on consecutive channels,
// so the y and x reads of a warp are one coalesced row and the g reads a
// broadcast. Each sum runs in offset order, so the result is deterministic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileJ = 16;             // output columns per block
constexpr int kChunkC = 32;            // channels staged per step
constexpr int kStride = kChunkC + 1;   // padded shared-memory row
constexpr int kMaxAcc = 8;             // outputs per thread

__global__ void __launch_bounds__(kThreads) correlation_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    float* __restrict__ out, int H, int W, int C, int k) {
  extern __shared__ float smem[];
  const int p = k / 2;
  const int kk = k * k;
  const int span = kTileJ + 2 * p;     // y columns one tile reads
  float* sx = smem;                    // [kTileJ][kStride]
  float* sy = smem + kTileJ * kStride; // [k][span][kStride]

  const int j0 = blockIdx.x * kTileJ;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_out = kTileJ * kk;
  const float* xb = x + static_cast<size_t>(b) * H * W * C;
  const float* yb = y + static_cast<size_t>(b) * H * W * C;

  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    for (int e = tid; e < kTileJ * kChunkC; e += kThreads) {
      const int jj = e / kChunkC;
      const int c = e % kChunkC;
      const int j = j0 + jj;
      float v = 0.f;
      if (j < W && c0 + c < C) {
        v = xb[(static_cast<size_t>(i) * W + j) * C + c0 + c];
      }
      sx[jj * kStride + c] = v;
    }
    for (int e = tid; e < k * span * kChunkC; e += kThreads) {
      const int c = e % kChunkC;
      const int col = (e / kChunkC) % span;
      const int r = e / (kChunkC * span);
      const int yi = i + r - p;
      const int yj = j0 + col - p;
      float v = 0.f;
      if (yi >= 0 && yi < H && yj >= 0 && yj < W && c0 + c < C) {
        v = yb[(static_cast<size_t>(yi) * W + yj) * C + c0 + c];
      }
      sy[(r * span + col) * kStride + c] = v;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int o = tid + a * kThreads;
      if (o < n_out) {
        const int jj = o / kk;
        const int d = o % kk;
        const int di = d / k;
        const int dj = d % k;
        const float* px = sx + jj * kStride;
        const float* py = sy + (di * span + jj + dj) * kStride;
        float s = acc[a];
#pragma unroll 8
        for (int c = 0; c < kChunkC; ++c) s = fmaf(px[c], py[c], s);
        acc[a] = s;
      }
    }
    __syncthreads();
  }

  // o = jj * kk + d, so a tile's outputs are one contiguous run of memory
  float* ob = out + ((static_cast<size_t>(b) * H + i) * W + j0) * kk;
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int o = tid + a * kThreads;
    if (o < n_out && j0 + o / kk < W) ob[o] = acc[a];
  }
}

__global__ void __launch_bounds__(kThreads) correlation_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ dy,
    int H, int W, int C, int k, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int c = static_cast<int>(e % C);
  const long long pix = e / C;
  const int j = static_cast<int>(pix % W);
  const int i = static_cast<int>((pix / W) % H);
  const long long b0 = pix / (static_cast<long long>(H) * W) * H * W;  // first pixel of b
  const int p = k / 2, kk = k * k;
  float sx = 0.f, sy = 0.f;
  for (int di = 0; di < k; ++di) {
    for (int dj = 0; dj < k; ++dj) {
      const int d = di * k + dj;
      if (dx != nullptr) {
        const int yi = i + di - p, yj = j + dj - p;
        if (yi >= 0 && yi < H && yj >= 0 && yj < W) {
          sx = fmaf(g[pix * kk + d], y[(b0 + yi * W + yj) * C + c], sx);
        }
      }
      if (dy != nullptr) {
        const int gi = i - di + p, gj = j - dj + p;
        if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
          const long long q = b0 + gi * W + gj;
          sy = fmaf(g[q * kk + d], x[q * C + c], sy);
        }
      }
    }
  }
  if (dx != nullptr) dx[e] = sx;
  if (dy != nullptr) dy[e] = sy;
}

}  // namespace

// The caller keeps k odd and k <= 11, so that kTileJ * k * k outputs fit
// kThreads * kMaxAcc accumulators and the tiles fit 48 KB of shared memory.
RF_API int rf_correlation_volume(const float* x, const float* y, float* out,
                                 int B, int H, int W, int C, int k,
                                 cudaStream_t stream) {
  const int span = kTileJ + 2 * (k / 2);
  const size_t smem = sizeof(float) * static_cast<size_t>(kTileJ + k * span) *
                      kStride;
  const dim3 grid((W + kTileJ - 1) / kTileJ, H, B);
  correlation_kernel<<<grid, kThreads, smem, stream>>>(x, y, out, H, W, C, k);
  return static_cast<int>(cudaGetLastError());
}

// g: (B, H, W, k*k) the volume's cotangent; dx, dy: (B, H, W, C), either
// null to skip it. Same layouts as rf_correlation_volume.
RF_API int rf_correlation_volume_bwd(const float* x, const float* y, const float* g,
                                     float* dx, float* dy, int B, int H, int W,
                                     int C, int k, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * W * C;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  correlation_bwd_kernel<<<blocks, kThreads, 0, stream>>>(x, y, g, dx, dy, H, W, C, k,
                                                          total);
  return static_cast<int>(cudaGetLastError());
}
