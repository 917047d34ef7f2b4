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
