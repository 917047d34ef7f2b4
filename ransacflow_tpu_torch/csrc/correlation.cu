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
// op in training) is a gather, with no atomics. Since k - 1 = 2p, the
// offsets satisfy delta(kk - 1 - d) = -delta(d), so both cotangents have
// the forward's neighbourhood form:
//   dx[b, i, j, c] = sum_d g[b, i, j, d] * y[b, i+di-p, j+dj-p, c]
//   dy[b, i, j, c] = sum_d g[b, i+di-p, j+dj-p, kk-1-d] * x[b, i+di-p, j+dj-p, c]
// terms outside the map being zero: out = sum_d w_d * z at the neighbour,
// z = y or x, the weights w either the output pixel's cotangent (dx) or
// the neighbour's, in reverse offset order (dy). At the training shape
// (32, 28, 28, 256), k=7, that is 2 x 315 M multiply-adds over 2 x 26 MB of
// maps, so it is bound by reuse, not by HBM (bound ~0.03 ms by bytes).
// Design, tiled as the forward is: one block per (row i, tile of
// kBwdTileJ = 32 output columns, image, cotangent: blockIdx.z picks dx or
// dy, so both run in one launch). The block first stages its weights
// w[jj][di][dj] (k rows padded to a multiple of 4: 7 KB for k=7, 17 KB for
// k=11): for dx the tile's own cotangent rows, for dy the k haloed rows of
// g gathered in reverse offset order, zeros outside the map. Then, for each
// chunk of 128 channels and each of the k neighbour rows in the map, it
// stages that row of z (span = 32 + 2p columns x 128 channels, 19.5 KB for
// k=7) and every thread accumulates 4 adjacent output columns x 4
// channels: a float4 of z read once from shared memory serves every
// (column, dj) pair it meets (a sliding window), and the weights of a row
// come in as broadcast float4 reads. A warp is one column group over 128
// contiguous channels, so its shared reads are conflict-free without
// padding. Shared memory stays under 48 KB for every k <= 11 (38 KB at 11),
// so no opt-in is needed. Each sum runs in (di, dj) order, so the result is
// deterministic. The remaining cost is shared-memory traffic: ~10 float4
// reads of z per 112 multiply-adds a thread, and each z row staged once per
// output row that reads it (k times).
#include "common.cuh"

#include <stdint.h>

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

constexpr int kBwdTileJ = 32;  // output columns per backward block
constexpr int kBwdCols = 4;    // adjacent output columns per thread
constexpr int kLanes = 32;     // float4 channel lanes per column group: 128 channels
constexpr int kBwdThreads = kLanes * kBwdTileJ / kBwdCols;

template <int K>
__global__ void __launch_bounds__(kBwdThreads) correlation_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ g, float* __restrict__ dx, float* __restrict__ dy,
    int H, int W, int C, int ncot, bool vec4) {
  constexpr int P = K / 2, KK = K * K;
  constexpr int KP = (K + 3) / 4 * 4;  // a weight row padded to whole float4s
  constexpr int SPAN = kBwdTileJ + 2 * P;
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);      // [kBwdTileJ][K][KP] weights
  float4* sz = smem4 + kBwdTileJ * K * KP / 4;      // [SPAN][kLanes] one row of z

  const int j0 = blockIdx.x * kBwdTileJ;
  const int i = blockIdx.y;
  const int b = blockIdx.z / ncot;
  const bool is_dy = ncot == 2 ? (blockIdx.z & 1) != 0 : dx == nullptr;
  const float* z = is_dy ? x : y;
  float* out = is_dy ? dy : dx;
  const size_t img = static_cast<size_t>(b) * H * W;  // first pixel of image b
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int jc = tid / kLanes * kBwdCols;  // the thread's first column in the tile

  if (!is_dy) {  // w[jj][di][dj] = g[i, j0 + jj, di * K + dj]
    const float* gp = g + (img + static_cast<size_t>(i) * W + j0) * KK;
    const int n = min(kBwdTileJ, W - j0) * KK;
    for (int e = tid; e < kBwdTileJ * KK; e += kBwdThreads) {
      const int jj = e / KK, d = e - jj * KK;
      sw[(jj * K + d / K) * KP + d % K] = e < n ? gp[e] : 0.f;
    }
  } else {  // w[jj][di][dj] = g[i+di-P, j0+jj+dj-P, (K-1-di) * K + (K-1-dj)]
    for (int e = tid; e < K * SPAN * K; e += kBwdThreads) {
      const int di = e / (SPAN * K);
      const int col = e / K - di * SPAN;
      const int m = e % K;  // runs of K along memory
      const int r = i + di - P, q = j0 - P + col;
      const int dj = K - 1 - m, jj = col - dj;
      if (jj < 0 || jj >= kBwdTileJ) continue;
      float v = 0.f;
      if (r >= 0 && r < H && q >= 0 && q < W) {
        v = g[(img + static_cast<size_t>(r) * W + q) * KK + (K - 1 - di) * K + m];
      }
      sw[(jj * K + di) * KP + dj] = v;
    }
  }

  for (int c0 = 0; c0 < C; c0 += 4 * kLanes) {
    float4 acc[kBwdCols];
#pragma unroll
    for (int a = 0; a < kBwdCols; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int di = 0; di < K; ++di) {
      const int r = i + di - P;
      if (r < 0 || r >= H) continue;  // a row of zeros (the same for the whole block)
      __syncthreads();  // the previous row's readers (and the weights' writers) are done
      const float* zr = z + (img + static_cast<size_t>(r) * W) * C;
      for (int e = tid; e < SPAN * kLanes; e += kBwdThreads) {
        const int col = e / kLanes, l = e - col * kLanes;
        const int q = j0 - P + col, c = c0 + 4 * l;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q >= 0 && q < W && c < C) {
          const float* src = zr + static_cast<size_t>(q) * C + c;
          if (vec4) {
            v = *reinterpret_cast<const float4*>(src);
          } else {
            v.x = src[0];
            if (c + 1 < C) v.y = src[1];
            if (c + 2 < C) v.z = src[2];
            if (c + 3 < C) v.w = src[3];
          }
        }
        sz[e] = v;
      }
      __syncthreads();

      float w[kBwdCols][KP];  // this row's weights of the thread's columns
#pragma unroll
      for (int a = 0; a < kBwdCols; ++a) {
        const float4* wr = reinterpret_cast<const float4*>(sw + ((jc + a) * K + di) * KP);
#pragma unroll
        for (int t = 0; t < KP / 4; ++t) {
          const float4 v = wr[t];
          w[a][4 * t] = v.x;
          w[a][4 * t + 1] = v.y;
          w[a][4 * t + 2] = v.z;
          w[a][4 * t + 3] = v.w;
        }
      }
      // sliding window: staged column jc + pos meets output column jc + a at dj = pos - a
#pragma unroll
      for (int pos = 0; pos < kBwdCols + K - 1; ++pos) {
        const float4 v = sz[(jc + pos) * kLanes + lane];
#pragma unroll
        for (int a = 0; a < kBwdCols; ++a) {
          const int dj = pos - a;
          if (dj < 0 || dj >= K) continue;
          acc[a].x = fmaf(w[a][dj], v.x, acc[a].x);
          acc[a].y = fmaf(w[a][dj], v.y, acc[a].y);
          acc[a].z = fmaf(w[a][dj], v.z, acc[a].z);
          acc[a].w = fmaf(w[a][dj], v.w, acc[a].w);
        }
      }
    }

    const int c = c0 + 4 * lane;
#pragma unroll
    for (int a = 0; a < kBwdCols; ++a) {
      const int j = j0 + jc + a;
      if (j >= W || c >= C) continue;
      float* dst = out + (img + static_cast<size_t>(i) * W + j) * C + c;
      if (vec4) {
        *reinterpret_cast<float4*>(dst) = acc[a];
      } else {
        dst[0] = acc[a].x;
        if (c + 1 < C) dst[1] = acc[a].y;
        if (c + 2 < C) dst[2] = acc[a].z;
        if (c + 3 < C) dst[3] = acc[a].w;
      }
    }
  }
}

template <int K>
int launch_bwd(const float* x, const float* y, const float* g, float* dx, float* dy,
               int B, int H, int W, int C, cudaStream_t stream) {
  constexpr int KP = (K + 3) / 4 * 4;
  const int ncot = (dx != nullptr) + (dy != nullptr);
  if (ncot == 0) return 0;
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec4 = C % 4 == 0 && aligned(x) && aligned(y) && aligned(dx) && aligned(dy);
  const size_t smem = sizeof(float) * kBwdTileJ * K * KP +
                      sizeof(float4) * (kBwdTileJ + 2 * (K / 2)) * kLanes;
  const dim3 grid((W + kBwdTileJ - 1) / kBwdTileJ, H, B * ncot);
  correlation_bwd_kernel<K><<<grid, kBwdThreads, smem, stream>>>(x, y, g, dx, dy, H, W,
                                                                C, ncot, vec4);
  return static_cast<int>(cudaGetLastError());
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
// null to skip it. Same layouts as rf_correlation_volume; k odd, <= 11.
RF_API int rf_correlation_volume_bwd(const float* x, const float* y, const float* g,
                                     float* dx, float* dy, int B, int H, int W,
                                     int C, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_bwd<1>(x, y, g, dx, dy, B, H, W, C, stream);
    case 3: return launch_bwd<3>(x, y, g, dx, dy, B, H, W, C, stream);
    case 5: return launch_bwd<5>(x, y, g, dx, dy, B, H, W, C, stream);
    case 7: return launch_bwd<7>(x, y, g, dx, dy, B, H, W, C, stream);
    case 9: return launch_bwd<9>(x, y, g, dx, dy, B, H, W, C, stream);
    case 11: return launch_bwd<11>(x, y, g, dx, dy, B, H, W, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
