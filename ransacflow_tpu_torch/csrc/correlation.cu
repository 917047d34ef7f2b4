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
// the kernel reads 2 x 4.9 MB and writes 0.9 MB (bound ~0.003 ms by bytes)
// and does 60 M multiply-adds; at the training step's (32, 28, 28, 256) 315
// M. Both are far below the fp32 rate: what costs is the 49-fold reuse of
// every y element, latency and filling 132 SMs with a 60x80 map.
// Design: one block per (kRows = 2 output rows, kTileJ = 16 output
// columns, image). A thread owns kCols = 4 adjacent output columns x all k
// values of dj for one (row, di), over every 8th float4 of each 32-channel
// chunk (8 lanes share an output: 448 threads at k = 7). For each chunk the
// block stages, as 16-byte cp.async copies double-buffered against the
// previous chunk's arithmetic, the x tile and the kRows + k - 1 y rows that
// its rows read, each once (zeros outside the map, by the copies' zero
// fill). The thread reads its 4 x float4 once and slides over the kCols + k
// - 1 y float4 of its row: each serves every (column, dj) pair it meets, 4
// multiply-adds a pair. The 8 lanes' partial sums are added by a fixed
// butterfly at the end. Every output sums its channels in the same order
// (lane g: channels 32 s + 4 g .. + 3 for chunks s in order; then the
// butterfly), and fmaf is symmetric in its factors, so corr(y, x) at (i', j',
// kk-1-d) is bit for bit corr(x, y) at (i, j, d) with (i', j') the offset
// neighbour. The pair form (rf_correlation_pair) writes both volumes from
// one pass: each value of corr(x, y) also goes to its place in corr(y, x),
// and the entry of corr(y, x) whose neighbour lies outside the map is 0.
// Shared memory: two stages of 26 KB at k = 7 (88 KB in all at k = 11),
// above 48 KB through the opt-in.
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
// Design: one block per (row i, tile of
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

constexpr int kRows = 2;      // output rows per block
constexpr int kTileJ = 16;    // output columns per block
constexpr int kCols = 4;      // adjacent output columns per thread
constexpr int kChunk4 = 8;    // float4s per staged channel chunk (32 channels)

__device__ __forceinline__ void copy16_or_zero(float4* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4_or_zero(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}

// One chunk of channels [c0, c0 + 32) of the block's x tile [kRows][kTileJ]
// and y rows [kRows + K - 1][kTileJ + K - 1] into sx, sy (float4 per 4
// channels, zeros outside the map and past C).
template <int K, int kThreadsT>
__device__ __forceinline__ void stage_chunk(
    float4* sx, float4* sy, const float* xb, const float* yb, int i0, int j0,
    int c0, int H, int W, int C, bool vec) {
  constexpr int P = K / 2, SPAN = kTileJ + K - 1;
  constexpr int NX = kRows * kTileJ * kChunk4;
  constexpr int N = NX + (kRows + K - 1) * SPAN * kChunk4;
  for (int e = threadIdx.x; e < N; e += kThreadsT) {
    const bool is_x = e < NX;
    const int f = is_x ? e : e - NX;
    const int l = f % kChunk4, pos = f / kChunk4;
    const int span = is_x ? kTileJ : SPAN;
    const int r = pos / span, col = pos - r * span;
    const int gi = is_x ? i0 + r : i0 + r - P;
    const int gj = is_x ? j0 + col : j0 + col - P;
    const int c = c0 + 4 * l;
    const bool in_map = gi >= 0 && gi < H && gj >= 0 && gj < W;
    const float* base = is_x ? xb : yb;
    const float* src = base + (static_cast<size_t>(in_map ? gi : 0) * W + (in_map ? gj : 0)) * C;
    float4* dst = (is_x ? sx : sy) + f;
    if (vec) {
      const bool ok = in_map && c < C;
      copy16_or_zero(dst, ok ? src + c : base, ok);
    } else {
      float* d = reinterpret_cast<float*>(dst);
      for (int q = 0; q < 4; ++q) {
        const bool ok = in_map && c + q < C;
        copy4_or_zero(d + q, ok ? src + c + q : base, ok);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int K, bool PAIR>
__global__ void __launch_bounds__(kRows * K * 32, K <= 7 ? 2 : 1) correlation_kernel(
    const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
    float* __restrict__ out_yx, int H, int W, int C, bool vec) {
  constexpr int P = K / 2, KK = K * K, SPAN = kTileJ + K - 1;
  constexpr int kThreadsT = kRows * K * 32;
  constexpr int STAGE = (kRows * kTileJ + (kRows + K - 1) * SPAN) * kChunk4;  // float4s
  extern __shared__ float4 smem4[];

  const int j0 = blockIdx.x * kTileJ;
  const int i0 = blockIdx.y * kRows;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid & 7;                 // the float4 of each chunk this lane sums
  const int jc = ((tid >> 3) & 3) * kCols;  // the thread's first column in the tile
  const int il = (tid >> 5) / K;         // its output row in the block
  const int di = (tid >> 5) % K;         // and its row offset
  const size_t img = static_cast<size_t>(b) * H * W * C;
  const float* xb = x + img;
  const float* yb = y + img;

  float acc[kCols][K];
#pragma unroll
  for (int a = 0; a < kCols; ++a)
#pragma unroll
    for (int dj = 0; dj < K; ++dj) acc[a][dj] = 0.f;

  const int n_chunks = (C + 4 * kChunk4 - 1) / (4 * kChunk4);
  stage_chunk<K, kThreadsT>(smem4, smem4 + kRows * kTileJ * kChunk4, xb, yb, i0, j0, 0,
                            H, W, C, vec);
  for (int s = 0; s < n_chunks; ++s) {
    float4* sx = smem4 + (s & 1) * STAGE;
    const float4* sy = sx + kRows * kTileJ * kChunk4;
    if (s + 1 < n_chunks) {
      float4* nx = smem4 + ((s + 1) & 1) * STAGE;
      stage_chunk<K, kThreadsT>(nx, nx + kRows * kTileJ * kChunk4, xb, yb, i0, j0,
                                (s + 1) * 4 * kChunk4, H, W, C, vec);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk s has landed for every thread

    float4 xv[kCols];
#pragma unroll
    for (int a = 0; a < kCols; ++a) xv[a] = sx[(il * kTileJ + jc + a) * kChunk4 + g];
    // sliding window: staged column jc + pos meets output column jc + a at dj = pos - a
    const float4* yr = sy + ((il + di) * SPAN + jc) * kChunk4 + g;
#pragma unroll
    for (int pos = 0; pos < kCols + K - 1; ++pos) {
      const float4 v = yr[pos * kChunk4];
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int dj = pos - a;
        if (dj < 0 || dj >= K) continue;
        float t = acc[a][dj];
        t = fmaf(xv[a].x, v.x, t);
        t = fmaf(xv[a].y, v.y, t);
        t = fmaf(xv[a].z, v.z, t);
        t = fmaf(xv[a].w, v.w, t);
        acc[a][dj] = t;
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  const int i = i0 + il;
#pragma unroll
  for (int a = 0; a < kCols; ++a) {
    const int j = j0 + jc + a;
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
      // the 8 lanes' partial sums, in the same order on every lane
      float t = acc[a][dj];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      t += __shfl_xor_sync(0xffffffffu, t, 4);
      if (g != (a * K + dj) % 8 || i >= H || j >= W) continue;
      const int d = di * K + dj;
      const size_t o = (static_cast<size_t>(b) * H + i) * W + j;
      out[o * KK + d] = t;
      if (PAIR) {
        const int ni = i + di - P, nj = j + dj - P;
        if (ni >= 0 && ni < H && nj >= 0 && nj < W) {
          out_yx[((static_cast<size_t>(b) * H + ni) * W + nj) * KK + KK - 1 - d] = t;
        } else {
          out_yx[o * KK + d] = 0.f;
        }
      }
    }
  }
}

template <int K, bool PAIR>
int launch_fwd(const float* x, const float* y, float* out, float* out_yx, int B, int H,
               int W, int C, cudaStream_t stream) {
  constexpr int SPAN = kTileJ + K - 1;
  constexpr size_t smem =
      2 * sizeof(float4) * (kRows * kTileJ + (kRows + K - 1) * SPAN) * kChunk4;
  if (smem > 48 * 1024) {  // the opt-in, set on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        correlation_kernel<K, PAIR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = C % 4 == 0 && aligned(x) && aligned(y);
  const dim3 grid((W + kTileJ - 1) / kTileJ, (H + kRows - 1) / kRows, B);
  correlation_kernel<K, PAIR><<<grid, kRows * K * 32, smem, stream>>>(
      x, y, out, out_yx, H, W, C, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAIR>
int dispatch_fwd(const float* x, const float* y, float* out, float* out_yx, int B, int H,
                 int W, int C, int k, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_fwd<1, PAIR>(x, y, out, out_yx, B, H, W, C, stream);
    case 3: return launch_fwd<3, PAIR>(x, y, out, out_yx, B, H, W, C, stream);
    case 5: return launch_fwd<5, PAIR>(x, y, out, out_yx, B, H, W, C, stream);
    case 7: return launch_fwd<7, PAIR>(x, y, out, out_yx, B, H, W, C, stream);
    case 9: return launch_fwd<9, PAIR>(x, y, out, out_yx, B, H, W, C, stream);
    case 11: return launch_fwd<11, PAIR>(x, y, out, out_yx, B, H, W, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
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

// x, y: (B, H, W, C); out: (B, H, W, k*k); k odd, <= 11.
RF_API int rf_correlation_volume(const float* x, const float* y, float* out,
                                 int B, int H, int W, int C, int k,
                                 cudaStream_t stream) {
  return dispatch_fwd<false>(x, y, out, nullptr, B, H, W, C, k, stream);
}

// Both volumes of the fine stage from one pass: out = corr(x, y) and
// out_yx = corr(y, x), each (B, H, W, k*k); k odd, <= 11.
RF_API int rf_correlation_pair(const float* x, const float* y, float* out, float* out_yx,
                               int B, int H, int W, int C, int k, cudaStream_t stream) {
  return dispatch_fwd<true>(x, y, out, out_yx, B, H, W, C, k, stream);
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
