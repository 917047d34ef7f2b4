// Epilogues of the flow and matchability heads, and their backward.
//
// Replaces: ransacflow_tpu/models/heads.py:69-99, what net_flow_coarse and
// net_matchability compute after conv4, and the TPU's autodiff of it in
// training:
//   flow  = (sum_c p_c gx_c / W * 2, sum_c p_c gy_c / H * 2),
//           p = softmax over the k*k logits of a cell, channel c the offset
//           (gx, gy) = (c % k - k/2, c / k - k/2) (`corr_offset_grids`);
//   match = sigmoid(logit).
// The backward: dlogit_c = p_c (u_c - sum_j p_j u_j) with
// u = gx * (g_x * 2 / W) + gy * (g_y * 2 / H), p recomputed from the
// logits; the sigmoid's is g (1 - s) s from the saved output s.
//
// What bounds it on the H100: a fine pass's three epilogues (60 x 80 cells,
// k = 7) move ~1.1 MB, a third of a microsecond of HBM time, so the
// launch and one round trip to memory set its cost: the design is one
// launch for all three maps. The training backward (32 x 28 x 28 cells)
// moves ~10 MB and is bound by its bytes.
//
// Design: a block of 32 threads owns 32 consecutive cells, one thread a cell.
// It stages the cells' logits, a contiguous run of 32 k*k floats, in shared
// memory with 16-byte loads (the run starts at a multiple of 4 floats; float
// by float when the tensor itself is not 16-byte aligned), and each thread
// then reduces its own cell from there: a stride of k*k floats, odd for odd
// k, so the reads are free of bank conflicts. 4800 serving cells make 150
// blocks for the 132 SMs. k is a template argument, so the offsets are
// constants and the loops unroll. The two matchability logits of a cell are
// read before the staging, so their loads are in flight beside it; the kernel
// writes flow, both sigmoids and their concatenation match = (match12,
// match21) directly. The same kernel with null pointers serves the training
// path's two separate epilogues (k = 0: the sigmoid alone, one thread an
// element, 256 a block). The flow's backward stages the logits the same way,
// keeps a cell's p in registers (one reciprocal of the sum, not k*k
// divisions), overwrites its logits in place with their cotangents, and
// writes the run back with 16-byte stores. expf, not __expf: the plain
// version's tolerances hold. Lane groups of 8 a cell (one offset column a
// lane, shuffles for the sums) read faster on the fine pass's 4800 cells but
// slower at the training shape, so one thread a cell is kept.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kCells = 32;   // cells of a block, one thread each
constexpr int kElems = 256;  // elements of a block, k = 0

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// s[0, n) = src[0, n), by the block's threads.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* s, int n) {
  int done = 0;
  if (aligned16(src)) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = threadIdx.x; i < n / 4; i += kCells) s4[i] = __ldg(src4 + i);
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kCells) s[i] = __ldg(src + i);
}

// dst[0, n) = s[0, n), by the block's threads.
__device__ __forceinline__ void unstage(const float* s, float* __restrict__ dst, int n) {
  int done = 0;
  if (aligned16(dst)) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += kCells) dst4[i] = s4[i];
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += kCells) dst[i] = s[i];
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The offsets of channel c.
template <int K>
__device__ __forceinline__ float gx(int c) { return static_cast<float>(c % K - K / 2); }
template <int K>
__device__ __forceinline__ float gy(int c) { return static_cast<float>(c / K - K / 2); }

template <int K>
__device__ __forceinline__ float row_max(const float* x) {
  float m = x[0];
#pragma unroll
  for (int c = 1; c < K * K; ++c) m = fmaxf(m, x[c]);
  return m;
}

// K > 0: the flow epilogue of flow_logits (n_cells x K*K) into flow
// (n_cells x 2). Each of m12_logits, m21_logits (n_cells) that is not null:
// its sigmoid into m12 / m21; match (n_cells x 2), when not null, gets both.
// K = 0: the sigmoid of m12_logits alone, one thread an element.
template <int K>
__global__ void __launch_bounds__(K > 0 ? kCells : kElems) epilogue_kernel(
    const float* __restrict__ flow_logits, const float* __restrict__ m12_logits,
    const float* __restrict__ m21_logits, float* __restrict__ flow,
    float* __restrict__ m12, float* __restrict__ m21, float* __restrict__ match,
    int n_cells, float h, float w) {
  if constexpr (K == 0) {
    const int i = blockIdx.x * kElems + threadIdx.x;
    if (i < n_cells) m12[i] = sigmoid(m12_logits[i]);
  } else {
    constexpr int KK = K * K;
    const int cell0 = blockIdx.x * kCells;
    const int n = min(kCells, n_cells - cell0);
    const int cell = cell0 + threadIdx.x;
    const bool mine = threadIdx.x < n;
    float a = 0.f, b = 0.f;
    if (mine && m12_logits) a = m12_logits[cell];
    if (mine && m21_logits) b = m21_logits[cell];
    __shared__ __align__(16) float s[kCells * KK];
    stage(flow_logits + static_cast<long long>(cell0) * KK, s, n * KK);
    __syncthreads();
    if (!mine) return;
    const float* x = s + threadIdx.x * KK;
    const float m = row_max<K>(x);
    float sum = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
    for (int c = 0; c < KK; ++c) {
      const float e = expf(x[c] - m);
      sum += e;
      sx = fmaf(e, gx<K>(c), sx);
      sy = fmaf(e, gy<K>(c), sy);
    }
    reinterpret_cast<float2*>(flow)[cell] = make_float2(sx / sum / w * 2.f, sy / sum / h * 2.f);
    if (m12_logits) m12[cell] = a = sigmoid(a);
    if (m21_logits) m21[cell] = b = sigmoid(b);
    if (match) reinterpret_cast<float2*>(match)[cell] = make_float2(a, b);
  }
}

// K > 0: the flow epilogue's backward, d_logits (n_cells x K*K) from the
// logits and the flow's cotangent g_flow (n_cells x 2). K = 0: the
// sigmoid's, d_s (n_cells) from its output s and cotangent g_s.
template <int K>
__global__ void __launch_bounds__(K > 0 ? kCells : kElems) epilogue_bwd_kernel(
    const float* __restrict__ logits, const float* __restrict__ g_flow,
    float* __restrict__ d_logits, const float* __restrict__ s_out,
    const float* __restrict__ g_s, float* __restrict__ d_s, int n_cells, float h,
    float w) {
  if constexpr (K == 0) {
    const int i = blockIdx.x * kElems + threadIdx.x;
    if (i < n_cells) {
      const float y = s_out[i];
      d_s[i] = g_s[i] * (1.f - y) * y;
    }
  } else {
    constexpr int KK = K * K;
    const int cell0 = blockIdx.x * kCells;
    const int n = min(kCells, n_cells - cell0);
    const int cell = cell0 + threadIdx.x;
    const bool mine = threadIdx.x < n;
    __shared__ __align__(16) float s[kCells * KK];
    float2 g = make_float2(0.f, 0.f);
    if (mine) g = reinterpret_cast<const float2*>(g_flow)[cell];
    const long long run = static_cast<long long>(cell0) * KK;
    stage(logits + run, s, n * KK);
    __syncthreads();
    if (mine) {
      float* x = s + threadIdx.x * KK;
      const float gfx = g.x * 2.f / w, gfy = g.y * 2.f / h;
      const float m = row_max<K>(x);
      float p[KK], sum = 0.f;
#pragma unroll
      for (int c = 0; c < KK; ++c) {
        p[c] = expf(x[c] - m);
        sum += p[c];
      }
      const float inv = 1.f / sum;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < KK; ++c) {
        p[c] *= inv;
        dot = fmaf(p[c], fmaf(gx<K>(c), gfx, gy<K>(c) * gfy), dot);
      }
#pragma unroll
      for (int c = 0; c < KK; ++c) x[c] = p[c] * (fmaf(gx<K>(c), gfx, gy<K>(c) * gfy) - dot);
    }
    __syncthreads();
    unstage(s, d_logits + run, n * KK);
  }
}

// A block per kCells cells, or per kElems elements at k = 0.
unsigned blocks(int n, int k) {
  const int per_block = k > 0 ? kCells : kElems;
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

// flow_logits: (B, H, W, k*k) or null with k = 0; m12_logits, m21_logits:
// (B, H, W, 1) or null; outputs flow (B, H, W, 2), m12 and m21 (B, H, W,
// 1), match (B, H, W, 2) (null where their input is); n_cells = B * H * W;
// 0 <= k <= 8. All fp32, contiguous.
RF_API int rf_head_epilogues(const float* flow_logits, const float* m12_logits,
                             const float* m21_logits, float* flow, float* m12,
                             float* m21, float* match, int n_cells, int k, int H,
                             int W, cudaStream_t stream) {
  const float h = static_cast<float>(H), w = static_cast<float>(W);
#define RF_EPILOGUE(K)                                                            \
  case K:                                                                         \
    epilogue_kernel<K><<<blocks(n_cells, K), K > 0 ? kCells : kElems, 0, stream>>>( \
        flow_logits, m12_logits, m21_logits, flow, m12, m21, match, n_cells, h, w);  \
    break;
  switch (k) {
    RF_EPILOGUE(0) RF_EPILOGUE(1) RF_EPILOGUE(2) RF_EPILOGUE(3) RF_EPILOGUE(4)
    RF_EPILOGUE(5) RF_EPILOGUE(6) RF_EPILOGUE(7) RF_EPILOGUE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RF_EPILOGUE
  return static_cast<int>(cudaGetLastError());
}

// k > 0: the flow's backward, logits and d_logits (B, H, W, k*k), g_flow
// (B, H, W, 2); k = 0: the sigmoid's, s_out, g_s, d_s (n_cells). The other
// pointers may be null. 0 <= k <= 8. All fp32, contiguous.
RF_API int rf_head_epilogues_bwd(const float* logits, const float* g_flow,
                                 float* d_logits, const float* s_out,
                                 const float* g_s, float* d_s, int n_cells, int k,
                                 int H, int W, cudaStream_t stream) {
  const float h = static_cast<float>(H), w = static_cast<float>(W);
#define RF_EPILOGUE_BWD(K)                                                        \
  case K:                                                                         \
    epilogue_bwd_kernel<K><<<blocks(n_cells, K), K > 0 ? kCells : kElems, 0,      \
                           stream>>>(logits, g_flow, d_logits, s_out, g_s, d_s,   \
                                     n_cells, h, w);                              \
    break;
  switch (k) {
    RF_EPILOGUE_BWD(0) RF_EPILOGUE_BWD(1) RF_EPILOGUE_BWD(2) RF_EPILOGUE_BWD(3)
    RF_EPILOGUE_BWD(4) RF_EPILOGUE_BWD(5) RF_EPILOGUE_BWD(6) RF_EPILOGUE_BWD(7)
    RF_EPILOGUE_BWD(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RF_EPILOGUE_BWD
  return static_cast<int>(cudaGetLastError());
}
