// Mutual nearest-neighbour epilogue of the matching score matrix, with the
// target mask folded in.
//
// Replaces: the argmax/reciprocity part of
// ransacflow_tpu/ops/matching.py:24 mutual_matching, exact or relaxed
// reciprocity, validB applied as score * validB. The score GEMM before it
// stays a torch.matmul, as it was a plain jnp.dot in the reference.
//
// Given the raw score (nA, nB) fp32, row-major, and an optional (nB,) 0/1
// mask m (s = score * m, the product taken per element as the reference
// takes it: a masked NaN or inf stays NaN, a masked negative is -0.0):
//   best_src[j]   = argmax_i s[i, j]   (nB,)  best source per target
//   best_tgt[i]   = argmax_j s[i, j]   (nA,)  best target per source
//   pair_score[j] = s[best_src[j], j]
//   valid[j]      = mutual(best_tgt[best_src[j]], j)  and  pair_score[j] != 0
// where mutual(back, j) is back == j (relax_cells = 0), or, with
// relax_cells > 0, the Chebyshev distance of the two cells on the target's
// row-major grid of width grid_w is <= relax_cells (cells, not flat
// indices: no wrap across a row edge).
// Argmax is in jnp.argmax / torch.argmax order: NaN counts as the largest
// value and ties go to the lowest index. Partial results cross threads and
// blocks as 64-bit keys, (order-preserving image of the value) << 32 |
// ~index, so that max over keys is that order (-0.0 keyed as +0.0): the
// result does not depend on the order in which warps or blocks finish.
//
// What bounds it on the H100: at the serving shape (13065 x 1200) the score
// is 63 MB, more than the 50 MB L2, so the epilogue is one HBM stream of
// the score (~19 us at 3.35 TB/s). Design: the score is read once. A block
// of 8 warps takes a chunk of rows and a slice of at most 1280 columns (one
// slice up to nB = 1280); a warp takes every 8th row of the chunk, each
// lane 16-byte loads of its columns (every 32nd float4 of the row), so the
// row's argmax is a warp shuffle and each lane keeps its columns' running
// argmax over the warp's rows in registers. Those registers leave room for
// half a row's loads in flight a lane, so a warp also asks L2 for its next
// row (one bulk prefetch) while it reduces this one: a one-row prefetch
// read fastest of one, two and four rows ahead. The mask is staged once per
// block in shared memory as 0/1 floats, a 16-byte read and 4 products per
// float4 of the score (a per-lane bit mask cost more instructions and read
// slower); to make room for the products, the masked pass compares with
// `>` alone and takes a row with a NaN or an inf in it again with the NaN
// rule. At the end the block's 8 warps meet in shared memory and the
// block writes one key per column of its slice. About two blocks an SM run
// in one wave, so the chunks' keys are ~2 MB. A second, small launch takes
// the max of each column's keys (a warp per column at the end), applies
// the reciprocity test and writes the outputs (and, with several slices,
// merges the rows' slice keys). Both launches share the caller's stream,
// which orders them; nothing is read back.
//
// The batch form: k scores (k, nA, nB) with k masks, one launch of each
// kernel for all of them. The pair is the grid's last axis (blockIdx.z of
// the chunk blocks, blockIdx.y of the merge blocks), and every pointer is
// offset to its pair's rows; a pair's blocks do what a single launch's
// blocks do, so each pair's outputs are the single form's bit for bit. The
// single form is the batch form with k = 1.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // warps of a chunk block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSlice = 1280;    // columns of a slice (MAX_SLICE in kernels/matching.py)
constexpr int kMergeCols = 32;     // columns of a merge block (one a warp at the end)
constexpr int kMergeLanes = 32;    // chunk lanes of a merge block (its warps)

// true when (v, i) comes before (bv, bi) in argmax order
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v);
  const bool bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// the running argmax of a stream whose indices only grow: a later index
// takes the place only of a smaller value, and NaN only of a non-NaN
__device__ __forceinline__ void take_later(float v, int i, float& bv, int& bi) {
  if (v > bv || (isnan(v) && !isnan(bv))) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ unsigned long long make_key(float v, int i) {
  unsigned b;
  if (isnan(v)) {
    b = 0xFFFFFFFFu;
  } else {
    const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
    b = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(~i);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(~static_cast<unsigned>(key & 0xFFFFFFFFull));
}

template <int kVec>
struct Load;
template <>
struct Load<4> {
  __device__ __forceinline__ static void get(const float* p, float* v) {
    set(__ldcs(reinterpret_cast<const float4*>(p)), v);  // streamed: read once
  }
  __device__ __forceinline__ static void get_shared(const float* p, float* v) {
    set(*reinterpret_cast<const float4*>(p), v);
  }
  __device__ __forceinline__ static void set(float4 a, float* v) {
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};
template <>
struct Load<1> {
  __device__ __forceinline__ static void get(const float* p, float* v) { v[0] = __ldcs(p); }
  __device__ __forceinline__ static void get_shared(const float* p, float* v) { v[0] = *p; }
};

// An L2 prefetch of `n` floats from p, as one bulk request (16-byte aligned
// rows of a multiple of 4 floats) or one request per 128-byte line.
template <int kVec>
__device__ __forceinline__ void prefetch_l2(const float* p, int n) {
  if (kVec == 4) {
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(n * 4) : "memory");
  } else {
    for (int i = 0; i < n; i += 32) asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i));
  }
}

// One row of the lane's columns into their running argmaxes (bv, bi) and
// the row's (rv, ri), with torch.argmax's NaN rule (kExact), or with `>`
// alone, exact for every value but NaN, returning a probe that is NaN when
// the lane met a NaN or an inf (a sum of x * 0): the caller then runs the
// row again in the exact order (a row applied twice changes no result of
// the first pass but for NaN).
template <int kVec, bool kMasked, bool kExact, int kUnits>
__device__ __forceinline__ float scan_row(const float* row, const float* smask, int lane,
                                          int ng, int c0, int r, float (&bv)[kUnits][kVec],
                                          int (&bi)[kUnits][kVec], float& rv, int& ri) {
  constexpr int kHalf = (kUnits + 1) / 2;
  float probe = 0.f;
  // the lane's loads in two halves: half the registers, and a half's loads
  // still all in flight together
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[kHalf][kVec];
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const int q = lane + 32 * (h * kHalf + k);
      if (h * kHalf + k < kUnits && q < ng) Load<kVec>::get(row + q * kVec, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const int u = h * kHalf + k;
      const int q = lane + 32 * u;
      if (u < kUnits && q < ng) {
        float m[kVec];
        if (kMasked) Load<kVec>::get_shared(smask + q * kVec, m);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float x = kMasked ? v[k][e] * m[e] : v[k][e];
          const int col = c0 + q * kVec + e;
          if (kExact) {
            take_later(x, r, bv[u][e], bi[u][e]);
            take_later(x, col, rv, ri);
          } else {
            if (x > bv[u][e]) {
              bv[u][e] = x;
              bi[u][e] = r;
            }
            if (x > rv) {
              rv = x;
              ri = col;
            }
            probe = fmaf(x, 0.f, probe);
          }
        }
      }
    }
  }
  return probe;
}

// One block: the rows [r0, r0 + rows_per_block) of the slice
// [c0, c0 + slice_w) of one pair's score (blockIdx = (chunk, slice, pair)). kVec = 4 needs nB % 4 == 0
// and a 16-byte aligned score (then every row and slice starts aligned).
// Writes col_key[chunk * nB + j] for the slice's columns and, per row, the
// row's best over the slice: its index into best_tgt (one slice) or its key
// into row_key[r * n_slices + slice].
template <int kVec, bool kMasked>
__global__ void __launch_bounds__(kThreads, 2) chunk_kernel(
    const float* __restrict__ score, const unsigned char* __restrict__ valid_b, int nA,
    int nB, int rows_per_block, int slice_w, unsigned long long* __restrict__ col_key,
    unsigned long long* __restrict__ row_key, int* __restrict__ best_tgt) {
  constexpr int kUnits = kMaxSlice / (32 * kVec);  // loads of a lane per row
  extern __shared__ unsigned long long smem[];     // [kWarps][slice_w] keys, then the mask
  float* smask = reinterpret_cast<float*>(smem + kWarps * slice_w);
  const size_t pair = blockIdx.z;
  score += pair * nA * nB;
  if (kMasked) valid_b += pair * nB;
  col_key += pair * gridDim.x * nB;
  row_key += pair * nA * gridDim.y;
  best_tgt += pair * nA;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slice = blockIdx.y, n_slices = gridDim.y;
  const int c0 = slice * slice_w;
  const int cw = min(slice_w, nB - c0);
  const int ng = cw / kVec;  // the slice's loads per row
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(nA, r0 + rows_per_block);
  const int first = r0 + warp;
  // the warp's first row on its way to L2 before anything else waits
  if (lane == 0 && first < r1) prefetch_l2<kVec>(score + static_cast<size_t>(first) * nB + c0, cw);
  if (kMasked) {
    for (int j = threadIdx.x; j < cw; j += kThreads) smask[j] = valid_b[c0 + j] ? 1.f : 0.f;
    __syncthreads();
  }

  // a lane's columns: c0 + (lane + 32 k) * kVec + e
  float bv[kUnits][kVec];
  int bi[kUnits][kVec];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      bv[k][e] = -INFINITY;
      bi[k][e] = first < r1 ? first : 0x7FFFFFFF;  // no row: loses every tie
    }
  }
  for (int r = first; r < r1; r += kWarps) {
    const float* row = score + static_cast<size_t>(r) * nB + c0;
    // the warp's next row on its way to L2 while this one is reduced
    if (lane == 0 && r + kWarps < r1) prefetch_l2<kVec>(row + static_cast<size_t>(kWarps) * nB, cw);
    const int r_init = lane < ng ? c0 + lane * kVec : 0x7FFFFFFF;
    float rv = -INFINITY;
    int ri = r_init;
    // with the mask, `>` alone and a second pass in the exact order for a
    // row with a NaN or an inf in it: the product's instructions leave no
    // room for the NaN rule on every value (both read faster this way with
    // the mask and slower without it, or with 4-byte loads)
    constexpr bool kFast = kMasked && kVec == 4;
    const float probe = scan_row<kVec, kMasked, !kFast, kUnits>(row, smask, lane, ng, c0, r,
                                                                bv, bi, rv, ri);
    if (kFast && __any_sync(0xffffffffu, probe != probe)) {
      rv = -INFINITY;
      ri = r_init;
      scan_row<kVec, kMasked, true, kUnits>(row, smask, lane, ng, c0, r, bv, bi, rv, ri);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, rv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ri, off);
      if (better(ov, oi, rv, ri)) {
        rv = ov;
        ri = oi;
      }
    }
    if (lane == 0) {
      if (n_slices == 1) {
        best_tgt[r] = ri;
      } else {
        row_key[static_cast<size_t>(r) * n_slices + slice] = make_key(rv, ri);
      }
    }
  }

  // the warps' column argmaxes meet in shared memory; the block's goes out
  unsigned long long* mine = smem + warp * slice_w;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int q = lane + 32 * k;
    if (q < ng) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) mine[q * kVec + e] = make_key(bv[k][e], bi[k][e]);
    }
  }
  __syncthreads();
  unsigned long long* out = col_key + static_cast<size_t>(blockIdx.x) * nB + c0;
  for (int j = threadIdx.x; j < cw; j += kThreads) {
    unsigned long long key = smem[j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) key = max(key, smem[w * slice_w + j]);
    out[j] = key;
  }
}

// the best target of row r over its slices' keys
__device__ __forceinline__ int row_best(const unsigned long long* __restrict__ row_key,
                                        int r, int n_slices) {
  unsigned long long key = 0ull;
  for (int s = 0; s < n_slices; ++s) {
    key = max(key, row_key[static_cast<size_t>(r) * n_slices + s]);
  }
  return key_index(key);
}

// Blocks [0, ceil(nB / kMergeCols)): a column's key over the chunks, then
// the reciprocity test and the outputs. With several slices, the blocks
// after them merge each row's slice keys into best_tgt. blockIdx.y: the
// pair.
__global__ void __launch_bounds__(kMergeCols * kMergeLanes) merge_kernel(
    const float* __restrict__ score, const unsigned char* __restrict__ valid_b, int nA,
    int nB, int n_chunks, int n_slices, const unsigned long long* __restrict__ col_key,
    const unsigned long long* __restrict__ row_key, int relax_cells, int grid_w,
    int* __restrict__ best_src, int* __restrict__ best_tgt,
    unsigned char* __restrict__ valid, float* __restrict__ pair_score) {
  __shared__ unsigned long long part[kMergeLanes][kMergeCols + 1];
  const size_t pair = blockIdx.y;
  score += pair * nA * nB;
  if (valid_b != nullptr) valid_b += pair * nB;
  col_key += pair * n_chunks * nB;
  row_key += pair * nA * n_slices;
  best_src += pair * nB;
  best_tgt += pair * nA;
  valid += pair * nB;
  pair_score += pair * nB;
  const int n_col_blocks = (nB + kMergeCols - 1) / kMergeCols;
  if (static_cast<int>(blockIdx.x) >= n_col_blocks) {
    const int r = (blockIdx.x - n_col_blocks) * blockDim.x + threadIdx.x;
    if (r < nA) best_tgt[r] = row_best(row_key, r, n_slices);
    return;
  }
  const int tx = threadIdx.x % kMergeCols, ty = threadIdx.x / kMergeCols;
  const int col = blockIdx.x * kMergeCols + tx;  // the column this thread's loads take
  unsigned long long key = 0ull;
  if (col < nB) {
#pragma unroll 4
    for (int c = ty; c < n_chunks; c += kMergeLanes) {
      key = max(key, col_key[static_cast<size_t>(c) * nB + col]);
    }
  }
  part[ty][tx] = key;
  __syncthreads();
  // warp ty takes column ty of the block: a shuffle over the 32 chunk lanes
  key = part[tx][ty];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
  const int j = blockIdx.x * kMergeCols + ty;
  if (tx != 0 || j >= nB) return;
  const int bi = key_index(key);
  float ps = score[static_cast<size_t>(bi) * nB + j];
  if (valid_b != nullptr) ps *= valid_b[j] ? 1.f : 0.f;
  best_src[j] = bi;
  pair_score[j] = ps;
  const int back = n_slices == 1 ? best_tgt[bi] : row_best(row_key, bi, n_slices);
  bool mutual = back == j;
  if (relax_cells > 0) {
    const int d_row = abs(back / grid_w - j / grid_w);
    const int d_col = abs(back % grid_w - j % grid_w);
    mutual = max(d_row, d_col) <= relax_cells;
  }
  valid[j] = (mutual && ps != 0.f) ? 1 : 0;
}

template <int kVec, bool kMasked>
cudaError_t launch_chunks(const float* score, const unsigned char* valid_b, int nA, int nB,
                          int n_pairs, int n_chunks, int rows_per_block, int n_slices,
                          int slice_w,
                          unsigned long long* col_key, unsigned long long* row_key,
                          int* best_tgt, cudaStream_t stream) {
  const int smem = kWarps * slice_w * 8 + (kMasked ? slice_w * 4 : 0);
  if (smem > 48 * 1024) {  // the opt-in, set on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_kernel<kVec, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  chunk_kernel<kVec, kMasked><<<dim3(n_chunks, n_slices, n_pairs), kThreads, smem, stream>>>(
      score, valid_b, nA, nB, rows_per_block, slice_w, col_key, row_key, best_tgt);
  return cudaGetLastError();
}

}  // namespace

// score (n_pairs, nA, nB) fp32 row-major; valid_b (n_pairs, nB) 0/1 bytes or
// null (no mask). The wrapper's schedule (kernels/matching.schedule), per
// pair: n_chunks blocks of rows_per_block rows by n_slices slices of
// slice_w columns (slice_w <= 1280, a multiple of 4 when vec). vec: nB % 4
// == 0 and score 16-byte aligned. keys: caller-allocated scratch of
// n_pairs * n_chunks * nB column keys, then n_pairs * nA * n_slices row
// keys when n_slices > 1. Outputs per pair: best_src, valid, pair_score
// (n_pairs, nB), best_tgt (n_pairs, nA). grid_w >= 1 when relax_cells > 0.
RF_API int rf_mutual_argmax(const float* score, const unsigned char* valid_b, int nA,
                            int nB, int n_pairs, int n_chunks, int rows_per_block,
                            int n_slices,
                            int slice_w, int vec, int relax_cells, int grid_w,
                            unsigned long long* keys, int* best_src, int* best_tgt,
                            unsigned char* valid, float* pair_score,
                            cudaStream_t stream) {
  if (slice_w > kMaxSlice || slice_w < 1 || (vec && slice_w % 4 != 0) || n_pairs < 1 ||
      n_pairs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* col_key = keys;
  unsigned long long* row_key = keys + static_cast<size_t>(n_pairs) * n_chunks * nB;
  const bool masked = valid_b != nullptr;
  const auto launch = vec ? (masked ? launch_chunks<4, true> : launch_chunks<4, false>)
                          : (masked ? launch_chunks<1, true> : launch_chunks<1, false>);
  const cudaError_t err = launch(score, valid_b, nA, nB, n_pairs, n_chunks, rows_per_block,
                                 n_slices, slice_w, col_key, row_key, best_tgt, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_col_blocks = (nB + kMergeCols - 1) / kMergeCols;
  constexpr int kMergeThreads = kMergeCols * kMergeLanes;
  const int n_row_blocks = n_slices > 1 ? (nA + kMergeThreads - 1) / kMergeThreads : 0;
  merge_kernel<<<dim3(n_col_blocks + n_row_blocks, n_pairs), kMergeThreads, 0, stream>>>(
      score, valid_b, nA, nB, n_chunks, n_slices, col_key, row_key, relax_cells, grid_w,
      best_src, best_tgt, valid, pair_score);
  return static_cast<int>(cudaGetLastError());
}
