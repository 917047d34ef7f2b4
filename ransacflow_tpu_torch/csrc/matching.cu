// Mutual nearest-neighbour epilogue of the matching score matrix.
//
// Replaces: the argmax/reciprocity part of
// ransacflow_tpu/ops/matching.py:24 mutual_matching, exact or relaxed
// reciprocity. The score GEMM before it stays a torch.matmul, as it was a
// plain jnp.dot in the reference.
//
// Given score (nA, nB) fp32, row-major:
//   best_src[j]   = argmax_i score[i, j]   (nB,)  best source per target
//   best_tgt[i]   = argmax_j score[i, j]   (nA,)  best target per source
//   pair_score[j] = score[best_src[j], j]
//   valid[j]      = mutual(best_tgt[best_src[j]], j)  and  pair_score[j] != 0
// where mutual(back, j) is back == j (relax_cells = 0), or, with
// relax_cells > 0, the Chebyshev distance of the two cells on the target's
// row-major grid of width grid_w is <= relax_cells (cells, not flat
// indices: no wrap across a row edge).
// with argmax in jnp.argmax / torch.argmax order: NaN counts as the largest
// value and ties go to the lowest index. Every reduction compares
// (value, -index) explicitly, so the result does not depend on the order in
// which threads meet.
//
// What bounds it on the H100: at the serving shape (13065 x 1200) the score
// is 63 MB, so the epilogue is a pure HBM stream (two passes, ~38 us at
// 3.35 TB/s). Design: the row argmax gives one warp to each row (coalesced
// along the row); the column argmax splits the rows into n_split ranges so
// that ~1200 blocks stream the matrix with 32 neighbouring columns per warp,
// and a last small kernel merges the partial results per column and applies
// the reciprocity test. The three launches share the caller's stream, which
// orders them.
#include "common.cuh"

#include <math.h>

namespace {

// true when (v, i) comes before (bv, bi) in argmax order
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v);
  const bool bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

constexpr int kRowWarps = 8;
constexpr int kColTile = 32;
constexpr int kRowLanes = 8;
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kRowWarps * 32) row_argmax_kernel(
    const float* __restrict__ score, int nA, int nB, int* __restrict__ best_tgt) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (r >= nA) return;  // uniform across the warp
  const float* row = score + static_cast<size_t>(r) * nB;
  float bv = -INFINITY;
  int bi = nB;  // sentinel: any real index wins the tie
  for (int j = lane; j < nB; j += 32) {
    const float v = row[j];
    if (better(v, j, bv, bi)) {
      bv = v;
      bi = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) best_tgt[r] = bi;
}

__global__ void __launch_bounds__(kColTile * kRowLanes) col_partial_kernel(
    const float* __restrict__ score, int nA, int nB, int rows_per_split,
    float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ float sv[kRowLanes][kColTile];
  __shared__ int si[kRowLanes][kColTile];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int j = blockIdx.x * kColTile + tx;
  const int s = blockIdx.y;
  const int r0 = s * rows_per_split;
  const int r1 = min(nA, r0 + rows_per_split);
  float bv = -INFINITY;
  int bi = nA;  // sentinel
  if (j < nB) {
    for (int r = r0 + ty; r < r1; r += kRowLanes) {
      const float v = score[static_cast<size_t>(r) * nB + j];
      if (better(v, r, bv, bi)) {
        bv = v;
        bi = r;
      }
    }
  }
  sv[ty][tx] = bv;
  si[ty][tx] = bi;
  __syncthreads();
  if (ty == 0 && j < nB) {
    for (int t = 1; t < kRowLanes; ++t) {
      if (better(sv[t][tx], si[t][tx], bv, bi)) {
        bv = sv[t][tx];
        bi = si[t][tx];
      }
    }
    part_v[static_cast<size_t>(s) * nB + j] = bv;
    part_i[static_cast<size_t>(s) * nB + j] = bi;
  }
}

__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ score, int nB, int n_split,
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    const int* __restrict__ best_tgt, int relax_cells, int grid_w,
    int* __restrict__ best_src, unsigned char* __restrict__ valid,
    float* __restrict__ pair_score) {
  const int j = blockIdx.x * kMergeThreads + threadIdx.x;
  if (j >= nB) return;
  float bv = part_v[j];
  int bi = part_i[j];
  for (int s = 1; s < n_split; ++s) {
    const float v = part_v[static_cast<size_t>(s) * nB + j];
    const int i = part_i[static_cast<size_t>(s) * nB + j];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  const float ps = score[static_cast<size_t>(bi) * nB + j];
  best_src[j] = bi;
  pair_score[j] = ps;
  const int back = best_tgt[bi];
  bool mutual = back == j;
  if (relax_cells > 0) {
    const int d_row = abs(back / grid_w - j / grid_w);
    const int d_col = abs(back % grid_w - j % grid_w);
    mutual = max(d_row, d_col) <= relax_cells;
  }
  valid[j] = (mutual && ps != 0.f) ? 1 : 0;
}

}  // namespace

// part_v / part_i: caller-allocated scratch of n_split * nB entries.
// Needs nA >= 1, nB >= 1, 1 <= n_split <= nA, and grid_w >= 1 when
// relax_cells > 0.
RF_API int rf_mutual_argmax(const float* score, int nA, int nB, int n_split,
                            int relax_cells, int grid_w,
                            float* part_v, int* part_i, int* best_src,
                            int* best_tgt, unsigned char* valid,
                            float* pair_score, cudaStream_t stream) {
  const int rows_per_split = (nA + n_split - 1) / n_split;
  row_argmax_kernel<<<(nA + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                      stream>>>(score, nA, nB, best_tgt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nB + kColTile - 1) / kColTile, n_split);
  col_partial_kernel<<<grid, dim3(kColTile, kRowLanes), 0, stream>>>(
      score, nA, nB, rows_per_split, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<(nB + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                 stream>>>(score, nB, n_split, part_v, part_i, best_tgt,
                           relax_cells, grid_w, best_src, valid, pair_score);
  return static_cast<int>(cudaGetLastError());
}
