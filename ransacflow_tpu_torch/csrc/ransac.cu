// Fixed-count RANSAC fit in one launch: draw, solve, score, pick the winner
// and write its inlier mask, for 4-point homographies or 3-point affine maps.
//
// Replaces: ransacflow_tpu/ops/ransac.py:102 ransac_homography ('homography'
// with the |det| gate, n_points 4; 'affine', n_points 3): its draws
// (_sample_minimal_sets in the valid-first order), its solve (_solve_models
// with ops/homography.py:136 dlt_homography, 'projective', or :217
// fit_affine), its count (ops/ransac.py:77 _make_count_chunk), the argmax
// (first index on ties) and the winner's mask (ops/ransac.py:181-182). The
// per-hypothesis steps and the layout of the work are in ransac_common.cuh.
//
// Block b takes hypotheses [b * kHyp, (b + 1) * kHyp), kHyp = 32: it
// builds the valid-first order, stages the valid matches, draws and solves
// its kHyp hypotheses (one thread each), scores them (4 a thread, the 32
// lanes of a warp over every 32nd match), takes one packed atomicMax and
// writes its best H and set to its slot. The last block to finish (a
// __threadfence, then an atomic ticket) reads the winner's slot, writes H,
// count, set, found and the mask over all N matches, and resets the
// two-word state for the next launch on the stream. Above kSharedOrderMax
// matches order_kernel writes the valid-first order to global memory first,
// and every block reads it from there instead of building its own.
//
// The batch form: k fits, one a pair, in one launch; blockIdx.y is the
// pair, and its blocks use its own state words and slots, so each pair's
// count, winner and mask are its single fit's under its own seed. The
// single form is the batch form with k = 1.
//
// It keeps a launch of its own beside the adaptive kernel's cooperative loop
// (ransac_adaptive.cu), which computes the same fit as one loop block of
// n_iter hypotheses: run so, that loop read 38% slower at 10k hypotheses
// and 13% slower at 50k on the H100 (PERF.md).
//
// What bounds it on the H100: at the serving shape (10k hypotheses x 1200
// matches) the work is 12 M point tests of ~35 instructions each, two of
// them IEEE divisions: ~15 us of issue at the card's fp32 rate, and almost
// no memory traffic. The design is about keeping that issue rate: 256
// threads a block, 4 independent chains a thread, shared-memory broadcasts
// of the matches, and nothing of the fit left to other launches.
#include "common.cuh"
#include "ransac_common.cuh"

namespace {

using namespace rf_ransac;

// Hypotheses a thread block takes: a one-off sweep on the H100 read 32
// within 2% of 16 at 10k hypotheses and 5% ahead of it at 50k, and 64
// slower at 10k (PERF.md).
constexpr int kHyp = 32;

struct State {
  unsigned long long best;  // packed key of the best hypothesis so far
  unsigned int ticket;      // blocks finished
};

template <int kNP, bool kGlobalOrder>
__global__ void __launch_bounds__(kThreads) ransac_fit_kernel(
    Problem P, int n_iter, int tile_len, Outputs out, State* state,
    float* slots) {
  extern __shared__ int smem[];
  __shared__ HypBlock<kHyp> hb;
  __shared__ int warp_sum[kWarps];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ float s_H[9];
  __shared__ bool s_last;

  at_pair(P, out, blockIdx.y, n_iter, kNP);
  state += blockIdx.y;
  slots += static_cast<size_t>(blockIdx.y) * gridDim.x * kSlotWords;
  const int* order;
  const int n_valid = block_order<kGlobalOrder>(P, smem, &order, warp_sum);
  const Tile tile = tile_at(smem, kGlobalOrder ? 0 : P.N, tile_len);
  const bool resident = n_valid <= tile_len;
  if (resident) stage(P, order, 0, n_valid, tile);
  const int h0 = blockIdx.x * kHyp;
  const int n_h = min(kHyp, n_iter - h0);
  solve<kHyp, kNP>(P, order, n_valid, h0, n_h, hb);
  __syncthreads();
  int c[Layout<kHyp>::kPer] = {};
  score_all<kHyp>(P, order, n_valid, resident, tile, tile_len, hb, c);
  const unsigned long long key = block_best<kHyp>(P, hb, h0, n_h, c, warp_best);
  if (threadIdx.x == 0) {
    write_slot(hb, key, h0, slots + static_cast<size_t>(blockIdx.x) * kSlotWords);
    atomicMax(&state->best, key);
    __threadfence();
    s_last = atomicAdd(&state->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block: every other block's slot and key are visible
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long win = atomicExch(&state->best, 0ull);
    atomicExch(&state->ticket, 0u);
    const unsigned h = key_index(win);
    take_winner(win, slots + static_cast<size_t>(h / kHyp) * kSlotWords, false,
                n_valid, kNP, P.N, true, out, s_H);
  }
  __syncthreads();
  write_mask(P, s_H, true, out.mask, threadIdx.x, kThreads);
}

template <int kNP, bool kGlobalOrder>
cudaError_t launch(const Problem& P, int n_iter, int n_pairs, const Outputs& out,
                   void* state, float* slots, cudaStream_t stream) {
  const int tile_len = max(1, min(P.N, kTileMax));
  const size_t smem = shared_bytes(kGlobalOrder ? 0 : P.N, tile_len);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ransac_fit_kernel<kNP, kGlobalOrder>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (kGlobalOrder) {
    order_kernel<<<n_pairs, kOrderThreads, 0, stream>>>(P.valid, P.N, P.order);
  }
  ransac_fit_kernel<kNP, kGlobalOrder>
      <<<dim3((n_iter + kHyp - 1) / kHyp, n_pairs), kThreads, smem, stream>>>(
          P, n_iter, tile_len, out, static_cast<State*>(state), slots);
  return cudaGetLastError();
}

}  // namespace

// k = n_pairs fits. m1, m2: (k, N, 3) fp32; valid: (k, N) bytes; seed: (k,)
// uint64 on the device, or null with samples: (k, n_iter, n_points) int32
// match indices in [0, N); n_points: 4 (homography) or 3 (affine); counts:
// (k, n_iter) int32 and sets: (k, n_iter, n_points) int32, each optional
// (null); H: (k, 9) fp32; ints: (k, 8) int32 (count, set); mask: (k, N + 1)
// bytes (the mask, then found); order: (k, N + 1) int32 scratch when N >
// kSharedOrderMax, else null; state: 2 k zeroed 64-bit words, left zeroed,
// one set per stream; slots: (k, ceil(n_iter / 32), 16) fp32 scratch.
RF_API int rf_ransac_fit(const float* m1, const float* m2,
                         const unsigned char* valid, int N, int n_pairs,
                         const unsigned long long* seed, const int* samples,
                         int n_iter, int n_points, float tol, int* counts,
                         int* sets, float* H, int* ints, unsigned char* mask,
                         int* order, void* state, float* slots, cudaStream_t stream) {
  if ((N > kSharedOrderMax) != (order != nullptr) || (n_points != 3 && n_points != 4) ||
      n_pairs < 1 || n_pairs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem P{m1, m2, valid, N, seed, samples, tol, counts, sets, order};
  const Outputs out{H, ints, mask};
  cudaError_t err;
  if (n_points == 4) {
    err = order != nullptr ? launch<4, true>(P, n_iter, n_pairs, out, state, slots, stream)
                           : launch<4, false>(P, n_iter, n_pairs, out, state, slots, stream);
  } else {
    err = order != nullptr ? launch<3, true>(P, n_iter, n_pairs, out, state, slots, stream)
                           : launch<3, false>(P, n_iter, n_pairs, out, state, slots, stream);
  }
  return static_cast<int>(err);
}
