// Adaptive RANSAC in one persistent launch: hypotheses in blocks of `chunk`
// until a confidence bound is met, the stop test on the device.
//
// Replaces: ransacflow_tpu/ops/ransac.py:194 ransac_homography_adaptive
// (4-point homographies or 3-point affine maps, kNP), the lax.while_loop
// over blocks (lines 251-295) and the winner's mask (lines 297-300). Above
// kSharedOrderMax matches order_kernel writes the valid-first order to
// global memory before the loop's launch. One cooperative launch (cudaLaunchCooperativeKernel, at
// most the co-resident block count) walks the loop; for loop block c:
//   1. the grid draws, solves and scores hypotheses c * chunk + i, i <
//      chunk, with the fixed-count kernel's device code and mapping
//      (ransac_common.cuh): the index is global, so a fit's sets do not
//      depend on where the loop stops, and they are the first rows of the
//      fixed-count fit's sets for the same seed;
//   2. each thread block takes one packed atomicMax into best[c] of
//      max(its best key, best[c - 1]): the packed maximum over all loop
//      blocks so far is the reference's running best, which changes only on
//      a strictly larger count, the first index on ties. One best slot per
//      loop block keeps a block that has passed the barrier from raising
//      the value a slower block is still reading;
//   3. grid barrier;
//   4. every block reads best[c] and evaluates the stop test in fp32 as the
//      reference: w = best / max(n_valid, 1), wn = min(w^kNP, 1 - 1e-7)
//      (w^4 as (w w)(w w), w^3 as w (w w): lax.integer_pow's products),
//      denom = min(log1p(-wn), -1e-30), n_req = log1p(-confidence) / denom,
//      stop when (c + 1) * chunk >= min(n_req, n_iter). The value is the
//      same on every block, so the grid leaves the loop together.
// Then every block reads the winner's slot and writes its share of the
// mask; block 0 writes H, count, set, found, the blocks run and the
// hypotheses evaluated. A winning count of 0 keeps the identity.
//
// The batch form: k adaptive fits, one a pair, in one cooperative launch
// of (blocks a pair, k) thread blocks, the co-resident blocks split evenly
// among the pairs. blockIdx.y is the pair; each pair has its own best[] row
// and slots. After each barrier every thread block evaluates the stop test
// of every pair still running (from that pair's best and n_valid, both in
// global memory), so all blocks agree on which pairs stop; a stopped pair's
// blocks run no more hypothesis blocks and its state stays as it was,
// while the grid takes the barrier with the pairs still running (JAX's
// vmap of the while loop: a finished lane is frozen). The grid leaves the
// loop when every pair has stopped. Each pair evaluates exactly the loop
// blocks its single fit would, and its winner and mask are that fit's.
// The single form is the batch form with k = 1.
//
// What bounds it on the H100: a block of 4096 hypotheses x 1200 matches is
// 5 M point tests, a few microseconds of issue; a fit that stops after one
// block costs one launch, the order and staging of each thread block, one
// hypothesis block's solve and score, and two grid barriers. Nothing waits
// on the host, and blocks after the stop cost nothing.
#include <cooperative_groups.h>

#include "common.cuh"
#include "ransac_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace rf_ransac;

// Hypotheses a thread block takes: a loop block of 4096 then spans 256
// thread blocks, about two an SM; a one-off sweep on the H100 read 16
// fastest of 16, 32 and 64, at one block and to the cap (PERF.md).
constexpr int kHyp = 16;
constexpr int kMaxPairs = 256;  // MAX_PAIRS in kernels/ransac_adaptive.py

struct Loop {
  int n_chunks, chunk, n_iter, n_pairs;
  float confidence;
};

template <int kNP>
__device__ __forceinline__ bool stop_test(int best_count, int n_valid, int evaluated,
                                          const Loop& L) {
  const float w = static_cast<float>(best_count) / static_cast<float>(max(n_valid, 1));
  const float w2 = __fmul_rn(w, w);
  // 1 - 1e-7 rounded to fp32 once, as the reference's constant
  const float wn = fminf(kNP == 4 ? __fmul_rn(w2, w2) : __fmul_rn(w, w2),
                         static_cast<float>(1.0 - 1e-7));
  const float denom = fminf(log1pf(-wn), -1e-30f);
  const float n_req = log1pf(-L.confidence) / denom;
  return static_cast<float>(evaluated) >= fminf(n_req, static_cast<float>(L.n_iter));
}

template <int kNP, bool kGlobalOrder>
__global__ void __launch_bounds__(kThreads) ransac_adaptive_kernel(
    Problem P, Loop L, int tile_len, Outputs out, unsigned long long* best,
    int* n_valid_of, float* slots) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  __shared__ HypBlock<kHyp> hb;
  __shared__ int warp_sum[kWarps];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ unsigned long long s_best;
  __shared__ float s_H[9];
  __shared__ int s_stop[kMaxPairs];  // the loop block each pair stopped after, or -1

  const int b = blockIdx.y;
  at_pair(P, out, b, L.n_chunks * L.chunk, kNP);
  const Tile tile = tile_at(smem, kGlobalOrder ? 0 : P.N, tile_len);
  if (blockIdx.x == 0 && b == 0) {
    for (int c = threadIdx.x; c < L.n_pairs * L.n_chunks; c += kThreads) best[c] = 0ull;
  }
  for (int p = threadIdx.x; p < L.n_pairs; p += kThreads) s_stop[p] = -1;
  const int* order;
  const int n_valid = block_order<kGlobalOrder>(P, smem, &order, warp_sum);
  if (blockIdx.x == 0 && threadIdx.x == 0) n_valid_of[b] = n_valid;
  const bool resident = n_valid <= tile_len;
  if (resident) stage(P, order, 0, n_valid, tile);
  const int chunk_blocks = (L.chunk + kHyp - 1) / kHyp;
  unsigned long long* my_best = best + static_cast<size_t>(b) * L.n_chunks;
  slots += static_cast<size_t>(b) * L.n_chunks * chunk_blocks * kSlotWords;
  grid.sync();  // best[] is zeroed, every n_valid written

  unsigned long long running = 0ull;
  for (int c = 0;; ++c) {
    const bool runs = s_stop[b] < 0;  // the same in every block of the pair
    if (runs) {
      unsigned long long mine = running;
      for (int j = blockIdx.x; j < chunk_blocks; j += gridDim.x) {
        const int h0 = c * L.chunk + j * kHyp;
        const int n_h = min(kHyp, L.chunk - j * kHyp);
        solve<kHyp, kNP>(P, order, n_valid, h0, n_h, hb);
        __syncthreads();
        int cnt[Layout<kHyp>::kPer] = {};
        score_all<kHyp>(P, order, n_valid, resident, tile, tile_len, hb, cnt);
        const unsigned long long key = block_best<kHyp>(P, hb, h0, n_h, cnt, warp_best);
        if (threadIdx.x == 0) {
          write_slot(hb, key, h0,
                     slots + (static_cast<size_t>(c) * chunk_blocks + j) * kSlotWords);
          mine = max_u64(mine, key);
        }
        __syncthreads();  // hb and the tile are taken again
      }
      if (threadIdx.x == 0) atomicMax(my_best + c, mine);
    }
    grid.sync();
    // the stop test of every pair still running, from its best over loop
    // blocks 0 .. c: the same inputs, so the same answer, in every block
    bool more = false;
    const int evaluated = (c + 1) * L.chunk;
    for (int p = threadIdx.x; p < L.n_pairs; p += kThreads) {
      if (s_stop[p] >= 0) continue;
      const unsigned long long key = __ldcg(best + static_cast<size_t>(p) * L.n_chunks + c);
      if (p == b) s_best = key;
      if (c + 1 == L.n_chunks ||
          stop_test<kNP>(static_cast<int>(key >> 32), __ldcg(n_valid_of + p), evaluated, L)) {
        s_stop[p] = c;
      } else {
        more = true;
      }
    }
    more = __syncthreads_or(more);
    if (runs) running = s_best;
    if (!more) break;
  }

  const int stop = s_stop[b];
  const unsigned h = key_index(running);
  const unsigned cw = h / L.chunk;
  const unsigned j = (h - cw * L.chunk) / kHyp;
  if (threadIdx.x == 0) {
    take_winner(running, slots + (static_cast<size_t>(cw) * chunk_blocks + j) * kSlotWords,
                true, n_valid, kNP, P.N, blockIdx.x == 0, out, s_H);
    if (blockIdx.x == 0) {
      out.ints[5] = stop + 1;
      out.ints[6] = (stop + 1) * L.chunk;
    }
  }
  __syncthreads();
  write_mask(P, s_H, (running >> 32) > 0, out.mask, blockIdx.x * kThreads + threadIdx.x,
             gridDim.x * kThreads);
}

struct Occupancy {
  int device = -1;
  size_t smem = 0;
  int blocks = 0;  // co-resident blocks on the card
};

template <int kNP, bool kGlobalOrder>
cudaError_t launch(const Problem& P, const Loop& L, const Outputs& out,
                   unsigned long long* best, int* n_valid_of, float* slots,
                   cudaStream_t stream) {
  static Occupancy occ;  // the last query of this kernel, kept: it costs host time
  auto kernel = ransac_adaptive_kernel<kNP, kGlobalOrder>;
  int tile_len = max(1, min(P.N, kTileMax));
  size_t smem = shared_bytes(kGlobalOrder ? 0 : P.N, tile_len);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess) {
    return err;
  }
  int device;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if (device != occ.device || smem != occ.smem) {
    int sms, per_sm;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             smem)) != cudaSuccess) {
      return err;
    }
    occ = {device, smem, sms * per_sm};
  }
  // the co-resident blocks split evenly among the pairs
  const int per_pair = min((L.chunk + kHyp - 1) / kHyp, occ.blocks / L.n_pairs);
  if (per_pair < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (kGlobalOrder) {
    order_kernel<<<L.n_pairs, kOrderThreads, 0, stream>>>(P.valid, P.N, P.order);
  }
  Problem p = P;
  Loop l = L;
  Outputs o = out;
  void* args[] = {&p, &l, &tile_len, &o, &best, &n_valid_of, &slots};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(per_pair, L.n_pairs),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// k = n_pairs fits (1 <= k <= kMaxPairs). m1, m2: (k, N, 3) fp32; valid:
// (k, N) bytes; seed: (k,) uint64 on the device, or null with samples: (k,
// n_chunks * chunk, n_points) int32 match indices in [0, N); n_points: 4
// (homography) or 3 (affine); counts: (k, n_chunks * chunk) int32 and sets:
// (k, n_chunks * chunk, n_points) int32, each optional (null), written for
// the blocks run; H: (k, 9) fp32; ints: (k, 8) int32 (count, set, blocks
// run, hypotheses evaluated); mask: (k, N + 1) bytes (the mask, then
// found); order: (k, N + 1) int32 scratch when N > kSharedOrderMax, else
// null; best: (k, n_chunks) 64-bit scratch; n_valid_of: (k,) int32
// scratch; slots: (k, n_chunks * ceil(chunk / 16), 16) fp32 scratch.
RF_API int rf_ransac_adaptive(const float* m1, const float* m2,
                              const unsigned char* valid, int N, int n_pairs,
                              const unsigned long long* seed, const int* samples,
                              int n_chunks, int chunk, int n_iter, int n_points,
                              float tol, float confidence, int* counts, int* sets,
                              float* H, int* ints, unsigned char* mask, int* order,
                              unsigned long long* best, int* n_valid_of, float* slots,
                              cudaStream_t stream) {
  if ((N > kSharedOrderMax) != (order != nullptr) || (n_points != 3 && n_points != 4) ||
      n_pairs < 1 || n_pairs > kMaxPairs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem P{m1, m2, valid, N, seed, samples, tol, counts, sets, order};
  const Loop L{n_chunks, chunk, n_iter, n_pairs, confidence};
  const Outputs out{H, ints, mask};
  cudaError_t err;
  if (n_points == 4) {
    err = order != nullptr ? launch<4, true>(P, L, out, best, n_valid_of, slots, stream)
                           : launch<4, false>(P, L, out, best, n_valid_of, slots, stream);
  } else {
    err = order != nullptr ? launch<3, true>(P, L, out, best, n_valid_of, slots, stream)
                           : launch<3, false>(P, L, out, best, n_valid_of, slots, stream);
  }
  return static_cast<int>(err);
}
