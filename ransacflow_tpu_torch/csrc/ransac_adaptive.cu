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

struct Loop {
  int n_chunks, chunk, n_iter;
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
    float* slots) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  __shared__ HypBlock<kHyp> hb;
  __shared__ int warp_sum[kWarps];
  __shared__ unsigned long long warp_best[kWarps];
  __shared__ unsigned long long s_best;
  __shared__ float s_H[9];

  const Tile tile = tile_at(smem, kGlobalOrder ? 0 : P.N, tile_len);
  if (blockIdx.x == 0) {
    for (int c = threadIdx.x; c < L.n_chunks; c += kThreads) best[c] = 0ull;
  }
  const int* order;
  const int n_valid = block_order<kGlobalOrder>(P, smem, &order, warp_sum);
  const bool resident = n_valid <= tile_len;
  if (resident) stage(P, order, 0, n_valid, tile);
  const int chunk_blocks = (L.chunk + kHyp - 1) / kHyp;
  grid.sync();  // best[] is zeroed

  unsigned long long running = 0ull;
  int c = 0;
  for (;; ++c) {
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
    if (threadIdx.x == 0) atomicMax(best + c, mine);
    grid.sync();
    if (threadIdx.x == 0) s_best = __ldcg(best + c);
    __syncthreads();
    running = s_best;
    const int evaluated = (c + 1) * L.chunk;
    if (c + 1 == L.n_chunks ||
        stop_test<kNP>(static_cast<int>(running >> 32), n_valid, evaluated, L)) {
      break;
    }
  }

  const unsigned h = key_index(running);
  const unsigned cw = h / L.chunk;
  const unsigned j = (h - cw * L.chunk) / kHyp;
  if (threadIdx.x == 0) {
    take_winner(running, slots + (static_cast<size_t>(cw) * chunk_blocks + j) * kSlotWords,
                true, n_valid, kNP, P.N, blockIdx.x == 0, out, s_H);
    if (blockIdx.x == 0) {
      out.ints[5] = c + 1;
      out.ints[6] = (c + 1) * L.chunk;
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
                   unsigned long long* best, float* slots, cudaStream_t stream) {
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
  const int grid = min((L.chunk + kHyp - 1) / kHyp, occ.blocks);
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (kGlobalOrder) order_kernel<<<1, kOrderThreads, 0, stream>>>(P.valid, P.N, P.order);
  Problem p = P;
  Loop l = L;
  Outputs o = out;
  void* args[] = {&p, &l, &tile_len, &o, &best, &slots};
  err = cudaLaunchCooperativeKernel((void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// m1, m2: (N, 3) fp32; valid: (N,) bytes; seed: () uint64 on the device, or
// null with samples: (n_chunks * chunk, n_points) int32 match indices in [0,
// N); n_points: 4 (homography) or 3 (affine); counts: (n_chunks * chunk,)
// int32 and sets: (n_chunks * chunk, n_points) int32, each optional (null),
// written for the blocks run; H: (9,) fp32; ints: (8,) int32 (count, set,
// blocks run, hypotheses evaluated); mask: (N + 1,) bytes (the mask, then
// found); order: (N + 1,) int32 scratch when N > kSharedOrderMax, else null;
// best: (n_chunks,) 64-bit scratch; slots: (n_chunks * ceil(chunk / 16),
// 16) fp32 scratch.
RF_API int rf_ransac_adaptive(const float* m1, const float* m2,
                              const unsigned char* valid, int N,
                              const unsigned long long* seed, const int* samples,
                              int n_chunks, int chunk, int n_iter, int n_points,
                              float tol, float confidence, int* counts, int* sets,
                              float* H, int* ints, unsigned char* mask, int* order,
                              unsigned long long* best, float* slots,
                              cudaStream_t stream) {
  if ((N > kSharedOrderMax) != (order != nullptr) || (n_points != 3 && n_points != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Problem P{m1, m2, valid, N, seed, samples, tol, counts, sets, order};
  const Loop L{n_chunks, chunk, n_iter, confidence};
  const Outputs out{H, ints, mask};
  cudaError_t err;
  if (n_points == 4) {
    err = order != nullptr ? launch<4, true>(P, L, out, best, slots, stream)
                           : launch<4, false>(P, L, out, best, slots, stream);
  } else {
    err = order != nullptr ? launch<3, true>(P, L, out, best, slots, stream)
                           : launch<3, false>(P, L, out, best, slots, stream);
  }
  return static_cast<int>(err);
}
