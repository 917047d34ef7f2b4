// Adaptive RANSAC: hypotheses scored in chunks until a confidence bound is
// met, with the stop test on the device.
//
// Replaces: ransacflow_tpu/ops/ransac.py:194 ransac_homography_adaptive,
// the lax.while_loop over chunks (lines 251-295). For chunk c:
//   1. score: solve and count every hypothesis of the chunk
//      (ransac_common.cuh, the same device code as the fixed-count kernel);
//   2. update, one block: the chunk's argmax (first index on ties) replaces
//      the running best only when its count is strictly greater; then, in
//      fp32 as the reference, w = best / max(n_valid, 1),
//      w4 = min(w^4, 1 - 1e-7), denom = min(log1p(-w4), -1e-30),
//      n_req = log1p(-confidence) / denom, and the done flag is set when
//      (c + 1) * chunk >= min(n_req, n_iter).
// The entry point enqueues all ceil(n_iter / chunk) chunks at once. Every
// kernel reads the done flag first and its blocks return at once when it is
// set, so the loop ends on the device and the host never waits for it.
//
// What bounds it on the H100: a chunk of 4096 hypotheses x 1200 matches is
// 5 M point tests, a few microseconds of arithmetic, spread over only 64
// blocks of 64 threads; the chain of 2 launches per chunk then costs more
// than the work (launch latency, ~13 chunks at the 50k cap). A chunk that
// is skipped costs one launch and one load. Keeping the stop test on the
// device is what matters at this size: a host read per chunk would add a
// full round trip for every chunk. Making one persistent kernel of the loop
// is later work.
//
// State (int32 state[8]): [0] best count, [1..4] best sample (match
// indices), [5] done, [6] chunks run; best_H (9 floats) beside it.
#include "common.cuh"
#include "ransac_common.cuh"

namespace {

using rf_ransac::kThreads;

constexpr int kUpdateThreads = 256;
enum { kBestCount = 0, kBestSample = 1, kDone = 5, kChunksRun = 6 };

__global__ void __launch_bounds__(kThreads) adaptive_score_kernel(
    const float* __restrict__ m1, const float* __restrict__ m2,
    const unsigned char* __restrict__ valid, int N,
    const int* __restrict__ samples, int chunk, float tol,
    float* __restrict__ H_out, int* __restrict__ counts,
    const int* __restrict__ state) {
  if (state[kDone]) return;  // the same value for every thread of the block
  rf_ransac::score_hypotheses(m1, m2, valid, N, samples, chunk, tol, H_out,
                              counts);
}

__global__ void __launch_bounds__(kUpdateThreads) adaptive_update_kernel(
    const float* __restrict__ H, const int* __restrict__ counts, int chunk,
    const int* __restrict__ samples, const int* __restrict__ n_valid,
    int evaluated, int n_iter, float confidence, float* __restrict__ best_H,
    int* __restrict__ state) {
  if (state[kDone]) return;
  __shared__ int s_val[kUpdateThreads];
  __shared__ int s_idx[kUpdateThreads];
  // argmax, first index on ties: each thread walks its indices upwards and
  // keeps strictly larger counts; the tree merge prefers the lower index
  int bv = -1, bi = 0;
  for (int i = threadIdx.x; i < chunk; i += kUpdateThreads) {
    const int v = counts[i];
    if (v > bv) {
      bv = v;
      bi = i;
    }
  }
  s_val[threadIdx.x] = bv;
  s_idx[threadIdx.x] = bi;
  __syncthreads();
  for (int stride = kUpdateThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const int ov = s_val[threadIdx.x + stride];
      const int oi = s_idx[threadIdx.x + stride];
      if (ov > s_val[threadIdx.x] ||
          (ov == s_val[threadIdx.x] && oi < s_idx[threadIdx.x])) {
        s_val[threadIdx.x] = ov;
        s_idx[threadIdx.x] = oi;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const int c_best = s_idx[0];
  if (counts[c_best] > state[kBestCount]) {
    state[kBestCount] = counts[c_best];
    for (int e = 0; e < 9; ++e) best_H[e] = H[c_best * 9 + e];
    for (int t = 0; t < 4; ++t) state[kBestSample + t] = samples[c_best * 4 + t];
  }
  const float w = static_cast<float>(state[kBestCount]) /
                  static_cast<float>(max(*n_valid, 1));
  const float w2 = w * w;
  // 1 - 1e-7 rounded to fp32 once, as the reference's constant
  const float w4 = fminf(w2 * w2, static_cast<float>(1.0 - 1e-7));
  const float denom = fminf(log1pf(-w4), -1e-30f);
  const float n_req = log1pf(-confidence) / denom;
  state[kDone] = static_cast<float>(evaluated) >=
                 fminf(n_req, static_cast<float>(n_iter));
  state[kChunksRun] += 1;
}

}  // namespace

// m1, m2: (N, 3) fp32; valid: (N,) bytes; samples: (n_chunks * chunk, 4)
// int32 match indices in [0, N); n_valid: () int32 on the device;
// H: (chunk, 9) fp32 and counts: (chunk,) int32 scratch; best_H: (9,) fp32
// holding the identity and state: (8,) int32 holding zeros on entry.
RF_API int rf_ransac_adaptive(const float* m1, const float* m2,
                              const unsigned char* valid, int N,
                              const int* samples, int n_chunks, int chunk,
                              int n_iter, float tol, float confidence,
                              const int* n_valid, float* H, int* counts,
                              float* best_H, int* state, cudaStream_t stream) {
  const int blocks = (chunk + kThreads - 1) / kThreads;
  for (int c = 0; c < n_chunks; ++c) {
    const int* chunk_samples = samples + static_cast<size_t>(c) * chunk * 4;
    adaptive_score_kernel<<<blocks, kThreads, 0, stream>>>(
        m1, m2, valid, N, chunk_samples, chunk, tol, H, counts, state);
    adaptive_update_kernel<<<1, kUpdateThreads, 0, stream>>>(
        H, counts, chunk, chunk_samples, n_valid, (c + 1) * chunk, n_iter,
        confidence, best_H, state);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
