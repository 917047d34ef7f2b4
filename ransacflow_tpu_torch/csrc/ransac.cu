// RANSAC homography hypotheses: solve and score, one hypothesis per thread.
//
// Replaces: ransacflow_tpu/ops/ransac.py:102 ransac_homography, its solve
// (_solve_models with ops/homography.py:136 dlt_homography, 'projective')
// and its count (ops/ransac.py:77 _make_count_chunk). The per-hypothesis
// steps are in ransac_common.cuh. H (n_iter, 3, 3) and counts (n_iter,)
// int32 are written; the argmax and the winner's inlier mask stay in torch.
//
// What bounds it on the H100: at the serving shape (10k hypotheses x 1200
// matches) the work is 12 M point tests, each a few multiply-adds and two
// divisions: microseconds of arithmetic and almost no memory traffic. The
// reference materialised (N x n_iter) projection matrices (3 x 48 MB) for
// it. Here nothing of size N x n_iter exists: the matches are staged tile by
// tile in shared memory and every thread reads the same match at the same
// time (a broadcast), so the kernel is bound by instruction latency and by
// having only ~80-160 blocks; small blocks of 64 threads spread them over
// more SMs.
#include "common.cuh"
#include "ransac_common.cuh"

namespace {

using rf_ransac::kThreads;

__global__ void __launch_bounds__(kThreads) ransac_score_kernel(
    const float* __restrict__ m1, const float* __restrict__ m2,
    const unsigned char* __restrict__ valid, int N,
    const int* __restrict__ samples, int n_iter, float tol,
    float* __restrict__ H_out, int* __restrict__ counts) {
  rf_ransac::score_hypotheses(m1, m2, valid, N, samples, n_iter, tol, H_out,
                              counts);
}

}  // namespace

// m1, m2: (N, 3) fp32; valid: (N,) bytes; samples: (n_iter, 4) int32 match
// indices in [0, N); H_out: (n_iter, 9) fp32; counts: (n_iter,) int32.
RF_API int rf_ransac_score(const float* m1, const float* m2,
                           const unsigned char* valid, int N,
                           const int* samples, int n_iter, float tol,
                           float* H_out, int* counts, cudaStream_t stream) {
  ransac_score_kernel<<<(n_iter + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(m1, m2, valid, N, samples, n_iter, tol,
                                  H_out, counts);
  return static_cast<int>(cudaGetLastError());
}
