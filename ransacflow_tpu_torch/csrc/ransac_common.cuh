// Solve and score of one RANSAC homography hypothesis per thread, shared by
// the fixed-count kernel (ransac.cu) and the adaptive one
// (ransac_adaptive.cu).
//
// For hypothesis h with match indices s = samples[h, 0:4]:
//   1. a set with a repeated index is rejected (count 0);
//   2. both 4-point sets are Hartley-normalized, H is built in closed form
//      from the projective basis, denormalized and scaled to unit Frobenius
//      norm (the reference's exact sequence of operations,
//      ransacflow_tpu/ops/homography.py:136 dlt_homography, 'projective');
//   3. a set with |det H| <= 1e-6 is rejected;
//   4. count = #{valid m : |dehom(H m2) - m1|^2 < tol^2}
//      (ransacflow_tpu/ops/ransac.py:77 _make_count_chunk).
#pragma once

#include <math.h>

namespace rf_ransac {

constexpr int kThreads = 64;
constexpr int kTile = 1024;  // matches staged in shared memory per step
constexpr float kDetEps = 1e-6f;

__device__ __forceinline__ void adjugate(const float* m, float* a) {
  a[0] = m[4] * m[8] - m[5] * m[7];
  a[1] = m[2] * m[7] - m[1] * m[8];
  a[2] = m[1] * m[5] - m[2] * m[4];
  a[3] = m[5] * m[6] - m[3] * m[8];
  a[4] = m[0] * m[8] - m[2] * m[6];
  a[5] = m[2] * m[3] - m[0] * m[5];
  a[6] = m[3] * m[7] - m[4] * m[6];
  a[7] = m[1] * m[6] - m[0] * m[7];
  a[8] = m[0] * m[4] - m[1] * m[3];
}

__device__ __forceinline__ float det3(const float* m) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) -
         m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

__device__ __forceinline__ void matmul3(const float* a, const float* b,
                                        float* c) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      c[r * 3 + q] = a[r * 3] * b[q] + a[r * 3 + 1] * b[3 + q] +
                     a[r * 3 + 2] * b[6 + q];
    }
  }
}

// Hartley normalization of 4 points in place (centroid 0, mean distance
// sqrt 2); T receives the similarity that maps the input to the output.
__device__ __forceinline__ void hartley(float* px, float* py, float* T) {
  const float cx = (px[0] + px[1] + px[2] + px[3]) / 4.f;
  const float cy = (py[0] + py[1] + py[2] + py[3]) / 4.f;
  float d = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float dx = px[t] - cx;
    const float dy = py[t] - cy;
    d += sqrtf(dx * dx + dy * dy);
  }
  d /= 4.f;
  const float s = 1.41421356f / fmaxf(d, 1e-12f);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    px[t] = (px[t] - cx) * s;
    py[t] = (py[t] - cy) * s;
  }
  T[0] = s;   T[1] = 0.f; T[2] = -s * cx;
  T[3] = 0.f; T[4] = s;   T[5] = -s * cy;
  T[6] = 0.f; T[7] = 0.f; T[8] = 1.f;
}

// The map sending the projective basis e1, e2, e3, (1,1,1) to the 4 points.
__device__ __forceinline__ void basis_transform(const float* px,
                                                const float* py, float* B) {
  const float M[9] = {px[0], px[1], px[2], py[0], py[1], py[2], 1.f, 1.f, 1.f};
  float A[9];
  adjugate(M, A);
  float c[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) c[r] = A[r * 3] * px[3] + A[r * 3 + 1] * py[3] + A[r * 3 + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) B[r * 3 + q] = M[r * 3 + q] * c[q];
  }
}

// The block's body: thread h = blockIdx.x * kThreads + threadIdx.x solves
// and scores samples[h] for h < n_iter, writing H_out[h] (9 floats) and
// counts[h]. Every thread of the block must call it (it synchronizes).
__device__ __forceinline__ void score_hypotheses(
    const float* __restrict__ m1, const float* __restrict__ m2,
    const unsigned char* __restrict__ valid, int N,
    const int* __restrict__ samples, int n_iter, float tol,
    float* __restrict__ H_out, int* __restrict__ counts) {
  // an invalid match is staged with a NaN source x: its error compares false
  __shared__ float s1x[kTile], s1y[kTile], s2x[kTile], s2y[kTile], s2z[kTile];
  const int h = blockIdx.x * kThreads + threadIdx.x;
  const bool active = h < n_iter;
  const float tol2 = tol * tol;

  float H[9];
  bool ok = false;
  if (active) {
    int id[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) id[t] = samples[h * 4 + t];
    const bool unique = id[0] != id[1] && id[0] != id[2] && id[0] != id[3] &&
                        id[1] != id[2] && id[1] != id[3] && id[2] != id[3];
    float xx[4], xy[4], yx[4], yy[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      xx[t] = m1[id[t] * 3];
      xy[t] = m1[id[t] * 3 + 1];
      yx[t] = m2[id[t] * 3];
      yy[t] = m2[id[t] * 3 + 1];
    }
    float T1[9], T2[9], BX[9], BY[9], adjBY[9], Hn[9], T1inv[9], tmp[9];
    hartley(xx, xy, T1);
    hartley(yx, yy, T2);
    basis_transform(xx, xy, BX);
    basis_transform(yx, yy, BY);
    adjugate(BY, adjBY);
    matmul3(BX, adjBY, Hn);
    adjugate(T1, T1inv);
    const float dT1 = fmaxf(det3(T1), 1e-20f);
#pragma unroll
    for (int e = 0; e < 9; ++e) T1inv[e] /= dT1;
    matmul3(T1inv, Hn, tmp);
    matmul3(tmp, T2, H);
    float nrm = 0.f;
#pragma unroll
    for (int e = 0; e < 9; ++e) nrm += H[e] * H[e];
    nrm = fmaxf(sqrtf(nrm), 1e-12f);
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      H[e] /= nrm;
      H_out[static_cast<size_t>(h) * 9 + e] = H[e];
    }
    ok = unique && fabsf(det3(H)) > kDetEps;
  }

  int cnt = 0;
  for (int t0 = 0; t0 < N; t0 += kTile) {
    const int n = min(kTile, N - t0);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int m = t0 + e;
      s1x[e] = valid[m] ? m1[m * 3] : NAN;
      s1y[e] = m1[m * 3 + 1];
      s2x[e] = m2[m * 3];
      s2y[e] = m2[m * 3 + 1];
      s2z[e] = m2[m * 3 + 2];
    }
    __syncthreads();
    if (ok) {
      for (int e = 0; e < n; ++e) {
        const float ex = s2x[e] * H[0] + s2y[e] * H[1] + s2z[e] * H[2];
        const float ey = s2x[e] * H[3] + s2y[e] * H[4] + s2z[e] * H[5];
        const float ez = s2x[e] * H[6] + s2y[e] * H[7] + s2z[e] * H[8];
        const float du = ex / ez - s1x[e];
        const float dv = ey / ez - s1y[e];
        cnt += (du * du + dv * dv < tol2) ? 1 : 0;
      }
    }
    __syncthreads();
  }
  if (active) counts[h] = ok ? cnt : 0;
}

}  // namespace rf_ransac
