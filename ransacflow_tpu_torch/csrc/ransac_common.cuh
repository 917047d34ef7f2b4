// RANSAC fits of 4-point homographies and 3-point affine maps: the device
// code shared by the fixed-count kernel (ransac.cu) and the adaptive one
// (ransac_adaptive.cu). The set size kNP (4 or 3) is a template parameter,
// so the homography path's code is the same whatever the affine one does.
//
// A thread block of kThreads threads takes kHyp hypotheses at a time (a
// hypothesis block). For hypothesis h:
//   1. draw: Philox4x32-10 with counter (h, 0, 0, 0) and the seed's two
//      32-bit words (low, high) as key gives 4 words x, y, z, w; the first
//      kNP of them become ranks r = min(floor(fp32((x >> 8) * 2^-24) *
//      fp32(n_valid)), n_valid - 1) of the stable valid-first order (n_valid
//      0 takes index 0), so an affine set is the first three indices of the
//      homography set under the same seed. Up to kSharedOrderMax matches
//      each block builds that order with a scan of `valid` into shared
//      memory; above it order_kernel writes it to global memory once, before
//      the fit's launch. An injected set replaces the draw;
//   2. a set with a repeated index is rejected (count 0);
//   3. homography: both 4-point sets are Hartley-normalized, H is built in
//      closed form from the projective basis, denormalized and scaled to
//      unit Frobenius norm (the reference's exact sequence of operations,
//      ransacflow_tpu/ops/homography.py:136 dlt_homography, 'projective');
//      a set with |det H| <= 1e-6 is rejected. Affine: the least-squares fit
//      through the 3x3 normal equations in closed form (affine_fit; the
//      reference's fit_affine, ransacflow_tpu/ops/homography.py:217), last
//      row [0, 0, 1], with no gate (ransacflow_tpu/ops/ransac.py:68-69): a
//      map with a non-finite entry (collinear points) counts 0 as it does
//      there, and is scored as a rejected set;
//   4. count = #{valid m : |dehom(H m2) - m1|^2 < tol^2}
//      (ransacflow_tpu/ops/ransac.py:77 _make_count_chunk; ez is m2's z
//      for an affine H).
// Scoring: the valid matches are staged in shared memory as structure of
// arrays (tiles of kTileMax when there are more); each thread holds kPer
// hypotheses in registers (4 for the fixed-count kernel's 32 hypotheses a
// block, 2 for the adaptive one's 16) and walks every kLanes-th staged
// match, so one shared load feeds kPer independent projection and divide
// chains, and the lanes' counts meet by warp shuffles. The block's best is
// packed as (count << 32) | (0xFFFFFFFF - h): one 64-bit atomicMax over
// blocks then gives torch.argmax's winner (the largest count, the first
// index on ties). The H that was scored goes to the hypothesis block's slot
// and is never solved again: ptxas may contract products into FMAs
// differently at another call site of the same source.
//
// The batch forms fit k problems of N matches each in one launch: matches
// (k, N, 3), valid (k, N), k seeds (or k sets of injected rows), outputs
// and records per pair. A thread block takes one pair's hypotheses
// (at_pair offsets every pointer to that pair's arrays) and runs the single
// form's code on them, so each pair's fit is its single launch's.
//
// The valid-first order (N ints) and one tile fit in a thread block's
// shared memory up to kSharedOrderMax = 40960 matches; above it the order
// lives in global memory, and the matches are staged tile by tile. The int32
// indexing of the (N, 3) match arrays bounds N by (2^31 - 1) / 3
// (kernels/ransac.py MAX_MATCHES).
#pragma once

#include <math.h>

namespace rf_ransac {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileMax = 2048;  // valid matches staged in shared memory at a time
constexpr int kSlotWords = 16;  // a hypothesis block's winner: H (9 floats), set (4 ints)
constexpr float kDetEps = 1e-6f;
constexpr int kSharedOrderMax = 40960;  // kernels/ransac.py SHARED_ORDER_MAX
constexpr int kOrderThreads = 1024;     // order_kernel's block

// The scoring layout of kHyp hypotheses a block: a thread holds kPer of
// them in registers, and the kLanes threads of a group walk the matches.
template <int kHyp>
struct Layout {
  static constexpr int kPer = kHyp >= 32 ? 4 : kHyp / 8;
  static constexpr int kGroups = kHyp / kPer;
  static constexpr int kLanes = kThreads / kGroups;
  static_assert(kPer >= 1 && kHyp % kPer == 0 && kThreads % kGroups == 0 && kLanes <= 32,
                "a group of lanes must lie inside one warp");
};

struct Problem {
  const float* m1;             // (N, 3)
  const float* m2;             // (N, 3)
  const unsigned char* valid;  // (N,)
  int N;
  const unsigned long long* seed;  // the draws' key, or null with `samples`
  const int* samples;              // injected sets (rows, 4), or null
  float tol;
  int* counts;  // optional records per hypothesis (null on the alignment
  int* sets;    // paths): its count and its set
  int* order;   // above kSharedOrderMax: the global valid-first order (N
                // ints, then n_valid) written by order_kernel; else null
};

struct Outputs {
  float* H;             // (9,)
  int* ints;            // count, set (4), blocks run, hypotheses evaluated
  unsigned char* mask;  // (N + 1,): the inlier mask, then found
};

struct Tile {
  float *x1, *y1, *x2, *y2, *z2;
};

template <int kHyp>
struct HypBlock {
  float H[kHyp][9];
  int ids[kHyp][4];
  int ok[kHyp];
};

// Pair b's problem and outputs in the batch arrays: `rows` hypotheses a
// pair (the injected sets and the records), kNP indices a set.
__device__ __forceinline__ void at_pair(Problem& P, Outputs& out, int b, int rows, int kNP) {
  const size_t n = P.N, pair = b;
  P.m1 += pair * n * 3;
  P.m2 += pair * n * 3;
  P.valid += pair * n;
  if (P.seed != nullptr) P.seed += pair;
  if (P.samples != nullptr) P.samples += pair * rows * kNP;
  if (P.counts != nullptr) P.counts += pair * rows;
  if (P.sets != nullptr) P.sets += pair * rows * kNP;
  if (P.order != nullptr) P.order += pair * (n + 1);
  out.H += pair * 9;
  out.ints += pair * 8;
  out.mask += pair * (n + 1);
}

// Dynamic shared memory: the shared valid-first order, then the tile.
inline size_t shared_bytes(int order_len, int tile_len) {
  return static_cast<size_t>(order_len) * sizeof(int) +
         5 * static_cast<size_t>(tile_len) * sizeof(float);
}

__device__ __forceinline__ Tile tile_at(int* smem, int order_len, int tile_len) {
  float* f = reinterpret_cast<float*>(smem + order_len);
  return {f, f + tile_len, f + 2 * tile_len, f + 3 * tile_len, f + 4 * tile_len};
}

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

// Exact-rounding forms of adjugate and det3 for affine_fit: every product
// and difference rounded on its own, as separate tensor ops round them.
__device__ __forceinline__ void adjugate_rn(const float* m, float* a) {
  a[0] = __fsub_rn(__fmul_rn(m[4], m[8]), __fmul_rn(m[5], m[7]));
  a[1] = __fsub_rn(__fmul_rn(m[2], m[7]), __fmul_rn(m[1], m[8]));
  a[2] = __fsub_rn(__fmul_rn(m[1], m[5]), __fmul_rn(m[2], m[4]));
  a[3] = __fsub_rn(__fmul_rn(m[5], m[6]), __fmul_rn(m[3], m[8]));
  a[4] = __fsub_rn(__fmul_rn(m[0], m[8]), __fmul_rn(m[2], m[6]));
  a[5] = __fsub_rn(__fmul_rn(m[2], m[3]), __fmul_rn(m[0], m[5]));
  a[6] = __fsub_rn(__fmul_rn(m[3], m[7]), __fmul_rn(m[4], m[6]));
  a[7] = __fsub_rn(__fmul_rn(m[1], m[6]), __fmul_rn(m[0], m[7]));
  a[8] = __fsub_rn(__fmul_rn(m[0], m[4]), __fmul_rn(m[1], m[3]));
}

// The affine fit X ~ Y M of 3 points (X: m1's x, y; Y: m2's x, y, z) in the
// order of operations of the plain version, ops/homography.py fit_affine:
// YtY and YtX summed point by point, M = adj(YtY) YtX / det(YtY), det the
// first row of YtY against adj's first column. The _rn intrinsics are never
// contracted into FMAs, so the result is the plain version's bit for bit.
// H = [M^T; 0 0 1]. Collinear points give inf or nan, as in the reference.
__device__ __forceinline__ void affine_fit(const float* x1, const float* y1,
                                           const float (*Y)[3], float* H) {
  float A[9], B[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) A[i * 3 + j] = __fmul_rn(Y[0][i], Y[0][j]);
    B[i * 2] = __fmul_rn(Y[0][i], x1[0]);
    B[i * 2 + 1] = __fmul_rn(Y[0][i], y1[0]);
  }
#pragma unroll
  for (int t = 1; t < 3; ++t) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        A[i * 3 + j] = __fadd_rn(A[i * 3 + j], __fmul_rn(Y[t][i], Y[t][j]));
      }
      B[i * 2] = __fadd_rn(B[i * 2], __fmul_rn(Y[t][i], x1[t]));
      B[i * 2 + 1] = __fadd_rn(B[i * 2 + 1], __fmul_rn(Y[t][i], y1[t]));
    }
  }
  float a[9];
  adjugate_rn(A, a);
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(A[0], a[0]), __fmul_rn(A[1], a[3])),
                              __fmul_rn(A[2], a[6]));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float m = __fadd_rn(__fadd_rn(__fmul_rn(a[i * 3], B[k]),
                                          __fmul_rn(a[i * 3 + 1], B[2 + k])),
                                __fmul_rn(a[i * 3 + 2], B[4 + k]));
      H[k * 3 + i] = __fdiv_rn(m, det);
    }
  }
  H[6] = 0.f;
  H[7] = 0.f;
  H[8] = 1.f;
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants and rounds) of
// the counter (ctr, 0, 0, 0) under the key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(unsigned ctr, unsigned k0,
                                               unsigned k1) {
  unsigned c0 = ctr, c1 = 0u, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const unsigned lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The draw rule: one Philox word -> the match index of its rank.
__device__ __forceinline__ int draw_index(unsigned x, const int* order,
                                          int n_valid) {
  if (n_valid == 0) return 0;  // the stable order of all-invalid starts at 0
  const float u = __uint2float_rn(x >> 8) * 5.9604644775390625e-08f;  // 2^-24
  const int r = static_cast<int>(floorf(__fmul_rn(u, __int2float_rn(n_valid))));
  return order[min(r, n_valid - 1)];
}

// order[r] = the index of the r-th valid match, by a block-wide scan of
// `valid`. Returns n_valid, the same in every thread. Every thread of the
// block must call it.
__device__ __forceinline__ int build_order(const unsigned char* __restrict__ valid,
                                           int N, int* order, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int i0 = 0; i0 < N; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool v = i < N && valid[i];
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) warp_sum[warp] = __popc(bits);
    __syncthreads();
    int offset = base, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[w];
      offset += w < warp ? s : 0;
      total += s;
    }
    if (v) order[offset + __popc(bits & ((1u << lane) - 1u))] = i;
    base += total;
    __syncthreads();
  }
  return base;
}

// The global valid-first order for more than kSharedOrderMax matches: one
// block of kOrderThreads threads walks `valid` 4 flags a thread at a time,
// places each valid index by a block-wide prefix sum of the counts, and
// writes order[0 .. n_valid) and order[N] = n_valid. A stable compaction,
// so the order is the one build_order gives. Launched once, before a fit,
// with one block a pair (blockIdx.x; valid (k, N), order (k, N + 1)).
static __global__ void __launch_bounds__(kOrderThreads) order_kernel(
    const unsigned char* __restrict__ valid, int N, int* __restrict__ order) {
  __shared__ int warp_incl[kOrderThreads / 32];
  valid += static_cast<size_t>(blockIdx.x) * N;
  order += static_cast<size_t>(blockIdx.x) * (N + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int i0 = 0; i0 < N; i0 += 4 * kOrderThreads) {
    const int i = i0 + 4 * threadIdx.x;
    bool f[4];
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      f[t] = i + t < N && valid[i + t];
      cnt += f[t];
    }
    int incl = cnt;  // inclusive prefix over the warp's lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {  // inclusive prefix over the block's 32 warps
      int w = warp_incl[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += v;
      }
      warp_incl[lane] = w;
    }
    __syncthreads();
    int pos = base + (warp > 0 ? warp_incl[warp - 1] : 0) + incl - cnt;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (f[t]) order[pos++] = i + t;
    }
    base += warp_incl[kOrderThreads / 32 - 1];
    __syncthreads();  // warp_incl is taken again
  }
  if (threadIdx.x == 0) order[N] = base;
}

// The block's valid-first order and n_valid: the global one written by
// order_kernel (kGlobalOrder), or built into shared memory at `smem`. A
// compile-time choice, so that the shared path's loads stay shared-memory
// loads. Every thread of the block must call it.
template <bool kGlobalOrder>
__device__ __forceinline__ int block_order(const Problem& P, int* smem, const int** order,
                                           int* warp_sum) {
  if constexpr (kGlobalOrder) {
    *order = P.order;
    return P.order[P.N];
  } else {
    *order = smem;
    return build_order(P.valid, P.N, smem, warp_sum);
  }
}

// Valid matches order[t0 .. t0 + n) into the tile.
__device__ __forceinline__ void stage(const Problem& P, const int* order, int t0,
                                      int n, Tile t) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int m = order[t0 + e];
    t.x1[e] = P.m1[m * 3];
    t.y1[e] = P.m1[m * 3 + 1];
    t.x2[e] = P.m2[m * 3];
    t.y2[e] = P.m2[m * 3 + 1];
    t.z2[e] = P.m2[m * 3 + 2];
  }
}

// The 4-point homography of X ~ H Y from the points (xx, xy) and (yx, yy),
// normalized in place: both sets Hartley-normalized, H in closed form from
// the projective basis, denormalized and scaled to unit Frobenius norm.
__device__ __forceinline__ void homography_fit(float* xx, float* xy, float* yx, float* yy,
                                               float* H) {
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
  for (int e = 0; e < 9; ++e) H[e] /= nrm;
}

// Thread i < n_h draws (or reads) and solves hypothesis h0 + i into hb: a
// homography from kNP = 4 points, an affine map from 3.
template <int kHyp, int kNP>
__device__ __forceinline__ void solve(const Problem& P, const int* order,
                                      int n_valid, int h0, int n_h,
                                      HypBlock<kHyp>& hb) {
  static_assert(kNP == 3 || kNP == 4, "4-point homographies or 3-point affine maps");
  const int i = threadIdx.x;
  if (i >= n_h) return;
  const int h = h0 + i;
  int id[4] = {0, 0, 0, 0};
  if (P.samples != nullptr) {
#pragma unroll
    for (int t = 0; t < kNP; ++t) id[t] = P.samples[static_cast<size_t>(h) * kNP + t];
  } else {
    const unsigned long long seed = *P.seed;
    const uint4 x = philox4x32_10(static_cast<unsigned>(h), static_cast<unsigned>(seed),
                                  static_cast<unsigned>(seed >> 32));
    id[0] = draw_index(x.x, order, n_valid);
    id[1] = draw_index(x.y, order, n_valid);
    id[2] = draw_index(x.z, order, n_valid);
    if (kNP == 4) id[3] = draw_index(x.w, order, n_valid);
  }
  if (P.sets != nullptr) {
#pragma unroll
    for (int t = 0; t < kNP; ++t) P.sets[static_cast<size_t>(h) * kNP + t] = id[t];
  }
  float H[9];
  bool ok;
  if constexpr (kNP == 3) {
    float x1[3], y1[3], Y[3][3];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      x1[t] = P.m1[id[t] * 3];
      y1[t] = P.m1[id[t] * 3 + 1];
      Y[t][0] = P.m2[id[t] * 3];
      Y[t][1] = P.m2[id[t] * 3 + 1];
      Y[t][2] = P.m2[id[t] * 3 + 2];
    }
    affine_fit(x1, y1, Y, H);
    // A non-finite entry makes every residual of its row non-finite, so
    // such a map counts 0 (in the plain version too): it is scored as a
    // rejected set, off the divide's slow path.
    bool finite = true;
#pragma unroll
    for (int e = 0; e < 6; ++e) finite = finite && isfinite(H[e]);
    ok = id[0] != id[1] && id[0] != id[2] && id[1] != id[2] && finite;
  } else {
    float xx[4], xy[4], yx[4], yy[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      xx[t] = P.m1[id[t] * 3];
      xy[t] = P.m1[id[t] * 3 + 1];
      yx[t] = P.m2[id[t] * 3];
      yy[t] = P.m2[id[t] * 3 + 1];
    }
    homography_fit(xx, xy, yx, yy, H);
    ok = id[0] != id[1] && id[0] != id[2] && id[0] != id[3] && id[1] != id[2] &&
         id[1] != id[3] && id[2] != id[3] && fabsf(det3(H)) > kDetEps;
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) hb.H[i][e] = H[e];
#pragma unroll
  for (int t = 0; t < 4; ++t) hb.ids[i][t] = id[t];
  hb.ok[i] = ok;
}

// This thread's kPer hypotheses of the block. A rejected one (count 0
// whatever it scores) is scored as the identity: its own H may be zero or
// not finite, and every division by such an ez takes the slow path.
template <int kHyp>
__device__ __forceinline__ void load_hypotheses(const HypBlock<kHyp>& hb,
                                                float (&h)[Layout<kHyp>::kPer][9]) {
  constexpr int kPer = Layout<kHyp>::kPer;
  const int g = threadIdx.x / Layout<kHyp>::kLanes;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = g * kPer + q;
#pragma unroll
    for (int e = 0; e < 9; ++e) h[q][e] = hb.ok[i] ? hb.H[i][e] : (e % 4 == 0 ? 1.f : 0.f);
  }
}

// Adds the inliers among the tile's n matches of this thread's lane.
template <int kHyp>
__device__ __forceinline__ void score(const float (&h)[Layout<kHyp>::kPer][9], Tile t,
                                      int n, float tol2, int (&c)[Layout<kHyp>::kPer]) {
  constexpr int kLanes = Layout<kHyp>::kLanes;
  for (int e = threadIdx.x % kLanes; e < n; e += kLanes) {
    const float x = t.x2[e], y = t.y2[e], z = t.z2[e];
    const float u = t.x1[e], v = t.y1[e];
#pragma unroll
    for (int q = 0; q < Layout<kHyp>::kPer; ++q) {
      const float ex = x * h[q][0] + y * h[q][1] + z * h[q][2];
      const float ey = x * h[q][3] + y * h[q][4] + z * h[q][5];
      const float ez = x * h[q][6] + y * h[q][7] + z * h[q][8];
      const float du = ex / ez - u;
      const float dv = ey / ez - v;
      c[q] += (du * du + dv * dv < tol2) ? 1 : 0;
    }
  }
}

// Scores hypotheses h0 .. h0 + n_h of hb over the n_valid valid matches:
// the tile holds them all when `resident`, else they are staged tile by
// tile. Every thread must call it; hb and the tile may be reused after it.
template <int kHyp>
__device__ __forceinline__ void score_all(const Problem& P, const int* order,
                                          int n_valid, bool resident, Tile tile,
                                          int tile_len, const HypBlock<kHyp>& hb,
                                          int (&c)[Layout<kHyp>::kPer]) {
  float h[Layout<kHyp>::kPer][9];
  load_hypotheses(hb, h);
  const float tol2 = P.tol * P.tol;
  if (resident) {
    score<kHyp>(h, tile, n_valid, tol2, c);
    return;
  }
  for (int t0 = 0; t0 < n_valid; t0 += tile_len) {
    const int n = min(tile_len, n_valid - t0);
    __syncthreads();  // the previous tile is read
    stage(P, order, t0, n, tile);
    __syncthreads();
    score<kHyp>(h, tile, n, tol2, c);
  }
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// Each hypothesis's count (recorded when asked) and the block's best key,
// valid in thread 0; 0 only when the block has no hypothesis. Every thread
// must call it.
template <int kHyp>
__device__ __forceinline__ unsigned long long block_best(
    const Problem& P, const HypBlock<kHyp>& hb, int h0, int n_h,
    int (&c)[Layout<kHyp>::kPer], unsigned long long* warp_best) {
  constexpr int kPer = Layout<kHyp>::kPer, kLanes = Layout<kHyp>::kLanes;
  const int g = threadIdx.x / kLanes;
  unsigned long long best = 0ull;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    int cnt = c[q];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    const int i = g * kPer + q;
    if (i < n_h) {
      const unsigned h = static_cast<unsigned>(h0 + i);
      cnt = hb.ok[i] ? cnt : 0;
      if (P.counts != nullptr && threadIdx.x % kLanes == 0) P.counts[h] = cnt;
      best = max_u64(best, (static_cast<unsigned long long>(cnt) << 32) |
                               (0xFFFFFFFFu - h));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    best = max_u64(best, __shfl_xor_sync(0xffffffffu, best, off));
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) best = max_u64(best, warp_best[w]);
  }
  return best;
}

__device__ __forceinline__ unsigned key_index(unsigned long long key) {
  return 0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull);
}

// Thread 0: the block's best hypothesis (key from block_best) to its slot.
template <int kHyp>
__device__ __forceinline__ void write_slot(const HypBlock<kHyp>& hb,
                                           unsigned long long key, int h0,
                                           float* slot) {
  const int i = static_cast<int>(key_index(key)) - h0;
#pragma unroll
  for (int e = 0; e < 9; ++e) slot[e] = hb.H[i][e];
  int* ids = reinterpret_cast<int*>(slot + 9);
#pragma unroll
  for (int t = 0; t < 4; ++t) ids[t] = hb.ids[i][t];
}

// Thread 0: the winner (packed key `win`, its H and set in `slot`, written
// by another block) into s_H and, when `write`, into the outputs: H,
// count, set (4 ints, an affine set's fourth 0) and found (n_valid >= the
// set size n_points). With `identity_if_none` a winning count of 0 keeps
// the identity and the zero set (the adaptive op's initial best).
__device__ __forceinline__ void take_winner(unsigned long long win, const float* slot,
                                            bool identity_if_none, int n_valid,
                                            int n_points, int N, bool write,
                                            Outputs out, float* s_H) {
  const int count = static_cast<int>(win >> 32);
  const bool none = identity_if_none && count == 0;
  const int* ids = reinterpret_cast<const int*>(slot + 9);
#pragma unroll
  for (int e = 0; e < 9; ++e) s_H[e] = none ? (e % 4 == 0 ? 1.f : 0.f) : __ldcg(slot + e);
  if (!write) return;
#pragma unroll
  for (int e = 0; e < 9; ++e) out.H[e] = s_H[e];
  out.ints[0] = count;
#pragma unroll
  for (int t = 0; t < 4; ++t) out.ints[1 + t] = none ? 0 : __ldcg(ids + t);
  out.mask[N] = count > 0 && n_valid >= n_points;
}

// mask[m] for m = first, first + stride, ...: the reference's
// reprojection_error (ransacflow_tpu/ops/homography.py:292, z taken as 1 as
// apply_homography does) below tol, on a valid match, when `gate`.
__device__ __forceinline__ void write_mask(const Problem& P, const float* H, bool gate,
                                           unsigned char* mask, int first, int stride) {
  for (int m = first; m < P.N; m += stride) {
    const float x = P.m2[m * 3], y = P.m2[m * 3 + 1];
    const float ex = H[0] * x + H[1] * y + H[2];
    const float ey = H[3] * x + H[4] * y + H[5];
    const float ez = H[6] * x + H[7] * y + H[8];
    const float dx = P.m1[m * 3] - ex / ez;
    const float dy = P.m1[m * 3 + 1] - ey / ez;
    const float err = sqrtf(dx * dx + dy * dy);
    mask[m] = gate && P.valid[m] && err < P.tol;
  }
}

}  // namespace rf_ransac
