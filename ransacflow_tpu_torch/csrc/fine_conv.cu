// A frozen convolution of the fine networks as one implicit GEMM in fp32,
// with its epilogue:
//
//   y[m, n] = relu((sum_k A[m, k] * Wp[k, n] + bias[n]) (+ residual[m, n]))
//
// on NHWC activations: m = (b, ho, wo) the output pixel (M = B * Ho * Wo),
// n the output channel (N = Cout), k = (r * S + s) * Cin + c the filter tap
// and input channel (K = R * S * Cin), A[m, k] = x[b, ho * stride - pad + r,
// wo * stride - pad + s, c] or 0 outside the image. Without a bias the
// epilogue is a plain store (the heads' conv4, the blur-pooled 1x1
// downsample, whose bias joins its block's second convolution).
//
// Replaces no TPU kernel. It was added for the fine feature extractor and
// the flow and matchability heads in inference (`models/feature_extractor`,
// `models/heads`), whose eval-mode BatchNorm is folded into the weights
// (`models/layers.FrozenBNFold`); the weights are packed once, at fold
// time, as Wp (K, Npad): k-major rows of the output channels, Npad = Cout
// rounded up to 4 with zero columns (`kernels/fine_conv.pack_conv`).
//
// What bounds it on the H100: the operations. A fine pass of one 480x640
// pair is 178 GFLOP against ~1.2 GB of activations, weights and outputs, so
// the floor is fp32 FMA at 67 TFLOP/s (no tensor cores: the port computes in
// fp32, TF32 off). The design keeps the FMA pipes fed:
// - a block computes a BM x BN tile of y (128 x 128 with 8 warps, or
//   128 x 64 with 4); each thread keeps an 8 x 8 tile of accumulators in
//   registers (rows tm + 4i of its warp's 32, columns tn * 4 + j and
//   32 + tn * 4 + j of its warp's 64), so four k cost a thread 16
//   shared-memory loads (eight 16-byte A reads, 4 k of a row each, and two
//   16-byte B reads for each k) for its 256 FMAs;
// - the operands reach shared memory through a ring of stages of kBK k
//   (3 of 32 for the wide tile, 3 of 16 for the narrow: `Tile`), filled by
//   cp.async ahead of the compute (zero-filled where the tap falls in the
//   padding, past M, K or Npad). A lands pixel-major (16-byte runs of
//   channels where Cin is a multiple of kBK, one filter tap a stage; else
//   element by element, the taps decoded per element), its rows padded to
//   kBK + 4 floats: the 4 distinct rows a warp reads at once fall in
//   distinct banks; a B row is a contiguous run, read as 8 distinct 16-byte
//   words a warp (the rest broadcast);
// - split-K over gridDim.z where the tiles alone would leave SMs idle (a
//   pair at 60x80 is 38 tile rows): each split writes its partial tile to a
//   workspace, the last split of a tile to arrive (a counter a tile, which
//   that block sets back to 0) sums the partials in split order, so the
//   result does not depend on the order the blocks ran in, and applies the
//   epilogue. Tile shape and split count are chosen by the wrapper from the
//   shape alone (`kernels/fine_conv.plan`);
// - the epilogue reads the bias (and the residual) and stores with 16-byte
//   accesses where Cout is a multiple of 4 and every pointer is 16-byte
//   aligned, else element by element.
// The sums are fp32 FMAs, k in order within a split. No allocation, no sync.
#include "common.cuh"

#include <stdint.h>

namespace {

// A tile config's k depth of a stage, its ring's stages and the blocks an SM
// is to hold at once (the register budget), by its width in warps: the wide
// tile holds 2 blocks of 8 warps at 128 registers a thread; the narrow one
// 2-3 blocks of 4 warps, whose threads may take more registers. (H100,
// timed against each other at the fine stage's calls: kBK 32 in 3 stages
// is ~4% faster for the wide tile than 16 in 4, slower for the narrow one,
// which the register room makes ~8% faster; 3 stages of 16 beat 4 and 6
// there by ~1%.)
template <int kWarpsN>
struct Tile;
template <>
struct Tile<2> {  // 128 x 128
  static constexpr int kBK = 32, kStages = 3, kMinBlocks = 2;
};
template <>
struct Tile<1> {  // 128 x 64
  static constexpr int kBK = 16, kStages = 3, kMinBlocks = 2;
};
constexpr int kMaxDevices = 64;
constexpr int kRowOff = -(1 << 28);  // an input row that falls outside any image

struct Conv {
  const float* x;     // (B, H, W, C) NHWC
  const float* w;     // (K, Npad)
  const float* bias;  // (N) or null
  const float* res;   // (B, Ho, Wo, N) or null
  float* y;           // (B, Ho, Wo, N)
  float* ws;          // split partials, (tiles, splits, BM * BN)
  int* sem;           // one counter a tile, 0 between launches
  int H, W, C, Ho, Wo, N, Npad, S, stride, pad, K, M;
  int kt_total, kt_per_split, c_tiles, vec_store;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// epi 0: a plain store, 1: bias + ReLU, 2: bias + residual + ReLU
__device__ __forceinline__ float epilogue(float v, float b, float r, int epi) {
  if (epi == 0) return v;
  v = v + b;
  if (epi == 2) v = v + r;
  return v < 0.f ? 0.f : v;  // NaN passes, as torch.relu's
}

// The output pixel m's image's first input pixel and the input coordinates
// of its tap (0, 0); a row past M gets coordinates outside any image.
__device__ __forceinline__ void decode(const Conv& p, int m, int& nhw, int& ih0, int& iw0) {
  if (m < p.M) {
    const int hw_out = p.Ho * p.Wo;
    const int b = m / hw_out, rem = m - b * hw_out;
    const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
    nhw = b * p.H * p.W;
    ih0 = ho * p.stride - p.pad;
    iw0 = wo * p.stride - p.pad;
  } else {
    nhw = 0;
    ih0 = kRowOff;
    iw0 = kRowOff;
  }
}

// Stage kt's A (BM x kBK, pixel-major, pitch kBKP) and B (kBK x BN) tiles,
// by cp.async, zero-filled outside the image and past M, K and Npad. The A
// rows' pixels come decoded from shared memory (s_nhw, s_ih0, s_iw0).
template <int kWarpsM, int kWarpsN, bool kVecA>
__device__ __forceinline__ void load_stage(const Conv& p, float* As, float* Bs, int kt, int n0,
                                           const int* s_nhw, const int* s_ih0,
                                           const int* s_iw0) {
  constexpr int BN = 64 * kWarpsN, NT = 32 * kWarpsM * kWarpsN;
  constexpr int kBK = Tile<kWarpsN>::kBK, kBKP = kBK + 4;
  constexpr int kVecRowsA = 32 * kWarpsM * kBK / 4 / NT;  // 16-byte A runs a thread
  constexpr int kScalarA = 32 * kWarpsM * kBK / NT;       // A elements a thread
  constexpr int kVecB = kBK * BN / 4 / NT;                // 16-byte B runs a thread
  const int tid = threadIdx.x;
  const int k0 = kt * kBK;
  if (kVecA) {
    // one filter tap a stage: kBK channels from c0, 16 bytes a thread and row
    const int rs = kt / p.c_tiles;
    const int c0 = (kt - rs * p.c_tiles) * kBK + (tid % (kBK / 4)) * 4;
    const int r = rs / p.S, s = rs - r * p.S;
#pragma unroll
    for (int j = 0; j < kVecRowsA; ++j) {
      const int row = tid / (kBK / 4) + (NT / (kBK / 4)) * j;
      const int ih = s_ih0[row] + r, iw = s_iw0[row] + s;
      const bool ok = static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
      const float* src =
          ok ? p.x + static_cast<int64_t>(s_nhw[row] + ih * p.W + iw) * p.C + c0 : p.x;
      cp_async16(As + row * kBKP + (tid % (kBK / 4)) * 4, src, ok);
    }
  } else {
    // element by element: this thread's column kk of the stage, its tap
    // decoded once
    const int kk = tid % kBK;
    const int k = k0 + kk;
    const bool kok = k < p.K;
    int r = 0, s = 0, c = 0;
    if (kok) {
      const int sc = p.S * p.C;
      r = k / sc;
      const int rem = k - r * sc;
      s = rem / p.C;
      c = rem - s * p.C;
    }
#pragma unroll 4
    for (int j = 0; j < kScalarA; ++j) {
      const int row = tid / kBK + (NT / kBK) * j;
      const int ih = s_ih0[row] + r, iw = s_iw0[row] + s;
      const bool ok = kok && static_cast<unsigned>(ih) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(iw) < static_cast<unsigned>(p.W);
      const float* src =
          ok ? p.x + static_cast<int64_t>(s_nhw[row] + ih * p.W + iw) * p.C + c : p.x;
      cp_async4(As + row * kBKP + kk, src, ok);
    }
  }
#pragma unroll
  for (int j = 0; j < kVecB; ++j) {
    const int idx = tid + NT * j;
    const int kr = idx / (BN / 4), col = (idx % (BN / 4)) * 4;
    const bool ok = k0 + kr < p.K && n0 + col < p.Npad;
    const float* src = ok ? p.w + static_cast<int64_t>(k0 + kr) * p.Npad + n0 + col : p.w;
    cp_async16(Bs + kr * BN + col, src, ok);
  }
}

template <int kWarpsM, int kWarpsN, bool kVecA>
__global__ void __launch_bounds__(32 * kWarpsM * kWarpsN, Tile<kWarpsN>::kMinBlocks)
    fine_conv_kernel(const Conv p) {
  constexpr int BM = 32 * kWarpsM, BN = 64 * kWarpsN, NT = 32 * kWarpsM * kWarpsN;
  constexpr int kBK = Tile<kWarpsN>::kBK, kBKP = kBK + 4, kStages = Tile<kWarpsN>::kStages;
  constexpr int kStageA = BM * kBKP, kStageB = kBK * BN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sA = smem;
  float* sB = smem + kStages * kStageA;
  int* s_nhw = reinterpret_cast<int*>(sB + kStages * kStageB);  // the A rows' pixels
  int* s_ih0 = s_nhw + BM;
  int* s_iw0 = s_ih0 + BM;
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt_begin = blockIdx.z * p.kt_per_split;
  const int kt_end = min(p.kt_total, kt_begin + p.kt_per_split);
  const int nkt = kt_end - kt_begin;
  for (int row = tid; row < BM; row += NT) decode(p, m0 + row, s_nhw[row], s_ih0[row], s_iw0[row]);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int tm = lane >> 3, tn = lane & 7;
  const int a_row0 = (warp % kWarpsM) * 32 + tm;
  const int b_col0 = (warp / kWarpsM) * 64 + tn * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nkt)
      load_stage<kWarpsM, kWarpsN, kVecA>(p, sA + st * kStageA, sB + st * kStageB,
                                          kt_begin + st, n0, s_nhw, s_ih0, s_iw0);
    cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it is in; every thread is done with stage it - 1
    const int next = it + kStages - 1;
    if (next < nkt)
      load_stage<kWarpsM, kWarpsN, kVecA>(p, sA + (next % kStages) * kStageA,
                                          sB + (next % kStages) * kStageB, kt_begin + next,
                                          n0, s_nhw, s_ih0, s_iw0);
    cp_async_commit();

    const float* As = sA + (it % kStages) * kStageA + a_row0 * kBKP;
    const float* Bs = sB + (it % kStages) * kStageB + b_col0;
#pragma unroll
    for (int kq = 0; kq < kBK / 4; ++kq) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + 4 * i * kBKP + kq * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + (kq * 4 + q) * BN);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + (kq * 4 + q) * BN + 32);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.z > 1) {
    // this split's partial tile, [16 float4 words][NT threads]
    const int tile = blockIdx.x + gridDim.x * blockIdx.y;
    float4* part = reinterpret_cast<float4*>(p.ws) +
                   (static_cast<int64_t>(tile) * gridDim.z + blockIdx.z) * (BM * BN / 4);
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const float* a = &acc[v >> 1][(v & 1) * 4];
      part[v * NT + tid] = make_float4(a[0], a[1], a[2], a[3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(p.sem + tile, 1) == static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const float4* parts = reinterpret_cast<const float4*>(p.ws) +
                          static_cast<int64_t>(tile) * gridDim.z * (BM * BN / 4);
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      float4 sum = __ldcg(parts + v * NT + tid);
      for (int z = 1; z < static_cast<int>(gridDim.z); ++z) {
        const float4 t = __ldcg(parts + static_cast<int64_t>(z) * (BM * BN / 4) + v * NT + tid);
        sum.x += t.x;
        sum.y += t.y;
        sum.z += t.z;
        sum.w += t.w;
      }
      float* a = &acc[v >> 1][(v & 1) * 4];
      a[0] = sum.x;
      a[1] = sum.y;
      a[2] = sum.z;
      a[3] = sum.w;
    }
    if (tid == 0) p.sem[tile] = 0;  // for the next launch on this stream
  }

  const int epi = p.bias == nullptr ? 0 : p.res == nullptr ? 1 : 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + a_row0 + 4 * i;
    if (m >= p.M) continue;
    float* yrow = p.y + static_cast<int64_t>(m) * p.N;
    const float* rrow = epi == 2 ? p.res + static_cast<int64_t>(m) * p.N : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + b_col0 + 32 * h;
      const float* v = &acc[i][4 * h];
      if (p.vec_store) {
        if (n >= p.N) continue;
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f), r = b;
        if (epi != 0) b = __ldg(reinterpret_cast<const float4*>(p.bias + n));
        if (epi == 2) r = __ldg(reinterpret_cast<const float4*>(rrow + n));
        float4 o;
        o.x = epilogue(v[0], b.x, r.x, epi);
        o.y = epilogue(v[1], b.y, r.y, epi);
        o.z = epilogue(v[2], b.z, r.z, epi);
        o.w = epilogue(v[3], b.w, r.w, epi);
        *reinterpret_cast<float4*>(yrow + n) = o;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n + e >= p.N) break;
          const float b = epi != 0 ? __ldg(p.bias + n + e) : 0.f;
          const float r = epi == 2 ? __ldg(rrow + n + e) : 0.f;
          yrow[n + e] = epilogue(v[e], b, r, epi);
        }
      }
    }
  }
}

template <int kWarpsM, int kWarpsN>
constexpr int smem_bytes() {
  using T = Tile<kWarpsN>;
  return (T::kStages * (32 * kWarpsM * (T::kBK + 4) + T::kBK * 64 * kWarpsN) + 3 * 32 * kWarpsM) *
         static_cast<int>(sizeof(float));
}

// Dynamic shared memory past 48 KB needs the function's attribute, once a
// device.
template <int kWarpsM, int kWarpsN, bool kVecA>
cudaError_t prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fine_conv_kernel<kWarpsM, kWarpsN, kVecA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<kWarpsM, kWarpsN>());
  if (err == cudaSuccess && dev < kMaxDevices) ready[dev] = true;
  return err;
}

template <int kWarpsM, int kWarpsN, bool kVecA>
cudaError_t launch(const Conv& p, int splits, cudaStream_t stream) {
  cudaError_t err = prepare<kWarpsM, kWarpsN, kVecA>();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + 32 * kWarpsM - 1) / (32 * kWarpsM),
                  (p.N + 64 * kWarpsN - 1) / (64 * kWarpsN), splits);
  fine_conv_kernel<kWarpsM, kWarpsN, kVecA>
      <<<grid, 32 * kWarpsM * kWarpsN, smem_bytes<kWarpsM, kWarpsN>(), stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The k tiling of the config, then the launch.
template <int kWarpsM, int kWarpsN>
cudaError_t launch_cfg(Conv p, int kt_per_split, cudaStream_t stream) {
  constexpr int kBK = Tile<kWarpsN>::kBK;
  p.kt_total = (p.K + kBK - 1) / kBK;
  p.kt_per_split = kt_per_split;
  p.c_tiles = p.C / kBK;
  const int splits = (p.kt_total + kt_per_split - 1) / kt_per_split;
  if (splits > 1 && (p.ws == nullptr || p.sem == nullptr)) return cudaErrorInvalidValue;
  return p.C % kBK == 0 && aligned16(p.x) ? launch<kWarpsM, kWarpsN, true>(p, splits, stream)
                                          : launch<kWarpsM, kWarpsN, false>(p, splits, stream);
}

}  // namespace

// Blocks of a tile config (0: 128 x 128, 1: 128 x 64) that fit on one SM at
// once, or a negative CUDA error.
RF_API int rf_fine_conv_occupancy(int cfg) {
  int blocks = 0;
  cudaError_t err;
  if (cfg == 0) {
    err = prepare<4, 2, true>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fine_conv_kernel<4, 2, true>, 256, smem_bytes<4, 2>());
  } else {
    err = prepare<4, 1, true>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fine_conv_kernel<4, 1, true>, 128, smem_bytes<4, 1>());
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// x: (B, H, W, C) fp32 NHWC contiguous; w: (R * S * C, Npad) fp32, Npad a
// multiple of 4 and >= N, 16-byte aligned; bias: (N) or null (then no
// epilogue); res: (B, Ho, Wo, N) or null (needs a bias); y: (B, Ho, Wo, N).
// cfg: 0 for 128 x 128 tiles, 1 for 128 x 64. kt_per_split: the config's k
// tiles (Tile<>::kBK) a split; with more than one split, ws holds tiles x
// splits x BM x BN floats and sem one int a tile, all 0.
RF_API int rf_fine_conv(const float* x, const float* w, const float* bias, const float* res,
                        float* y, float* ws, int* sem, int B, int H, int W, int C, int Ho,
                        int Wo, int N, int Npad, int R, int S, int stride, int pad, int cfg,
                        int kt_per_split, cudaStream_t stream) {
  if ((res != nullptr && bias == nullptr) || Npad % 4 != 0 || Npad < N || !aligned16(w) ||
      kt_per_split <= 0 || R <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Conv p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.res = res;
  p.y = y;
  p.ws = ws;
  p.sem = sem;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = Ho;
  p.Wo = Wo;
  p.N = N;
  p.Npad = Npad;
  p.S = S;
  p.stride = stride;
  p.pad = pad;
  p.K = R * S * C;
  p.M = B * Ho * Wo;
  p.vec_store = N % 4 == 0 && aligned16(y) && (bias == nullptr || aligned16(bias)) &&
                (res == nullptr || aligned16(res));
  const cudaError_t err = cfg == 0 ? launch_cfg<4, 2>(p, kt_per_split, stream)
                                   : launch_cfg<4, 1>(p, kt_per_split, stream);
  return static_cast<int>(err);
}
