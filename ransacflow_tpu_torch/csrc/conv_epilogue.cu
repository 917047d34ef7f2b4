// The epilogue of a frozen trunk convolution, in place on its NCHW output:
//
//   out[n, c, :, :] = relu(conv_out[n, c, :, :] + bias[c] (+ residual[n, c, :, :]))
//
// the sum taken in that order, (x + b) + r, as the plain version takes it.
//
// Replaces no TPU kernel. It was added for the ResNet-50 trunk's inference
// forward (`models/resnet50`), whose eval-mode BatchNorm is folded into the
// convolutions' weights and biases: what is left after each convolution is
// this one pass, where the unfolded forward ran a BatchNorm, a ReLU and an
// add, each reading and writing the whole activation.
//
// What bounds it on the H100: one add (two with the residual) and a compare
// per element against 8 bytes (12 with the residual) moved, so it is bound
// by memory traffic: the output read once and written once, the residual
// read once, at 3.35 TB/s. At the trunk's largest call (layer1's conv3 at a
// 960x1280 image: 256 x 240 x 320 fp32 a picture, with the shortcut) that is
// 236 MB a picture, ~70 us.
//
// Design: each block works on whole channel planes (blockIdx.y, striding by
// gridDim.y past 65,535 planes), so the bias is one scalar a block, read
// once. blockIdx.x cuts a plane into chunks of kThreads x kUnroll float4s;
// each thread issues its kUnroll 16-byte loads (and the residual's) before
// it computes and stores, so a warp keeps several loads in flight. A plane
// of H x W elements starts at a 16-byte boundary only when its offset is a
// multiple of 4: the elements before its first boundary (at most 3) and the
// ragged tail after its last whole float4 (at most 3) are masked scalar
// work of the plane's first block. Where a base pointer is not 16-byte
// aligned, every element is scalar work. No allocation, no sync.
#include "common.cuh"

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxPlanesPerGrid = 65535;

template <bool kResidual>
__device__ __forceinline__ float epilogue(float v, float b, float r) {
  v = v + b;
  if (kResidual) v = v + r;
  return v < 0.f ? 0.f : v;  // NaN passes, as torch.relu's
}

template <bool kResidual, bool kVector>
__global__ void __launch_bounds__(kThreads) conv_epilogue_pass(
    float* __restrict__ x, const float* __restrict__ bias,
    const float* __restrict__ residual, int C, int HW, int planes) {
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const float b = __ldg(bias + plane % C);
    const size_t base = static_cast<size_t>(plane) * HW;
    float* xp = x + base;
    const float* rp = kResidual ? residual + base : nullptr;
    // [0, head) and [tail, HW) are scalar; [head, tail) whole float4s
    int head = HW, n_vec = 0;
    if (kVector) {
      head = static_cast<int>((4 - (base & 3)) & 3);
      if (head > HW) head = HW;
      n_vec = (HW - head) >> 2;
    }
    const int tail = head + 4 * n_vec;
    if (kVector) {
      float4* xv = reinterpret_cast<float4*>(xp + head);
      const float4* rv = kResidual ? reinterpret_cast<const float4*>(rp + head) : nullptr;
      const int first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
      float4 v[kUnroll], r[kUnroll] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = first + u * kThreads;
        if (i < n_vec) {
          v[u] = xv[i];
          if (kResidual) r[u] = __ldg(rv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = first + u * kThreads;
        if (i < n_vec) {
          float4 o;
          o.x = epilogue<kResidual>(v[u].x, b, kResidual ? r[u].x : 0.f);
          o.y = epilogue<kResidual>(v[u].y, b, kResidual ? r[u].y : 0.f);
          o.z = epilogue<kResidual>(v[u].z, b, kResidual ? r[u].z : 0.f);
          o.w = epilogue<kResidual>(v[u].w, b, kResidual ? r[u].w : 0.f);
          xv[i] = o;
        }
      }
    }
    // the scalar elements, s-th of head + (HW - tail), over the plane's blocks
    const int n_scalar = head + (HW - tail);
    for (int s = blockIdx.x * kThreads + threadIdx.x; s < n_scalar;
         s += gridDim.x * kThreads) {
      const int e = s < head ? s : tail + (s - head);
      xp[e] = epilogue<kResidual>(xp[e], b, kResidual ? rp[e] : 0.f);
    }
  }
}

template <bool kResidual>
void launch(float* x, const float* bias, const float* residual, int planes, int C,
            int HW, bool vector, cudaStream_t stream) {
  // a chunk is kThreads x kUnroll float4s, or as many scalars
  const int per_chunk = vector ? kThreads * kUnroll * 4 : kThreads * kUnroll;
  const dim3 grid((HW + per_chunk - 1) / per_chunk,
                  planes < kMaxPlanesPerGrid ? planes : kMaxPlanesPerGrid);
  if (vector) {
    conv_epilogue_pass<kResidual, true>
        <<<grid, kThreads, 0, stream>>>(x, bias, residual, C, HW, planes);
  } else {
    conv_epilogue_pass<kResidual, false>
        <<<grid, kThreads, 0, stream>>>(x, bias, residual, C, HW, planes);
  }
}

}  // namespace

// x: (N, C, H, W) fp32, contiguous NCHW, written in place; bias: (C,) fp32;
// residual: null, or (N, C, H, W) fp32 contiguous NCHW. planes = N * C,
// HW = H * W, both > 0.
RF_API int rf_conv_epilogue(float* x, const float* bias, const float* residual,
                            int planes, int C, int HW, cudaStream_t stream) {
  const bool vector =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(residual)) % 16 == 0;
  if (residual != nullptr) {
    launch<true>(x, bias, residual, planes, C, HW, vector, stream);
  } else {
    launch<false>(x, bias, residual, planes, C, HW, vector, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
