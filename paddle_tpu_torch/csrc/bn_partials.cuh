// Shared pieces of the batch-norm kernels (fused_bn.cu, fused_conv.cu):
// element conversions, vector packs, and the fixed-order reduction of
// per-chunk column partials that replaces the TPU kernels' sequential-grid
// accumulators.
//
// A TPU kernel sums a [M, C] activation's columns by carrying the sums in
// its output block across the grid's steps, which run in order on one
// core.  On the H100 blocks run in parallel and in no order, so each block
// writes the sums of its own rows to a [chunks, C] partials buffer and
// reduce_partials_kernel adds the chunks in a fixed order: no float
// atomics, and two runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// N contiguous elements read or written as one vector access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

constexpr int kRedX = 32;  // channels per block of the partials reduction
constexpr int kRedY = 32;  // chunk lanes per block

// out0[c] = sum_k p0[k, c], out1[c] = sum_k p1[k, c] over k < chunks, in a
// fixed order (lane ry takes chunks ry, ry + 32, ...; the 32 lanes are
// then added in order).  With moments, the sums are Σx and Σx² of m rows and
// the outputs are the batch moments as fused_bn.py:93-94 computes them:
//   mean = s / m,  var = max(q / m - mean², 0)
// with every operation rounded on its own (no fused multiply-add), as the
// plain version's separate tensor ops round.
__global__ void reduce_partials_kernel(const float* __restrict__ p0,
                                       const float* __restrict__ p1,
                                       float* __restrict__ out0,
                                       float* __restrict__ out1, int chunks,
                                       int C, int moments, float m) {
  __shared__ float s0[kRedY][kRedX];
  __shared__ float s1[kRedY][kRedX];
  const int cx = threadIdx.x, ry = threadIdx.y;
  const int c = blockIdx.x * kRedX + cx;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int k = ry; k < chunks; k += kRedY) {
      a += p0[static_cast<size_t>(k) * C + c];
      b += p1[static_cast<size_t>(k) * C + c];
    }
  }
  s0[ry][cx] = a;
  s1[ry][cx] = b;
  __syncthreads();
  if (ry != 0 || c >= C) return;
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int y = 0; y < kRedY; ++y) {
    a += s0[y][cx];
    b += s1[y][cx];
  }
  if (moments) {
    const float mean = __fdiv_rn(a, m);
    const float ex2 = __fdiv_rn(b, m);
    out0[c] = mean;
    out1[c] = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
  } else {
    out0[c] = a;
    out1[c] = b;
  }
}

inline cudaError_t reduce_partials(const float* p0, const float* p1,
                                   float* out0, float* out1, int chunks,
                                   int C, bool moments, long long m,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<dim3((C + kRedX - 1) / kRedX), dim3(kRedX, kRedY),
                           0, stream>>>(p0, p1, out0, out1, chunks, C,
                                        moments ? 1 : 0,
                                        static_cast<float>(m));
  return cudaGetLastError();
}

}  // namespace bn
