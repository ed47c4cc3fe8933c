// NHWC convolution with fused output statistics for Hopper (sm_90a).
//
// Replaces the TPU kernel B7 of paddle_tpu/ops/pallas/fused_conv.py:
// `_conv_stats_kernel`, called by `_conv_stats` (pallas_call :176): the
// conv of a [N, H, W, Cin] activation with an OIHW weight (taps up to 5x5,
// stride 1 or 2, symmetric zero padding), f32 accumulation, the output
// stored once in x's dtype, and the per-channel Σy and Σy² taken from the
// unrounded f32 accumulator before the store, so the batch statistics cost
// no second read of the output.
//
// The conv is an implicit GEMM: rows M = N·Ho·Wo (output pixels, in NHWC
// order, so the output is written as the channels-last tensor the next
// layer reads), columns Cout, reduction K = kh·kw·Cin.  The weight is
// re-laid out once per call by the wrapper as [kh, kw, Cin, Cout] (small).
//
// What bounds it on an H100: operations.  At the ResNet-50 stage-1 3x3
// conv (batch 256, 56x56x64 -> 64) it does 59 GFLOP on 206 MB: 60 us on the
// bf16 tensor cores, 3.4x its 18 us of memory time.  This first kernel does
// its products as f32 FMAs (67 TFLOP/s peak), so it sits an order of
// magnitude above that bound; bf16 mma/wgmma tiles are later work.
//
// What the design does:
//   * one block of 256 threads per [BM = 128, BN = 64] output tile; each
//     thread accumulates an 8x4 sub-tile in f32 registers;
//   * the K loop walks the taps and, within a tap, Cin in chunks of BK =
//     16: each block stages the shifted input rows of the chunk (stride and
//     padding by address arithmetic, zero outside the image, past M and
//     past Cin) and the weight slice in shared memory, as f32, double
//     buffered: the next chunk's global loads are in flight while the
//     current one is multiplied;
//   * loads are 16 bytes wide where Cin (input) or Cout (weight, output)
//     allow it; other widths (the s2d stem's Cin = 12) load element by
//     element;
//   * the epilogue stores y in x's dtype and writes the tile's per-channel
//     Σy and Σy² (rows past M are exact zeros) to a [tiles, Cout] partials
//     buffer, added in a fixed order by bn_partials.cuh: no atomics, the
//     same bits every run.
//
// Interface: plain C, loaded with ctypes.  The caller allocates every
// buffer (partials: conv_tiles(M) rows of Cout f32 each); the launch runs
// on the given stream and returns cudaGetLastError().  dtype codes: 0 f32,
// 1 bf16 (x, w and y share it).

#include "bn_partials.cuh"

namespace {

using bn::from_f32;
using bn::Pack;
using bn::to_f32;

constexpr int BM = 128;  // output pixels per tile
constexpr int BN = 64;   // output channels per tile
constexpr int BK = 16;   // input channels per K step
constexpr int kThreads = 256;

struct Shape {
  int H, W, Cin, Cout, KW, stride, pad, Ho, Wo;
  long long M;
  int cchunks;  // ceil(Cin / BK)
  int ksteps;   // kh * kw * cchunks
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// VA: Cin is a multiple of the 16-byte vector width and x is aligned;
// VB: Cout is a multiple of 4 and w and y are aligned.
template <typename T, bool VA, bool VB>
__global__ void __launch_bounds__(kThreads, 2)
conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ y, float* __restrict__ psum,
                  float* __restrict__ psq, const Shape s) {
  constexpr int AV = 16 / sizeof(T);  // elements of one 16-byte load
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // compute: columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // compute: rows ty*8 .. ty*8+7
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // load role for the input: one tile row, 8 consecutive channels
  const int ar = tid >> 1;
  const int ah = (tid & 1) * 8;
  const long long am = m0 + ar;
  const bool arow = am < s.M;
  long long aimg = 0;
  int aih0 = 0, aiw0 = 0;
  if (arow) {
    const long long hw = static_cast<long long>(s.Ho) * s.Wo;
    const long long n = am / hw;
    const int rem = static_cast<int>(am - n * hw);
    aih0 = (rem / s.Wo) * s.stride - s.pad;
    aiw0 = (rem % s.Wo) * s.stride - s.pad;
    aimg = n * s.H * s.W;
  }
  // load role for the weight: one K row, 4 consecutive output channels
  const int bk = tid >> 4;
  const int bc = (tid & 15) * 4;
  const int bcol = n0 + bc;

  float ra[8], rb[4];

  auto load = [&](int t) {
    const int tap = t / s.cchunks;
    const int cin0 = (t - tap * s.cchunks) * BK;
    const int u = tap / s.KW, v = tap - u * s.KW;
    const int ih = aih0 + u, iw = aiw0 + v;
    const bool ok = arow && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
    const int c = cin0 + ah;
    const long long off =
        ok ? ((aimg + static_cast<long long>(ih) * s.W + iw) * s.Cin + c)
           : 0;
    if (VA) {
#pragma unroll
      for (int p = 0; p < 8 / AV; ++p) {
        if (ok && c + p * AV < s.Cin) {
          const Pack<T, AV> pk =
              *reinterpret_cast<const Pack<T, AV>*>(x + off + p * AV);
#pragma unroll
          for (int e = 0; e < AV; ++e) ra[p * AV + e] = to_f32(pk.v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < AV; ++e) ra[p * AV + e] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ra[e] = (ok && c + e < s.Cin) ? to_f32(x[off + e]) : 0.f;
    }
    const int kr = cin0 + bk;
    const long long boff =
        (static_cast<long long>(tap) * s.Cin + kr) * s.Cout + bcol;
    if (VB) {
      if (kr < s.Cin && bcol < s.Cout) {
        const Pack<T, 4> pk = *reinterpret_cast<const Pack<T, 4>*>(w + boff);
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = to_f32(pk.v[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) rb[j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rb[j] = (kr < s.Cin && bcol + j < s.Cout) ? to_f32(w[boff + j]) : 0.f;
    }
  };

  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 8; ++e) As[buf][ah + e][ar] = ra[e];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < s.ksteps; ++t) {
    const int cur = t & 1;
    if (t + 1 < s.ksteps) load(t + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * 8 + 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < s.ksteps) stash(cur ^ 1);
    __syncthreads();
  }

  // y, in x's dtype, rows of the NHWC output
  const int col = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= s.M) continue;
    T* dst = y + m * s.Cout + col;
    if (VB) {
      if (col < s.Cout) {
        Pack<T, 4> pk;
#pragma unroll
        for (int j = 0; j < 4; ++j) pk.v[j] = from_f32<T>(acc[i][j]);
        *reinterpret_cast<Pack<T, 4>*>(dst) = pk;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < s.Cout) dst[j] = from_f32<T>(acc[i][j]);
    }
  }

  // per-channel Σy, Σy² of the tile from the f32 accumulator; the shared
  // tiles are free (the K loop ended on a barrier)
  float(*red_s)[BN] = reinterpret_cast<float(*)[BN]>(&As[0][0][0]);
  float(*red_q)[BN] = reinterpret_cast<float(*)[BN]>(&As[1][0][0]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float cs = 0.f, cq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cs += acc[i][j];
      cq += acc[i][j] * acc[i][j];
    }
    red_s[ty][tx * 4 + j] = cs;
    red_q[ty][tx * 4 + j] = cq;
  }
  __syncthreads();
  if (tid < BN && n0 + tid < s.Cout) {
    float cs = 0.f, cq = 0.f;
#pragma unroll
    for (int r = 0; r < kThreads / 16; ++r) {
      cs += red_s[r][tid];
      cq += red_q[r][tid];
    }
    const size_t o = static_cast<size_t>(blockIdx.x) * s.Cout + n0 + tid;
    psum[o] = cs;
    psq[o] = cq;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, float* psum,
                   float* psq, float* mean, float* var, const Shape& s,
                   cudaStream_t st) {
  const bool va = s.Cin % (16 / sizeof(T)) == 0 && aligned16(x);
  const bool vb = s.Cout % 4 == 0 && aligned16(w) && aligned16(y);
  const int tiles = static_cast<int>((s.M + BM - 1) / BM);
  const dim3 grid(tiles, (s.Cout + BN - 1) / BN);
  auto xp = static_cast<const T*>(x);
  auto wp = static_cast<const T*>(w);
  auto yp = static_cast<T*>(y);
  if (va && vb)
    conv_stats_kernel<T, true, true><<<grid, kThreads, 0, st>>>(xp, wp, yp,
                                                                psum, psq, s);
  else if (va)
    conv_stats_kernel<T, true, false><<<grid, kThreads, 0, st>>>(
        xp, wp, yp, psum, psq, s);
  else if (vb)
    conv_stats_kernel<T, false, true><<<grid, kThreads, 0, st>>>(
        xp, wp, yp, psum, psq, s);
  else
    conv_stats_kernel<T, false, false><<<grid, kThreads, 0, st>>>(
        xp, wp, yp, psum, psq, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bn::reduce_partials(psum, psq, mean, var, tiles, s.Cout, true, s.M,
                             st);
}

}  // namespace

// Rows of the partials buffers for M output pixels.
extern "C" int conv_tiles(long long M) {
  return static_cast<int>((M + BM - 1) / BM);
}

// dims: N, H, W, Cin, Cout, kh, kw, stride, pad, Ho, Wo.  x [N, H, W, Cin],
// w [kh, kw, Cin, Cout], y [N, Ho, Wo, Cout]; psum, psq [conv_tiles(M),
// Cout]; mean, var [Cout], all f32.
extern "C" int conv_stats_launch(const void* x, const void* w, void* y,
                                 void* psum, void* psq, void* mean, void* var,
                                 const long long* dims, int dtype,
                                 void* stream) {
  const long long N = dims[0];
  Shape s;
  s.H = static_cast<int>(dims[1]);
  s.W = static_cast<int>(dims[2]);
  s.Cin = static_cast<int>(dims[3]);
  s.Cout = static_cast<int>(dims[4]);
  const int KH = static_cast<int>(dims[5]);
  s.KW = static_cast<int>(dims[6]);
  s.stride = static_cast<int>(dims[7]);
  s.pad = static_cast<int>(dims[8]);
  s.Ho = static_cast<int>(dims[9]);
  s.Wo = static_cast<int>(dims[10]);
  if (N <= 0 || s.H <= 0 || s.W <= 0 || s.Cin <= 0 || s.Cout <= 0 ||
      KH <= 0 || s.KW <= 0 || s.stride <= 0 || s.pad < 0 || s.Ho <= 0 ||
      s.Wo <= 0 ||
      s.Ho != (s.H + 2 * s.pad - KH) / s.stride + 1 ||
      s.Wo != (s.W + 2 * s.pad - s.KW) / s.stride + 1)
    return cudaErrorInvalidValue;
  s.M = N * s.Ho * s.Wo;
  s.cchunks = (s.Cin + BK - 1) / BK;
  s.ksteps = KH * s.KW * s.cchunks;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  switch (dtype) {
    case 0:
      return launch<float>(x, w, y, f(psum), f(psq), f(mean), f(var), s, st);
    case 1:
      return launch<__nv_bfloat16>(x, w, y, f(psum), f(psq), f(mean), f(var),
                                   s, st);
    default: return cudaErrorInvalidValue;
  }
}
