// Flash-decoding for Hopper (sm_90a): single-query attention over the KV
// ring cache, split along the cached context, in a plain variant (f32 or
// bf16 K/V) and an int8-KV variant.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_decode.py:
//   * `_decode_kernel`, called by `flash_decode_fn` (pallas_call :118);
//   * `_decode_kernel_quant`, called by `flash_decode_quant_fn` (:217);
//   * the split merge that follows both (:147-156), plain XLA there, is
//     the second kernel of this file.
//
// What bounds it on an H100: memory.  One decode step reads the whole
// cache once, 2*B*N*S*H*elt bytes of K and V (plus 2*B*N*S*4 bytes of
// scales for int8) against 4*B*N*S*H operations: under one operation per
// byte, far below the ~295 op/byte where the tensor cores would become the
// limit.  At the served shape (B=8, N=12, S=256, H=64) that is 6.29 MB in
// bf16 (1.9 us at 3.35 TB/s) and 3.34 MB in int8 (1.0 us).
//
// What the design does about it:
//   * one CUDA block per (sequence*head, split of kBlockK = 64 cached
//     columns), so a single query row still spreads over B*N*ceil(S/64)
//     blocks (384 at the served shape) and keeps enough loads in flight.
//     The TPU kernel takes 512 columns per block (VMEM holds large
//     blocks); on the H100 the grid must fill 132 SMs instead.  Any S is
//     taken: the last split masks its columns past S;
//   * each warp walks whole cache rows, each lane loading H/32 contiguous
//     elements in one vector load, so a warp reads a row as one coalesced
//     transaction and the dot product is one warp reduction;
//   * columns outside the row's [start, end) window are never loaded: a
//     short prompt early in decoding reads only the live part of the ring;
//   * int8 rows are dequantized in registers as they are loaded, so the
//     cache streams at one byte per element.
// Tensor cores (wgmma) and TMA would not move a bound of bytes; they are
// left to a later pass with the rest of the tuning.
//
// Numerics follow the TPU kernel: scores and the running max, normalizer
// and accumulator in f32; columns outside the window masked with the
// finite -1e30 and their probabilities zeroed explicitly (a split with no
// valid column has m = -1e30, where exp(s - m) = 1 would fake a live
// normalizer); in the plain kernel p is rounded to V's dtype before the
// PV product (flash_decode.py:85); the int8 kernel stays in f32
// throughout (:167-179).  The merge guards l_tot == 0 (:154).
//
// Interface: plain C, loaded with ctypes.  The caller allocates every
// buffer; each function launches on the given stream and returns
// cudaGetLastError() (0 on success).  The softmax scale is 1/sqrt(H), as
// every caller of the TPU kernel uses it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;      // cached columns per split
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// One (sequence*head, split) cell: partial attention of the row's query
// over columns [split*kBlockK, (split+1)*kBlockK) of its cache, masked to
// the batch row's [start, end) window clipped to [0, S).  Writes the
// unnormalized accumulator o_part[row, split, :], the split's max
// m_part[row, split] and its normalizer l_part[row, split].  With QUANT the cache holds int8 rows
// and k_scale/v_scale the per-(token, head) f32 scales.
template <typename TQ, typename TKV, int H, bool QUANT>
__global__ void __launch_bounds__(kThreads, 4)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ start,
                    const int* __restrict__ end,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int heads, int S) {
  constexpr int EPL = H / 32;  // elements of one row per lane
  const float scale = 1.f / sqrtf(static_cast<float>(H));
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = row / heads;  // the window is per batch row, all heads
  const int lo = max(start[b], 0);
  const int hi = min(end[b], S);  // the last split's columns past S
  const int col0 = split * kBlockK;

  __shared__ float p_s[kBlockK];
  __shared__ float red[kWarps];
  __shared__ float acc_s[kWarps][H];

  float qv[EPL];
  {
    const Pack<TQ, EPL> pq = *reinterpret_cast<const Pack<TQ, EPL>*>(
        q + static_cast<size_t>(row) * H + lane * EPL);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[e] = to_f32(pq.v[e]);
  }
  const size_t row_base = static_cast<size_t>(row) * S;
  const size_t elt0 = (row_base + col0) * H + lane * EPL;

  // scores: one warp per cached row, skipped outside the window
  for (int j = warp; j < kBlockK; j += kWarps) {
    const int col = col0 + j;
    float s = kNegInf;
    if (col >= lo && col < hi) {
      const Pack<TKV, EPL> pk = *reinterpret_cast<const Pack<TKV, EPL>*>(
          k + elt0 + static_cast<size_t>(j) * H);
      const float ks = QUANT ? k_scale[row_base + col] : 1.f;
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float kf = to_f32(pk.v[e]);
        if constexpr (QUANT) kf *= ks;
        d += qv[e] * kf;
      }
      s = warp_sum(d) * scale;
    }
    if (lane == 0) p_s[j] = s;
  }
  __syncthreads();

  float m = kNegInf;
  for (int j = threadIdx.x; j < kBlockK; j += kThreads)
    m = fmaxf(m, p_s[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused for the normalizer

  float l = 0.f;
  for (int j = threadIdx.x; j < kBlockK; j += kThreads) {
    const int col = col0 + j;
    const float p = (col >= lo && col < hi) ? expf(p_s[j] - m) : 0.f;
    p_s[j] = p;
    l += p;
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += red[w];

  // accumulator p @ V, rows split over warps exactly as for the scores
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int j = warp; j < kBlockK; j += kWarps) {
    const int col = col0 + j;
    if (col < lo || col >= hi) continue;
    float p = p_s[j];
    if constexpr (!QUANT) p = to_f32(from_f32<TKV>(p));
    const Pack<TKV, EPL> pv = *reinterpret_cast<const Pack<TKV, EPL>*>(
        v + elt0 + static_cast<size_t>(j) * H);
    const float vs = QUANT ? v_scale[row_base + col] : 1.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float vf = to_f32(pv.v[e]);
      if constexpr (QUANT) vf *= vs;
      acc[e] += p * vf;
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc_s[warp][lane * EPL + e] = acc[e];
  __syncthreads();

  const size_t cell = static_cast<size_t>(row) * nsplit + split;
  for (int h = threadIdx.x; h < H; h += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += acc_s[w][h];
    o_part[cell * H + h] = t;
  }
  if (threadIdx.x == 0) {
    m_part[cell] = m;
    l_part[cell] = l;
  }
}

// Exact online-softmax merge of one row's split partials:
//   g = max_s m_s,  out = sum_s acc_s e^(m_s - g) / sum_s l_s e^(m_s - g)
template <typename TO>
__global__ void decode_merge_kernel(const float* __restrict__ o_part,
                                    const float* __restrict__ m_part,
                                    const float* __restrict__ l_part,
                                    TO* __restrict__ out, int nsplit, int H) {
  const int row = blockIdx.x;
  const float* m = m_part + static_cast<size_t>(row) * nsplit;
  const float* l = l_part + static_cast<size_t>(row) * nsplit;
  float g = kNegInf;
  for (int s = 0; s < nsplit; ++s) g = fmaxf(g, m[s]);
  float l_tot = 0.f;
  for (int s = 0; s < nsplit; ++s) l_tot += l[s] * expf(m[s] - g);
  const float l_safe = l_tot == 0.f ? 1.f : l_tot;
  const float* o = o_part + static_cast<size_t>(row) * nsplit * H;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s)
      acc += o[static_cast<size_t>(s) * H + h] * expf(m[s] - g);
    out[static_cast<size_t>(row) * H + h] = from_f32<TO>(acc / l_safe);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
  const void* start;
  const void* end;
  void* o_part;
  void* m_part;
  void* l_part;
  void* out;
  int batch_heads, heads, S, H;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int H, bool QUANT>
cudaError_t launch(const Args& a) {
  const int nsplit = (a.S + kBlockK - 1) / kBlockK;
  decode_split_kernel<TQ, TKV, H, QUANT>
      <<<dim3(a.batch_heads, nsplit), kThreads, 0, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), static_cast<const float*>(a.k_scale),
          static_cast<const float*>(a.v_scale),
          static_cast<const int*>(a.start), static_cast<const int*>(a.end),
          static_cast<float*>(a.o_part), static_cast<float*>(a.m_part),
          static_cast<float*>(a.l_part), a.heads, a.S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<TQ><<<a.batch_heads, H, 0, a.stream>>>(
      static_cast<const float*>(a.o_part),
      static_cast<const float*>(a.m_part),
      static_cast<const float*>(a.l_part), static_cast<TQ*>(a.out), nsplit,
      H);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_h(const Args& a) {
  if (a.S <= 0 || a.batch_heads <= 0 || a.heads <= 0)
    return cudaErrorInvalidValue;
  switch (a.H) {
    case 64: return launch<TQ, TKV, 64, QUANT>(a);
    case 128: return launch<TQ, TKV, 128, QUANT>(a);
    case 256: return launch<TQ, TKV, 256, QUANT>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes of q, out (and of k, v in the plain kernel): 0 f32, 1 bf16.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* start,
                                   const void* end, void* o_part,
                                   void* m_part, void* l_part, void* out,
                                   int batch_heads, int heads, int S, int H,
                                   int dtype, void* stream) {
  const Args a{q,      k,      v,      nullptr, nullptr,
               start,  end,    o_part, m_part,  l_part,
               out,    batch_heads,    heads,   S,
               H,      static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_h<float, float, false>(a);
    case 1: return launch_h<__nv_bfloat16, __nv_bfloat16, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_decode_quant_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* start, const void* end, void* o_part,
    void* m_part, void* l_part, void* out, int batch_heads, int heads, int S,
    int H, int dtype, void* stream) {
  const Args a{q,      k,      v,      k_scale, v_scale,
               start,  end,    o_part, m_part,  l_part,
               out,    batch_heads,    heads,   S,
               H,      static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_h<float, int8_t, true>(a);
    case 1: return launch_h<__nv_bfloat16, int8_t, true>(a);
    default: return cudaErrorInvalidValue;
  }
}
