// Train-mode batch norm (+ReLU) for Hopper (sm_90a): the four streaming
// passes over a [M, C] channels-last activation.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused_bn.py:
//   * B5 `_stats_kernel` (called by `_moments`, pallas_call :83): per-channel
//     Σx and Σx² in f32, finished here into mean and var;
//   * B5 `_apply_kernel` (`_apply`, :100): y = x·scale + shift (+ReLU);
//   * B6 `_bwd_reduce_kernel` (`bn_bwd_reduce`, :187): Σdy'·x and Σdy', dy'
//     being dy gated by the ReLU recomputed from x;
//   * B6 `_bwd_dx_kernel` (`bn_bwd_dx`, :208): dx = a·dy' + b·x + c.
//
// What bounds them on an H100: memory.  Each pass reads the activation
// (and dy) once and does a handful of operations per element: at the
// ResNet-50 stage-1 epilogue, [802816, 256] bf16, the apply pass moves
// 822 MB, 245 us at 3.35 TB/s, against 0.4 GFLOP.
//
// What the design does about it:
//   * every thread owns VEC consecutive channels (16 bytes: 8 bf16 or 4 f32
//     when C and the pointers allow, else 1) and walks rows of its block's
//     chunk, so a warp reads whole rows in 16-byte coalesced accesses and
//     the per-channel vectors (scale, shift, a, b, c) are loaded once per
//     thread into registers;
//   * the reductions keep their sums in f32 registers over the chunk, add
//     the block's row lanes in shared memory in a fixed order and write one
//     row of a [chunks, C] partials buffer; bn_partials.cuh adds the chunks
//     in a fixed order (no atomics: two runs give the same bits);
//   * y is never stored for the backward: B6 recomputes the ReLU gate from
//     x, as the TPU kernels do.
//
// Numerics follow the TPU kernels: x·scale + shift and a·dy' + b·x + c are
// rounded operation by operation (no fused multiply-add), exactly as the
// plain version's tensor ops round them, so the ReLU gate of the backward
// agrees with the forward and with the plain version bit for bit; the
// moments are var = max(Σx²/m − mean², 0) (fused_bn.py:93-94).
//
// Interface: plain C, loaded with ctypes.  The caller allocates every
// buffer (the partials hold bn_chunks(M, C, dtype) rows); each function
// launches on the given stream and returns cudaGetLastError().  dtype codes:
// 0 f32, 1 bf16 (of x, dy and the outputs y and dx; every per-channel
// vector is f32).

#include "bn_partials.cuh"

namespace {

using bn::from_f32;
using bn::Pack;
using bn::to_f32;

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132 * 8;  // a few waves of blocks over 132 SMs
constexpr int kMaxChunks = 1024;        // bounds the partials buffers

struct Plan {
  int vec;     // channels per thread
  int ct;      // thread columns per block
  int rb;      // row lanes per block (kThreads / ct)
  int tiles;   // column tiles
  int chunks;  // row chunks
  int rows;    // rows per chunk (a multiple of rb)
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

Plan make_plan(long long M, int C, int elt, bool vec_ok) {
  Plan p;
  p.vec = (vec_ok && C % (16 / elt) == 0) ? 16 / elt : 1;
  const int cols = C / p.vec;
  p.ct = cols < kThreads ? cols : kThreads;
  p.rb = kThreads / p.ct;
  p.tiles = (cols + p.ct - 1) / p.ct;
  long long want = kTargetBlocks / p.tiles;
  if (want < 1) want = 1;
  if (want > kMaxChunks) want = kMaxChunks;
  long long rows = (M + want - 1) / want;
  rows = (rows + p.rb - 1) / p.rb * p.rb;
  if (rows < p.rb) rows = p.rb;
  p.rows = static_cast<int>(rows);
  p.chunks = static_cast<int>((M + rows - 1) / rows);
  if (p.chunks < 1) p.chunks = 1;
  return p;
}

// The thread's place in the block: channel c0 (VEC of them) and row lane.
struct Place {
  int c0, lane;
  bool live;
};

template <int VEC>
__device__ __forceinline__ Place place(int ct, int rb, int C) {
  Place q;
  const int t = threadIdx.x;
  q.lane = t / ct;
  q.c0 = (blockIdx.x * ct + t % ct) * VEC;
  q.live = q.lane < rb && q.c0 < C;
  return q;
}

template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, size_t off,
                                         float (&f)[VEC]) {
  const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(p + off);
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = to_f32(v.v[e]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* __restrict__ p, size_t off,
                                          const float (&f)[VEC]) {
  Pack<T, VEC> v;
#pragma unroll
  for (int e = 0; e < VEC; ++e) v.v[e] = from_f32<T>(f[e]);
  *reinterpret_cast<Pack<T, VEC>*>(p + off) = v;
}

// Adds the block's row lanes (each holding VEC sums of two quantities) in
// lane order and writes the block's row of the partials buffers.
template <int VEC>
__device__ __forceinline__ void block_partials(const float (&a)[VEC],
                                               const float (&b)[VEC],
                                               const Place& q, int ct, int rb,
                                               int C, float* __restrict__ pa,
                                               float* __restrict__ pb) {
  __shared__ float sa[kThreads * VEC];
  __shared__ float sb[kThreads * VEC];
  const int t = threadIdx.x;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sa[t * VEC + e] = a[e];
    sb[t * VEC + e] = b[e];
  }
  __syncthreads();
  if (q.lane != 0 || !q.live) return;
  const int col = t % ct;
  float ra[VEC], rbv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) ra[e] = rbv[e] = 0.f;
  for (int l = 0; l < rb; ++l) {
    const int s = (l * ct + col) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ra[e] += sa[s + e];
      rbv[e] += sb[s + e];
    }
  }
  const size_t o = static_cast<size_t>(blockIdx.y) * C + q.c0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    pa[o + e] = ra[e];
    pb[o + e] = rbv[e];
  }
}

__device__ __forceinline__ float affine(float x, float s, float h) {
  return __fadd_rn(__fmul_rn(x, s), h);
}

// B5 stats: per-chunk Σx, Σx².
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, float* __restrict__ psum,
             float* __restrict__ psq, long long M, int C, int ct, int rb,
             int rows) {
  const Place q = place<VEC>(ct, rb, C);
  float s[VEC], sq[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = sq[e] = 0.f;
  if (q.live) {
    const long long r0 = static_cast<long long>(blockIdx.y) * rows;
    const long long r1 = min(r0 + rows, M);
#pragma unroll 4
    for (long long r = r0 + q.lane; r < r1; r += rb) {
      float f[VEC];
      load_row<T, VEC>(x, static_cast<size_t>(r) * C + q.c0, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s[e] += f[e];
        sq[e] += f[e] * f[e];
      }
    }
  }
  block_partials<VEC>(s, sq, q, ct, rb, C, psum, psq);
}

// B5 apply: y = x·scale + shift (+ReLU).
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ y, long long M,
             int C, int ct, int rb, int rows) {
  const Place q = place<VEC>(ct, rb, C);
  if (!q.live) return;
  float sc[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sc[e] = scale[q.c0 + e];
    sh[e] = shift[q.c0 + e];
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * rows;
  const long long r1 = min(r0 + rows, M);
#pragma unroll 4
  for (long long r = r0 + q.lane; r < r1; r += rb) {
    const size_t off = static_cast<size_t>(r) * C + q.c0;
    float f[VEC];
    load_row<T, VEC>(x, off, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float v = affine(f[e], sc[e], sh[e]);
      if (RELU) v = v < 0.f ? 0.f : v;  // NaN passes, as max(NaN, 0) does
      f[e] = v;
    }
    store_row<T, VEC>(y, off, f);
  }
}

// B6 reduce: per-chunk Σdy'·x, Σdy'.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ pdyx,
                  float* __restrict__ pdy, long long M, int C, int ct, int rb,
                  int rows) {
  const Place q = place<VEC>(ct, rb, C);
  float sdyx[VEC], sdy[VEC], sc[VEC], sh[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sdyx[e] = sdy[e] = 0.f;
    sc[e] = q.live && RELU ? scale[q.c0 + e] : 0.f;
    sh[e] = q.live && RELU ? shift[q.c0 + e] : 0.f;
  }
  if (q.live) {
    const long long r0 = static_cast<long long>(blockIdx.y) * rows;
    const long long r1 = min(r0 + rows, M);
#pragma unroll 4
    for (long long r = r0 + q.lane; r < r1; r += rb) {
      const size_t off = static_cast<size_t>(r) * C + q.c0;
      float fx[VEC], fd[VEC];
      load_row<T, VEC>(x, off, fx);
      load_row<T, VEC>(dy, off, fd);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d =
            (!RELU || affine(fx[e], sc[e], sh[e]) > 0.f) ? fd[e] : 0.f;
        sdy[e] += d;
        sdyx[e] += d * fx[e];
      }
    }
  }
  block_partials<VEC>(sdyx, sdy, q, ct, rb, C, pdyx, pdy);
}

// B6 dx: dx = a·dy' + b·x + c.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ scale,
              const float* __restrict__ shift, const float* __restrict__ a,
              const float* __restrict__ b, const float* __restrict__ c,
              T* __restrict__ dx, long long M, int C, int ct, int rb,
              int rows) {
  const Place q = place<VEC>(ct, rb, C);
  if (!q.live) return;
  float sc[VEC], sh[VEC], ca[VEC], cb[VEC], cc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    sc[e] = RELU ? scale[q.c0 + e] : 0.f;
    sh[e] = RELU ? shift[q.c0 + e] : 0.f;
    ca[e] = a[q.c0 + e];
    cb[e] = b[q.c0 + e];
    cc[e] = c[q.c0 + e];
  }
  const long long r0 = static_cast<long long>(blockIdx.y) * rows;
  const long long r1 = min(r0 + rows, M);
#pragma unroll 4
  for (long long r = r0 + q.lane; r < r1; r += rb) {
    const size_t off = static_cast<size_t>(r) * C + q.c0;
    float fx[VEC], fd[VEC];
    load_row<T, VEC>(x, off, fx);
    load_row<T, VEC>(dy, off, fd);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d =
          (!RELU || affine(fx[e], sc[e], sh[e]) > 0.f) ? fd[e] : 0.f;
      fd[e] = __fadd_rn(__fadd_rn(__fmul_rn(ca[e], d), __fmul_rn(cb[e], fx[e])),
                        cc[e]);
    }
    store_row<T, VEC>(dx, off, fd);
  }
}

// -- launchers ----------------------------------------------------------------

template <typename T>
cudaError_t stats(const void* x, float* psum, float* psq, float* mean,
                  float* var, long long M, int C, cudaStream_t st) {
  const Plan p = make_plan(M, C, sizeof(T), aligned16(x));
  const dim3 grid(p.tiles, p.chunks);
  if (p.vec == 1)
    stats_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), psum, psq, M, C, p.ct, p.rb, p.rows);
  else
    stats_kernel<T, 16 / sizeof(T)><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), psum, psq, M, C, p.ct, p.rb, p.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bn::reduce_partials(psum, psq, mean, var, p.chunks, C, true, M, st);
}

template <typename T, bool RELU>
cudaError_t apply(const void* x, const float* scale, const float* shift,
                  void* y, long long M, int C, cudaStream_t st) {
  const Plan p = make_plan(M, C, sizeof(T), aligned16(x) && aligned16(y));
  const dim3 grid(p.tiles, p.chunks);
  if (p.vec == 1)
    apply_kernel<T, 1, RELU><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), scale, shift, static_cast<T*>(y), M, C,
        p.ct, p.rb, p.rows);
  else
    apply_kernel<T, 16 / sizeof(T), RELU><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), scale, shift, static_cast<T*>(y), M, C,
        p.ct, p.rb, p.rows);
  return cudaGetLastError();
}

template <typename T, bool RELU>
cudaError_t bwd_reduce(const void* x, const void* dy, const float* scale,
                       const float* shift, float* pdyx, float* pdy,
                       float* sum_dyx, float* sum_dy, long long M, int C,
                       cudaStream_t st) {
  const Plan p = make_plan(M, C, sizeof(T), aligned16(x) && aligned16(dy));
  const dim3 grid(p.tiles, p.chunks);
  if (p.vec == 1)
    bwd_reduce_kernel<T, 1, RELU><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, shift,
        pdyx, pdy, M, C, p.ct, p.rb, p.rows);
  else
    bwd_reduce_kernel<T, 16 / sizeof(T), RELU><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, shift,
        pdyx, pdy, M, C, p.ct, p.rb, p.rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return bn::reduce_partials(pdyx, pdy, sum_dyx, sum_dy, p.chunks, C, false,
                             M, st);
}

template <typename T, bool RELU>
cudaError_t bwd_dx(const void* x, const void* dy, const float* scale,
                   const float* shift, const float* a, const float* b,
                   const float* c, void* dx, long long M, int C,
                   cudaStream_t st) {
  const Plan p = make_plan(M, C, sizeof(T),
                           aligned16(x) && aligned16(dy) && aligned16(dx));
  const dim3 grid(p.tiles, p.chunks);
  if (p.vec == 1)
    bwd_dx_kernel<T, 1, RELU><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, shift, a,
        b, c, static_cast<T*>(dx), M, C, p.ct, p.rb, p.rows);
  else
    bwd_dx_kernel<T, 16 / sizeof(T), RELU><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), scale, shift, a,
        b, c, static_cast<T*>(dx), M, C, p.ct, p.rb, p.rows);
  return cudaGetLastError();
}

bool bad(long long M, int C) { return M <= 0 || C <= 0; }

}  // namespace

// Rows of the partials buffers that bn_stats_launch and
// bn_bwd_reduce_launch need for a [M, C] activation of this dtype (the
// vector width, hence the plan, also depends on the pointers' alignment:
// the count returned is the larger of the two plans').
extern "C" int bn_chunks(long long M, int C, int dtype) {
  if (bad(M, C) || (dtype != 0 && dtype != 1)) return -1;
  const int elt = dtype == 0 ? 4 : 2;
  const int a = make_plan(M, C, elt, true).chunks;
  const int b = make_plan(M, C, elt, false).chunks;
  return a > b ? a : b;
}

extern "C" int bn_stats_launch(const void* x, void* psum, void* psq,
                               void* mean, void* var, long long M, int C,
                               int dtype, void* stream) {
  if (bad(M, C)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  switch (dtype) {
    case 0: return stats<float>(x, f(psum), f(psq), f(mean), f(var), M, C, st);
    case 1:
      return stats<__nv_bfloat16>(x, f(psum), f(psq), f(mean), f(var), M, C,
                                  st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bn_apply_launch(const void* x, const void* scale,
                               const void* shift, void* y, long long M, int C,
                               int relu, int dtype, void* stream) {
  if (bad(M, C)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto sh = static_cast<const float*>(shift);
  switch (dtype * 2 + (relu ? 1 : 0)) {
    case 0: return apply<float, false>(x, sc, sh, y, M, C, st);
    case 1: return apply<float, true>(x, sc, sh, y, M, C, st);
    case 2: return apply<__nv_bfloat16, false>(x, sc, sh, y, M, C, st);
    case 3: return apply<__nv_bfloat16, true>(x, sc, sh, y, M, C, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bn_bwd_reduce_launch(const void* x, const void* dy,
                                    const void* scale, const void* shift,
                                    void* pdyx, void* pdy, void* sum_dyx,
                                    void* sum_dy, long long M, int C,
                                    int relu, int dtype, void* stream) {
  if (bad(M, C)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  switch (dtype * 2 + (relu ? 1 : 0)) {
    case 0:
      return bwd_reduce<float, false>(x, dy, cf(scale), cf(shift), f(pdyx),
                                      f(pdy), f(sum_dyx), f(sum_dy), M, C, st);
    case 1:
      return bwd_reduce<float, true>(x, dy, cf(scale), cf(shift), f(pdyx),
                                     f(pdy), f(sum_dyx), f(sum_dy), M, C, st);
    case 2:
      return bwd_reduce<__nv_bfloat16, false>(x, dy, cf(scale), cf(shift),
                                              f(pdyx), f(pdy), f(sum_dyx),
                                              f(sum_dy), M, C, st);
    case 3:
      return bwd_reduce<__nv_bfloat16, true>(x, dy, cf(scale), cf(shift),
                                             f(pdyx), f(pdy), f(sum_dyx),
                                             f(sum_dy), M, C, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int bn_bwd_dx_launch(const void* x, const void* dy,
                                const void* scale, const void* shift,
                                const void* a, const void* b, const void* c,
                                void* dx, long long M, int C, int relu,
                                int dtype, void* stream) {
  if (bad(M, C)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  switch (dtype * 2 + (relu ? 1 : 0)) {
    case 0:
      return bwd_dx<float, false>(x, dy, cf(scale), cf(shift), cf(a), cf(b),
                                  cf(c), dx, M, C, st);
    case 1:
      return bwd_dx<float, true>(x, dy, cf(scale), cf(shift), cf(a), cf(b),
                                 cf(c), dx, M, C, st);
    case 2:
      return bwd_dx<__nv_bfloat16, false>(x, dy, cf(scale), cf(shift), cf(a),
                                          cf(b), cf(c), dx, M, C, st);
    case 3:
      return bwd_dx<__nv_bfloat16, true>(x, dy, cf(scale), cf(shift), cf(a),
                                         cf(b), cf(c), dx, M, C, st);
    default: return cudaErrorInvalidValue;
  }
}
