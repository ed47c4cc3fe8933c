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
// layer reads), columns Cout, reduction K over the taps and Cin.  Two
// kernels, chosen by dtype (a static dispatch, not a fallback):
//
// bf16, conv_stats_tc_kernel: the bf16 tensor cores.
//
// What bounds it on an H100 (batch 256, the bound chip_smoke.py computes
// at every ResNet-50 site): bytes at most sites (x, w and y once at 3.35
// TB/s: 61 us at the stage-1 3x3 conv, 147 us at the s2d stem, 184 us at
// the largest 1x1s), operations at the 3x3 convs of stages 2-4 but the
// first stride-2 one, and at every stage-4 conv (59 GFLOP: 60 us at 989
// TFLOP/s).  Over the 53 sites of a step the bound sums to 3.9 ms.
//
// What the design does:
//   * one block of 256 threads (two warpgroups) per [BM = 128, BN] output
//     tile, BN = 64 where Cout <= 64, else 128; each warpgroup multiplies
//     its 64 rows with wgmma.mma_async m64nBNk16 (bf16 in, f32
//     accumulator in registers), both operands read from shared memory
//     through descriptors of K-major tiles in the 128-byte swizzle;
//   * K runs over (tap, channel) with each tap's channels in a slot of
//     cpad = Cin rounded up to 8, in steps of 64 (one 128-byte row): at
//     Cin = 64 a step is one tap, at the s2d stem (Cin = 12, slot 16) four
//     taps.  The weight is re-laid out once per call by the wrapper as
//     [Cout, kpad] (K-major, zero past kh·kw·cpad, kpad a multiple of 64);
//   * the A tile is an im2col gather: every thread copies 16-byte chunks
//     (8 channels of one tap of one output pixel) with cp.async, zero-
//     filled (src-size 0) in the padding halo, past M, past Cin and past
//     the last tap; 8-byte copies where Cin is a multiple of 4 only (the
//     stem: a pixel's 24 bytes are 8- but not 16-byte aligned), element
//     loads for any other Cin.  A ring of 3 (BN = 64, two blocks an SM)
//     or 5 (BN = 128, one block an SM) stages keeps all but one stage's
//     copies in flight while the tensor cores work: one barrier per
//     64-deep K step;
//   * each K step's wgmma group starts from zero and its result is added
//     to the f32 accumulator with round-to-nearest adds: the tensor
//     cores' own accumulation drops low bits and, over 72 steps, biases
//     deep sums enough to fail the statistics' limit;
//   * the blocks are persistent, one per place on the card, and walk the
//     output tiles (a row tile's column tiles next to each other, so its
//     input rows come from L2 the second time); the copies run across
//     tile boundaries, so a tile's epilogue overlaps the next tile's
//     first loads;
//   * the epilogue takes each column's Σy and Σy² from the f32
//     accumulator fragment (the thread's two rows, a reduce-scatter over
//     the 8 lanes that share its columns, then the 8 warps in shared
//     memory, all in a fixed order) and stores y through shared memory as
//     16-byte rows.
//
// Left for later: a producer warp specialised for the copies (setmaxnreg)
// with mbarriers in place of the block barrier, so that wgmma groups stay
// in flight across K steps; TMA's im2col mode for the A tile; reuse of
// the A rows a 3x3 conv's taps share.
//
// f32, conv_stats_kernel: f32 FMAs (67 TFLOP/s peak), for the f32 parity
// paths.  The weight is re-laid out as [kh, kw, Cin, Cout].
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
// Both kernels' tiles are 128 rows deep, so conv_tiles(M) sizes the
// partials of either.
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

// -- bf16: wgmma over a cp.async ring ----------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;            // output pixels per tile: 2 x 64 rows
constexpr int BK = 64;             // K elements per stage: one 128-byte row
constexpr int kRow = BK * 2;       // bytes of a tile row in shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCinAlign = 8;       // a tap's channel slot: Cin rounded up
constexpr int kRowsPerPass = kThreads / 8;  // rows one pass of chunks covers

struct Shape {
  int H, W, Cin, Cout, KW, stride, pad, Ho, Wo;
  long long M;
  int cpad;    // a tap's channel slot in K: Cin rounded up to kCinAlign
  int ktot;    // kh · kw · cpad
  int kpad;    // ktot rounded up to BK: the weight's row length
  int ksteps;  // kpad / BK
  int tiles;   // row tiles: ceil(M / BM)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 8 bytes; with ok false nothing is read and the
// destination is zero-filled (src-size 0)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator register across
// the wgmma waits
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// descriptor of a K-major bf16 tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1); the start
// address moves 32 bytes per k16 slice within the swizzle atom
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[64 x N] = A[64 x 16] · B[16 x N]^T (+ d with accumulate), both
// K-major in shared memory.
// Fragment: thread t of the warpgroup holds rows 16·(t/32) + (t%32)/4 and
// that + 8, columns 8q + 2·(t%4) and that + 1, as d[4q + 2h + e] (h: the
// second row, e: the second column)
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

// one round of a reduce-scatter over lanes `o` apart: the lane keeps one
// half of v[0, 2H) (the upper one where `up`), adds the partner's copy of
// that half into v[0, H), and hands the other half to the partner
template <int H, int N>
__device__ __forceinline__ void rs_round(float (&v)[N], bool up, int o) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i], hi = v[i + H];
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, o);
  }
}

// the ring's depth: 5 stages of 128x128 tile pairs (one block an SM), 3
// of 128x64 ones (two blocks an SM)
template <int BN>
__host__ __device__ constexpr int stages() {
  return BN == 64 ? 3 : 5;
}

// shared memory of one block: the ring, then the epilogue's y tile
// ([BM][BN + 8] bf16, rows padded against bank conflicts) and the warps'
// column sums; plus 1024 bytes to align the ring to the swizzle atom
template <int BN>
__host__ __device__ constexpr int ring_bytes() {
  return stages<BN>() * (BM + BN) * kRow;
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<BN>() + BM * (BN + 8) * 2 + 2 * kWarps * BN * 4 + 1024;
}

// Persistent: block b takes the tiles b, b + gridDim.x, ... of the
// s.tiles x ceil(Cout / BN) output tiles, the column tiles of one row
// tile next to each other (their input rows are read from HBM once and
// from L2 after).  The copies run kS - 1 stages ahead of the tensor cores
// across tile boundaries, so a tile's epilogue overlaps the next one's
// first loads.
//
// AW: input elements per copy: 8 (cp.async 16 B: Cin % 8 == 0), 4 (8 B:
// Cin % 4 == 0) or 1 (element loads).  vy: Cout % 8 == 0 and y aligned,
// y rows stored 16 bytes at a time.
template <int BN, int AW>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
conv_stats_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ y, float* __restrict__ psum,
                     float* __restrict__ psq, const Shape s, const int vy) {
  constexpr int kS = stages<BN>();
  constexpr int kAhead = kS - 1;  // stages copied ahead of the one used
  constexpr int kA = BM * kRow;
  constexpr int kStage = (BM + BN) * kRow;
  constexpr int kYS = BN + 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(smem);
  bf16* ys = reinterpret_cast<bf16*>(smem + ring_bytes<BN>());
  float* red_s = reinterpret_cast<float*>(smem + ring_bytes<BN>() +
                                          BM * kYS * 2);
  float* red_q = red_s + kWarps * BN;  // [kWarps][BN] each

  const int tid = threadIdx.x;
  const int ntiles = (s.Cout + BN - 1) / BN;
  const int items = s.tiles * ntiles;

  // copy role: 16-byte chunk j (8 K elements) of tile rows r0 + 32 i; the
  // chunk's swizzled place is the same in all of them (r0 + 32 i ≡ r0
  // mod 8).  The copies' own position: tile l_item, K step l_k, where the
  // chunk's K index k = 64·l_k + 8j is tap (u, v), channel c.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const int sw = (j ^ (r0 & 7)) << 4;
  constexpr int kARows = BM / kRowsPerPass;
  int ih0[kARows], iw0[kARows];
  long long row0[kARows];  // x offset of the row's tap (0, 0), channel 0
  int l_item = blockIdx.x, l_k = 0, l_n0 = 0;
  const int tap0 = (j * 8) / s.cpad;
  const int c0 = j * 8 - tap0 * s.cpad;
  const int u0 = tap0 / s.KW, v0 = tap0 - u0 * s.KW;
  int k = j * 8, c = c0, u = u0, v = v0;
  auto decode = [&]() {  // the rows and weight columns of tile l_item
    const int mt = l_item / ntiles;
    l_n0 = (l_item - mt * ntiles) * BN;
    const long long hw = static_cast<long long>(s.Ho) * s.Wo;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const long long m =
          static_cast<long long>(mt) * BM + r0 + kRowsPerPass * i;
      if (m < s.M) {
        const long long n = m / hw;
        const int rem = static_cast<int>(m - n * hw);
        ih0[i] = (rem / s.Wo) * s.stride - s.pad;
        iw0[i] = (rem % s.Wo) * s.stride - s.pad;
        row0[i] = ((n * s.H + ih0[i]) * s.W + iw0[i]) * s.Cin;
      } else {  // past M: no tap lands in the image
        ih0[i] = -(1 << 29);
        iw0[i] = 0;
        row0[i] = 0;
      }
    }
  };
  // the copies' next stage into ring slot `slot`, then one step on
  auto load_next = [&](int slot) {
    if (l_item >= items) return;
    uint8_t* a_g = smem + slot * kStage;
    const uint32_t a_s = sbase + slot * kStage;
    const bool kin = k < s.ktot;
    const long long tap_off =
        (static_cast<long long>(u) * s.W + v) * s.Cin + c;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int r = r0 + kRowsPerPass * i;
      const int ih = ih0[i] + u, iw = iw0[i] + v;
      const bool ok = kin && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      const bf16* src = ok ? x + (row0[i] + tap_off) : x;
      if (AW == 8) {
        cp16(a_s + r * kRow + sw, src, ok);
      } else if (AW == 4) {
        cp8(a_s + r * kRow + sw, src, ok);
        cp8(a_s + r * kRow + sw + 8, ok ? src + 4 : x, ok && c + 4 < s.Cin);
      } else {
        Pack<bf16, 8> pk;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          pk.v[e] = (ok && c + e < s.Cin) ? src[e] : __float2bfloat16(0.f);
        *reinterpret_cast<Pack<bf16, 8>*>(a_g + r * kRow + sw) = pk;
      }
    }
    const uint32_t b_s = a_s + kA;
#pragma unroll
    for (int i = 0; i < BN / kRowsPerPass; ++i) {
      const int r = r0 + kRowsPerPass * i;
      const bool ok = l_n0 + r < s.Cout;
      const bf16* src =
          ok ? w + (static_cast<long long>(l_n0 + r) * s.kpad + l_k * BK +
                    j * 8)
             : w;
      cp16(b_s + r * kRow + sw, src, ok);
    }
    if (++l_k == s.ksteps) {  // the next tile, from K index 8j again
      l_k = 0;
      k = j * 8;
      c = c0;
      u = u0;
      v = v0;
      l_item += gridDim.x;
      if (l_item < items) decode();
    } else {  // K index + 64: the channel on, across as many taps
      k += BK;
      c += BK;
      while (c >= s.cpad) {
        c -= s.cpad;
        if (++v == s.KW) {
          v = 0;
          ++u;
        }
      }
    }
  };

  if (l_item < items) decode();
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    load_next(t);
    cp_commit();
  }

  const int wg = tid >> 7;  // warpgroup: tile rows 64·wg ..
  // the fragment's rows and columns (see Mma)
  const int warp = tid >> 5, lane = tid & 31;
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cl = (lane & 3) * 2;
  int slot = 0;  // the ring slot of the stage multiplied next
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int mt = item / ntiles;
    const long long m0 = static_cast<long long>(mt) * BM;
    const int n0 = (item - mt * ntiles) * BN;
    // the tensor cores add a K step's 64 products into `part`; `acc` adds
    // the steps with round-to-nearest f32 adds.  Accumulating the whole
    // K loop in the tensor cores' own adder, which drops the low bits of
    // each sum, pulls deep sums (kh·kw·Cin = 4608) towards zero by ~1e-5
    // of their size, enough to move Σy² past the statistics' limit.
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < s.ksteps; ++t) {
      // this stage has landed for every thread, and the wgmma of the
      // previous one is done in both warpgroups (each waited for it), so
      // its slot, the one copied into next, is free
      cp_wait<kAhead - 1>();
      fence_async_smem();
      __syncthreads();
      const uint32_t a_s = sbase + slot * kStage;
      const uint32_t b_s = a_s + kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Mma<BN>::run(part, desc_sw128(a_s + wg * 64 * kRow + kk * 32),
                     desc_sw128(b_s + kk * 32), kk > 0);
      wgmma_commit();
      load_next(slot == 0 ? kS - 1 : slot - 1);
      cp_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        reg_fence(part[i]);
        acc[i] += part[i];
      }
      slot = slot == kS - 1 ? 0 : slot + 1;
    }

    // epilogue (its own shared memory: the ring keeps copying).  The y
    // tile and the column sums of the previous tile were last read before
    // this tile's first K-step barrier.
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const int col = q * 8 + cl;
      *reinterpret_cast<__nv_bfloat162*>(&ys[row * kYS + col]) =
          __floats2bfloat162_rn(acc[4 * q], acc[4 * q + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&ys[(row + 8) * kYS + col]) =
          __floats2bfloat162_rn(acc[4 * q + 2], acc[4 * q + 3]);
    }
    // Σy, Σy² of each of the thread's columns over its two rows (rows past
    // M are zero-filled A rows: exact zeros): value 2q + e is Σy of column
    // 8q + cl + e, value kV/2 + 2q + e its Σy²
    constexpr int kV = BN / 2;
    float v[kV];
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = acc[4 * q + e], b = acc[4 * q + 2 + e];
        v[2 * q + e] = a + b;
        v[kV / 2 + 2 * q + e] = a * a + b * b;
      }
    }
    // then over the warp's 16 rows: a reduce-scatter over the 8 lanes that
    // share the columns (lane bits 2-4).  Each round keeps half of the
    // values, adds the partner's copy of that half and hands over the
    // other half; lane group g = lane / 4 ends with values g·kV/8 ..
    // (g + 1)·kV/8 - 1 summed over the 8 lanes, in a fixed order
    const int g = lane >> 2;
    rs_round<kV / 2>(v, (g >> 2) & 1, 16);
    rs_round<kV / 4>(v, (g >> 1) & 1, 8);
    rs_round<kV / 8>(v, g & 1, 4);
#pragma unroll
    for (int i = 0; i < kV / 8; ++i) {
      const int idx = g * (kV / 8) + i;
      const int stat = idx / (kV / 2), qe = idx % (kV / 2);
      red_s[(stat * kWarps + warp) * BN + (qe >> 1) * 8 + cl + (qe & 1)] =
          v[i];
    }
    __syncthreads();
    if (tid < BN && n0 + tid < s.Cout) {
      float cs = 0.f, cq = 0.f;
#pragma unroll
      for (int wp = 0; wp < kWarps; ++wp) {
        cs += red_s[wp * BN + tid];
        cq += red_q[wp * BN + tid];
      }
      const size_t o = static_cast<size_t>(mt) * s.Cout + n0 + tid;
      psum[o] = cs;
      psq[o] = cq;
    }
    // y: 16-byte row chunks, consecutive threads on consecutive chunks
    constexpr int kChunks = BN / 8;
    for (int idx = tid; idx < BM * kChunks; idx += kThreads) {
      const int r = idx / kChunks, q = idx - r * kChunks;
      const long long m = m0 + r;
      const int col = n0 + q * 8;
      if (m >= s.M || col >= s.Cout) continue;
      const bf16* src = &ys[r * kYS + q * 8];
      bf16* dst = y + m * s.Cout + col;
      if (vy) {
        *reinterpret_cast<Pack<bf16, 8>*>(dst) =
            *reinterpret_cast<const Pack<bf16, 8>*>(src);
      } else {
        for (int e = 0; e < 8 && col + e < s.Cout; ++e) dst[e] = src[e];
      }
    }
  }
  cp_wait<0>();  // nothing in flight at exit (the last groups are empty)
}

// the blocks that fit on the card at once (SMs x blocks an SM), found
// once per instantiation, after its opt-in to more than 48 KB of shared
// memory
struct Residency {
  cudaError_t err;
  int blocks;
};

template <int BN, int AW>
cudaError_t launch_bn_aw(const bf16* x, const bf16* w, bf16* y, float* psum,
                         float* psq, const Shape& s, int vy,
                         cudaStream_t st) {
  constexpr int smem = smem_bytes<BN>();
  static const Residency res = [] {
    Residency r{cudaSuccess, 0};
    int dev = 0, sms = 0, per_sm = 0;
    r.err = cudaFuncSetAttribute(conv_stats_tc_kernel<BN, AW>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (r.err == cudaSuccess) r.err = cudaGetDevice(&dev);
    if (r.err == cudaSuccess)
      r.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (r.err == cudaSuccess)
      r.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, conv_stats_tc_kernel<BN, AW>, kThreads, smem);
    if (r.err == cudaSuccess && per_sm < 1) r.err = cudaErrorInvalidValue;
    r.blocks = sms * per_sm;
    return r;
  }();
  if (res.err != cudaSuccess) return res.err;
  const long long items =
      static_cast<long long>(s.tiles) * ((s.Cout + BN - 1) / BN);
  if (items > (1LL << 30)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < res.blocks ? items : res.blocks);
  conv_stats_tc_kernel<BN, AW><<<grid, kThreads, smem, st>>>(x, w, y, psum,
                                                              psq, s, vy);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bn(const bf16* x, const bf16* w, bf16* y, float* psum,
                      float* psq, const Shape& s, int vy, cudaStream_t st) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (s.Cin % 8 == 0 && xa % 16 == 0)
    return launch_bn_aw<BN, 8>(x, w, y, psum, psq, s, vy, st);
  if (s.Cin % 4 == 0 && xa % 8 == 0)
    return launch_bn_aw<BN, 4>(x, w, y, psum, psq, s, vy, st);
  return launch_bn_aw<BN, 1>(x, w, y, psum, psq, s, vy, st);
}

// w: [Cout, kpad] bf16, K-major, (tap, channel slot) order, zero-padded
cudaError_t launch(const void* x, const void* w, void* y, float* psum,
                   float* psq, float* mean, float* var, Shape s, int KH,
                   cudaStream_t st) {
  s.cpad = (s.Cin + kCinAlign - 1) / kCinAlign * kCinAlign;
  s.ktot = KH * s.KW * s.cpad;
  s.kpad = (s.ktot + BK - 1) / BK * BK;
  s.ksteps = s.kpad / BK;
  if (!aligned16(w)) return cudaErrorInvalidValue;
  const int vy = s.Cout % 8 == 0 && aligned16(y);
  s.tiles = static_cast<int>((s.M + BM - 1) / BM);
  auto xp = static_cast<const bf16*>(x);
  auto wp = static_cast<const bf16*>(w);
  auto yp = static_cast<bf16*>(y);
  const cudaError_t err =
      s.Cout <= 64 ? launch_bn<64>(xp, wp, yp, psum, psq, s, vy, st)
                   : launch_bn<128>(xp, wp, yp, psum, psq, s, vy, st);
  if (err != cudaSuccess) return err;
  return bn::reduce_partials(psum, psq, mean, var, s.tiles, s.Cout, true,
                             s.M, st);
}

}  // namespace tc

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
    case 1: {
      tc::Shape t;
      t.H = s.H;
      t.W = s.W;
      t.Cin = s.Cin;
      t.Cout = s.Cout;
      t.KW = s.KW;
      t.stride = s.stride;
      t.pad = s.pad;
      t.Ho = s.Ho;
      t.Wo = s.Wo;
      t.M = s.M;
      return tc::launch(x, w, y, f(psum), f(psq), f(mean), f(var), t, KH,
                        st);
    }
    default: return cudaErrorInvalidValue;
  }
}
