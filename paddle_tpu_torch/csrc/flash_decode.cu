// Flash-decoding for Hopper (sm_90a): single-query attention over the KV
// ring cache in one cluster launch per call, in a plain variant (f32 or
// bf16 K/V) and an int8-KV variant.  The same launch takes a block of tq
// queries per (sequence, head) with a window end per query (speculative
// decoding's verify block): each query row runs the one-query code at the
// same span, chunk alignment and merge order, so it gives the bits a
// one-query call with its window gives.  The tq queries of a row read
// K/V separately; only their window ends differ.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_decode.py:
//   * `_decode_kernel`, called by `flash_decode_fn` (pallas_call :118);
//   * `_decode_kernel_quant`, called by `flash_decode_quant_fn` (:217);
//   * the split merge that follows both (:147-156), plain XLA there, runs
//     inside the same launch here, through distributed shared memory.
//
// What bounds it on an H100: memory.  One decode step reads the whole
// cache once, 2*B*N*S*H*elt bytes of K and V (plus 2*B*N*S*4 bytes of
// scales for int8) against 4*B*N*S*H operations: under one operation per
// byte, far below the ~295 op/byte where the tensor cores would become the
// limit (one query row fills 1 of the 16 rows of an mma tile anyway).  At
// the served shape (B=8, N=12, S=256, H=64) that is 6.29 MB in bf16
// (1.9 us at 3.35 TB/s) and 3.34 MB in int8 (1.0 us): so little that the
// call is all latency unless the whole cache is requested at once.
//
// What the design does about it:
//   * one launch: grid (B*N*tq, C) in clusters of (1, C, 1).  The C blocks
//     of a cluster share one query row; rank r takes a contiguous
//     span of ceil(S/C) cached columns, C = min(4, ceil(S/64)) (384
//     blocks at the served shape, all resident in the first wave);
//   * loads go out before arithmetic: the rows of a block's span inside
//     the row's [start, end) window are contiguous, so a chunk of them
//     (8 KB of K + V) goes to shared memory as one Hopper bulk copy
//     (cp.async.bulk) each of K, V (and the int8 scales), completing on
//     one mbarrier; a 3-stage ring keeps three chunks in flight, which
//     is a whole span of up to 96 rows at the served shape's head_dim,
//     and the block walks its chunks with an online softmax.  Rows
//     outside the window are never loaded;
//   * 16-byte reads from shared memory: a group of H*elt/16 lanes (at
//     most 32) holds one row, so a warp scores several rows per pass and
//     a row's dot product needs log2(group) shuffles; q stays in
//     registers and int8 is dequantized in registers;
//   * the merge stays in the cluster: each rank stores (m, l, acc[H])
//     into its slot of rank 0's shared memory, arrives once on rank 0's
//     mbarrier and leaves; rank 0 waits for all C arrivals, merges the
//     slots in rank order and writes the output.  No scratch in device
//     memory, no atomics, no second launch: two launches give the same
//     bits.
//
// Numerics follow the TPU kernel: scores and the running max, normalizer
// and accumulator in f32; only the window's rows are loaded, and a rank
// with no live row contributes m = -1e30, l = 0, acc = 0 (a row with no
// valid column anywhere gives 0); in the plain kernel p is rounded to V's
// dtype before the PV product (flash_decode.py:85), here against the
// block's running max; the int8 kernel stays in f32 throughout
// (:167-179), a row's scale multiplying its integer dot product and its
// p.  The merge guards l_tot == 0 (:154).
//
// Interface: plain C, loaded with ctypes.  The caller allocates the
// output; each function launches on the given stream and returns the
// launch's CUDA error (0 on success).  q, k, v and the scales must start
// on 16 bytes (the bulk copies' alignment; the wrapper checks it).  The
// softmax scale is 1/sqrt(H), as every caller of the TPU kernel uses it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Measured on an H100 at B=8, N=12, H=64, S = 256 to 1024 (PERF.md §6):
// 8 ranks a row, 16 KB stages or 2 stages were slower than these.
constexpr int kSplitCols = 64;     // cached columns per rank before another
constexpr int kMaxCluster = 4;     // ranks a row at most
constexpr int kStageBytes = 8192;  // K + V rows of one ring stage
constexpr int kStages = 3;
constexpr float kNegInf = -1e30f;

// 16 bytes of T as floats: N elements
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void cvt(uint4 w, float* o) {
    o[0] = __uint_as_float(w.x);
    o[1] = __uint_as_float(w.y);
    o[2] = __uint_as_float(w.z);
    o[3] = __uint_as_float(w.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void cvt(uint4 w, float* o) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // the lower address is the low half
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  // exact: the biased byte b + 128 becomes the mantissa of 2^23 + b + 128
  static __device__ __forceinline__ void cvt(uint4 w, float* o) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = u[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        o[4 * i + b] =
            __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + b)) -
            8388736.f;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// p rounded to V's dtype before the PV product (the plain kernel only)
template <typename TKV>
__device__ __forceinline__ float round_p(float p) { return p; }
template <>
__device__ __forceinline__ float round_p<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival, with release at cluster scope, on the barrier at the same
// shared-memory offset in rank 0 of the cluster
__device__ __forceinline__ void mbar_arrive_rank0(uint64_t* bar) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(0));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// wait, with acquire at cluster scope, for the phase of `parity`
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shapes of one instantiation: lanes per cached row, elements per lane,
// rows per ring stage and rows per lane group within a stage.
template <typename TKV, int H>
struct Plan {
  static constexpr int kVE = Vec16<TKV>::N;        // elements per 16 bytes
  static constexpr int kRowVecs = H / kVE;
  static constexpr int kG = kRowVecs < 32 ? kRowVecs : 32;  // lanes a row
  static constexpr int kVPL = kRowVecs / kG;       // 16-byte reads a lane
  static constexpr int kEPL = kVPL * kVE;          // elements a lane
  static constexpr int kGroups = kThreads / kG;
  static constexpr int kRows = kStageBytes / (2 * H * int(sizeof(TKV)));
  static constexpr int kRPG = (kRows + kGroups - 1) / kGroups;
  // the scales of one stage: n rows widened to 4-row boundaries on both
  // sides, a multiple of 4 floats
  static __host__ __device__ int scale_floats(int rows) {
    return (rows + 6 + 3) & ~3;
  }
  static __host__ __device__ int stage_bytes(int rows, bool quant) {
    return 2 * rows * H * int(sizeof(TKV)) +
           (quant ? 2 * scale_floats(rows) * 4 : 0);
  }
};

// One cluster rank of one (sequence*head) row: attention of the row's
// query over the live columns of its span [rank*span, (rank+1)*span),
// masked to the batch row's [start, end) window clipped to [0, S), walked
// in chunks of `chunk_rows`; then rank 0 merges the ranks' partials and
// writes out[row, :].  With QUANT the cache holds int8 rows and
// k_scale/v_scale the per-(token, head) f32 scales.
template <typename TQ, typename TKV, int H, bool QUANT>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                      const TKV* __restrict__ v,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ start,
                      const int* __restrict__ end, TQ* __restrict__ out,
                      int heads, int tq, int S, int span, int chunk_rows) {
  using P = Plan<TKV, H>;
  constexpr int kG = P::kG, kVE = P::kVE, kVPL = P::kVPL, kEPL = P::kEPL;
  constexpr int kGroups = P::kGroups, kRPG = P::kRPG;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float red[kStages][kWarps];   // a chunk's max, by ring slot
  __shared__ float wacc[kWarps][H];
  __shared__ float wl[kWarps];
  // rank 0's: each rank's partial acc[H], m, l, and their arrivals
  __shared__ float inbox[kMaxCluster][H + 2];
  __shared__ __align__(8) uint64_t merged;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  // the query row (b, n, t): q and out at row * H, K/V at (b, n)
  const int row = blockIdx.x;
  const int bn = row / tq, t = row - bn * tq;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = tid / kG, lig = tid % kG;
  const float scale = 1.f / sqrtf(static_cast<float>(H));
  const int b = bn / heads;  // the window is per batch row, all heads
  const int lo = max(max(start[b], 0), rank * span);
  const int hi = min(min(end[b * tq + t], S), (rank + 1) * span);
  const int nchunks = hi > lo ? (hi - lo + chunk_rows - 1) / chunk_rows : 0;
  const int kv_bytes = chunk_rows * H * int(sizeof(TKV));
  const int sc_floats = QUANT ? P::scale_floats(chunk_rows) : 0;
  const int stage_bytes = P::stage_bytes(chunk_rows, QUANT);
  const size_t row0 = static_cast<size_t>(bn) * S;

  // thread 0 requests chunk c: its K and V rows (and their scales, widened
  // to 4-row boundaries so that both ends sit on 16 bytes; the extra
  // floats are never read, and the widened end stays inside the 16 bytes
  // that hold the tensor's last scale)
  auto request = [&](int c) {
    const int c0 = lo + c * chunk_rows;
    const int n = min(chunk_rows, hi - c0);
    unsigned char* st = ring + (c % kStages) * stage_bytes;
    uint64_t* bar = &full[c % kStages];
    const size_t g0 = row0 + c0;
    const uint32_t bytes = static_cast<uint32_t>(n) * H * sizeof(TKV);
    uint32_t tx = 2 * bytes, sbytes = 0;
    size_t a4 = 0;
    if constexpr (QUANT) {
      a4 = g0 & ~size_t(3);
      sbytes = static_cast<uint32_t>(((g0 + n + 3) & ~size_t(3)) - a4) * 4;
      tx += 2 * sbytes;
    }
    mbar_expect_tx(bar, tx);
    bulk_load(st, k + g0 * H, bytes, bar);
    bulk_load(st + kv_bytes, v + g0 * H, bytes, bar);
    if constexpr (QUANT) {
      bulk_load(st + 2 * kv_bytes, k_scale + a4, sbytes, bar);
      bulk_load(st + 2 * kv_bytes + sc_floats * 4, v_scale + a4, sbytes,
                bar);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(&merged, nrank);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(nchunks, kStages); ++c) request(c);
  }
  // this block has started, and its barriers are initialised: waited for
  // before any rank touches another's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the lane's part of q, while the rows are in flight: 16-byte vectors
  // (lig + i*kG) of the row, kVE elements each
  float qv[kEPL];
  {
    const TQ* qrow = q + static_cast<size_t>(row) * H;
    constexpr int kQN = Vec16<TQ>::N;
#pragma unroll
    for (int i = 0; i < kVPL; ++i)
#pragma unroll
      for (int p = 0; p < kVE / kQN; ++p)
        Vec16<TQ>::cvt(*reinterpret_cast<const uint4*>(
                           qrow + (lig + i * kG) * kVE + p * kQN),
                       qv + i * kVE + p * kQN);
  }
  __syncthreads();  // the barriers' initialisation, before any wait

  float m_run = kNegInf, l = 0.f;
  float acc[kEPL];
#pragma unroll
  for (int e = 0; e < kEPL; ++e) acc[e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int slot = c % kStages;
    mbar_wait(&full[slot], (c / kStages) & 1);
    const int c0 = lo + c * chunk_rows;
    const int n = min(chunk_rows, hi - c0);
    const unsigned char* st = ring + slot * stage_bytes;
    const TKV* ks = reinterpret_cast<const TKV*>(st);
    const TKV* vs = reinterpret_cast<const TKV*>(st + kv_bytes);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * kv_bytes) +
                       ((row0 + c0) & 3);
    const float* vsc = ksc + sc_floats;

    // scores of the group's rows gid + i*kGroups, kept in registers
    float s[kRPG];
    float mloc = kNegInf;
#pragma unroll
    for (int i = 0; i < kRPG; ++i) {
      const int j = gid + i * kGroups;
      float d = 0.f;
      if (j < n) {
#pragma unroll
        for (int t = 0; t < kVPL; ++t) {
          float kf[kVE];
          Vec16<TKV>::cvt(*reinterpret_cast<const uint4*>(
                              ks + static_cast<size_t>(j) * H +
                              (lig + t * kG) * kVE),
                          kf);
#pragma unroll
          for (int e = 0; e < kVE; ++e) {
            d += qv[t * kVE + e] * kf[e];
          }
        }
      }
#pragma unroll
      for (int o = kG / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      // int8: the row's scale applied to the dot product of its integers
      s[i] = j < n ? (QUANT ? d * ksc[j] : d) * scale : kNegInf;
      mloc = fmaxf(mloc, s[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
    if (lane == 0) red[slot][warp] = mloc;
    __syncthreads();
    // every thread is past chunk c-1 here: its stage takes the next chunk
    if (tid == 0 && c >= 1 && c - 1 + kStages < nchunks)
      request(c - 1 + kStages);

    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red[slot][w]);
    const float alpha = expf(m_run - m_new);  // 0 before the first chunk
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kEPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < kRPG; ++i) {
      const int j = gid + i * kGroups;
      if (j >= n) continue;
      const float p = expf(s[i] - m_new);
      l += p;
      // bf16: p rounded to V's dtype; int8: p times the row's scale
      const float pv = QUANT ? p * vsc[j] : round_p<TKV>(p);
#pragma unroll
      for (int t = 0; t < kVPL; ++t) {
        float vf[kVE];
        Vec16<TKV>::cvt(*reinterpret_cast<const uint4*>(
                            vs + static_cast<size_t>(j) * H +
                            (lig + t * kG) * kVE),
                        vf);
#pragma unroll
        for (int e = 0; e < kVE; ++e)
          acc[t * kVE + e] += pv * vf[e];
      }
    }
    m_run = m_new;
  }

  // the block's partial: the groups of a warp, then the warps, in order
#pragma unroll
  for (int o = kG; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < kEPL; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane < kG) {
#pragma unroll
    for (int t = 0; t < kVPL; ++t)
#pragma unroll
      for (int e = 0; e < kVE; ++e)
        wacc[warp][(lane + t * kG) * kVE + e] = acc[t * kVE + e];
    if (lane == 0) wl[warp] = l;
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the partial goes to rank 0's inbox, then one release arrival on rank
  // 0's barrier: the other ranks leave without waiting for the merge
  float* box = cluster.map_shared_rank(&inbox[rank][0], 0);
  for (int h = tid; h < H; h += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wacc[w][h];
    box[h] = a;
  }
  if (tid == 0) {
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lt += wl[w];
    box[H] = m_run;
    box[H + 1] = lt;
  }
  // the block's stores happen before thread 0's release arrival, which
  // rank 0's acquire wait orders before its loads
  __syncthreads();
  if (tid == 0) mbar_arrive_rank0(&merged);
  if (rank != 0) return;

  // exact merge in rank order:
  //   g = max_r m_r,  out = sum_r acc_r e^(m_r - g) / sum_r l_r e^(m_r - g)
  mbar_wait_cluster(&merged, 0);
  float wgt[kMaxCluster];
  float g = kNegInf;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < nrank) g = fmaxf(g, inbox[r][H]);
  float l_tot = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < nrank) {
      wgt[r] = expf(inbox[r][H] - g);  // an empty rank: l = 0, acc = 0
      l_tot += inbox[r][H + 1] * wgt[r];
    }
  const float l_safe = l_tot == 0.f ? 1.f : l_tot;
  for (int h = tid; h < H; h += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < nrank) a += inbox[r][h] * wgt[r];
    out[static_cast<size_t>(row) * H + h] = from_f32<TQ>(a / l_safe);
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
  void* out;
  int batch_heads, heads, tq, S, H;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int H, bool QUANT>
cudaError_t launch(const Args& a) {
  using P = Plan<TKV, H>;
  const int C = std::min(kMaxCluster, (a.S + kSplitCols - 1) / kSplitCols);
  const int span = (a.S + C - 1) / C;
  const int chunk_rows = std::min(P::kRows, span);
  const int stages =
      std::min(kStages, (span + chunk_rows - 1) / chunk_rows);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.batch_heads * a.tq, C, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  // at most 3 x 8.7 KB: under the 48 KB that needs no opt-in
  cfg.dynamicSmemBytes = stages * P::stage_bytes(chunk_rows, QUANT);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_cluster_kernel<TQ, TKV, H, QUANT>,
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.start),
      static_cast<const int*>(a.end), static_cast<TQ*>(a.out), a.heads, a.tq,
      a.S, span, chunk_rows);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_h(const Args& a) {
  if (a.S <= 0 || a.batch_heads <= 0 || a.heads <= 0 || a.tq <= 0)
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
// q and out are (B, N, tq, H) and `end` is (B, tq): query t of batch row
// b sees the columns [start[b], end[b, t]).  tq = 1 is the decode step;
// tq > 1 the speculative verify block, each query row computed exactly as
// a one-query call with that window would compute it.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* start,
                                   const void* end, void* out,
                                   int batch_heads, int heads, int tq, int S,
                                   int H, int dtype, void* stream) {
  const Args a{q,     k,   v,           nullptr, nullptr,
               start, end, out,         batch_heads, heads,
               tq,    S,   H,           static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_h<float, float, false>(a);
    case 1: return launch_h<__nv_bfloat16, __nv_bfloat16, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_decode_quant_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* start, const void* end, void* out,
    int batch_heads, int heads, int tq, int S, int H, int dtype,
    void* stream) {
  const Args a{q,     k,   v,           k_scale, v_scale,
               start, end, out,         batch_heads, heads,
               tq,    S,   H,           static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_h<float, int8_t, true>(a);
    case 1: return launch_h<__nv_bfloat16, int8_t, true>(a);
    default: return cudaErrorInvalidValue;
  }
}
