// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dQ; dK and dV), over (B, N, S, H) tensors given by
// strides, with an optional additive f32 bias and bottom-right causal
// masking.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   * `_fwd_kernel` (:67), called by `_flash_fwd_call` (pallas_call :158):
//     tc::fwd_tc_kernel (bf16) and fwd_kernel (f32) below;
//   * `_dq_kernel` (:192) and `_dkv_kernel` (:232), called by
//     `_flash_bwd_call` (pallas_call :326 and :338): tc::dq_tc_kernel and
//     tc::dkv_tc_kernel (bf16), dq_kernel and dkv_kernel (f32) below.
//     dd = rowsum(dO * O), plain XLA there (:285), is one torch reduction
//     in the wrapper.
//
// What bounds it on an H100 (SXM published peaks, 700 W power limit).
// At BERT-base (B*N = 768, S = 128, H = 64, bf16) the forward reads q,
// k, v and writes o (12.6 MB each) and lse:
// ~50.7 MB, 15.1 us at 3.35 TB/s, against 3.2 GFLOP, 3.3 us on the bf16
// tensor cores (989 TF/s): bytes bound it.  The backward moves ~89 MB
// (26.5 us) against 11.3 GFLOP (11.4 us).  Two sets of kernels, chosen
// by dtype (a static dispatch, not a fallback):
//
// bf16, namespace tc: every product on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 sums), so bytes, not
// operations, bind them:
//   * blocks of 4 warps own 64 rows (query rows: forward, dQ; key rows:
//     dK/dV), each warp 16: one m16 fragment, FA2's layout;
//   * the other operand's tiles (K, V: forward, dQ; Q, dO, lse, dd:
//     dK/dV) are double-buffered in shared memory by cp.async, tile t + 1
//     in flight while tile t computes; rows past Sq or Sk are zero-filled
//     (src-size 0).  Tiles stay bf16, 16-byte chunks XOR-swizzled by row
//     so that ldmatrix reads them free of bank conflicts (the transposed
//     operands, V and K for P V and dS K, dO and Q for P^T dO and dS^T Q,
//     through ldmatrix.trans);
//   * the scores are a register fragment: the online softmax reduces a
//     row over the 4 lanes that hold it (2 shuffles), and p (forward,
//     dK/dV) or ds, rounded to bf16, are the next product's A operand as
//     they lie: the m16n8k16 accumulator layout is the A layout.  dK/dV
//     computes S^T = K Q^T and dP^T = V dO^T, keys as rows, so that P^T
//     and dS^T are A operands too;
//   * each tile's P V (dS K, P^T dO, dS^T Q) starts from zero and is added
//     to the f32 accumulator with f32 FMAs: the tensor cores' own adder
//     sums at most one tile;
//   * a bias that is one row for all queries (BERT's padding mask,
//     strides (b, 0, 0, k)) is staged with each key tile (forward, dQ) or
//     read once per key row (dK/dV); others are read element by element
//     in the ragged-edge path.  Tiles with no ragged edge and no causal
//     cut take a branch-free path (scale, bias);
//   * outputs leave through shared memory as 16-byte row pieces;
//   * steps of 32 keys (forward, dQ) or 64/16 query rows (dK/dV), and
//     column blocks of HO outputs that recompute the same scores, keep the
//     accumulators in registers unspilled up to H = 256.
//
// f32: the first version, f32 FMAs out of shared memory (67 TF/s of f32:
// the forward's operations alone take 48 us and the backward's 169 us,
// 3x and 6x above the bytes):
//   * the TPU grid's sequential axis ("arbitrary", the k-block sweep)
//     becomes a loop inside the block.  Forward and dQ: one block per
//     (batch*head, tile of query rows) sweeping the key tiles; dK/dV: one
//     block per (batch*head, tile of key rows) sweeping the query tiles.
//     Each output is written by one block, with no atomics, so gradients
//     are deterministic (both sets);
//   * tiles of T = 64 rows (32 for H = 256 in the backward, which holds
//     four T x H tiles), converted to f32 in shared memory on load, rows
//     padded by 4 floats so that the strided row reads of a warp hit
//     distinct banks; 256 threads each own a 4x4 (2x2) block of the
//     score tile and the matching rows of the T x H accumulators, kept in
//     registers;
//   * the (S x S) score matrix never reaches device memory: scores, p and
//     ds live in registers and one T x T shared tile (both sets: the tc
//     kernels keep them in registers only);
//   * causal: key tiles with no visible column are skipped (forward, dQ),
//     and query tiles whose last row sees no column of the key tile
//     (dK/dV), in both sets;
//   * ragged tails: rows and columns past Sq or Sk are zero-filled on
//     load and their p set to 0, so any Sq and Sk are taken (both sets);
//   * q, k, v, dO and the outputs are addressed by (batch, head, seq)
//     strides with the head_dim contiguous, so the heads split out of a
//     (B, S, N*H) projection are read in place, and outputs written as
//     (B, S, N, H) merge back to (B, S, N*H) without a copy (both sets;
//     the tc kernels need every stride and start 16-byte aligned and
//     refuse others: the wrapper copies such a view first).
//
// Numerics follow the TPU kernels: f32 scores, softmax state and
// accumulators; the finite -1e30 causal mask; p rounded to V's dtype
// before PV (forward) and to dO's before dV, ds to K's before dQ and to
// Q's before dK (in bf16 exactly where the tensor cores take their
// operands); the l == 0 guard (:111-113); lse = m + log(l) in f32,
// one value per row ((B*N, Sq), not replicated over 8 sublanes as Mosaic
// needed).  The bias gets no gradient.
//
// Interface: plain C, loaded with ctypes.  The caller allocates every
// buffer; each function launches on the given stream and returns
// cudaGetLastError() (0 on success).  `dims` holds, as int64:
//   [0..4]  B, N, Sq, Sk, H
//   [5..7]  q strides (batch, head, seq)      [8..10]  k strides
//   [11..13] v strides                         [14..16] dO strides
//   [17..19] o (forward) or dQ strides         [20..22] dK strides
//   [23..25] dV strides                        [26..29] bias strides
//            (batch, head, row, column; 0 where the bias broadcasts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads over a score tile
constexpr float kNegInf = -1e30f;

struct Str {
  long long b, n, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse_in;
  const float* dd;
  void* out;      // o (forward) or dQ
  void* dk;
  void* dv;
  float* lse_out;
  int N, Sq, Sk;
  Str qs, ks, vs, dos, os, dks, dvs;
  long long bb, bn, bq, bk;   // bias strides
  float scale;
  int causal;
};

__device__ __forceinline__ void load4(const float* p, float* d) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

// x rounded to T and back: the kernels' rounding points
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }

// max / sum over the 16 threads (tx = 0..15) that share a score row
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ROWS x H tile of one (batch, head) row block, rows row0.. of a
// sequence of `nvalid` rows, into f32 shared memory of row stride H + 4;
// rows past the end are zero-filled.
template <typename T, int H, int ROWS>
__device__ __forceinline__ void load_tile(float* sm, const T* base,
                                          long long ss, int row0,
                                          int nvalid) {
  constexpr int LD = H + 4;
  constexpr int VPR = H / 4;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < nvalid) load4(base + (row0 + r) * ss + c, d);
    store4(sm + r * LD + c, d);
  }
}

// the logit of (row, col) from its raw dot product: scale, bias, causal
// mask; `valid` is false past Sq or Sk
__device__ __forceinline__ float logit(const Params& p, const float* bias,
                                       float dot, int row, int col,
                                       bool valid) {
  float x = dot * p.scale;
  if (valid) {
    if (bias != nullptr) x += bias[row * p.bq + col * p.bk];
    if (p.causal && row + (p.Sk - p.Sq) < col) x = kNegInf;
  }
  return x;
}

template <typename T, int H, int TT>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(Params p) {
  constexpr int LD = H + 4, LDS = TT + 4;
  constexpr int R = TT / 16, HC = H / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // TT x LD
  float* kv_s = q_s + TT * LD;                    // TT x LD: K, then V
  float* p_s = kv_s + TT * LD;                    // TT x LDS
  const int bh = blockIdx.x, b = bh / p.N, n = bh % p.N;
  const int q0 = blockIdx.y * TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + n * p.qs.n;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + n * p.ks.n;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + n * p.vs.n;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.bb + n * p.bn;

  load_tile<T, H, TT>(q_s, qb, p.qs.s, q0, p.Sq);
  int nk = (p.Sk + TT - 1) / TT;
  if (p.causal)
    nk = min(nk, (min(q0 + TT, p.Sq) - 1 + p.Sk - p.Sq) / TT + 1);

  float m[R], l[R], acc[R][HC][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * TT;
    __syncthreads();            // the last tile's reads of kv_s, p_s
    load_tile<T, H, TT>(kv_s, kb, p.ks.s, k0, p.Sk);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    for (int h = 0; h < H; h += 4) {
      float4 a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < R; ++j)
        c[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * LD + h);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                     a[i].w * c[j].w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid = col < p.Sk && row < p.Sq;
        s[i][j] = col < p.Sk ? logit(p, bias, s[i][j], row, col, valid)
                             : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the tile's first column is < Sk, so m_new is finite
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const float pj = col < p.Sk ? expf(s[i][j] - m_new) : 0.f;
        rs += pj;
        p_s[(ty + 16 * i) * LDS + tx + 16 * j] = round_to<T>(pj);
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();            // K read, p written
    load_tile<T, H, TT>(kv_s, vb, p.vs.s, k0, p.Sk);
    __syncthreads();
    for (int c = 0; c < TT; ++c) {
      float pr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pr[i] = p_s[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int hh = 0; hh < HC; ++hh) {
        const float4 vv = *reinterpret_cast<const float4*>(
            kv_s + c * LD + tx * 4 + 64 * hh);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][hh][0] += pr[i] * vv.x;
          acc[i][hh][1] += pr[i] * vv.y;
          acc[i][hh][2] += pr[i] * vv.z;
          acc[i][hh][3] += pr[i] * vv.w;
        }
      }
    }
  }

  T* ob = static_cast<T*>(p.out) + b * p.os.b + n * p.os.n;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int hh = 0; hh < HC; ++hh) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[i][hh][e] / ls;
      store4(ob + row * p.os.s + tx * 4 + 64 * hh, o);
    }
    if (tx == 0)
      p.lse_out[static_cast<long long>(bh) * p.Sq + row] = m[i] + logf(ls);
  }
}

template <typename T, int H, int TT>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Params p) {
  constexpr int LD = H + 4, LDS = TT + 4;
  constexpr int R = TT / 16, HC = H / 64;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + TT * LD;
  float* k_s = do_s + TT * LD;
  float* v_s = k_s + TT * LD;
  float* ds_s = v_s + TT * LD;                    // TT x LDS
  const int bh = blockIdx.x, b = bh / p.N, n = bh % p.N;
  const int q0 = blockIdx.y * TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + n * p.qs.n;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + n * p.ks.n;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + n * p.vs.n;
  const T* dob = static_cast<const T*>(p.dout) + b * p.dos.b + n * p.dos.n;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.bb + n * p.bn;

  load_tile<T, H, TT>(q_s, qb, p.qs.s, q0, p.Sq);
  load_tile<T, H, TT>(do_s, dob, p.dos.s, q0, p.Sq);
  float lse[R], dd[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = static_cast<long long>(bh) * p.Sq + row;
    lse[i] = row < p.Sq ? p.lse_in[at] : 0.f;
    dd[i] = row < p.Sq ? p.dd[at] : 0.f;
  }
  int nk = (p.Sk + TT - 1) / TT;
  if (p.causal)
    nk = min(nk, (min(q0 + TT, p.Sq) - 1 + p.Sk - p.Sq) / TT + 1);

  float dq[R][HC][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][c][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * TT;
    __syncthreads();
    load_tile<T, H, TT>(k_s, kb, p.ks.s, k0, p.Sk);
    load_tile<T, H, TT>(v_s, vb, p.vs.s, k0, p.Sk);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int h = 0; h < H; h += 4) {
      float4 a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < R; ++j)
        c[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LD + h);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                     a[i].w * c[j].w;
    }
    for (int h = 0; h < H; h += 4) {
      float4 a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(do_s + (ty + 16 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < R; ++j)
        c[j] = *reinterpret_cast<const float4*>(v_s + (tx + 16 * j) * LD + h);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          dp[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                      a[i].w * c[j].w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid = col < p.Sk && row < p.Sq;
        const float x = logit(p, bias, s[i][j], row, col, valid);
        const float pij = valid ? expf(x - lse[i]) : 0.f;
        const float ds = pij * (dp[i][j] - dd[i]) * p.scale;
        ds_s[(ty + 16 * i) * LDS + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    for (int c = 0; c < TT; ++c) {
      float dr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dr[i] = ds_s[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int hh = 0; hh < HC; ++hh) {
        const float4 kk = *reinterpret_cast<const float4*>(
            k_s + c * LD + tx * 4 + 64 * hh);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dq[i][hh][0] += dr[i] * kk.x;
          dq[i][hh][1] += dr[i] * kk.y;
          dq[i][hh][2] += dr[i] * kk.z;
          dq[i][hh][3] += dr[i] * kk.w;
        }
      }
    }
  }

  T* out = static_cast<T*>(p.out) + b * p.os.b + n * p.os.n;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int hh = 0; hh < HC; ++hh)
      store4(out + row * p.os.s + tx * 4 + 64 * hh, dq[i][hh]);
  }
}

template <typename T, int H, int TT>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(Params p) {
  constexpr int LD = H + 4, LDS = TT + 4;
  constexpr int R = TT / 16, HC = H / 64;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + TT * LD;
  float* q_s = v_s + TT * LD;
  float* do_s = q_s + TT * LD;
  float* p_s = do_s + TT * LD;                    // TT x LDS, [k row][q row]
  float* ds_s = p_s + TT * LDS;
  float* lse_s = ds_s + TT * LDS;                 // TT
  float* dd_s = lse_s + TT;                       // TT
  const int bh = blockIdx.x, b = bh / p.N, n = bh % p.N;
  const int k0 = blockIdx.y * TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs.b + n * p.qs.n;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks.b + n * p.ks.n;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs.b + n * p.vs.n;
  const T* dob = static_cast<const T*>(p.dout) + b * p.dos.b + n * p.dos.n;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.bb + n * p.bn;
  const int offset = p.Sk - p.Sq;

  load_tile<T, H, TT>(k_s, kb, p.ks.s, k0, p.Sk);
  load_tile<T, H, TT>(v_s, vb, p.vs.s, k0, p.Sk);
  const int nq = (p.Sq + TT - 1) / TT;
  // causal: the first query tile whose last row sees column k0
  const int t0 = p.causal ? max(0, k0 - offset) / TT : 0;

  float dk[R][HC][4], dv[R][HC][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < HC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][c][e] = dv[i][c][e] = 0.f;

  for (int t = t0; t < nq; ++t) {
    const int q0 = t * TT;
    __syncthreads();
    load_tile<T, H, TT>(q_s, qb, p.qs.s, q0, p.Sq);
    load_tile<T, H, TT>(do_s, dob, p.dos.s, q0, p.Sq);
    if (threadIdx.x < TT) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * p.Sq + row;
      lse_s[threadIdx.x] = row < p.Sq ? p.lse_in[at] : 0.f;
      dd_s[threadIdx.x] = row < p.Sq ? p.dd[at] : 0.f;
    }
    __syncthreads();
    // transposed tiles: i runs over key rows, j over query rows
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int h = 0; h < H; h += 4) {
      float4 a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(k_s + (ty + 16 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < R; ++j)
        c[j] = *reinterpret_cast<const float4*>(q_s + (tx + 16 * j) * LD + h);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                     a[i].w * c[j].w;
    }
    for (int h = 0; h < H; h += 4) {
      float4 a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(v_s + (ty + 16 * i) * LD + h);
#pragma unroll
      for (int j = 0; j < R; ++j)
        c[j] = *reinterpret_cast<const float4*>(do_s + (tx + 16 * j) * LD + h);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          dp[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                      a[i].w * c[j].w;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qr = tx + 16 * j;
        const int row = q0 + qr;
        const bool valid = col < p.Sk && row < p.Sq;
        const float x = logit(p, bias, s[i][j], row, col, valid);
        const float pij = valid ? expf(x - lse_s[qr]) : 0.f;
        const float ds = pij * (dp[i][j] - dd_s[qr]) * p.scale;
        p_s[(ty + 16 * i) * LDS + qr] = round_to<T>(pij);
        ds_s[(ty + 16 * i) * LDS + qr] = round_to<T>(ds);
      }
    }
    __syncthreads();
    for (int c = 0; c < TT; ++c) {
      float pr[R], dr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pr[i] = p_s[(ty + 16 * i) * LDS + c];
        dr[i] = ds_s[(ty + 16 * i) * LDS + c];
      }
#pragma unroll
      for (int hh = 0; hh < HC; ++hh) {
        const float4 gv = *reinterpret_cast<const float4*>(
            do_s + c * LD + tx * 4 + 64 * hh);
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + c * LD + tx * 4 + 64 * hh);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][hh][0] += pr[i] * gv.x;
          dv[i][hh][1] += pr[i] * gv.y;
          dv[i][hh][2] += pr[i] * gv.z;
          dv[i][hh][3] += pr[i] * gv.w;
          dk[i][hh][0] += dr[i] * qv.x;
          dk[i][hh][1] += dr[i] * qv.y;
          dk[i][hh][2] += dr[i] * qv.z;
          dk[i][hh][3] += dr[i] * qv.w;
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dks.b + n * p.dks.n;
  T* dvb = static_cast<T*>(p.dv) + b * p.dvs.b + n * p.dvs.n;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int hh = 0; hh < HC; ++hh) {
      store4(dkb + row * p.dks.s + tx * 4 + 64 * hh, dk[i][hh]);
      store4(dvb + row * p.dvs.s + tx * 4 + 64 * hh, dv[i][hh]);
    }
  }
}

enum Kind { kFwd, kDq, kDkv };

// the backward holds four T x H tiles: 32 rows at H = 256 keeps them
// inside the 227 KB a block may use
template <int H>
constexpr int bwd_tile() { return H == 256 ? 32 : 64; }

template <Kind K, int H, int TT>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (K == kFwd ? 2 * TT * (H + 4) + TT * (TT + 4)
          : K == kDq ? 4 * TT * (H + 4) + TT * (TT + 4)
                     : 4 * TT * (H + 4) + 2 * TT * (TT + 4) + 2 * TT);
}

template <Kind K, typename T, int H>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int TT = K == kFwd ? 64 : bwd_tile<H>();
  constexpr size_t smem = smem_bytes<K, H, TT>();
  void (*kern)(Params);
  if constexpr (K == kFwd)
    kern = fwd_kernel<T, H, TT>;
  else if constexpr (K == kDq)
    kern = dq_kernel<T, H, TT>;
  else
    kern = dkv_kernel<T, H, TT>;
  // once per kernel instance (and so never inside a CUDA-graph capture
  // after the first eager call)
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int rows = K == kDkv ? p.Sk : p.Sq;
  const dim3 grid(B * p.N, (rows + TT - 1) / TT);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <Kind K, typename T>
cudaError_t launch_h(const Params& p, int B, int H, cudaStream_t stream) {
  switch (H) {
    case 64: return launch<K, T, 64>(p, B, stream);
    case 128: return launch<K, T, 128>(p, B, stream);
    case 256: return launch<K, T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // a block's own rows, 16 a warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; with ok false nothing is read and the
// destination is zero-filled (src-size 0)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32.  Lane
// (g = lane / 4, c = lane % 4) holds d[0..1] at row g, columns 2c, 2c + 1
// and d[2..3] at row g + 8; a[0..3] rows (g, g + 8) x columns (2c, 2c + 8)
// in that order, two bf16 a register; b[0..1] rows 2c and 2c + 8 of
// column g.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (the kernels' rounding points), lo in the low
// half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a shared tile of rows of H
// bf16.  The chunk index is XORed with r mod 8, so the 8 rows that one
// ldmatrix matrix (or one cp.async row) touches at one logical chunk lie
// in 8 distinct groups of 4 banks.
template <int H>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return static_cast<uint32_t>(r * (2 * H) + ((c ^ (r & 7)) << 4));
}

// R rows of H bf16, rows row0.. of a sequence of `nvalid` rows with row
// stride ss, into a swizzled tile by cp.async; rows past the end are
// zero-filled
template <int H, int R>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* base,
                                          long long ss, int row0,
                                          int nvalid) {
  constexpr int C = H / 8;
  static_assert(R * C % kTcThreads == 0, "whole passes of the block");
#pragma unroll
  for (int it = 0; it < R * C / kTcThreads; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = i / C, c = i % C;
    const bool ok = row0 + r < nvalid;
    cp16(tile + sw<H>(r, c), ok ? base + (row0 + r) * ss + 8 * c : base, ok);
  }
}

// A operand (rows r0..r0 + 15, k step kk) of a tile
template <int H>
__device__ __forceinline__ void lda(uint32_t (&a)[4], uint32_t tile, int r0,
                                    int kk, int lane) {
  ldsm4(a, tile + sw<H>(r0 + (lane & 7) + (lane & 8), 2 * kk + (lane >> 4)));
}

// B operands of the n8 tiles n0/8 and n0/8 + 1 at k step kk, from a tile
// whose rows are B's columns (K for Q K^T, V for dO V^T, Q and dO for the
// transposed products): b[0..1] for rows n0.., b[2..3] for n0 + 8..
template <int H>
__device__ __forceinline__ void ldb(uint32_t (&b)[4], uint32_t tile, int n0,
                                    int kk, int lane) {
  ldsm4(b, tile + sw<H>(n0 + (lane & 7) + ((lane >> 4) << 3),
                        2 * kk + ((lane >> 3) & 1)));
}

// B operands of the n8 tiles c and c + 1 (chunks) at the k rows k0..k0 +
// 15 of a tile whose rows are B's rows (V for P V, K for dS K, dO and Q
// for P^T dO and dS^T Q), transposed by ldmatrix
template <int H>
__device__ __forceinline__ void ldbt(uint32_t (&b)[4], uint32_t tile, int k0,
                                     int c, int lane) {
  ldsm4t(b, tile + sw<H>(k0 + (lane & 7) + (lane & 8), c + (lane >> 4)));
}

// s (16 x 8NT, f32) = rows r0.. of tile a times the first 8NT rows of
// tile b, transposed, over the depth H
template <int H, int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], uint32_t a_tile,
                                   int r0, uint32_t b_tile, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t a[4];
    lda<H>(a, a_tile, r0, kk, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldb<H>(b, b_tile, 8 * j, kk, lane);
      mma(s[j], a, b[0], b[1]);
      mma(s[j + 1], a, b[2], b[3]);
    }
  }
}

// The f32 fragment s (16 x 16KS) rounded to bf16 as KS A operands: the
// m16n8k16 accumulator of n8 tiles 2kk and 2kk + 1 is, element for
// element, the A operand of k step kk
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4],
                                     const float (&s)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc (16 x 8NO, f32) = acc * alpha (per row) + a b, with a the KS A
// operands in registers and b rows 0..16KS of a tile, at chunks c0...
// Each tile's product starts from zero and is added with f32 FMAs, so
// the tensor cores' adder sums at most 16KS terms.
template <int H, int KS, int NO>
__device__ __forceinline__ void pv(float (&acc)[NO][4],
                                   const uint32_t (&a)[KS][4],
                                   uint32_t b_tile, int c0,
                                   const float (&alpha)[2], int lane) {
#pragma unroll
  for (int j = 0; j < NO; j += 2) {
    float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];
      ldbt<H>(b, b_tile, 16 * kk, c0 + j, lane);
      mma(o0, a[kk], b[0], b[1]);
      mma(o1, a[kk], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = acc[j][e] * alpha[e >> 1] + o0[e];
      acc[j + 1][e] = acc[j + 1][e] * alpha[e >> 1] + o1[e];
    }
  }
}

// The warp's fragment acc (16 x 8NO) times mul (per row), rounded to
// bf16, stored to global rows row0.. (those < nvalid) of `out` (row
// stride os): staged through the warp's own rows r0..r0 + 15 of a tile,
// which no other warp reads, and written as 16-byte row pieces
template <int H, int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4],
                                           const float (&mul)[2],
                                           uint32_t tile, int r0, bf16* out,
                                           long long os, int row0,
                                           int nvalid, int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      sts32(tile + sw<H>(r0 + g + 8 * i, j) + 4 * c,
            pack(acc[j][2 * i] * mul[i], acc[j][2 * i + 1] * mul[i]));
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * NO / 32; ++it) {
    const int x = lane + 32 * it, r = x / NO, ch = x % NO;
    if (row0 + r < nvalid)
      *reinterpret_cast<uint4*>(out + (row0 + r) * os + 8 * ch) =
          lds128(tile + sw<H>(r0 + r, ch));
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// e^x for a difference of logits x <= 0, as 2^(x log2 e) (one MUFU.EX2
// and its range fix-up): the product rounds relative to x, so where p is
// not negligible (x > -20) its relative error stays near 1e-6, far
// below the bf16 step it is rounded to
__device__ __forceinline__ float exp_(float x) { return exp2f(x * kLog2e); }

// N f32 of a row, src[(i0 + i) * stride] for i < N, into shared memory
// by cp.async; past `nvalid` zero-filled
template <int N>
__device__ __forceinline__ void load_row(uint32_t dst, const float* src,
                                         long long stride, int i0,
                                         int nvalid) {
  static_assert(N <= kTcThreads, "one element a thread");
  const int i = threadIdx.x;
  if (i < N) {
    const bool ok = i0 + i < nvalid;
    cp4(dst + 4 * i, ok ? src + (i0 + i) * stride : src, ok);
  }
}

// x = f(x, i, cc) over a score fragment: i = 0, 1 for its rows g, g + 8,
// cc its column in the tile.  Each caller's f is branch-free where it
// can be, so the unrolled loop is straight-line code.
template <int NT, class F>
__device__ __forceinline__ void map(float (&s)[NT][4], int c, F f) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        s[j][2 * i + e] = f(s[j][2 * i + e], i, 8 * j + 2 * c + e);
}

// The logits of a (query rows) x (key tile at k0) fragment, in place,
// as logit() gives them and -inf past Sk.  An interior tile (every
// column < Sk and, causal, visible to the block's first row q0) with no
// bias or a bias row staged in shared memory (brow_s, else null) takes
// the scale and the bias only.
template <int NT>
__device__ __forceinline__ void logits_q(float (&s)[NT][4], const Params& p,
                                         const float* bias,
                                         const float* brow_s, int k0,
                                         int q0, const int (&row)[2],
                                         int c) {
  const bool interior = k0 + 8 * NT <= p.Sk &&
                        !(p.causal && q0 + (p.Sk - p.Sq) < k0 + 8 * NT - 1);
  const float scale = p.scale;
  if (interior && brow_s != nullptr)
    map<NT>(s, c, [&](float x, int, int cc) { return x * scale + brow_s[cc]; });
  else if (interior && bias == nullptr)
    map<NT>(s, c, [&](float x, int, int) { return x * scale; });
  else
    map<NT>(s, c, [&](float x, int i, int cc) {
      const int col = k0 + cc;
      return col < p.Sk ? logit(p, bias, x, row[i], col, row[i] < p.Sq)
                        : -INFINITY;
    });
}

// Forward.  One block of 4 warps per (batch*head, 64 query rows, HO of
// the H output columns), each warp 16 rows; key tiles of BK rows (K, V
// and, for a bias that is one row for all queries, its row)
// double-buffered by cp.async.  With HO < H each column block computes
// the same scores and softmax state; the first writes lse.
template <int H, int BK, int HO>
__global__ void __launch_bounds__(kTcThreads, H == 64 ? 4 : 1)
    fwd_tc_kernel(Params p) {
  constexpr int NT = BK / 8, NO = HO / 8;
  constexpr uint32_t QB = kRows * H * 2, KB = BK * H * 2;
  constexpr uint32_t STAGE = 2 * KB + BK * 4;      // K, V, bias row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t q_s = smem_u32(tc_smem);
  const int bh = blockIdx.x, b = bh / p.N, n = bh % p.N;
  const int q0 = blockIdx.y * kRows, h0 = blockIdx.z * HO;
  const int lane = threadIdx.x & 31, wr = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qs.b + n * p.qs.n;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ks.b + n * p.ks.n;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vs.b + n * p.vs.n;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.bb + n * p.bn;
  const bool brow = bias != nullptr && p.bq == 0;  // BERT's padding mask
  auto stage = [&](int t) { return QB + (t & 1) * STAGE; };
  auto load_kv = [&](int t) {
    const uint32_t at = q_s + stage(t);
    load_tile<H, BK>(at, kb, p.ks.s, t * BK, p.Sk);
    load_tile<H, BK>(at + KB, vb, p.vs.s, t * BK, p.Sk);
    if (brow) load_row<BK>(at + 2 * KB, bias, p.bk, t * BK, p.Sk);
  };

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal)
    nk = min(nk, (min(q0 + kRows, p.Sq) - 1 + p.Sk - p.Sq) / BK + 1);
  load_tile<H, kRows>(q_s, qb, p.qs.s, q0, p.Sq);
  load_kv(0);
  cp_commit();

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {           // tile t + 1 loads while tile t computes
      load_kv(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    const float* brow_s =
        brow ? reinterpret_cast<const float*>(tc_smem + stage(t) + 2 * KB)
             : nullptr;
    float s[NT][4];
    qk<H, NT>(s, q_s, wr, q_s + stage(t), lane);
    logits_q(s, p, bias, brow_s, k0, q0, row, c);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      // the 4 lanes of a quad hold the row's columns
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // the tile's first column is < Sk, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = exp_(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pj = exp_(s[j][2 * i + e] - m_new);  // 0 past Sk
          rs += pj;
          s[j][2 * i + e] = pj;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = alpha[i] * l[i] + rs;
      m[i] = m_new;
    }
    uint32_t pa[NT / 2][4];     // p rounded to bf16 before P V
    to_a<NT>(pa, s);
    pv<H, NT / 2, NO>(acc, pa, q_s + stage(t) + KB, h0 / 8, alpha, lane);
    __syncthreads();            // stage t & 1 is refilled at t + 2
  }

  const float ls[2] = {l[0] == 0.f ? 1.f : l[0], l[1] == 0.f ? 1.f : l[1]};
  const float inv[2] = {1.f / ls[0], 1.f / ls[1]};
  bf16* ob = static_cast<bf16*>(p.out) + b * p.os.b + n * p.os.n + h0;
  store_rows<H, NO>(acc, inv, q_s, wr, ob, p.os.s, q0 + wr, p.Sq, lane);
  if (c == 0 && h0 == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.Sq)
        p.lse_out[static_cast<long long>(bh) * p.Sq + row[i]] =
            m[i] + logf(ls[i]);
}

// dQ.  One block per (batch*head, 64 query rows, HO of the H columns),
// each warp 16 rows; key tiles of BK rows (K, V, a one-row bias)
// double-buffered by cp.async.
template <int H, int BK, int HO>
__global__ void __launch_bounds__(kTcThreads, H == 64 ? 4 : 1)
    dq_tc_kernel(Params p) {
  constexpr int NT = BK / 8, NO = HO / 8;
  constexpr uint32_t QB = kRows * H * 2, KB = BK * H * 2;
  constexpr uint32_t STAGE = 2 * KB + BK * 4;      // K, V, bias row
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t q_s = smem_u32(tc_smem), do_s = q_s + QB;
  const int bh = blockIdx.x, b = bh / p.N, n = bh % p.N;
  const int q0 = blockIdx.y * kRows, h0 = blockIdx.z * HO;
  const int lane = threadIdx.x & 31, wr = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qs.b + n * p.qs.n;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ks.b + n * p.ks.n;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vs.b + n * p.vs.n;
  const bf16* dob =
      static_cast<const bf16*>(p.dout) + b * p.dos.b + n * p.dos.n;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.bb + n * p.bn;
  const bool brow = bias != nullptr && p.bq == 0;
  auto stage = [&](int t) { return 2 * QB + (t & 1) * STAGE; };
  auto load_kv = [&](int t) {
    const uint32_t at = q_s + stage(t);
    load_tile<H, BK>(at, kb, p.ks.s, t * BK, p.Sk);
    load_tile<H, BK>(at + KB, vb, p.vs.s, t * BK, p.Sk);
    if (brow) load_row<BK>(at + 2 * KB, bias, p.bk, t * BK, p.Sk);
  };

  int nk = (p.Sk + BK - 1) / BK;
  if (p.causal)
    nk = min(nk, (min(q0 + kRows, p.Sq) - 1 + p.Sk - p.Sq) / BK + 1);
  load_tile<H, kRows>(q_s, qb, p.qs.s, q0, p.Sq);
  load_tile<H, kRows>(do_s, dob, p.dos.s, q0, p.Sq);
  load_kv(0);
  cp_commit();

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long at = static_cast<long long>(bh) * p.Sq + row[i];
    lse[i] = row[i] < p.Sq ? p.lse_in[at] : 0.f;
    dd[i] = row[i] < p.Sq ? p.dd[at] : 0.f;
  }
  const float one[2] = {1.f, 1.f};
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load_kv(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    const uint32_t kt = q_s + stage(t);
    const float* brow_s =
        brow ? reinterpret_cast<const float*>(tc_smem + stage(t) + 2 * KB)
             : nullptr;
    float s[NT][4], dp[NT][4];
    qk<H, NT>(s, q_s, wr, kt, lane);
    qk<H, NT>(dp, do_s, wr, kt + KB, lane);
    // p is 0 past Sk (logit -inf); rows past Sq are computed but not
    // stored
    logits_q(s, p, bias, brow_s, k0, q0, row, c);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pij = exp_(s[j][2 * i + e] - lse[i]);
          s[j][2 * i + e] = pij * (dp[j][2 * i + e] - dd[i]) * p.scale;
        }
    uint32_t da[NT / 2][4];     // ds rounded to bf16 before dS K
    to_a<NT>(da, s);
    pv<H, NT / 2, NO>(dq, da, kt, h0 / 8, one, lane);
    __syncthreads();
  }
  bf16* out = static_cast<bf16*>(p.out) + b * p.os.b + n * p.os.n + h0;
  store_rows<H, NO>(dq, one, q_s, wr, out, p.os.s, q0 + wr, p.Sq, lane);
}

// dK and dV.  One block per (batch*head, 64 key rows, HO of the H output
// columns), each warp 16 key rows; query tiles of BQ rows (Q, dO, lse,
// dd) double-buffered by cp.async.  The scores are computed transposed,
// keys as the fragment's rows, so P^T and dS^T are A operands in
// registers.
template <int H, int BQ, int HO>
__global__ void __launch_bounds__(kTcThreads) dkv_tc_kernel(Params p) {
  constexpr int NT = BQ / 8, NO = HO / 8;
  constexpr uint32_t KB = kRows * H * 2, QB = BQ * H * 2;
  constexpr uint32_t STAGE = 2 * QB + 2 * BQ * 4;   // Q, dO, lse, dd
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t k_s = smem_u32(tc_smem), v_s = k_s + KB;
  const int bh = blockIdx.x, b = bh / p.N, n = bh % p.N;
  const int k0 = blockIdx.y * kRows, h0 = blockIdx.z * HO;
  const int lane = threadIdx.x & 31, wr = 16 * (threadIdx.x >> 5);
  const int g = lane >> 2, c = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.qs.b + n * p.qs.n;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.ks.b + n * p.ks.n;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.vs.b + n * p.vs.n;
  const bf16* dob =
      static_cast<const bf16*>(p.dout) + b * p.dos.b + n * p.dos.n;
  const float* bias =
      p.bias == nullptr ? nullptr : p.bias + b * p.bb + n * p.bn;
  const int offset = p.Sk - p.Sq;
  const int nq = (p.Sq + BQ - 1) / BQ;
  // causal: the first query tile whose last row sees column k0
  const int t0 = p.causal ? max(0, k0 - offset) / BQ : 0;
  auto stage = [&](int t) { return 2 * KB + ((t - t0) & 1) * STAGE; };
  auto load_q = [&](int t) {
    const uint32_t at = k_s + stage(t);
    const long long row0 = static_cast<long long>(bh) * p.Sq;
    load_tile<H, BQ>(at, qb, p.qs.s, t * BQ, p.Sq);
    load_tile<H, BQ>(at + QB, dob, p.dos.s, t * BQ, p.Sq);
    load_row<BQ>(at + 2 * QB, p.lse_in + row0, 1, t * BQ, p.Sq);
    load_row<BQ>(at + 2 * QB + 4 * BQ, p.dd + row0, 1, t * BQ, p.Sq);
  };

  load_tile<H, kRows>(k_s, kb, p.ks.s, k0, p.Sk);
  load_tile<H, kRows>(v_s, vb, p.vs.s, k0, p.Sk);
  load_q(t0);
  cp_commit();

  // the thread's key rows and, for a bias that is one row for all
  // queries (bq == 0: BERT's padding mask), their bias values
  const int kr[2] = {k0 + wr + g, k0 + wr + g + 8};
  float kbias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kbias[i] = bias != nullptr && kr[i] < p.Sk ? bias[kr[i] * p.bk] : 0.f;
  const float one[2] = {1.f, 1.f};
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int t = t0; t < nq; ++t) {
    if (t + 1 < nq) {
      load_q(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t qs = k_s + stage(t), dos = qs + QB;
    const float* lse =
        reinterpret_cast<const float*>(tc_smem + stage(t) + 2 * QB);
    const float* dd = lse + BQ;
    const int q0 = t * BQ;
    float st[NT][4], dpt[NT][4];   // S^T, dP^T: key rows x query columns
    qk<H, NT>(st, k_s, wr, qs, lane);
    qk<H, NT>(dpt, v_s, wr, dos, lane);
    // logits, -inf past Sq (p = 0); key rows past Sk are not stored.
    // Every query row < Sq, every key < Sk and, causal, every key visible
    // to the tile's first query row, with no bias or a bias row: the
    // scale and the bias only
    const bool interior = q0 + BQ <= p.Sq && k0 + kRows <= p.Sk &&
                          !(p.causal && q0 + offset < k0 + kRows - 1);
    const float scale = p.scale;
    if (interior && (bias == nullptr || p.bq == 0))
      map<NT>(st, c, [&](float x, int i, int) { return x * scale + kbias[i]; });
    else
      map<NT>(st, c, [&](float x, int i, int qc) {
        const int q = q0 + qc;
        return q < p.Sq ? logit(p, bias, x, q, kr[i], kr[i] < p.Sk)
                        : -INFINITY;
      });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * j + 2 * c + e;
          const float pt = exp_(st[j][2 * i + e] - lse[qi]);
          st[j][2 * i + e] = pt;
          dpt[j][2 * i + e] = pt * (dpt[j][2 * i + e] - dd[qi]) * scale;
        }
    uint32_t pa[NT / 2][4], da[NT / 2][4];   // p, ds rounded to bf16
    to_a<NT>(pa, st);
    to_a<NT>(da, dpt);
    pv<H, NT / 2, NO>(dv, pa, dos, h0 / 8, one, lane);
    pv<H, NT / 2, NO>(dk, da, qs, h0 / 8, one, lane);
    __syncthreads();
  }
  bf16* dkb = static_cast<bf16*>(p.dk) + b * p.dks.b + n * p.dks.n + h0;
  bf16* dvb = static_cast<bf16*>(p.dv) + b * p.dvs.b + n * p.dvs.n + h0;
  store_rows<H, NO>(dk, one, k_s, wr, dkb, p.dks.s, k0 + wr, p.Sk, lane);
  store_rows<H, NO>(dv, one, v_s, wr, dvb, p.dvs.s, k0 + wr, p.Sk, lane);
}

// 16-byte rows: the tile copies and the output stores are 16 bytes wide
bool rows16(const void* ptr, const Str& s) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % 8 == 0 &&
         s.n % 8 == 0 && s.s % 8 == 0;
}

template <Kind K, int H>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  // fwd, dQ: keys a step; dK/dV: query rows a step; all: output columns
  // a block.  Column blocks (HO < H) recompute the same scores; with
  // them and the smaller steps past H = 64, the f32 accumulators (16 x HO
  // a warp, two of them in dK/dV) and the scores stay in registers,
  // unspilled (ptxas -v).
  constexpr int BK = 32;
  constexpr int BQ = H == 64 ? 64 : 16;
  constexpr int HO = K == kDkv ? 64 : (H == 64 ? 64 : 128);
  constexpr size_t own = kRows * H * 2;
  constexpr size_t smem =
      K == kFwd  ? own + 2 * (2 * BK * H * 2 + BK * 4)
      : K == kDq ? 2 * own + 2 * (2 * BK * H * 2 + BK * 4)
                 : 2 * own + 2 * (2 * BQ * H * 2 + 2 * BQ * 4);
  void (*kern)(Params);
  if constexpr (K == kFwd)
    kern = fwd_tc_kernel<H, BK, HO>;
  else if constexpr (K == kDq)
    kern = dq_tc_kernel<H, BK, HO>;
  else
    kern = dkv_tc_kernel<H, BQ, HO>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int rows = K == kDkv ? p.Sk : p.Sq;
  const dim3 grid(B * p.N, (rows + kRows - 1) / kRows, H / HO);
  kern<<<grid, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <Kind K>
cudaError_t launch_h(const Params& p, int B, int H, cudaStream_t stream) {
  // the wrapper copies a misaligned view; one that reaches here is refused
  if (!rows16(p.q, p.qs) || !rows16(p.k, p.ks) || !rows16(p.v, p.vs) ||
      !rows16(p.dout, p.dos) || !rows16(p.out, p.os) ||
      !rows16(p.dk, p.dks) || !rows16(p.dv, p.dvs))
    return cudaErrorMisalignedAddress;
  switch (H) {
    case 64: return launch<K, 64>(p, B, stream);
    case 128: return launch<K, 128>(p, B, stream);
    case 256: return launch<K, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

template <Kind K>
int run(Params p, const long long* d, int dtype, void* stream) {
  const int B = static_cast<int>(d[0]), H = static_cast<int>(d[4]);
  p.N = static_cast<int>(d[1]);
  p.Sq = static_cast<int>(d[2]);
  p.Sk = static_cast<int>(d[3]);
  if (B <= 0 || p.N <= 0 || p.Sq <= 0 || p.Sk <= 0)
    return cudaErrorInvalidValue;
  p.qs = Str{d[5], d[6], d[7]};
  p.ks = Str{d[8], d[9], d[10]};
  p.vs = Str{d[11], d[12], d[13]};
  p.dos = Str{d[14], d[15], d[16]};
  p.os = Str{d[17], d[18], d[19]};
  p.dks = Str{d[20], d[21], d[22]};
  p.dvs = Str{d[23], d[24], d[25]};
  p.bb = d[26];
  p.bn = d[27];
  p.bq = d[28];
  p.bk = d[29];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_h<K, float>(p, B, H, s);
    case 1: return tc::launch_h<K>(p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes of q, k, v, dO and every output: 0 f32 (the FMA kernels),
// 1 bf16 (the tensor-core kernels, which return cudaErrorMisalignedAddress
// without launching for a start or stride that is not 16-byte aligned).
// bias is f32 or null.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     void* o, void* lse,
                                     const long long* dims, float scale,
                                     int causal, int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = o;
  p.lse_out = static_cast<float*>(lse);
  p.scale = scale;
  p.causal = causal;
  return run<kFwd>(p, dims, dtype, stream);
}

extern "C" int flash_attn_dq_launch(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    const void* dout, const void* lse,
                                    const void* dd, void* dq,
                                    const long long* dims, float scale,
                                    int causal, int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.out = dq;
  p.scale = scale;
  p.causal = causal;
  return run<kDq>(p, dims, dtype, stream);
}

extern "C" int flash_attn_dkv_launch(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* dout, const void* lse,
                                     const void* dd, void* dk, void* dv,
                                     const long long* dims, float scale,
                                     int causal, int dtype, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.dout = dout;
  p.lse_in = static_cast<const float*>(lse);
  p.dd = static_cast<const float*>(dd);
  p.dk = dk;
  p.dv = dv;
  p.scale = scale;
  p.causal = causal;
  return run<kDkv>(p, dims, dtype, stream);
}
