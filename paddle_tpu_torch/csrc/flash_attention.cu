// Flash attention for Hopper (sm_90a): the forward kernel and the two
// backward kernels (dQ; dK and dV), over (B, N, S, H) tensors given by
// strides, with an optional additive f32 bias and bottom-right causal
// masking.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   * `_fwd_kernel` (:67), called by `_flash_fwd_call` (pallas_call :158):
//     fwd_kernel below;
//   * `_dq_kernel` (:192) and `_dkv_kernel` (:232), called by
//     `_flash_bwd_call` (pallas_call :326 and :338): dq_kernel and
//     dkv_kernel below.  dd = rowsum(dO * O), plain XLA there (:285), is
//     one torch reduction in the wrapper.
//
// What bounds it on an H100 (SXM published peaks, 700 W power limit).
// At BERT-base (B*N = 768, S = 128, H = 64, bf16) the forward reads q,
// k, v and writes o (12.6 MB each) and lse:
// ~50.7 MB, 15.1 us at 3.35 TB/s, against 3.2 GFLOP, 3.3 us on the bf16
// tensor cores (989 TF/s): bytes bound it.  The backward moves ~89 MB
// (26.5 us) against 11.3 GFLOP (11.4 us).  This first version does its
// products with f32 FMAs out of shared memory, not on the tensor cores:
// at 67 TF/s of f32 the forward's operations alone take 48 us and the
// backward's 169 us, so it is bound by operations, some 3x and 6x above
// the bytes.  wgmma/mma.sync on bf16 tiles is the later step.
//
// What the design does about it:
//   * the TPU grid's sequential axis ("arbitrary", the k-block sweep)
//     becomes a loop inside the block.  Forward and dQ: one block per
//     (batch*head, tile of query rows) sweeping the key tiles; dK/dV: one
//     block per (batch*head, tile of key rows) sweeping the query tiles.
//     Each output is written by one block, with no atomics, so gradients
//     are deterministic;
//   * tiles of T = 64 rows (32 for H = 256 in the backward, which holds
//     four T x H tiles), converted to f32 in shared memory on load, rows
//     padded by 4 floats so that the strided row reads of a warp hit
//     distinct banks; 256 threads each own a 4x4 (2x2) block of the
//     score tile and the matching rows of the T x H accumulators, kept in
//     registers;
//   * the (S x S) score matrix never reaches device memory: scores, p and
//     ds live in registers and one T x T shared tile;
//   * causal: key tiles with no visible column are skipped (forward, dQ),
//     and query tiles whose last row sees no column of the key tile
//     (dK/dV);
//   * ragged tails: rows and columns past Sq or Sk are zero-filled on
//     load and their p set to 0, so any Sq and Sk are taken;
//   * q, k, v, dO and the outputs are addressed by (batch, head, seq)
//     strides with the head_dim contiguous, so the heads split out of a
//     (B, S, N*H) projection are read in place, and outputs written as
//     (B, S, N, H) merge back to (B, S, N*H) without a copy.
//
// Numerics follow the TPU kernels: f32 scores, softmax state and
// accumulators; the finite -1e30 causal mask; p rounded to V's dtype
// before PV (forward) and to dO's before dV, ds to K's before dQ and to
// Q's before dK; the l == 0 guard (:111-113); lse = m + log(l) in f32,
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

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* d) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* s) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) =
      __floats2bfloat162_rn(s[0], s[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) =
      __floats2bfloat162_rn(s[2], s[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// x rounded to T and back: the kernels' rounding points
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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
    case 1: return launch_h<K, __nv_bfloat16>(p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes of q, k, v, dO and every output: 0 f32, 1 bf16.  bias is
// f32 or null.
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
