// The backward of non-causal multi-head attention,
//
//   o = softmax(scale * q k^T) v        (keys at or past T masked)
//
// given the forward's output o, its row logsumexp lse (natural log of the
// scaled scores, f32, written by the forward of csrc/attention.cu) and the
// output's cotangent do:
//
//   p    = exp(scale * q k^T - lse)      recomputed per tile, never stored
//   dv   = p^T do
//   dp   = do v^T
//   ds   = p * (dp - delta),  delta = rowsum(do * o)
//   dq   = scale * ds k,  dk = scale * ds^T q
//
// Replaces the TPU backward kernels that the JAX package's `mha` takes its
// gradients through: for K9 (`_flash`) the library's flash-attention
// backward (`jax/experimental/pallas/ops/tpu/flash_attention.py:254`, its
// `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` kernels), and
// for K10 (`_splash`, q pre-scaled) the splash backward
// (`splash_attention_kernel.py:2241`, `_bwd_dq` and `_bwd_dkv`).  Splash's
// q is pre-scaled, so the splash form runs this kernel at scale 1 and the
// scale reaches q's gradient through the pre-scaling product.
//
// Design (the FlashAttention-2 order, no atomics, so the result does not
// vary from run to run):
//
// * `delta_kernel`: the pre-pass, delta = rowsum(do * o) in f32, one warp a
//   row.
// * `dkdv_*`: a block owns a tile of keys and loops over every query tile,
//   accumulating dk and dv in registers (f32).
// * `dq_*`: a block owns a tile of queries and loops over every key tile,
//   accumulating dq in registers.
//
// bfloat16 (`*_bf16`): 4 warps, each 16 rows of the block's 64 as mma
// fragments (mma.sync m16n8k16, bf16 in, f32 accumulate), the other side's
// 64-row tiles through shared memory by cp.async.  p and ds are rounded to
// bf16 for the products that take them as operands, as the forward rounds
// p.  The head dim D is a template parameter (16, 32, 64, 72): reductions
// over D run over D rounded up to 16 with zero pad columns, products with D
// as their n dimension take it in tiles of 8 (72 = 9 x 8), as the forward.
//
// float32 (`*_f32`): plain f32 FMAs on 32-row tiles in shared memory,
// 128 threads, each owning a quarter of one row of the accumulators: the
// checking path (f32 training of the small models, the gradient checks);
// its speed is not the point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(bf x) { return __bfloat162float(x); }

__device__ __forceinline__ void st2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void st2(bf* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- the pre-pass ---------------------------------------------------------

// delta[bh * T + i] = sum_c do[b, h, i, c] * o[b, h, i, c] in f32; one warp
// a row, 8 rows a block
template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long o_b, long long o_h,
             long long o_t, long long d_b, long long d_h, long long d_t,
             int H, int Tlen, int D, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / Tlen;
  const long long i = row % Tlen;
  const long long b = bh / H, h = bh % H;
  const T* op = o + b * o_b + h * o_h + i * o_t;
  const T* dp = dout + b * d_b + h * d_h + i * d_t;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += tof(op[c]) * tof(dp[c]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) delta[row] = s;
}

// ---- bfloat16: tensor cores -----------------------------------------------

constexpr int BT = 64;       // rows of a block's own tile and of the looped tiles
constexpr int NTHR = 128;    // 4 warps x 16 rows

template <int D>
struct Geom {
  static constexpr int DK = (D + 15) / 16 * 16;  // reductions over D, zero-padded
  static constexpr int NK = DK / 16;             // their k16 steps
  static constexpr int NV = D / 8;               // n8 tiles of a D-wide product
  static constexpr int SK = DK + 8;              // row stride: no ldmatrix bank conflicts
  static constexpr int CH = D / 8;               // 16-byte chunks per row
};

// rows [r0, r0 + BT) of a [T, D] slice with row stride st into a shared
// tile [BT][SK]; rows at or past T land as zeros
template <int D>
__device__ __forceinline__ void load_tile(bf* dst, const bf* src, long long st,
                                          int r0, int Tlen, int tid) {
  using G = Geom<D>;
  for (int c = tid; c < BT * G::CH; c += NTHR) {
    const int r = c / G::CH, cc = (c % G::CH) * 8, row = r0 + r;
    const bool ok = row < Tlen;
    cp_async16(dst + r * G::SK + cc, src + (long long)(ok ? row : 0) * st + cc,
               ok ? 16 : 0);
  }
}

// the pad columns D..DK of n tiles [BT][SK], which no copy writes
template <int D>
__device__ __forceinline__ void zero_pads(bf* tiles, int n, int tid) {
  using G = Geom<D>;
  if constexpr (G::DK > D) {
    constexpr int PAD = G::DK - D;
    for (int i = tid; i < n * BT * PAD; i += NTHR)
      tiles[(i / PAD) * G::SK + D + i % PAD] = __float2bfloat16(0.f);
  }
}

// s += A B^T over D for the warp's 16 rows of A (a [BT][SK] tile, rows
// warp*16..) against the 64 rows of B (8 n8 tiles of rows)
template <int D>
__device__ __forceinline__ void rows_dot_tile(float (&s)[8][4], const bf* A,
                                              const bf* B, int lane) {
  using G = Geom<D>;
#pragma unroll
  for (int kk = 0; kk < G::NK; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * G::SK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // matrices: (rows +0, cols +0), (rows +0, cols +8), (rows +8, cols
      // +0), (rows +8, cols +8) -> B fragments of n8 tiles 2np, 2np+1
      const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int kc = kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t r[4];
      ldsm_x4(r, B + kr * G::SK + kc);
      mma_bf16(s[2 * np], a, r[0], r[1]);
      mma_bf16(s[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// acc += X Y for X the warp's [16 x 64] accumulator tiles x (8 n8 tiles,
// rounded to bf16) and Y a [BT][SK] tile ([64 x D])
template <int D>
__device__ __forceinline__ void tile_times(float (&acc)[Geom<D>::NV][4],
                                           const float (&x)[8][4], const bf* Y,
                                           int lane) {
  using G = Geom<D>;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * ks][0], x[2 * ks][1]),
                           pack_bf16x2(x[2 * ks][2], x[2 * ks][3]),
                           pack_bf16x2(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                           pack_bf16x2(x[2 * ks + 1][2], x[2 * ks + 1][3])};
    const bf* yrow = Y + (ks * 16 + (lane & 15)) * G::SK;
#pragma unroll
    for (int np = 0; np < G::NV / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, yrow + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a, r[0], r[1]);
      mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
    }
    if (G::NV % 2) {  // the odd last n8 tile (D = 72)
      constexpr int nl = G::NV - 1;
      uint32_t r0, r1;
      ldsm_x2_trans(r0, r1, yrow + nl * 8);
      mma_bf16(acc[nl], a, r0, r1);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  long long s_b, s_h, s_t;  // q, k, v
  long long o_b, o_h, o_t;  // o
  long long d_b, d_h, d_t;  // do
  long long g_b, g_h, g_t;  // dq, dk, dv
  int B, H, Tlen;
  float scale;
};

// a block: keys [kv0, kv0 + 64) of one (batch, head); each warp 16 keys
template <int D>
__global__ void __launch_bounds__(NTHR, 1) dkdv_bf16(BwdArgs a) {
  using G = Geom<D>;
  constexpr int SK = G::SK;
  __shared__ __align__(16) bf tiles[4][BT * SK];  // K, V, Q, dO
  __shared__ float Ls[BT], Dl[BT];
  bf* Ks = tiles[0];
  bf* Vs = tiles[1];
  bf* Qs = tiles[2];
  bf* Ds = tiles[3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T = a.Tlen;
  const long long in_off = (long long)b * a.s_b + (long long)h * a.s_h;
  const bf* qb = static_cast<const bf*>(a.q) + in_off;
  const bf* db = static_cast<const bf*>(a.dout) + (long long)b * a.d_b +
                 (long long)h * a.d_h;
  const float* lse = a.lse + (long long)bh * T;
  const float* dl = a.delta + (long long)bh * T;
  const float scale_log2 = a.scale * LOG2E;
  const int kv0 = blockIdx.x * BT;

  zero_pads<D>(&tiles[0][0], 4, tid);
  load_tile<D>(Ks, static_cast<const bf*>(a.k) + in_off, a.s_t, kv0, T, tid);
  load_tile<D>(Vs, static_cast<const bf*>(a.v) + in_off, a.s_t, kv0, T, tid);
  cp_async_commit();

  float dka[G::NV][4], dva[G::NV][4];
#pragma unroll
  for (int n = 0; n < G::NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const bf* Kw = Ks + warp * 16 * SK;
  const bf* Vw = Vs + warp * 16 * SK;
  for (int q0 = 0; q0 < T; q0 += BT) {
    __syncthreads();  // the previous query tile is no longer read
    load_tile<D>(Qs, qb, a.s_t, q0, T, tid);
    load_tile<D>(Ds, db, a.d_t, q0, T, tid);
    cp_async_commit();
    for (int r = tid; r < BT; r += NTHR) {
      const bool ok = q0 + r < T;
      Ls[r] = ok ? lse[q0 + r] * LOG2E : 0.f;
      Dl[r] = ok ? dl[q0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys, columns the
    // tile's queries
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_dot_tile<D>(s, Kw, Qs, lane);
    rows_dot_tile<D>(dp, Vw, Ds, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        const float p = q0 + qc < T ? exp2f(s[j][e] * scale_log2 - Ls[qc]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dl[qc]);
      }
    tile_times<D>(dva, s, Ds, lane);   // dV += P^T dO
    tile_times<D>(dka, dp, Qs, lane);  // dK += dS^T Q
  }

  bf* dk = static_cast<bf*>(a.dk) + (long long)b * a.g_b + (long long)h * a.g_h;
  bf* dv = static_cast<bf*>(a.dv) + (long long)b * a.g_b + (long long)h * a.g_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = kv0 + warp * 16 + g + 8 * hh;
    if (row < T) {
#pragma unroll
      for (int n = 0; n < G::NV; ++n) {
        const long long off = (long long)row * a.g_t + n * 8 + 2 * t;
        st2(dk + off, dka[n][2 * hh] * a.scale, dka[n][2 * hh + 1] * a.scale);
        st2(dv + off, dva[n][2 * hh], dva[n][2 * hh + 1]);
      }
    }
  }
}

// a block: queries [q0, q0 + 64) of one (batch, head); each warp 16 queries
template <int D>
__global__ void __launch_bounds__(NTHR, 1) dq_bf16(BwdArgs a) {
  using G = Geom<D>;
  constexpr int SK = G::SK;
  __shared__ __align__(16) bf tiles[4][BT * SK];  // Q, dO, K, V
  bf* Qs = tiles[0];
  bf* Ds = tiles[1];
  bf* Ks = tiles[2];
  bf* Vs = tiles[3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T = a.Tlen;
  const long long in_off = (long long)b * a.s_b + (long long)h * a.s_h;
  const bf* kb = static_cast<const bf*>(a.k) + in_off;
  const bf* vb = static_cast<const bf*>(a.v) + in_off;
  const float scale_log2 = a.scale * LOG2E;
  const int q0 = blockIdx.x * BT;

  zero_pads<D>(&tiles[0][0], 4, tid);
  load_tile<D>(Qs, static_cast<const bf*>(a.q) + in_off, a.s_t, q0, T, tid);
  load_tile<D>(Ds, static_cast<const bf*>(a.dout) + (long long)b * a.d_b +
                       (long long)h * a.d_h, a.d_t, q0, T, tid);
  cp_async_commit();
  float ls[2], dl[2];  // rows g and g + 8 of the warp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const bool ok = row < T;
    ls[i] = ok ? a.lse[(long long)bh * T + row] * LOG2E : 0.f;
    dl[i] = ok ? a.delta[(long long)bh * T + row] : 0.f;
  }

  float dqa[G::NV][4];
#pragma unroll
  for (int n = 0; n < G::NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const bf* Qw = Qs + warp * 16 * SK;
  const bf* Dw = Ds + warp * 16 * SK;
  for (int kv0 = 0; kv0 < T; kv0 += BT) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D>(Ks, kb, a.s_t, kv0, T, tid);
    load_tile<D>(Vs, vb, a.s_t, kv0, T, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_dot_tile<D>(s, Qw, Ks, lane);   // S = Q K^T
    rows_dot_tile<D>(dp, Dw, Vs, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const float p =
            key < T ? exp2f(s[j][e] * scale_log2 - ls[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }
    tile_times<D>(dqa, dp, Ks, lane);  // dQ += dS K
  }

  bf* dq = static_cast<bf*>(a.dq) + (long long)b * a.g_b + (long long)h * a.g_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + warp * 16 + g + 8 * hh;
    if (row < T) {
#pragma unroll
      for (int n = 0; n < G::NV; ++n)
        st2(dq + (long long)row * a.g_t + n * 8 + 2 * t,
            dqa[n][2 * hh] * a.scale, dqa[n][2 * hh + 1] * a.scale);
    }
  }
}

// ---- float32: plain FMAs --------------------------------------------------

constexpr int FT = 32;  // rows of a tile in the f32 kernels

// rows [r0, r0 + FT) of a [T, D] f32 slice into a [FT][D + 1] tile, rows at
// or past T as zeros
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long st, int r0, int Tlen,
                                         int tid) {
  for (int i = tid; i < FT * D; i += NTHR) {
    const int r = i / D, c = i % D, row = r0 + r;
    dst[r * (D + 1) + c] = row < Tlen ? src[(long long)row * st + c] : 0.f;
  }
}

// a block: keys [kv0, kv0 + 32); thread tid owns key row tid / 4 and the
// columns c = tid % 4 + 4 i of its dk and dv
template <int D>
__global__ void __launch_bounds__(NTHR) dkdv_f32(BwdArgs a) {
  constexpr int DP = D + 1, NC = D / 4;
  __shared__ float Ks[FT * DP], Vs[FT * DP], Qs[FT * DP], Ds[FT * DP];
  __shared__ float Pt[FT][FT + 1], St[FT][FT + 1];
  __shared__ float Ls[FT], Dl[FT];
  const int tid = threadIdx.x, r = tid >> 2, cg = tid & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T = a.Tlen;
  const long long in_off = (long long)b * a.s_b + (long long)h * a.s_h;
  const float* qb = static_cast<const float*>(a.q) + in_off;
  const float* db = static_cast<const float*>(a.dout) + (long long)b * a.d_b +
                    (long long)h * a.d_h;
  const float* lse = a.lse + (long long)bh * T;
  const float* dl = a.delta + (long long)bh * T;
  const float scale_log2 = a.scale * LOG2E;
  const int kv0 = blockIdx.x * FT;
  load_f32<D>(Ks, static_cast<const float*>(a.k) + in_off, a.s_t, kv0, T, tid);
  load_f32<D>(Vs, static_cast<const float*>(a.v) + in_off, a.s_t, kv0, T, tid);
  float ak[NC], av[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) ak[i] = av[i] = 0.f;

  for (int q0 = 0; q0 < T; q0 += FT) {
    __syncthreads();
    load_f32<D>(Qs, qb, a.s_t, q0, T, tid);
    load_f32<D>(Ds, db, a.d_t, q0, T, tid);
    if (tid < FT) {
      const bool ok = q0 + tid < T;
      Ls[tid] = ok ? lse[q0 + tid] * LOG2E : 0.f;
      Dl[tid] = ok ? dl[q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < 8; ++j) {
      const int qq = cg * 8 + j;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        s += Ks[r * DP + c] * Qs[qq * DP + c];
        dp += Vs[r * DP + c] * Ds[qq * DP + c];
      }
      const float p = q0 + qq < T ? exp2f(s * scale_log2 - Ls[qq]) : 0.f;
      Pt[r][qq] = p;
      St[r][qq] = p * (dp - Dl[qq]);
    }
    __syncthreads();
    for (int qq = 0; qq < FT; ++qq) {
      const float p = Pt[r][qq], ds = St[r][qq];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        av[i] += p * Ds[qq * DP + cg + 4 * i];
        ak[i] += ds * Qs[qq * DP + cg + 4 * i];
      }
    }
  }
  const int row = kv0 + r;
  if (row < T) {
    const long long off = (long long)b * a.g_b + (long long)h * a.g_h +
                          (long long)row * a.g_t;
    float* dk = static_cast<float*>(a.dk) + off;
    float* dv = static_cast<float*>(a.dv) + off;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dk[cg + 4 * i] = ak[i] * a.scale;
      dv[cg + 4 * i] = av[i];
    }
  }
}

// a block: queries [q0, q0 + 32); thread tid owns query row tid / 4
template <int D>
__global__ void __launch_bounds__(NTHR) dq_f32(BwdArgs a) {
  constexpr int DP = D + 1, NC = D / 4;
  __shared__ float Qs[FT * DP], Ds[FT * DP], Ks[FT * DP], Vs[FT * DP];
  __shared__ float Sd[FT][FT + 1];
  const int tid = threadIdx.x, r = tid >> 2, cg = tid & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T = a.Tlen;
  const long long in_off = (long long)b * a.s_b + (long long)h * a.s_h;
  const float* kb = static_cast<const float*>(a.k) + in_off;
  const float* vb = static_cast<const float*>(a.v) + in_off;
  const float scale_log2 = a.scale * LOG2E;
  const int q0 = blockIdx.x * FT;
  load_f32<D>(Qs, static_cast<const float*>(a.q) + in_off, a.s_t, q0, T, tid);
  load_f32<D>(Ds, static_cast<const float*>(a.dout) + (long long)b * a.d_b +
                      (long long)h * a.d_h, a.d_t, q0, T, tid);
  const bool live = q0 + r < T;
  const float ls = live ? a.lse[(long long)bh * T + q0 + r] * LOG2E : 0.f;
  const float dl = live ? a.delta[(long long)bh * T + q0 + r] : 0.f;
  float aq[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) aq[i] = 0.f;

  for (int kv0 = 0; kv0 < T; kv0 += FT) {
    __syncthreads();
    load_f32<D>(Ks, kb, a.s_t, kv0, T, tid);
    load_f32<D>(Vs, vb, a.s_t, kv0, T, tid);
    __syncthreads();
    for (int j = 0; j < 8; ++j) {
      const int kk = cg * 8 + j;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        s += Qs[r * DP + c] * Ks[kk * DP + c];
        dp += Ds[r * DP + c] * Vs[kk * DP + c];
      }
      const float p = kv0 + kk < T ? exp2f(s * scale_log2 - ls) : 0.f;
      Sd[r][kk] = p * (dp - dl);
    }
    __syncthreads();
    for (int kk = 0; kk < FT; ++kk) {
      const float ds = Sd[r][kk];
#pragma unroll
      for (int i = 0; i < NC; ++i) aq[i] += ds * Ks[kk * DP + cg + 4 * i];
    }
  }
  if (live) {
    float* dq = static_cast<float*>(a.dq) + (long long)b * a.g_b +
                (long long)h * a.g_h + (long long)(q0 + r) * a.g_t;
#pragma unroll
    for (int i = 0; i < NC; ++i) dq[cg + 4 * i] = aq[i] * a.scale;
  }
}

template <int D>
int run_d(int dtype, const BwdArgs& a, cudaStream_t st) {
  const unsigned bh = (unsigned)(a.B * a.H);
  if (dtype == 0) {
    dim3 grid((unsigned)((a.Tlen + FT - 1) / FT), bh);
    dkdv_f32<D><<<grid, NTHR, 0, st>>>(a);
    dq_f32<D><<<grid, NTHR, 0, st>>>(a);
  } else {
    dim3 grid((unsigned)((a.Tlen + BT - 1) / BT), bh);
    dkdv_bf16<D><<<grid, NTHR, 0, st>>>(a);
    dq_bf16<D><<<grid, NTHR, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16; d: 16, 32, 64 or 72.  q, k, v share the
// element strides s_*; o, do and the gradients dq, dk, dv (which share
// g_*) have their own; the head dim is contiguous everywhere and, for
// bfloat16, every row start of q, k, v and do is 16-byte aligned (checked
// by the Python wrapper).  lse: the forward's f32 [B, H, T] logsumexp of
// the scaled scores; delta: f32 [B, H, T] scratch for the pre-pass.
// scale: the forward's score scale (1 for the splash form).
int natdiff_attention_bwd(int dtype, int d, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          const float* lse, float* delta, void* dq, void* dk,
                          void* dv, long long s_b, long long s_h, long long s_t,
                          long long o_b, long long o_h, long long o_t,
                          long long d_b, long long d_h, long long d_t,
                          long long g_b, long long g_h, long long g_t, int B,
                          int H, int Tlen, float scale, void* stream) {
  if (Tlen <= 0 || B <= 0 || H <= 0 || (long long)B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, s_b, s_h, s_t,
                  o_b, o_h, o_t, d_b, d_h, d_t, g_b, g_h, g_t, B, H, Tlen,
                  scale};
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)B * H * Tlen;
  const unsigned nb = (unsigned)((rows + 7) / 8);
  if (dtype == 0)
    delta_kernel<float><<<nb, 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), delta,
        o_b, o_h, o_t, d_b, d_h, d_t, H, Tlen, d, rows);
  else
    delta_kernel<bf><<<nb, 256, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), delta, o_b,
        o_h, o_t, d_b, d_h, d_t, H, Tlen, d, rows);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  switch (d) {
    case 16: return run_d<16>(dtype, a, st);
    case 32: return run_d<32>(dtype, a, st);
    case 64: return run_d<64>(dtype, a, st);
    case 72: return run_d<72>(dtype, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
