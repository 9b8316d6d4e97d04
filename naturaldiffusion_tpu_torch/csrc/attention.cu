// Non-causal multi-head flash attention,
//
//   o[b, h, i, :] = sum_j softmax_j(scale * q[b, h, i, :] . k[b, h, j, :]) v[b, h, j, :]
//
// over keys j < T, with the softmax in f32 and the output in q's type.
// Keys at or past T are masked to -inf inside the kernel, so any T works.
//
// Replaces two TPU kernels of naturaldiffusion_tpu/ops/attention.py:
//
// * K9, the Pallas flash-attention kernel reached through `_flash` (the
//   `jax.experimental.pallas.ops.tpu.flash_attention` kernel): entry
//   `natdiff_flash_attention`, the scale folded into the exponent; when a
//   gradient is needed it also writes the row logsumexp that the backward
//   (csrc/attention_bwd.cu) reads.
// * K10, the splash kernel reached through `_splash` and `mha_joint` (the
//   `...ops.tpu.splash_attention` kernel): entry `natdiff_splash_attention`.
//   Splash takes q already multiplied by the scale, so the exponent scale is
//   log2(e); with `save_residuals` it also returns each row's natural-log
//   logsumexp, lse = ln 2 * (m + log2 l) from the running max m (log2
//   units) and sum l that the loop keeps anyway (template flag LSE).  The
//   TPU splash kernel differs from the flash one in its grid and block
//   granularity only, which has no counterpart here: both entries run the
//   same tile loop.
//
// On the TPU an unaligned T is zero-padded to 128/512 tokens and the pad
// keys are masked by segment ids; here the mask is an index test, and
// nothing is padded in device memory.
//
// Design.  Each warp owns 16 query rows, as mma fragments.  K and V pass
// through shared memory in
// tiles of 64 keys; per tile a warp computes S = Q K^T (mma.sync m16n8k16,
// bf16 in, f32 accumulate), updates its rows' running max and sum (online
// softmax in f32, exp2 with the scale folded in), rescales its f32 output
// accumulator and adds P V, P taken from the S registers without a trip
// through memory.  The head dim D is a template parameter: 64 (MMDiT), 72
// (DiT-XL/2), and 16 and 32 (the small DiTs of the JAX package's apps).
// 72 is not a multiple of the mma's k of 16, so the Q K^T reduction runs
// over D rounded up to 16 with zero columns (80 for 72); P V's n dimension
// is D in tiles of 8 (72 = 9 x 8).
//
// bfloat16 (`flash_ring_kernel`, the path of the models and the benches):
// a block of 4 or 8 warps (64 or 128 queries, the plan of
// ops/attention.py:_attn_plan, which the entry checks) copies its Q tile
// and the K/V tiles with cp.async into shared memory: raw 16-byte chunks,
// a ring of RING_STAGES tiles, two tiles in flight while the warps compute
// on the third, one barrier per tile.  The Q fragments are read from the
// Q tile again for each key tile, which keeps the 8-warp instances within
// the 128 registers that two blocks per SM allow.  Rows at or past T arrive as zeros
// (zeros, not garbage: a masked key's p is 0, and 0 * NaN is NaN); the pad
// columns D..DK of Q and K are zeroed once and never written by a copy.
// Only the last tile, when T is not a multiple of 64, tests the key index
// (template flag MASK).
//
// float32 (`flash_split_kernel`, the checking path) runs the same
// tensor-core loop with each operand split in two bf16 terms, a = hi + lo
// (hi = bf16(a), lo = bf16(a - hi)), and three products hi*hi + hi*lo +
// lo*hi: about 16 significant bits per operand, so an f32 call agrees
// with an f32 softmax to ~1e-5 and checks the same indexing tightly.  It
// stages K and V through registers (the split) in blocks of 4 warps; its
// speed is not the point.
//
// Bound on the H100: at DiT-XL/2 ([2, 16, 256, 72], bf16) the call moves
// 4.7 MB and does 0.6 GFLOP: bytes, 1.4 us, over 4 x 32 = 128 blocks of 4
// warps and 4 key tiles each, so the ring's point there is to overlap the
// tiles' load latency with the products.  At SD3's joint length ([2, 24,
// 4250, 64], bf16) it does 222 GFLOP on 104 MB: operations, 0.22 ms, over
// 34 x 48 blocks of 8 warps and 67 key tiles each.  What the ring does not
// reach: `mma.sync` from registers and shared memory tops out below the
// tensor cores' `wgmma` rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BQ = 64;        // queries per block of the float32 kernel
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // threads per block of the float32 kernel

// a pair of f32 values as bf16x2 words hi = bf16(a), lo = bf16(a - hi)
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a0 - hf.x, a1 - hf.y));
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }

// 8 consecutive elements, 16-byte aligned, as f32
__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The float32 path.  LSE: also write lse[(b * H + h) * Tlen + i], the
// natural-log logsumexp of row i's scaled scores (f32)
template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, long long s_b, long long s_h,
                   long long s_t, long long o_b, long long o_h, long long o_t,
                   int H, int Tlen, float scale_log2) {
  constexpr int DK = (D + 15) / 16 * 16;     // Q K^T reduction, zero-padded
  constexpr int NK = DK / 16;                // its k16 steps
  constexpr int NV = D / 8;                  // P V's n8 tiles
  constexpr int NS = 2;                      // bf16 terms per operand
  constexpr int SK = DK + 8;                 // row stride: no ldmatrix bank conflicts
  constexpr int CH = D / 8;                  // 8-element chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[NS][BKV][SK];
  __shared__ __align__(16) __nv_bfloat16 Vs[NS][BKV][SK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row within 8
  const int t = lane & 3;   // fragment column pair
  const int bh = blockIdx.y;
  const long long in_off = (long long)(bh / H) * s_b + (long long)(bh % H) * s_h;
  const float* qb = q + in_off;
  const float* kb = k + in_off;
  const float* vb = v + in_off;
  const int q0 = blockIdx.x * BQ + warp * 16;

  // the zero columns D..DK of K are never written by the tile loads
  for (int i = tid; i < NS * BKV * (SK - D); i += THREADS) {
    const int s = i / (BKV * (SK - D));
    const int r = (i / (SK - D)) % BKV;
    Ks[s][r][D + i % (SK - D)] = __float2bfloat16(0.f);
  }

  // Q fragments straight from device memory: reg 0 = (row g, cols 2t,2t+1),
  // 1 = (row g+8, same), 2 = (row g, cols +8), 3 = (row g+8, cols +8)
  uint32_t qf[NS][NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + ((i & 1) ? 8 : 0);
      const int col = kk * 16 + 2 * t + ((i >> 1) ? 8 : 0);
      float a0 = 0.f, a1 = 0.f;
      if (row < Tlen && col < D) {
        const float* p = qb + (long long)row * s_t + col;
        a0 = ld1(p);
        a1 = ld1(p + 1);
      }
      uint32_t hi, lo;
      split2(a0, a1, hi, lo);
      qf[0][kk][i] = hi;
      if (NS == 2) qf[NS - 1][kk][i] = lo;
    }
  }

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sums

  for (int kv0 = 0; kv0 < Tlen; kv0 += BKV) {
    __syncthreads();  // the previous tile is no longer read
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH;
      const int cc = (c % CH) * 8;
      float kv[8], vv[8];
      if (kv0 + r < Tlen) {
        ld8(kb + (long long)(kv0 + r) * s_t + cc, kv);
        ld8(vb + (long long)(kv0 + r) * s_t + cc, vv);
      } else {
        // zeros, not garbage: a masked key's p is 0, and 0 * NaN is NaN
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
      uint32_t kh[4], kl[4], vh[4], vl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        split2(kv[2 * e], kv[2 * e + 1], kh[e], kl[e]);
        split2(vv[2 * e], vv[2 * e + 1], vh[e], vl[e]);
      }
      *reinterpret_cast<uint4*>(&Ks[0][r][cc]) = make_uint4(kh[0], kh[1], kh[2], kh[3]);
      *reinterpret_cast<uint4*>(&Vs[0][r][cc]) = make_uint4(vh[0], vh[1], vh[2], vh[3]);
      if (NS == 2) {
        *reinterpret_cast<uint4*>(&Ks[NS - 1][r][cc]) = make_uint4(kl[0], kl[1], kl[2], kl[3]);
        *reinterpret_cast<uint4*>(&Vs[NS - 1][r][cc]) = make_uint4(vl[0], vl[1], vl[2], vl[3]);
      }
    }
    __syncthreads();

    // S = Q K^T over this tile: 8 n8 tiles of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // matrices: (keys +0, cols +0), (keys +0, cols +8), (keys +8, cols
        // +0), (keys +8, cols +8) -> B fragments of key tiles 2np, 2np+1
        const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int kc = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldsm_x4(r, &Ks[0][kr][kc]);
        mma_bf16(s[2 * np], qf[0][kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[0][kk], r[2], r[3]);
        if (NS == 2) {
          mma_bf16(s[2 * np], qf[NS - 1][kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[NS - 1][kk], r[2], r[3]);
          ldsm_x4(r, &Ks[NS - 1][kr][kc]);
          mma_bf16(s[2 * np], qf[0][kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[0][kk], r[2], r[3]);
        }
      }
    }

    // mask, running max, p = exp2(s - max), running sum
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t + (e & 1);
        const float x = key < Tlen ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // key 0 is in the first tile, so the new max is finite from there on
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's A fragment for keys 16ks.. is S tiles 2ks and 2ks+1
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[NS][4];
      {
        uint32_t hi, lo;
        split2(s[2 * ks][0], s[2 * ks][1], hi, lo);
        pa[0][0] = hi; pa[NS - 1][0] = NS == 2 ? lo : hi;
        split2(s[2 * ks][2], s[2 * ks][3], hi, lo);
        pa[0][1] = hi; pa[NS - 1][1] = NS == 2 ? lo : hi;
        split2(s[2 * ks + 1][0], s[2 * ks + 1][1], hi, lo);
        pa[0][2] = hi; pa[NS - 1][2] = NS == 2 ? lo : hi;
        split2(s[2 * ks + 1][2], s[2 * ks + 1][3], hi, lo);
        pa[0][3] = hi; pa[NS - 1][3] = NS == 2 ? lo : hi;
      }
      const int vr = ks * 16 + (lane & 15);
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        const int vc = np * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldsm_x4_trans(r, &Vs[0][vr][vc]);
        mma_bf16(acc[2 * np], pa[0], r[0], r[1]);
        mma_bf16(acc[2 * np + 1], pa[0], r[2], r[3]);
        if (NS == 2) {
          mma_bf16(acc[2 * np], pa[NS - 1], r[0], r[1]);
          mma_bf16(acc[2 * np + 1], pa[NS - 1], r[2], r[3]);
          ldsm_x4_trans(r, &Vs[NS - 1][vr][vc]);
          mma_bf16(acc[2 * np], pa[0], r[0], r[1]);
          mma_bf16(acc[2 * np + 1], pa[0], r[2], r[3]);
        }
      }
      if (NV % 2) {  // the odd last n8 tile (D = 72)
        constexpr int nl = NV - 1;
        uint32_t r0, r1;
        ldsm_x2_trans(r0, r1, &Vs[0][vr][nl * 8]);
        mma_bf16(acc[nl], pa[0], r0, r1);
        if (NS == 2) {
          mma_bf16(acc[nl], pa[NS - 1], r0, r1);
          ldsm_x2_trans(r0, r1, &Vs[NS - 1][vr][nl * 8]);
          mma_bf16(acc[nl], pa[0], r0, r1);
        }
      }
    }
  }

  // normalise and store: c0,c1 at row g, c2,c3 at row g+8
  float inv[2], l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv[i] = 1.f / l;
  }
  float* ob = o + (long long)(bh / H) * o_b + (long long)(bh % H) * o_h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + g + 8 * h;
    if (row < Tlen) {
#pragma unroll
      for (int n = 0; n < NV; ++n)
        st2(ob + (long long)row * o_t + n * 8 + 2 * t,
            acc[n][2 * h] * inv[h], acc[n][2 * h + 1] * inv[h]);
      // m_run and l_row are the same in the 4 threads of a row's quad
      if (LSE && t == 0)
        lse[(long long)bh * Tlen + row] =
            0.6931471805599453f * (m_run[h] + log2f(l_row[h]));
    }
  }
}

// ---- the bfloat16 path: a cp.async ring of raw K/V tiles -------------------

constexpr int RING_STAGES = 3;  // K/V tiles in shared memory: two in flight

template <int D>
struct Geom {
  static constexpr int DK = (D + 15) / 16 * 16;  // Q K^T reduction, zero-padded
  static constexpr int NK = DK / 16;             // its k16 steps
  static constexpr int NV = D / 8;               // P V's n8 tiles
  static constexpr int SK = DK + 8;              // row stride: no ldmatrix bank conflicts
  static constexpr int CH = D / 8;               // 16-byte chunks per row
};

// Q tile [16 warps][SK], then RING_STAGES x (K tile, V tile) [BKV][SK]
template <int D>
constexpr int ring_smem_bytes(int warps) {
  return (16 * warps + 2 * RING_STAGES * BKV) * Geom<D>::SK * 2;
}

// One key tile: S = Q K^T, the online softmax, O += P V.  MASK: keys at
// or past Tlen (only in the last tile) are masked.
// Qw: the warp's 16 rows of the Q tile in shared memory, read again per
// tile (ldmatrix) rather than held in registers, so that two 8-warp
// blocks fit on an SM without spills.
template <int D, bool MASK>
__device__ __forceinline__ void ring_tile(
    const __nv_bfloat16* Qw, const __nv_bfloat16* Kt, const __nv_bfloat16* Vt,
    float (&acc)[Geom<D>::NV][4], float (&m_run)[2], float (&l_run)[2],
    int kv0, int Tlen, float scale_log2, int lane) {
  using G = Geom<D>;
  const int t = lane & 3;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < G::NK; ++kk) {
    uint32_t qf[4];
    ldsm_x4(qf, Qw + (lane & 15) * G::SK + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // matrices: (keys +0, cols +0), (keys +0, cols +8), (keys +8, cols
      // +0), (keys +8, cols +8) -> B fragments of key tiles 2np, 2np+1
      const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int kc = kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t r[4];
      ldsm_x4(r, Kt + kr * G::SK + kc);
      mma_bf16(s[2 * np], qf, r[0], r[1]);
      mma_bf16(s[2 * np + 1], qf, r[2], r[3]);
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = !MASK || kv0 + j * 8 + 2 * t + (e & 1) < Tlen
                          ? s[j][e] * scale_log2 : -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // every tile holds a key below Tlen, so the new max is finite
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = exp2f(m_run[i] - m_new);
    m_run[i] = m_new;
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m_run[e >> 1]);
      s[j][e] = p;
      l_run[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < G::NV; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }

  // O += P V: P's A fragment for keys 16ks.. is S tiles 2ks and 2ks+1
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t pa[4] = {pack_bf16x2(s[2 * ks][0], s[2 * ks][1]),
                            pack_bf16x2(s[2 * ks][2], s[2 * ks][3]),
                            pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                            pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
    const __nv_bfloat16* vrow = Vt + (ks * 16 + (lane & 15)) * G::SK;
#pragma unroll
    for (int np = 0; np < G::NV / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, vrow + np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], pa, r[0], r[1]);
      mma_bf16(acc[2 * np + 1], pa, r[2], r[3]);
    }
    if (G::NV % 2) {  // the odd last n8 tile (D = 72)
      constexpr int nl = G::NV - 1;
      uint32_t r0, r1;
      ldsm_x2_trans(r0, r1, vrow + nl * 8);
      mma_bf16(acc[nl], pa, r0, r1);
    }
  }
}

// 8-warp blocks two to an SM, 4-warp blocks three (as their shared memory
// allows at d = 64).  d = 72 takes 4-warp blocks only: its 8-warp form
// spills within the 128 registers of two blocks per SM.
template <int D, bool LSE, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, WARPS == 8 ? 2 : 3)
flash_ring_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  long long s_b, long long s_h, long long s_t, long long o_b,
                  long long o_h, long long o_t, int H, int Tlen,
                  float scale_log2) {
  using G = Geom<D>;
  using bf = __nv_bfloat16;
  constexpr int BQR = 16 * WARPS;  // queries per block
  constexpr int NTHR = 32 * WARPS;
  constexpr int SK = G::SK, CH = G::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);  // [BQR][SK]
  bf* ring = Qs + BQR * SK;              // [RING_STAGES][K, V][BKV][SK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const long long in_off = (long long)(bh / H) * s_b + (long long)(bh % H) * s_h;
  const bf* qb = q + in_off;
  const bf* kb = k + in_off;
  const bf* vb = v + in_off;
  const int qblk = blockIdx.x * BQR;

  if constexpr (G::DK > D) {
    // the pad columns D..DK of Q and of every stage's K: never copied into
    constexpr int PAD = G::DK - D;
    for (int i = tid; i < (BQR + RING_STAGES * BKV) * PAD; i += NTHR) {
      const int r = i / PAD;
      bf* row = r < BQR ? Qs + r * SK
                        : ring + ((r - BQR) / BKV) * 2 * BKV * SK + ((r - BQR) % BKV) * SK;
      row[D + i % PAD] = __float2bfloat16(0.f);
    }
  }
  for (int c = tid; c < BQR * CH; c += NTHR) {
    const int r = c / CH, cc = (c % CH) * 8, row = qblk + r;
    cp_async16(Qs + r * SK + cc, qb + (long long)(row < Tlen ? row : 0) * s_t + cc,
               row < Tlen ? 16 : 0);
  }
  cp_async_commit();
  auto load_kv = [&](int stage, int kv0) {
    bf* kd = ring + stage * 2 * BKV * SK;
    bf* vd = kd + BKV * SK;
    for (int c = tid; c < BKV * CH; c += NTHR) {
      const int r = c / CH, cc = (c % CH) * 8, row = kv0 + r;
      const bool ok = row < Tlen;
      const long long off = (long long)(ok ? row : 0) * s_t + cc;
      cp_async16(kd + r * SK + cc, kb + off, ok ? 16 : 0);
      cp_async16(vd + r * SK + cc, vb + off, ok ? 16 : 0);
    }
  };
  const int NT = (Tlen + BKV - 1) / BKV;
#pragma unroll
  for (int s = 0; s < RING_STAGES - 1; ++s) {
    if (s < NT) load_kv(s, s * BKV);
    cp_async_commit();
  }
  const bf* Qw = Qs + warp * 16 * SK;

  float acc[G::NV][4];
#pragma unroll
  for (int n = 0; n < G::NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g+8, log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sums

  const int full = Tlen / BKV;  // tiles without a key at or past Tlen
  for (int j = 0; j < NT; ++j) {
    cp_async_wait<RING_STAGES - 2>();  // tile j has landed for this thread
    __syncthreads();                   // ... for all; tile j - 1's stage is free
    if (j + RING_STAGES - 1 < NT)
      load_kv((j + RING_STAGES - 1) % RING_STAGES, (j + RING_STAGES - 1) * BKV);
    cp_async_commit();
    const bf* Kt = ring + (j % RING_STAGES) * 2 * BKV * SK;
    if (j < full)
      ring_tile<D, false>(Qw, Kt, Kt + BKV * SK, acc, m_run, l_run, j * BKV,
                          Tlen, scale_log2, lane);
    else
      ring_tile<D, true>(Qw, Kt, Kt + BKV * SK, acc, m_run, l_run, j * BKV,
                         Tlen, scale_log2, lane);
  }
  cp_async_wait<0>();

  // normalise and store: c0,c1 at row g, c2,c3 at row g+8
  float inv[2], l_row[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[i] = l;
    inv[i] = 1.f / l;
  }
  bf* ob = o + (long long)(bh / H) * o_b + (long long)(bh % H) * o_h;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = qblk + warp * 16 + g + 8 * h;
    if (row < Tlen) {
#pragma unroll
      for (int n = 0; n < G::NV; ++n)
        st2(ob + (long long)row * o_t + n * 8 + 2 * t, acc[n][2 * h] * inv[h],
            acc[n][2 * h + 1] * inv[h]);
      // m_run and l_row are the same in the 4 threads of a row's quad
      if (LSE && t == 0)
        lse[(long long)bh * Tlen + row] =
            0.6931471805599453f * (m_run[h] + log2f(l_row[h]));
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  long long s_b, s_h, s_t, o_b, o_h, o_t;
  int B, H, Tlen;
  float scale_log2;
};

template <int D, bool LSE>
int launch_f32(const Args& a, cudaStream_t st) {
  dim3 grid((unsigned)((a.Tlen + BQ - 1) / BQ), (unsigned)(a.B * a.H));
  flash_split_kernel<D, LSE><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.s_b,
      a.s_h, a.s_t, a.o_b, a.o_h, a.o_t, a.H, a.Tlen, a.scale_log2);
  return (int)cudaGetLastError();
}

template <int D, bool LSE, int WARPS>
int launch_ring(const Args& a, cudaStream_t st) {
  using bf = __nv_bfloat16;
  auto kern = flash_ring_kernel<D, LSE, WARPS>;
  constexpr int smem = ring_smem_bytes<D>(WARPS);
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  dim3 grid((unsigned)((a.Tlen + 16 * WARPS - 1) / (16 * WARPS)),
            (unsigned)(a.B * a.H));
  kern<<<grid, WARPS * 32, smem, st>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<bf*>(a.o), a.lse, a.s_b, a.s_h,
      a.s_t, a.o_b, a.o_h, a.o_t, a.H, a.Tlen, a.scale_log2);
  return (int)cudaGetLastError();
}

// Check the plan (warps, stages, smem from ops/attention.py:_attn_plan)
// against this file's constants and launch.  float32 takes the split
// kernel (warps 4, stages 0, smem 0), bfloat16 the ring kernel.
template <int D, bool LSE>
int run_d(int dtype, int warps, int stages, int smem, const Args& a,
          cudaStream_t st) {
  if (dtype == 0)
    return warps == 4 && stages == 0 && smem == 0 ? launch_f32<D, LSE>(a, st)
                                                  : (int)cudaErrorInvalidValue;
  if (dtype != 1 || stages != RING_STAGES ||
      (warps != 4 && (warps != 8 || D > 64)) ||
      smem != ring_smem_bytes<D>(warps))
    return (int)cudaErrorInvalidValue;
  if constexpr (D <= 64)
    if (warps == 8) return launch_ring<D, LSE, 8>(a, st);
  return launch_ring<D, LSE, 4>(a, st);
}

template <bool LSE>
int dispatch(int dtype, int d, int warps, int stages, int smem, const Args& a,
             void* stream) {
  if (a.Tlen <= 0 || a.B <= 0 || a.H <= 0 || (long long)a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return run_d<16, LSE>(dtype, warps, stages, smem, a, st);
    case 32: return run_d<32, LSE>(dtype, warps, stages, smem, a, st);
    case 64: return run_d<64, LSE>(dtype, warps, stages, smem, a, st);
    case 72: return run_d<72, LSE>(dtype, warps, stages, smem, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16; d: 16, 32, 64 or 72.  q, k, v share the
// element strides s_b, s_h, s_t (batch, head, token; the head dim is
// contiguous), o has its own; every row start is 16-byte aligned (checked
// by the Python wrapper).  scale_log2 = sm_scale * log2(e).  lse: null,
// or a contiguous f32 [B, H, T] that receives each row's natural-log
// logsumexp of the scaled scores (what the backward, attention_bwd.cu,
// reads).  warps, stages, smem: the plan of ops/attention.py:_attn_plan.
int natdiff_flash_attention(int dtype, int d, const void* q, const void* k,
                            const void* v, void* o, float* lse, long long s_b,
                            long long s_h, long long s_t, long long o_b,
                            long long o_h, long long o_t, int B, int H,
                            int Tlen, float scale_log2, int warps, int stages,
                            int smem, void* stream) {
  const Args a{q, k, v, o, lse, s_b, s_h, s_t, o_b, o_h, o_t, B, H, Tlen,
               scale_log2};
  if (lse) return dispatch<true>(dtype, d, warps, stages, smem, a, stream);
  return dispatch<false>(dtype, d, warps, stages, smem, a, stream);
}

// The splash form: q is pre-scaled (q * sm_scale in q's type), so the
// exponent scale is log2(e).  lse: null, or a contiguous f32 [B, H, T] that
// receives each row's natural-log logsumexp.  Otherwise as above.
int natdiff_splash_attention(int dtype, int d, const void* q, const void* k,
                             const void* v, void* o, float* lse,
                             long long s_b, long long s_h, long long s_t,
                             long long o_b, long long o_h, long long o_t,
                             int B, int H, int Tlen, int warps, int stages,
                             int smem, void* stream) {
  const Args a{q, k, v, o, lse, s_b, s_h, s_t, o_b, o_h, o_t, B, H, Tlen,
               1.4426950408889634f};
  if (lse) return dispatch<true>(dtype, d, warps, stages, smem, a, stream);
  return dispatch<false>(dtype, d, warps, stages, smem, a, stream);
}

}  // extern "C"
