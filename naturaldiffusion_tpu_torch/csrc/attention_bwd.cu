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
// bfloat16 at head dims 64 and 72 (DiT-XL/2's 72, SD3's 64): one pass on
// Hopper in the FlashAttention-3 form (`hop::bwd_wgmma_kernel`).
//
// * Bound: at SD3's length (T 4250-4429) operations, the 5 products of
//   2 B H T^2 D (0.61 ms at 989 TFLOP/s for [2, 24, 4429, 64]); at DiT's
//   T = 256 bytes (q, k, v, o, do read, dq, dk, dv written: 0.045 ms at
//   3.35 TB/s for [32, 16, 256, 72]).  So the products run on wgmma, fed
//   by TMA, and each is run once: the TPU form (and this file's mma.sync
//   kernels) split dk/dv and dq into two kernels that each recompute S
//   and dP, 7 products where the work needs 5.
// * A block owns 128 keys of one head: two consumer warpgroups of 64 keys
//   and a producer warpgroup.  K and V arrive once by TMA (128-byte
//   swizzle; D = 72 takes two 64-column boxes, the second zero past 72, so
//   reductions over D run over 80).  One producer thread streams every
//   64-query tile of Q and dO (tensor maps of the strided [B, H, T, D]
//   views, rows past T zero-filled), with lse log2 e and delta, through a
//   ring of STAGES stages under mbarriers; the consumers free a stage once
//   its last product is done, so loads overlap the math.
// * Per query tile a warpgroup runs S^T = K Q^T and dP^T = V dO^T (wgmma,
//   both operands in shared memory), P^T = exp2(S^T scale log2 e - lse
//   log2 e) and dS^T = P^T (dP^T - delta) in registers (p and ds rounded
//   to bf16 for the products that take them, as the mma.sync kernels do),
//   dV += P^T dO and dK += dS^T Q (A from registers, B MN-major), then
//   dS^T to shared memory by stmatrix and dQ part = dS K (both operands
//   MN-major).  Keys past T get p = 0; queries past T have lse = +inf, so
//   p = 0 and nothing of them reaches dq, dk or dv.
// * dq: each warpgroup stages its f32 part and a writer warp of the
//   producer warpgroup adds it into an f32 scratch [B H][Tp][D] by one bulk
//   reduction (cp.reduce.async.bulk .add.f32) a tile; a pre-pass
//   (`bwd_prep_kernel`: delta, lse log2 e, the scratch zeroed) and a
//   post-pass (`bwd_dq_kernel`: dq = bf16(sum scale)) make three launches.
//   The key blocks add in no fixed order, so the last bits of dq vary from
//   run to run; dk and dv have one writer each and do not.
// * Registers: ptxas allocates every thread within the launch bound's 168
//   (384 threads), setmaxnreg or not; the loop makes its descriptors from
//   fenced values (hoisted out of it they spilled) and takes S and dP's
//   first step write-only, so nothing spills.
//
// bfloat16 at head dims 16 and 32 (the small configurations and tests),
// the FlashAttention-2 order with no atomics:
//
// * `delta_kernel`: the pre-pass, delta = rowsum(do * o) in f32, one warp a
//   row.
// * `dkdv_*`: a block owns a tile of keys and loops over every query tile,
//   accumulating dk and dv in registers (f32).
// * `dq_*`: a block owns a tile of queries and loops over every key tile,
//   accumulating dq in registers.
//
// `*_bf16`: 4 warps, each 16 rows of the block's 64 as mma fragments
// (mma.sync m16n8k16, bf16 in, f32 accumulate), the other side's 64-row
// tiles through shared memory by cp.async.  p and ds are rounded to bf16
// for the products that take them as operands, as the forward rounds p.
// Reductions over D run over D rounded up to 16 with zero pad columns.
//
// float32 (`*_f32`, every head dim): the same three kernels on plain f32
// FMAs, 32-row tiles in shared memory, 128 threads, each owning a quarter
// of one row of the accumulators: the checking path (f32 training of the
// small models, the gradient checks); its speed is not the point.

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

// the head dims of these kernels, 16 and 32: multiples of 16, so no pad
// columns and an even count of n8 tiles
template <int D>
struct Geom {
  static_assert(D == 16 || D == 32, "the mma.sync kernels take d 16, 32");
  static constexpr int NK = D / 16;              // k16 steps over D
  static constexpr int NV = D / 8;               // n8 tiles of a D-wide product
  static constexpr int SK = D + 8;               // row stride: no ldmatrix bank conflicts
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

// ---- bfloat16 on Hopper: one wgmma + TMA pass (D = 64, 72) ---------------

// d += A B for one m64n64k16 step, A and B from shared memory by
// descriptor; TA / TB: 0 K-major, 1 MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// d += A B for one m64n64k16 step, A from registers (mma.sync's A
// fragment layout, warp w rows 16w..16w+15), B by descriptor, TB as above
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

// d += A B for one m64n72k16 step, A and B from shared memory by
// descriptor; TA / TB: 0 K-major, 1 MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n72k16_ss(float (&d)[36], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, %38, %39;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// d += A B for one m64n72k16 step, A from registers (mma.sync's A
// fragment layout, warp w rows 16w..16w+15), B by descriptor, TB as above
template <int TB>
__device__ __forceinline__ void wgmma_m64n72k16_rs(float (&d)[36],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, %41;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB));
}

// d = A B for the first m64n64k16 step of a product (d's old value is
// neither read nor kept alive), operands as wgmma_m64n64k16_ss
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss0(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// d = A B for the first m64n72k16 step of a product (d's old value is
// neither read nor kept alive), operands as wgmma_m64n72k16_ss
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n72k16_ss0(float (&d)[36], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, %38, %39;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// one k16 step of an m64nN product (N = 64 or 72) from shared memory:
// the first of a product (FIRST: d is written, not read) or a later one
template <int N, int TA, int TB, bool FIRST>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 64 && FIRST)
    wgmma_m64n64k16_ss0<TA, TB>(d, da, db);
  else if constexpr (N == 64)
    wgmma_m64n64k16_ss<TA, TB>(d, da, db);
  else if constexpr (FIRST)
    wgmma_m64n72k16_ss0<TA, TB>(d, da, db);
  else
    wgmma_m64n72k16_ss<TA, TB>(d, da, db);
}
template <int N>
__device__ __forceinline__ void mma_rs_t(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64)
    wgmma_m64n64k16_rs<1>(d, a, db);
  else
    wgmma_m64n72k16_rs<1>(d, a, db);
}

namespace hop {

constexpr int BQ = 64;             // queries a ring stage holds
constexpr int BKV = 128;           // keys a block owns: two warpgroups of 64
constexpr int STAGES = 2;          // depth of the Q / dO ring
constexpr int THREADS = 384;       // two consumer warpgroups + a producer one
// registers a thread after setmaxnreg (128 x 40 + 256 x 232 <= 65,536):
// the producer warpgroup gives its spare ones back, but ptxas still fits
// every thread in the launch bound's 168, so the loop is written to fit
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// named barriers (0 is __syncthreads'): a consumer warpgroup's own (+ w);
// its staged dQ part full and free, met by the warpgroup and its writer
constexpr int BAR_WG = 1, BAR_DQ_FULL = 3, BAR_DQ_EMPTY = 5;
constexpr int BOX = 64;            // columns of a TMA box: one 128-byte row

template <int D>
struct G {
  static constexpr int NB = (D + BOX - 1) / BOX;  // boxes a row takes (1, 2)
  static constexpr int NK = (D + 15) / 16;        // k16 steps over D
  static constexpr int NA = D / 2;                // f32 registers of an m64nD tile
  static constexpr int KV_BOX = BKV * 128;        // bytes of a K or V box
  static constexpr int Q_BOX = BQ * 128;          // ... of a Q or dO box
  static constexpr int KV_TILE = NB * KV_BOX;
  static constexpr int Q_TILE = NB * Q_BOX;
  static constexpr int DS = 64 * 128;             // a warpgroup's dS^T, bf16
  static constexpr int DQ = BQ * D * 4;           // a warpgroup's f32 dQ part
  // offsets from the 1024-aligned base: every swizzled tile 1024-aligned
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_TILE;
  static constexpr int OFF_Q = OFF_V + KV_TILE;            // [STAGES]
  static constexpr int OFF_DO = OFF_Q + STAGES * Q_TILE;   // [STAGES]
  static constexpr int OFF_DS = OFF_DO + STAGES * Q_TILE;  // [2 warpgroups]
  static constexpr int OFF_DQ = OFF_DS + 2 * DS;           // [2 warpgroups]
  static constexpr int OFF_L = OFF_DQ + 2 * DQ;            // [STAGES][BQ] f32
  static constexpr int OFF_DL = OFF_L + STAGES * BQ * 4;   // [STAGES][BQ] f32
  static constexpr int OFF_BAR = OFF_DL + STAGES * BQ * 4;  // full, empty, kv
  static constexpr int SMEM = 1024 + OFF_BAR + (2 * STAGES + 1) * 8;
};

struct Args {
  const float* lse2;   // [B H][Tp]: lse log2(e), +inf at rows >= T
  const float* delta;  // [B H][Tp]: rowsum(do o), 0 at rows >= T
  float* acc;          // [B H][Tp][D]: dq's f32 sums, fragment order a tile
  void *dk, *dv;
  long long g_b, g_h, g_t;
  int H, Tlen, Tp;
  float scale_log2, scale;
};

// Block (x, y): keys [128 x, 128 x + 128) of head y.  Warps 0-7 are two
// consumer warpgroups, warpgroup w owning keys 64 w.. of the tile; warps
// 8-11 the producer warpgroup: warp 8 lane 0 loads K and V once, then each
// query tile's Q, dO, lse and delta into the ring; warp 9 + w adds
// warpgroup w's staged dQ part into acc by bulk reductions.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap, const Args a) {
  using L = G<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_addr(sm);
  const uint32_t full = base + L::OFF_BAR;     // [STAGES]: the stage arrived
  const uint32_t empty = full + 8 * STAGES;    // [STAGES]: 8 warps are done
  const uint32_t kvbar = empty + 8 * STAGES;   // K and V arrived
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kv0 = blockIdx.x * BKV;
  const int nq = (a.Tlen + BQ - 1) / BQ;
  float* accg = a.acc + (long long)bh * a.Tp * D;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 8 && lane == 0) {  // every load
      mbar_expect_tx(kvbar, 2 * L::KV_TILE);
#pragma unroll
      for (int x = 0; x < L::NB; ++x) {
        tma_load_4d(base + L::OFF_K + x * L::KV_BOX, &kmap, x * BOX, kv0, h, b,
                    kvbar);
        tma_load_4d(base + L::OFF_V + x * L::KV_BOX, &vmap, x * BOX, kv0, h, b,
                    kvbar);
      }
      const float* lrow = a.lse2 + (long long)bh * a.Tp;
      const float* drow = a.delta + (long long)bh * a.Tp;
      for (int i = 0; i < nq; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, 2 * L::Q_TILE + 2 * BQ * 4);
#pragma unroll
        for (int x = 0; x < L::NB; ++x) {
          tma_load_4d(base + L::OFF_Q + s * L::Q_TILE + x * L::Q_BOX, &qmap,
                      x * BOX, i * BQ, h, b, bar);
          tma_load_4d(base + L::OFF_DO + s * L::Q_TILE + x * L::Q_BOX, &domap,
                      x * BOX, i * BQ, h, b, bar);
        }
        bulk_load(base + L::OFF_L + s * BQ * 4, lrow + i * BQ, BQ * 4, bar);
        bulk_load(base + L::OFF_DL + s * BQ * 4, drow + i * BQ, BQ * 4, bar);
      }
    } else if (warp == 9 || warp == 10) {  // the dQ writers
      const int w = warp - 9;
      const uint32_t stage = base + L::OFF_DQ + w * L::DQ;
      named_barrier_arrive(BAR_DQ_EMPTY + w, 160);  // the stage starts free
      for (int i = 0; i < nq; ++i) {
        named_barrier(BAR_DQ_FULL + w, 160);
        if (lane == 0) {
          bulk_reduce_add_f32(accg + (long long)i * BQ * D, stage, L::DQ);
          bulk_commit();
          bulk_wait_read<0>();
        }
        __syncwarp();
        if (i + 1 < nq) named_barrier_arrive(BAR_DQ_EMPTY + w, 160);
      }
      if (lane == 0) bulk_wait<0>();
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // the consumers.  Thread (warp wl of warpgroup wg, lane 4 g + t) holds
  // rows 16 wl + g and + 8 of each m64 tile, columns 8 j + 2 t and + 1 of
  // each n8 chunk j.
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  const int key = kv0 + 64 * wg + 16 * wl + g;  // and key + 8
  const float live0 = key < a.Tlen ? 1.f : 0.f;
  const float live1 = key + 8 < a.Tlen ? 1.f : 0.f;
  const uint32_t ks = base + L::OFF_K + wg * 64 * 128;  // the warpgroup's keys
  const uint32_t vs = base + L::OFF_V + wg * 64 * 128;
  const uint32_t dss = base + L::OFF_DS + wg * L::DS;
  // this lane's stmatrix row of dS^T: matrix m = lane / 8 of a store is
  // chunk 2 q + m / 2, key row 16 wl + 8 (m % 2) + lane % 8; the chunk's
  // swizzled position (2 q + m / 2) ^ (lane % 8) split into its bits
  const uint32_t dsrow =
      dss + (16 * wl + 8 * ((lane >> 3) & 1) + (lane & 7)) * 128;
  const int sw_hi = (lane & 7) >> 1, sw_lo = ((lane >> 4) ^ lane) & 1;
  float4* dqs = reinterpret_cast<float4*>(sm + L::OFF_DQ + wg * L::DQ) +
                wl * 32 + lane;

  float dv[L::NA], dk[L::NA];
#pragma unroll
  for (int e = 0; e < L::NA; ++e) dv[e] = dk[e] = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < nq; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t qs = base + L::OFF_Q + s * L::Q_TILE;
    const uint32_t dos = base + L::OFF_DO + s * L::Q_TILE;
    const float* lse2 = reinterpret_cast<const float*>(sm + L::OFF_L) + s * BQ;
    const float* dlt = reinterpret_cast<const float*>(sm + L::OFF_DL) + s * BQ;
    // descriptors (a step adds its byte offset / 16), made here from
    // fenced values: hoisted out of the loop they took ~30 registers
    uint32_t kq = ks, vq = vs;
    keep(kq);
    keep(vq);
    const uint64_t kdesc = desc_sw128(kq), vdesc = desc_sw128(vq);
    const uint64_t qdesc = desc_sw128(qs), dodesc = desc_sw128(dos);

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, over D): both
    // operands K-major, 32 bytes a k16 step; D past 64 in the second box
    float sa[32], pa[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::NK; ++kk) {
      const uint32_t okv = ((kk / 4) * L::KV_BOX + (kk % 4) * 32) >> 4;
      const uint32_t oq = ((kk / 4) * L::Q_BOX + (kk % 4) * 32) >> 4;
      if (kk == 0)
        mma_ss<64, 0, 0, true>(sa, kdesc + okv, qdesc + oq);
      else
        mma_ss<64, 0, 0, false>(sa, kdesc + okv, qdesc + oq);
    }
#pragma unroll
    for (int kk = 0; kk < L::NK; ++kk) {
      const uint32_t okv = ((kk / 4) * L::KV_BOX + (kk % 4) * 32) >> 4;
      const uint32_t oq = ((kk / 4) * L::Q_BOX + (kk % 4) * 32) >> 4;
      if (kk == 0)
        mma_ss<64, 0, 0, true>(pa, vdesc + okv, dodesc + oq);
      else
        mma_ss<64, 0, 0, false>(pa, vdesc + okv, dodesc + oq);
    }
    wgmma_commit();

    // P^T = exp2(S^T scale log2 e - lse log2 e), zero at keys >= T (rows
    // of queries >= T have lse +inf), and dS^T = P^T (dP^T - delta), each
    // packed to bf16 A fragments as it is made: chunk j of the m64n64 tile
    // is k16 step j / 2, registers (j % 2) 2 (row g) and + 1 (row g + 8)
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      keep(sa[e]);
      keep(pa[e]);
    }
    uint32_t pf[4][4], df[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * j + 2 * hh;
        const float live = hh ? live1 : live0;
        const float p0 = ex2(sa[e] * a.scale_log2 - l.x) * live;
        const float p1 = ex2(sa[e + 1] * a.scale_log2 - l.y) * live;
        pf[j >> 1][(j & 1) * 2 + hh] = pack_bf16x2(p0, p1);
        df[j >> 1][(j & 1) * 2 + hh] =
            pack_bf16x2(p0 * (pa[e] - dl.x), p1 * (pa[e + 1] - dl.y));
      }
    }

    // dV += P^T dO and dK += dS^T Q (64 keys x D, over the 64 queries): A
    // from registers, B MN-major (D along the rows, 16 queries a step)
    const uint64_t domn = desc_sw128_mn(dos, L::Q_BOX);
    const uint64_t qmn = desc_sw128_mn(qs, L::Q_BOX);
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        keep(pf[k4][r]);
        keep(df[k4][r]);
      }
    wgmma_fence();
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) mma_rs_t<D>(dv, pf[k4], domn + k4 * 128);
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) mma_rs_t<D>(dk, df[k4], qmn + k4 * 128);
    wgmma_commit();

    // while they run, dS^T into shared memory: keys as rows of 64 queries
    // (128 bytes, 16-byte chunks swizzled as the descriptor reads them);
    // stmatrix q stores chunks 2q and 2q + 1, df[q] as it stands
    uint32_t dsr = dsrow;
    keep(dsr);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      stsm_x4(dsr + ((((q ^ sw_hi) << 1) | sw_lo) << 4), df[q]);
    fence_proxy_async();
    named_barrier(BAR_WG + wg, 128);
    wgmma_wait<0>();  // dV and dK done: the stage is free
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        keep(pf[k4][r]);
        keep(df[k4][r]);
      }
    if (lane == 0) mbar_arrive(empty + 8 * s);

    // dQ_i part = dS K over the warpgroup's 64 keys: A = dS (queries x
    // keys) MN-major, B = K (keys x D) MN-major; 16 keys (2048 bytes) a step
    uint32_t dq0 = dss;
    keep(dq0);
    const uint64_t dsdesc = desc_sw128_mn(dq0, L::DS);
    const uint64_t kmn = desc_sw128_mn(kq, L::KV_BOX);
    float qa[L::NA];
    wgmma_fence();
    mma_ss<D, 1, 1, true>(qa, dsdesc, kmn);
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      mma_ss<D, 1, 1, false>(qa, dsdesc + kk * 128, kmn + kk * 128);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < L::NA; ++e) keep(qa[e]);

    // the f32 part staged in fragment order (chunk j, warp, lane: 16 bytes
    // each) for the warpgroup's writer warp, once it has read the last one
    named_barrier(BAR_DQ_EMPTY + wg, 160);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dqs[j * 128] =
          make_float4(qa[4 * j], qa[4 * j + 1], qa[4 * j + 2], qa[4 * j + 3]);
    fence_proxy_async();
    named_barrier_arrive(BAR_DQ_FULL + wg, 160);
  }

  bf* dkp = static_cast<bf*>(a.dk) + (long long)b * a.g_b + (long long)h * a.g_h;
  bf* dvp = static_cast<bf*>(a.dv) + (long long)b * a.g_b + (long long)h * a.g_h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = key + 8 * hh;
    if (row < a.Tlen) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const long long off = (long long)row * a.g_t + 8 * j + 2 * t;
        st2(dkp + off, dk[4 * j + 2 * hh] * a.scale,
            dk[4 * j + 2 * hh + 1] * a.scale);
        st2(dvp + off, dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// the pre-pass over the rows of [B H][Tp], 32 rows a block of 256 threads,
// 8 a row (16 bytes of o and do each per step): delta = rowsum(do o) and
// lse log2 e below T (0 and +inf past it); the block's rows of acc zeroed
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const bf* __restrict__ o, const bf* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, float* __restrict__ acc,
                long long o_b, long long o_h, long long o_t, long long d_b,
                long long d_h, long long d_t, int H, int Tlen, int Tp,
                long long rows) {
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  {
    const long long bh = row / Tp;
    const int i = (int)(row % Tp);
    float s = 0.f;
    if (row < rows && i < Tlen) {
      const long long b = bh / H, h = bh % H;
      const bf* op = o + b * o_b + h * o_h + (long long)i * o_t;
      const bf* dp = dout + b * d_b + h * d_h + (long long)i * d_t;
      for (int c = 8 * part; c < D; c += 64) {
        const uint4 x = *reinterpret_cast<const uint4*>(op + c);
        const uint4 y = *reinterpret_cast<const uint4*>(dp + c);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
          const float2 yf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
          s += xf.x * yf.x + xf.y * yf.y;
        }
      }
    }
#pragma unroll
    for (int m = 4; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (part == 0 && row < rows) {
      delta[row] = s;
      lse2[row] = i < Tlen ? lse[bh * Tlen + i] * LOG2E : INFINITY;
    }
  }
  // rows [32 x, 32 x + 32) of acc are 32 D contiguous floats
  float4* z = reinterpret_cast<float4*>(acc + (long long)blockIdx.x * 32 * D);
  const long long left = (rows - (long long)blockIdx.x * 32) * D / 4;
  for (int e = threadIdx.x; e < 8 * D && e < left; e += 256)
    z[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// the post-pass: dq[b, i, h, c] = bf16(acc * scale).  One thread takes one
// 16-byte entry of acc's fragment order (chunk j, warp w, lane 4 g + t of a
// 64-row tile: rows 16 w + g and + 8, columns 8 j + 2 t and + 1)
template <int D>
__global__ void __launch_bounds__(256)
bwd_dq_kernel(const float* __restrict__ acc, bf* __restrict__ dq,
              long long g_b, long long g_h, long long g_t, int H, int Tlen,
              int Tp, float scale, long long entries) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= entries) return;
  const float4 v = reinterpret_cast<const float4*>(acc)[idx];
  const int e = (int)(idx % (BQ * D / 4));  // entry within the tile
  const long long tile = idx / (BQ * D / 4);
  const long long bh = tile / (Tp / BQ);
  const int r0 = (int)(tile % (Tp / BQ)) * BQ;
  const int lane = e & 31, w = (e >> 5) & 3, j = e >> 7;
  const int i = r0 + 16 * w + (lane >> 2), c = 8 * j + 2 * (lane & 3);
  const long long b = bh / H, h = bh % H;
  bf* p = dq + b * g_b + h * g_h + c;
  if (i < Tlen) st2(p + (long long)i * g_t, v.x * scale, v.y * scale);
  if (i + 8 < Tlen)
    st2(p + (long long)(i + 8) * g_t, v.z * scale, v.w * scale);
}

// the tensor map of a [B, H, T, D] bf16 view (head dim contiguous, strides
// in elements): boxes of 64 columns x rows, 128-byte swizzle, columns past
// D and rows past T read as zeros
int qkv_map(CUtensorMap* map, const void* p, int d, int Tlen, int H, int B,
            long long st, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)Tlen, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, (cuuint32_t)rows, 1, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, p, dims,
                           strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int run(const BwdArgs& x, float* work, cudaStream_t st) {
  using L = G<D>;
  const int Tp = (x.Tlen + BQ - 1) / BQ * BQ;
  const long long rows = (long long)x.B * x.H * Tp;
  float* lse2 = work;
  float* delta = work + rows;
  float* acc = work + 2 * rows;
  CUtensorMap qm, km, vm, dm;
  int err = qkv_map(&qm, x.q, D, x.Tlen, x.H, x.B, x.s_t, x.s_h, x.s_b, BQ);
  if (!err) err = qkv_map(&km, x.k, D, x.Tlen, x.H, x.B, x.s_t, x.s_h, x.s_b, BKV);
  if (!err) err = qkv_map(&vm, x.v, D, x.Tlen, x.H, x.B, x.s_t, x.s_h, x.s_b, BKV);
  if (!err) err = qkv_map(&dm, x.dout, D, x.Tlen, x.H, x.B, x.d_t, x.d_h, x.d_b, BQ);
  if (err) return err;
  bwd_prep_kernel<D><<<(unsigned)((rows + 31) / 32), 256, 0, st>>>(
      static_cast<const bf*>(x.o), static_cast<const bf*>(x.dout), x.lse, lse2,
      delta, acc, x.o_b, x.o_h, x.o_t, x.d_b, x.d_h, x.d_t, x.H, x.Tlen, Tp,
      rows);
  if ((err = (int)cudaGetLastError())) return err;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    if ((err = (int)cudaFuncSetAttribute(
             bwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             L::SMEM)))
      return err;
    opted = true;
  }
  const Args a{lse2, delta, acc, x.dk, x.dv, x.g_b, x.g_h, x.g_t, x.H, x.Tlen,
               Tp, x.scale * LOG2E, x.scale};
  dim3 grid((unsigned)((x.Tlen + BKV - 1) / BKV), (unsigned)(x.B * x.H));
  bwd_wgmma_kernel<D><<<grid, THREADS, L::SMEM, st>>>(qm, km, vm, dm, a);
  if ((err = (int)cudaGetLastError())) return err;
  const long long entries = rows * D / 4;
  bwd_dq_kernel<D><<<(unsigned)((entries + 255) / 256), 256, 0, st>>>(
      acc, static_cast<bf*>(x.dq), x.g_b, x.g_h, x.g_t, x.H, x.Tlen, Tp,
      x.scale, entries);
  return (int)cudaGetLastError();
}

}  // namespace hop

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

// the FMA kernels (f32) or the mma.sync kernels (bf16, d 16 and 32) after
// the delta pre-pass into work ([B H][T] f32)
template <int D>
int run_d(int dtype, BwdArgs a, float* work, cudaStream_t st) {
  a.delta = work;
  const unsigned bh = (unsigned)(a.B * a.H);
  const long long rows = (long long)a.B * a.H * a.Tlen;
  const unsigned nb = (unsigned)((rows + 7) / 8);
  if (dtype == 0) {
    delta_kernel<float><<<nb, 256, 0, st>>>(
        static_cast<const float*>(a.o), static_cast<const float*>(a.dout),
        work, a.o_b, a.o_h, a.o_t, a.d_b, a.d_h, a.d_t, a.H, a.Tlen, D, rows);
    dim3 grid((unsigned)((a.Tlen + FT - 1) / FT), bh);
    dkdv_f32<D><<<grid, NTHR, 0, st>>>(a);
    dq_f32<D><<<grid, NTHR, 0, st>>>(a);
  } else if constexpr (D <= 32) {
    delta_kernel<bf><<<nb, 256, 0, st>>>(
        static_cast<const bf*>(a.o), static_cast<const bf*>(a.dout), work,
        a.o_b, a.o_h, a.o_t, a.d_b, a.d_h, a.d_t, a.H, a.Tlen, D, rows);
    dim3 grid((unsigned)((a.Tlen + BT - 1) / BT), bh);
    dkdv_bf16<D><<<grid, NTHR, 0, st>>>(a);
    dq_bf16<D><<<grid, NTHR, 0, st>>>(a);
  } else {
    return hop::run<D>(a, work, st);
  }
  return (int)cudaGetLastError();
}

// the launch plan of ops/attention.py:_bwd_plan, which must agree with this
// file's constants: path 0 the f32 kernels (FT-row tiles), 1 the bf16
// mma.sync kernels (BT-row tiles), 2 the bf16 wgmma pass (hop::BKV keys a
// block, hop::BQ queries a stage, hop::STAGES stages, G<d>::SMEM bytes)
bool plan_ok(int dtype, int d, int path, int bkv, int bq, int stages,
             int smem) {
  const int want = dtype == 0 ? 0 : d <= 32 ? 1 : 2;
  if (path != want) return false;
  if (path == 0) return bkv == FT && bq == FT && stages == 0 && smem == 0;
  if (path == 1) return bkv == BT && bq == BT && stages == 0 && smem == 0;
  const int need = d == 64 ? hop::G<64>::SMEM : hop::G<72>::SMEM;
  return bkv == hop::BKV && bq == hop::BQ && stages == hop::STAGES &&
         smem == need;
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16; d: 16, 32, 64 or 72.  q, k, v share the
// element strides s_*; o, do and the gradients dq, dk, dv (which share
// g_*) have their own; the head dim is contiguous everywhere and, for
// bfloat16, every stride is a positive multiple of 8 elements and every
// row start of q, k, v and do 16-byte aligned (checked by the Python
// wrapper; the wgmma pass reads them through tensor maps).  lse: the
// forward's f32 [B, H, T] logsumexp of the scaled scores.  work: f32
// scratch, [B H][T] (delta) for paths 0 and 1; for path 2 [B H][Tp] lse
// log2 e, [B H][Tp] delta and [B H][Tp][d] dq sums, Tp = T rounded up to
// hop::BQ.  scale: the forward's score scale (1 for the splash form).
// path .. smem: the plan (plan_ok), else nothing runs.
int natdiff_attention_bwd(int dtype, int d, const void* q, const void* k,
                          const void* v, const void* o, const void* dout,
                          const float* lse, float* work, void* dq, void* dk,
                          void* dv, long long s_b, long long s_h, long long s_t,
                          long long o_b, long long o_h, long long o_t,
                          long long d_b, long long d_h, long long d_t,
                          long long g_b, long long g_h, long long g_t, int B,
                          int H, int Tlen, float scale, int path, int bkv,
                          int bq, int stages, int smem, void* stream) {
  if (Tlen <= 0 || B <= 0 || H <= 0 || (long long)B * H > 65535 ||
      (dtype != 0 && dtype != 1) ||
      (d != 16 && d != 32 && d != 64 && d != 72) ||
      !plan_ok(dtype, d, path, bkv, bq, stages, smem))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, lse, nullptr, dq, dk, dv, s_b, s_h, s_t,
                  o_b, o_h, o_t, d_b, d_h, d_t, g_b, g_h, g_t, B, H, Tlen,
                  scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return run_d<16>(dtype, a, work, st);
    case 32: return run_d<32>(dtype, a, work, st);
    case 64: return run_d<64>(dtype, a, work, st);
    case 72: return run_d<72>(dtype, a, work, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
