// 3x3, stride-1, SAME-padded NHWC convolution as an implicit GEMM, with the
// fused-resblock prologue and epilogue:
//
//   xin  = HAS_PRE ? round_to_T(silu(x * pre_w[b, ci] + pre_b[b, ci])) : x
//   acc  = sum_{tap, ci} xin[b, h+dy, w+dx, ci] * w[dy, dx, ci, co]   (f32)
//          + bias[co]
//   acc  = HAS_SKIP ? (acc + skip[b, h, w, co]) * out_scale : acc
//   y    = round_to_T(acc)
//   s1[b, co] += acc, s2[b, co] += acc * acc        (EMIT_STATS)
//
// Replaces four Pallas TPU kernels of naturaldiffusion_tpu/ops/conv3x3.py,
// all one function on the H100:
//   * `_conv_kernel` (K2, via `conv3x3_pallas` / `_pallas_conv_call`): no
//     prologue, skip or statistics;
//   * `_conv_gn_kernel` (K3, via `conv3x3_gn_pallas` / `_pallas_fused_call`):
//     the other flag sets;
//   * `_conv_tiled_kernel` (K4, via `_pallas_conv_tiled_call`) and
//     `_conv_tiledew_kernel` (K5, via `_pallas_conv_tiledew_call`): K2's
//     function on large maps; the two TPU kernels differ only in how VMEM
//     is filled (H-tiles with zeroed edge rows, or overlapping windows of a
//     padded input).
// Entries: `natdiff_conv3x3` (K2, K3) and `natdiff_conv3x3_tiled` (K4, K5).
//
// bf16: `tc::conv3x3_tc_kernel`, on the tensor cores.  Bound on the H100:
// operations.  At the main shapes ([64,32,32,128] -> 128, 19.3 GFLOP on
// ~50 MB) the conv does ~390 flop per byte, above the bf16 ridge of ~295
// (989 TFLOP/s over 3.35 TB/s), so it pays only on the tensor cores, as
// the TPU kernel feeds its matrix unit bf16 tap by tap with f32 sums.  The
// design:
//   * A 2-D halo tile.  A block owns TH x TW output pixels of one image, or
//     several whole images of the 8x8 and 4x4 maps, times BN output
//     channels.  Per chunk of BK = 64 input channels it stages the
//     (TH+2) x (TW+2) halo once, [pixel][channel] in bf16 with a padded row
//     stride, zeros where the halo leaves the image (SAME padding of the
//     post-SiLU activation: 0, never silu(pre_b)).  Each image of a
//     multi-image tile has its own halo, so no image leaks into another.
//     The chunk comes by cp.async with zero fill, two buffers deep: the
//     next chunk is requested at the current chunk's first tap.
//   * The prologue once per staged pixel, in place in shared memory before
//     the chunk is read, not once per tap and column block as a flat-row
//     tile would need.
//   * The nine taps are nine shifted reads of one staged tile: ldmatrix
//     takes one row address per lane, so the A fragment of tap (dy, dx) is
//     the halo rows of pixels (r+dy, c+dx), gathered with no copy.
//   * The weights, a plain [9 Cin, Cout] matrix, stream through a ring of
//     three BK x BN shared-memory stages by cp.async, two in flight.
//   * Products: mma.sync m16n8k16, bf16 in, f32 accumulate; 8 warps of
//     (BM/2) x (BN/4), two blocks per SM (at most 128 registers a thread;
//     per-row halo tables in shared memory keep the staging's index
//     arithmetic out of the registers, so nothing spills).  The epilogue
//     runs from the accumulators; statistics reduce in the warp by
//     shuffles, across the block in shared memory, and leave by one f32
//     atomic per (sample, column) and block.
//   * Tile sizes (128x128, 64x128 or 64x64), the spatial tile and the grid
//     come from a plan chosen in Python (`ops/conv3x3.py:_tile_plan`) so
//     that small maps still fill the 132 SMs; the entry checks the plan
//     against its own constants.  K is never split: the statistics and the
//     skip need the whole sum.
//   * wgmma (m64nNk16, A from registers gathered by the same ldmatrix, B by
//     descriptor from a core-matrix ring) was built, right at every shape,
//     and measured 1.1-1.5x slower than this loop on an NVIDIA H100 80GB
//     HBM3 at 700 W (PERF.md): each k step waited on its wgmma
//     before the next barrier, and letting one group run on raced.
//
// Traps both forms keep: the prologue output is rounded to x's type before
// the product, as the TPU kernel does (`xf.astype(x_ref.dtype)`); the
// statistics are of the final f32 value (after bias, skip and rescale),
// before the cast, and every output row carries its own sample index;
// channel counts that are not multiples of the tile (the 3 -> 128 stem,
// the -> 3 heads) are masked on load and on store.
//
// float32: the SIMT kernels below, unchanged.  f32 is the type of the
// checks' oracle runs, not one users sample in; a bf16 hi/lo split on the
// tensor cores would leave each conv ~1.5e-5 off, which ~90 convs of a
// forward would bring near the 1e-4 forward check.  The dispatch by type
// is explicit in the entries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

// ---------------------------------------------------------------------------
// The float32 kernels (only T = float is instantiated): a block computes a
// BM x BN tile of the [B*H*W, Cout] output with SIMT f32 FMAs (4x4 outputs
// per thread, operands from shared memory), bounded by the card's 67
// TFLOP/s f32 rate.

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per stage
constexpr int THREADS = 256;
constexpr int A_ROWS = THREADS / BK;   // pixel rows loaded per pass (8)
constexpr int B_ROWS = THREADS / BN;   // channel rows loaded per pass (4)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

template <typename T, bool HAS_PRE, bool HAS_SKIP, bool EMIT_STATS>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, const float* __restrict__ pre_w,
               const float* __restrict__ pre_b, const T* __restrict__ skip,
               float out_scale, T* __restrict__ y, float* __restrict__ s1,
               float* __restrict__ s2, int B, int H, int W, int Cin,
               int Cout) {
  __shared__ __align__(16) float As[BK][BM + 4];  // [channel][pixel]
  __shared__ __align__(16) float Bs[BK][BN];      // [channel][out channel]
  __shared__ float red1[BN], red2[BN];

  const int tid = threadIdx.x;
  const int HW = H * W;
  const long long M = (long long)B * HW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // input-tile loads: thread owns channel a_col of pixel rows a_row0 + A_ROWS*i
  const int a_col = tid % BK;
  const int a_row0 = tid / BK;
  int a_b[BM / A_ROWS], a_h[BM / A_ROWS], a_w[BM / A_ROWS];
#pragma unroll
  for (int i = 0; i < BM / A_ROWS; ++i) {
    long long m = m0 + a_row0 + A_ROWS * i;
    if (m < M) {
      a_b[i] = (int)(m / HW);
      int r = (int)(m % HW);
      a_h[i] = r / W;
      a_w[i] = r % W;
    } else {
      a_b[i] = -1;  // past the last pixel: loads zero
      a_h[i] = a_w[i] = 0;
    }
  }
  // weight-tile loads: thread owns out channel b_n of channel rows b_k0 + B_ROWS*i
  const int b_n = tid % BN;
  const int b_k0 = tid / BN;
  // compute: thread owns rows ty*4..ty*4+3 and columns tx*4..tx*4+3
  const int tx = tid % (BN / 4);
  const int ty = tid / (BN / 4);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ci = c0 + a_col;
#pragma unroll
      for (int i = 0; i < BM / A_ROWS; ++i) {
        const int hh = a_h[i] + dy, ww = a_w[i] + dx;
        float v = 0.f;
        if (a_b[i] >= 0 && ci < Cin && hh >= 0 && hh < H && ww >= 0 &&
            ww < W) {
          v = to_f(x[(((long long)a_b[i] * H + hh) * W + ww) * Cin + ci]);
          if (HAS_PRE) {
            const int pc = a_b[i] * Cin + ci;
            // two IEEE-rounded operations, no FMA contraction, and SiLU as
            // x / (1 + exp(-x)): the plain version's float32 arithmetic, so
            // the rounding to x's type below lands on the same value
            v = __fadd_rn(__fmul_rn(v, pre_w[pc]), pre_b[pc]);
            v = __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
            v = to_f(from_f<T>(v));    // rounded to x's type
          }
        }
        As[a_col][a_row0 + A_ROWS * i] = v;
      }
      const int co = n0 + b_n;
#pragma unroll
      for (int i = 0; i < BK / B_ROWS; ++i) {
        const int k = b_k0 + B_ROWS * i;
        const int cik = c0 + k;
        float v = 0.f;
        if (cik < Cin && co < Cout)
          v = to_f(w[((long long)tap * Cin + cik) * Cout + co]);
        Bs[k][b_n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: bias, skip, rescale, cast, statistics
  const long long m_last = (m0 + BM < M ? m0 + BM : M) - 1;
  const bool one_sample = (m0 / HW) == (m_last / HW);  // block-uniform
  float p1[4] = {0.f, 0.f, 0.f, 0.f}, p2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const int bi = (int)(m / HW);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= Cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f(bias[co]);
      if (HAS_SKIP) v = (v + to_f(skip[m * Cout + co])) * out_scale;
      y[m * Cout + co] = from_f<T>(v);
      if (EMIT_STATS) {
        if (one_sample) {
          p1[j] += v;
          p2[j] += v * v;
        } else {
          atomicAdd(&s1[(long long)bi * Cout + co], v);
          atomicAdd(&s2[(long long)bi * Cout + co], v * v);
        }
      }
    }
  }
  if (EMIT_STATS && one_sample) {
    // every row of the block is one sample: reduce in shared memory first,
    // then one global atomic per column and block
    if (tid < BN) red1[tid] = red2[tid] = 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + tx * 4 + j < Cout) {
        atomicAdd(&red1[tx * 4 + j], p1[j]);
        atomicAdd(&red2[tx * 4 + j], p2[j]);
      }
    }
    __syncthreads();
    if (tid < BN && n0 + tid < Cout) {
      const long long o = (m0 / HW) * Cout + n0 + tid;
      atomicAdd(&s1[o], red1[tid]);
      atomicAdd(&s2[o], red2[tid]);
    }
  }
}

template <typename T, bool P, bool S, bool E>
void launch_one(dim3 grid, cudaStream_t st, const void* x, const void* w,
                const void* bias, const float* pre_w, const float* pre_b,
                const void* skip, float out_scale, void* y, float* s1,
                float* s2, int B, int H, int W, int Cin, int Cout) {
  conv3x3_kernel<T, P, S, E><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), pre_w, pre_b, static_cast<const T*>(skip),
      out_scale, static_cast<T*>(y), s1, s2, B, H, W, Cin, Cout);
}

template <typename T>
void launch(int has_pre, int has_skip, int emit_stats, dim3 grid,
            cudaStream_t st, const void* x, const void* w, const void* bias,
            const float* pre_w, const float* pre_b, const void* skip,
            float out_scale, void* y, float* s1, float* s2, int B, int H,
            int W, int Cin, int Cout) {
  const int key = (has_pre ? 4 : 0) | (has_skip ? 2 : 0) | (emit_stats ? 1 : 0);
#define NATDIFF_CASE(K, P, S, E)                                               \
  case K:                                                                      \
    launch_one<T, P, S, E>(grid, st, x, w, bias, pre_w, pre_b, skip,           \
                           out_scale, y, s1, s2, B, H, W, Cin, Cout);          \
    break;
  switch (key) {
    NATDIFF_CASE(0, false, false, false)
    NATDIFF_CASE(1, false, false, true)
    NATDIFF_CASE(2, false, true, false)
    NATDIFF_CASE(3, false, true, true)
    NATDIFF_CASE(4, true, false, false)
    NATDIFF_CASE(5, true, false, true)
    NATDIFF_CASE(6, true, true, false)
    NATDIFF_CASE(7, true, true, true)
  }
#undef NATDIFF_CASE
}

}  // namespace

// ---------------------------------------------------------------------------
// Halo-tiled conv for large maps: the same function as the instance of
// `conv3x3_kernel` without prologue, skip or statistics (3x3, stride 1,
// SAME, + bias, f32 accumulation, output in x's type).
//
// Replaces two Pallas TPU kernels of naturaldiffusion_tpu/ops/conv3x3.py:
//   * `_conv_tiled_kernel` (via `_pallas_conv_tiled_call`): a grid step DMAs
//     one H-tile of rows plus a one-row halo on each side into VMEM, with
//     the image-edge halo rows zeroed, and runs the nine taps;
//   * `_conv_tiledew_kernel` (via `_pallas_conv_tiledew_call`): the same
//     function with the halo fetched as overlapping element windows of a
//     zero-padded input.
// The two differ only in how VMEM is filled, so one kernel serves both.
// A block owns TH x TW output pixels of one sample and a slice of BN output
// channels.  Per chunk of BK input channels it stages the (TH+2) x (TW+2)
// halo tile in shared memory, zeros where the halo leaves the image (SAME
// padding), and the 9 x BK x BN weights beside it; each thread then
// accumulates 8 neighbouring pixels of one row x 4 output channels in f32,
// reusing each staged input row across the three horizontal taps.  The tile
// is two-dimensional because a whole 256-pixel row times a channel chunk
// would not leave room for enough blocks per SM.
//
// The float32 form of K4/K5; bf16 takes the tensor-core kernel below.
// Like the kernel above it accumulates with SIMT f32 FMAs.

namespace {

constexpr int TT_H = 8;     // output rows per block
constexpr int TT_W = 16;    // output columns per block
constexpr int TT_N = 64;    // output channels per block
constexpr int TT_K = 8;     // input channels per stage
constexpr int TT_HALO_H = TT_H + 2, TT_HALO_W = TT_W + 2;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ y, int H,
                     int W, int Cin, int Cout, int tiles_w) {
  __shared__ __align__(16) float xs[TT_K][TT_HALO_H][TT_HALO_W];
  __shared__ __align__(16) float ws[9][TT_K][TT_N];

  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_w) * TT_H;
  const int w0 = (blockIdx.x % tiles_w) * TT_W;
  const int n0 = blockIdx.y * TT_N;
  const int b = blockIdx.z;
  const T* xb = x + (long long)b * H * W * Cin;

  // compute: thread owns output channels tc*4.. and pixels (row, col0..+7)
  const int tc = tid % (TT_N / 4);
  const int tp = tid / (TT_N / 4);
  const int row = tp / 2;
  const int col0 = (tp % 2) * 8;

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += TT_K) {
    // the halo tile, input channel fastest: zero outside the image
    for (int i = tid; i < TT_K * TT_HALO_H * TT_HALO_W; i += THREADS) {
      const int ci = i % TT_K;
      const int pix = i / TT_K;
      const int hr = pix / TT_HALO_W, hc = pix % TT_HALO_W;
      const int gh = h0 + hr - 1, gw = w0 + hc - 1;
      float v = 0.f;
      if (gh >= 0 && gh < H && gw >= 0 && gw < W && c0 + ci < Cin)
        v = to_f(xb[((long long)gh * W + gw) * Cin + c0 + ci]);
      xs[ci][hr][hc] = v;
    }
    // the weights of this chunk, output channel fastest
    for (int i = tid; i < 9 * TT_K * TT_N; i += THREADS) {
      const int co = i % TT_N;
      const int k = (i / TT_N) % TT_K;
      const int tap = i / (TT_N * TT_K);
      float v = 0.f;
      if (c0 + k < Cin && n0 + co < Cout)
        v = to_f(w[((long long)tap * Cin + c0 + k) * Cout + n0 + co]);
      ws[tap][k][co] = v;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < TT_K; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float a[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) a[j] = xs[ci][row + dy][col0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&ws[dy * 3 + dx][ci][tc * 4]);
          const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[j][q] = fmaf(a[j + dx], wq[q], acc[j][q]);
        }
      }
    }
    __syncthreads();
  }

  const int oh = h0 + row;
  if (oh >= H) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ow = w0 + col0 + j;
    if (ow >= W) continue;
    T* yp = y + (((long long)b * H + oh) * W + ow) * Cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int co = n0 + tc * 4 + q;
      if (co >= Cout) continue;
      float v = acc[j][q];
      if (bias != nullptr) v += to_f(bias[co]);
      yp[co] = from_f<T>(v);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel: one template for every bf16 call of both
// entries (K2, K3, K4, K5).  See the header comment for the design; the
// pipeline, per iteration it = 9 chunk + tap: wait for weight stage it,
// barrier, request stage it + 2 (and, at tap 0, the next chunk's halo),
// 4 k16 steps of products, and at tap 8 the next chunk's prologue.

namespace {  // internal linkage: each library keeps its own instances
namespace tc {

constexpr int BK = 64;       // input channels per chunk
constexpr int STAGES = 3;    // weight ring depth
constexpr int THREADS = 256; // 8 warps: 2 down the pixels, 4 across channels
constexpr int SA = BK + 8;   // halo row stride (bf16): 144 B, 8 rows -> 8 bank groups
constexpr int CPR = BK / 8;  // 16-byte vectors per halo row

// A block owns BM = 32 MI output pixels x BN = 32 NI output channels; warp
// (wr, wc) owns 16 MI pixels x 8 NI channels.
template <int MI, int NI>
struct Tile {
  static constexpr int BM = 32 * MI;
  static constexpr int BN = 32 * NI;
  static constexpr int SB = BN + 8;  // weight row stride (bf16): 8 bank groups
  // the halo of BM pixels is at most 9/4 BM rows (4x4 images, 6x6 each)
  static constexpr int HALO_MAX = BM * 9 / 4;
  static constexpr int MAXV = (HALO_MAX * CPR + THREADS - 1) / THREADS;
};

// The tile plan (chosen in Python by ops/conv3x3.py:_tile_plan): a block's
// pixels are imgs images x th rows x tw columns; imgs > 1 only for whole
// images (th = H, tw = W) of a multiple of 16 pixels.
struct Plan {
  int imgs, th, tw, tiles_w, tiles_h;
};

__host__ __device__ inline int halo_rows(const Plan& p) {
  return p.imgs * (p.th + 2) * (p.tw + 2);
}

inline size_t smem_bytes(int bn, const Plan& p, int cin, bool pre,
                         bool stats) {
  return (size_t)2 * halo_rows(p) * SA * 2 + (size_t)STAGES * BK * (bn + 8) * 2 +
         (pre ? (size_t)2 * p.imgs * cin * 4 : 0) +
         (stats ? (size_t)2 * p.imgs * bn * 4 : 0) +
         ((size_t)halo_rows(p) * 5 + 15) / 16 * 16;
}

template <int MI, int NI, bool HAS_PRE, bool HAS_SKIP, bool EMIT_STATS>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ bias,
                  const float* __restrict__ pre_w,
                  const float* __restrict__ pre_b,
                  const __nv_bfloat16* __restrict__ skip, float out_scale,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ s1,
                  float* __restrict__ s2, int B, int H, int W, int Cin,
                  int Cout, Plan pl, int vec_x, int vec_w) {
  using T = Tile<MI, NI>;
  constexpr int BN = T::BN, SB = T::SB, MAXV = T::MAXV;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = halo_rows(pl);
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][rows][SA]
  __nv_bfloat16* ring = halo + 2 * rows * SA;                    // [STAGES][BK][SB]
  float* pre_s = reinterpret_cast<float*>(ring + STAGES * BK * SB);  // [2][imgs][Cin]
  float* red = pre_s + (HAS_PRE ? 2 * pl.imgs * Cin : 0);            // [2][imgs][BN]
  int* row_src = reinterpret_cast<int*>(red + (EMIT_STATS ? 2 * pl.imgs * BN : 0));  // [rows]
  unsigned char* row_img = reinterpret_cast<unsigned char*>(row_src + rows);       // [rows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row within 8
  const int t4 = lane & 3;  // fragment column pair
  const int wm = (warp >> 2) * 16 * MI;
  const int wn = (warp & 3) * 8 * NI;

  const int tx = blockIdx.x % pl.tiles_w;
  const int ty = (blockIdx.x / pl.tiles_w) % pl.tiles_h;
  const int b0 = blockIdx.x / (pl.tiles_w * pl.tiles_h) * pl.imgs;
  const int h0 = ty * pl.th, w0 = tx * pl.tw;
  const int n0 = blockIdx.y * BN;
  const int hw_t = pl.th * pl.tw;    // pixels of one image in the tile
  const int hrow = pl.tw + 2;        // halo row length
  const int himg = (pl.th + 2) * hrow;  // halo rows of one image

  // the tables the staging reads, filled once: the prologue's
  // coefficients of the tile's images; per halo row its pixel's index in
  // x (-1 outside the image: SAME padding, zero) and its image in the
  // tile; and the zeroed statistics of the block
  if (HAS_PRE) {
    for (int i = tid; i < pl.imgs * Cin; i += THREADS) {
      const int b = b0 + i / Cin;
      const long long o = (long long)b * Cin + i % Cin;
      pre_s[i] = b < B ? pre_w[o] : 0.f;
      pre_s[pl.imgs * Cin + i] = b < B ? pre_b[o] : 0.f;
    }
  }
  for (int r = tid; r < rows; r += THREADS) {
    const int img = r / himg, rr = r % himg;
    const int b = b0 + img;
    const int gh = h0 + rr / hrow - 1, gw = w0 + rr % hrow - 1;
    row_src[r] = (b < B && gh >= 0 && gh < H && gw >= 0 && gw < W)
                     ? (b * H + gh) * W + gw : -1;
    row_img[r] = (unsigned char)img;
  }
  if (EMIT_STATS)
    for (int i = tid; i < 2 * pl.imgs * BN; i += THREADS) red[i] = 0.f;
  __syncthreads();

  // halo staging: vector v = tid + THREADS j holds channels ch8..ch8+7 of
  // halo row v / CPR
  const int ch8 = (tid % CPR) * 8;
  // the chunk at c0 into halo buffer buf: cp.async with zero fill, or
  // plain copies where Cin % 8 != 0 (the 3-channel stem: one chunk)
  auto issue_x = [&](int buf, int c0) {
    __nv_bfloat16* hb = halo + buf * rows * SA;
    const int c = c0 + ch8;
#pragma unroll 1
    for (int j = 0; j < MAXV; ++j) {
      const int r = (tid + THREADS * j) / CPR;
      if (r >= rows) break;
      const int src = row_src[r];
      __nv_bfloat16* dst = hb + r * SA + ch8;
      const __nv_bfloat16* p = x + (long long)(src < 0 ? 0 : src) * Cin + c;
      if (vec_x) {  // Cin % 8 == 0: the vector is wholly in or out
        const bool ok = src >= 0 && c < Cin;
        cp_async16(dst, ok ? p : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[q] = (src >= 0 && c + q < Cin) ? p[q] : __float2bfloat16(0.f);
      }
    }
  };
  // the prologue, once per staged pixel and in place, on the vectors this
  // thread copied (so its own wait suffices): as the plain version computes
  // it, two IEEE-rounded operations (no FMA contraction), SiLU as
  // x / (1 + exp(-x)), rounded to bf16; halo zeros and channels past Cin
  // stay 0
  auto prologue_x = [&](int buf, int c0) {
    __nv_bfloat16* hb = halo + buf * rows * SA;
#pragma unroll 1
    for (int j = 0; j < MAXV; ++j) {
      const int r = (tid + THREADS * j) / CPR;
      if (r >= rows) break;
      if (row_src[r] < 0) continue;
      __nv_bfloat16* d = hb + r * SA + ch8;
      const float* pw = pre_s + row_img[r] * Cin;
      const float* pb = pw + pl.imgs * Cin;
      // element by element in shared memory: few live registers beside
      // the accumulators
#pragma unroll 1
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + ch8 + q;
        float f = 0.f;
        if (c < Cin) {
          f = __fadd_rn(__fmul_rn(__bfloat162float(d[q]), pw[c]), pb[c]);
          f = __fdiv_rn(f, __fadd_rn(1.f, expf(-f)));
        }
        d[q] = __float2bfloat16(f);
      }
    }
  };

  // weight slices: iteration it = 9 kc + tap reads w[tap][kc BK + k][n0 + n]
  auto load_w = [&](int stage, int it) {
    const int kc = it / 9, tap = it - 9 * kc;
    __nv_bfloat16* dst = ring + stage * BK * SB;
#pragma unroll
    for (int rep = 0; rep < BK * BN / 8 / THREADS; ++rep) {
      const int i = tid + THREADS * rep;
      const int k = i / (BN / 8), cn = (i % (BN / 8)) * 8;
      const int ci = kc * BK + k, co = n0 + cn;
      const long long o = ((long long)tap * Cin + ci) * Cout + co;
      if (vec_w) {  // Cout % 8 == 0: the vector is wholly in or out
        const bool ok = ci < Cin && co < Cout;
        cp_async16(dst + k * SB + cn, ok ? w + o : w, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          dst[k * SB + cn + q] = (ci < Cin && co + q < Cout)
                                     ? w[o + q] : __float2bfloat16(0.f);
      }
    }
  };

  // each lane's ldmatrix row: pixel wm + 16 mi + (lane & 15), as the halo
  // row of its top-left tap; tap (dy, dx) adds dy * hrow + dx
  // (two 16-bit rows a register: halo rows number at most 9/4 BM)
  uint32_t abase[(MI + 1) / 2] = {};
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = wm + mi * 16 + (lane & 15);
    const uint32_t a = (p / hw_t) * himg + (p % hw_t / pl.tw) * hrow + p % pl.tw;
    abase[mi / 2] |= a << (16 * (mi % 2));
  }
  const int a_col = (lane >> 4) * 8;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int KC = (Cin + BK - 1) / BK;
  const int NIT = 9 * KC;
  issue_x(0, 0);
  cp_async_commit();
  if (HAS_PRE) {
    cp_async_wait<0>();
    prologue_x(0, 0);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < NIT) load_w(s, s);
    cp_async_commit();
  }

  int kc = 0, tap = 0;
  for (int it = 0; it < NIT; ++it) {
    // stage `it` has landed for every thread, and every thread is past
    // iteration it - 1, whose stage the next load overwrites
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < NIT) load_w((it + STAGES - 1) % STAGES, it + STAGES - 1);
    // the next chunk's halo rides in this iteration's group, which has
    // landed by tap STAGES - 1; its buffer was last read in chunk kc - 1
    const bool next = kc + 1 < KC;
    if (tap == 0 && next) issue_x((kc + 1) & 1, (kc + 1) * BK);
    cp_async_commit();

    const __nv_bfloat16* hb =
        halo + (kc & 1) * rows * SA + ((tap / 3) * hrow + tap % 3) * SA + a_col;
    const __nv_bfloat16* wb = ring + (it % STAGES) * BK * SB;
#pragma unroll 1
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bfr[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, wb + (ks + (lane & 15)) * SB + wn + nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        uint32_t af[4];
        ldsm_x4(af, hb + ((abase[mi / 2] >> (16 * (mi % 2))) & 0xFFFFu) * SA + ks);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16(acc[mi][ni], af, bfr[ni][0], bfr[ni][1]);
      }
    }
    // the next chunk's halo is read after chunk kc + 1's first barrier
    if (HAS_PRE && tap == 8 && next) prologue_x((kc + 1) & 1, (kc + 1) * BK);
    if (++tap == 9) {
      tap = 0;
      ++kc;
    }
  }
  cp_async_wait<0>();

  // epilogue: bias, skip, rescale, cast; acc keeps the final f32 value of
  // each stored element (0 elsewhere) for the statistics
  const bool pair = (Cout % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm + mi * 16 + g + 8 * h;
      const int b = b0 + p / hw_t;
      const int oh = h0 + p % hw_t / pl.tw, ow = w0 + p % pl.tw;
      const bool valid = b < B && oh < H && ow < W;
      const long long m = ((long long)b * H + oh) * W + ow;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t4;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = col + e;
          v[e] = 0.f;
          if (valid && co < Cout) {
            v[e] = acc[mi][ni][2 * h + e];
            if (bias != nullptr) v[e] += __bfloat162float(bias[co]);
            if (HAS_SKIP)
              v[e] = (v[e] + __bfloat162float(skip[m * Cout + co])) * out_scale;
          }
          acc[mi][ni][2 * h + e] = v[e];
        }
        if (!valid || col >= Cout) continue;
        __nv_bfloat16* yp = y + m * Cout + col;
        if (pair && col + 1 < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          yp[0] = __float2bfloat16(v[0]);
          if (col + 1 < Cout) yp[1] = __float2bfloat16(v[1]);
        }
      }
    }
  }

  if (EMIT_STATS) {
    // every m16 row tile lies in one image (the plan's invariant): sum its
    // rows g, g+8 in the thread, then over g by shuffles (lanes that share
    // a column), then across the two warps of a column in shared memory
    float* red1 = red;
    float* red2 = red + pl.imgs * BN;
    const bool one_img = pl.imgs == 1;
    float p1[NI][2], p2[NI][2];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      p1[ni][0] = p1[ni][1] = p2[ni][0] = p2[ni][1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float u = acc[mi][ni][e], v = acc[mi][ni][2 + e];
          p1[ni][e] += u + v;
          p2[ni][e] += u * u + v * v;
        }
      // one image in the whole tile: flush once, after the last row tile
      if (one_img && mi + 1 < MI) continue;
      const int img = (wm + mi * 16) / hw_t;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a1 = p1[ni][e], a2 = p2[ni][e];
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            a1 += __shfl_xor_sync(0xffffffffu, a1, o);
            a2 += __shfl_xor_sync(0xffffffffu, a2, o);
          }
          if (g == 0) {
            const int c = wn + ni * 8 + 2 * t4 + e;
            atomicAdd(&red1[img * BN + c], a1);
            atomicAdd(&red2[img * BN + c], a2);
          }
          p1[ni][e] = p2[ni][e] = 0.f;
        }
    }
    __syncthreads();
    for (int i = tid; i < pl.imgs * BN; i += THREADS) {
      const int b = b0 + i / BN, co = n0 + i % BN;
      if (b < B && co < Cout) {
        atomicAdd(&s1[(long long)b * Cout + co], red1[i]);
        atomicAdd(&s2[(long long)b * Cout + co], red2[i]);
      }
    }
  }
}

template <int MI, int NI, bool P, bool S, bool E>
int launch_tc(dim3 grid, size_t smem, cudaStream_t st, const void* x,
              const void* w, const void* bias, const float* pre_w,
              const float* pre_b, const void* skip, float out_scale, void* y,
              float* s1, float* s2, int B, int H, int W, int Cin, int Cout,
              const Plan& pl, int vec_x, int vec_w) {
  auto kern = conv3x3_tc_kernel<MI, NI, P, S, E>;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  using bf = __nv_bfloat16;
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w),
      static_cast<const bf*>(bias), pre_w, pre_b, static_cast<const bf*>(skip),
      out_scale, static_cast<bf*>(y), s1, s2, B, H, W, Cin, Cout, pl, vec_x,
      vec_w);
  return (int)cudaGetLastError();
}

template <int MI, int NI>
int dispatch_flags(int key, dim3 grid, size_t smem, cudaStream_t st,
                   const void* x, const void* w, const void* bias,
                   const float* pre_w, const float* pre_b, const void* skip,
                   float out_scale, void* y, float* s1, float* s2, int B,
                   int H, int W, int Cin, int Cout, const Plan& pl, int vec_x,
                   int vec_w) {
#define NATDIFF_CASE(K, P, S, E)                                               \
  case K:                                                                      \
    return launch_tc<MI, NI, P, S, E>(grid, smem, st, x, w, bias, pre_w,       \
                                      pre_b, skip, out_scale, y, s1, s2, B, H, \
                                      W, Cin, Cout, pl, vec_x, vec_w);
  switch (key) {
    NATDIFF_CASE(0, false, false, false)
    NATDIFF_CASE(1, false, false, true)
    NATDIFF_CASE(2, false, true, false)
    NATDIFF_CASE(3, false, true, true)
    NATDIFF_CASE(4, true, false, false)
    NATDIFF_CASE(5, true, false, true)
    NATDIFF_CASE(6, true, true, false)
    NATDIFF_CASE(7, true, true, true)
  }
#undef NATDIFF_CASE
  return (int)cudaErrorInvalidValue;
}

// Check the Python plan against the kernel's own constants and launch.
int run(int has_pre, int has_skip, int emit_stats, const void* x,
        const void* w, const void* bias, const float* pre_w,
        const float* pre_b, const void* skip, float out_scale, void* y,
        float* s1, float* s2, int B, int H, int W, int Cin, int Cout, int cfg,
        int imgs, int th, int tw, int bk, int stages, int grid_x, int grid_y,
        int smem, int vec_x, int vec_w, cudaStream_t st) {
  static const int TILE_BM[3] = {128, 64, 64}, TILE_BN[3] = {128, 128, 64};
  if (cfg < 0 || cfg > 2 || B <= 0 || H <= 0 || W <= 0 || Cin <= 0 ||
      Cout <= 0 || imgs <= 0 || th <= 0 || tw <= 0 || bk != BK ||
      stages != STAGES)
    return (int)cudaErrorInvalidValue;
  const int bm = TILE_BM[cfg], bn = TILE_BN[cfg];
  Plan pl{imgs, th, tw, (W + tw - 1) / tw, (H + th - 1) / th};
  const bool whole = th == H && tw == W && (th * tw) % 16 == 0;
  const long long gx = (long long)((B + imgs - 1) / imgs) * pl.tiles_w * pl.tiles_h;
  const size_t want = smem_bytes(bn, pl, Cin, has_pre, emit_stats);
  if (imgs * th * tw != bm || (imgs > 1 && !whole) ||
      halo_rows(pl) > bm * 9 / 4 || gx != grid_x ||
      (Cout + bn - 1) / bn != grid_y || want != (size_t)smem ||
      want > 232448 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const int key = (has_pre ? 4 : 0) | (has_skip ? 2 : 0) | (emit_stats ? 1 : 0);
  switch (cfg) {
    case 0:
      return dispatch_flags<4, 4>(key, grid, want, st, x, w, bias, pre_w, pre_b,
                                  skip, out_scale, y, s1, s2, B, H, W, Cin,
                                  Cout, pl, vec_x, vec_w);
    case 1:
      return dispatch_flags<2, 4>(key, grid, want, st, x, w, bias, pre_w, pre_b,
                                  skip, out_scale, y, s1, s2, B, H, W, Cin,
                                  Cout, pl, vec_x, vec_w);
    default:
      return dispatch_flags<2, 2>(key, grid, want, st, x, w, bias, pre_w, pre_b,
                                  skip, out_scale, y, s1, s2, B, H, W, Cin,
                                  Cout, pl, vec_x, vec_w);
  }
}

}  // namespace tc
}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  x [B,H,W,Cin], w [3,3,Cin,Cout], bias
// [Cout] or null, pre_w/pre_b [B,Cin] f32, skip/y [B,H,W,Cout], s1/s2 [B,Cout]
// f32 zeroed by the caller; all contiguous (checked by the Python wrapper).
// The tile plan (cfg .. smem, from ops/conv3x3.py:_tile_plan) and vec_x /
// vec_w (Cin resp. Cout % 8 == 0 and x resp. w 16-byte aligned) drive the
// bf16 kernel; float32 ignores them.
int natdiff_conv3x3(int dtype, int has_pre, int has_skip, int emit_stats,
                    const void* x, const void* w, const void* bias,
                    const float* pre_w, const float* pre_b, const void* skip,
                    float out_scale, void* y, float* s1, float* s2, int B,
                    int H, int W, int Cin, int Cout, int cfg, int imgs, int th,
                    int tw, int bk, int stages, int grid_x, int grid_y,
                    int smem, int vec_x, int vec_w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return tc::run(has_pre, has_skip, emit_stats, x, w, bias, pre_w, pre_b,
                   skip, out_scale, y, s1, s2, B, H, W, Cin, Cout, cfg, imgs,
                   th, tw, bk, stages, grid_x, grid_y, smem, vec_x, vec_w, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  launch<float>(has_pre, has_skip, emit_stats, grid, st, x, w, bias, pre_w,
                pre_b, skip, out_scale, y, s1, s2, B, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

// The large-map conv: x [B,H,W,Cin], w [3,3,Cin,Cout], bias [Cout] or
// null, y [B,H,W,Cout]; contiguous, dtype and plan as above.
int natdiff_conv3x3_tiled(int dtype, const void* x, const void* w,
                          const void* bias, void* y, int B, int H, int W,
                          int Cin, int Cout, int cfg, int imgs, int th, int tw,
                          int bk, int stages, int grid_x, int grid_y, int smem,
                          int vec_x, int vec_w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return tc::run(0, 0, 0, x, w, bias, nullptr, nullptr, nullptr, 1.f, y,
                   nullptr, nullptr, B, H, W, Cin, Cout, cfg, imgs, th, tw, bk,
                   stages, grid_x, grid_y, smem, vec_x, vec_w, st);
  if (dtype != 0 || B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TT_W - 1) / TT_W;
  const long long tiles = (long long)tiles_w * ((H + TT_H - 1) / TT_H);
  dim3 grid((unsigned)tiles, (unsigned)((Cout + TT_N - 1) / TT_N),
            (unsigned)B);
  conv3x3_tiled_kernel<float><<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, Cin,
      Cout, tiles_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
