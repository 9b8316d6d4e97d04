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
// Replaces two Pallas TPU kernels of naturaldiffusion_tpu/ops/conv3x3.py:
//   * `_conv_kernel` (via `conv3x3_pallas` / `_pallas_conv_call`): the
//     instance with HAS_PRE = HAS_SKIP = EMIT_STATS = false;
//   * `_conv_gn_kernel` (via `conv3x3_gn_pallas` / `_pallas_fused_call`):
//     the other instances.
// Its `taps9` / `kstack` / `valid9` forms are TPU layouts of one sum; here a
// block computes a BM x BN tile of the [B*H*W, Cout] output and loops over
// the 9 taps x Cin chunks of BK channels, staging the input tile (with the
// prologue applied) and the weight tile in shared memory.
//
// Traps the design keeps:
//   * The SAME padding pads the post-SiLU activation with zeros: the
//     prologue runs only on in-bounds pixels, and a halo pixel loads 0
//     (silu(pre_b) on the halo is the classic bug).
//   * The prologue output is rounded to x's type before the product, as the
//     TPU kernel does (`xf.astype(x_ref.dtype)`).
//   * The statistics are of the final f32 value (after bias, skip and
//     rescale), before the cast.  They cross blocks by f32 atomics into a
//     zeroed [B, Cout] buffer; every output row carries its own sample
//     index, so a tile that spans samples (4x4 maps) stays right.
//   * Channel counts that are not multiples of the tile (the 3->128 stem
//     and 128->3 head) are masked on load and on store.
//
// Bound on the H100: operations.  At the main path's shapes
// (e.g. [64,32,32,128] -> 128) the conv does ~19 GFLOP on ~50 MB, ~390
// flop/byte, above the bf16 ridge of ~295.  This first kernel accumulates
// with SIMT f32 FMAs (4x4 outputs per thread, operands from shared memory),
// so it is bounded by the card's 67 TFLOP/s f32 rate, not by the 989
// TFLOP/s of the bf16 tensor cores: it is simple and exact in f32.  The
// tensor-core form (wgmma fed by TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per stage
constexpr int THREADS = 256;
constexpr int A_ROWS = THREADS / BK;   // pixel rows loaded per pass (8)
constexpr int B_ROWS = THREADS / BN;   // channel rows loaded per pass (4)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

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
// Bound on the H100: operations (at [4, 256, 256, 128] -> 128, 77 GFLOP on
// 67 MB).  Like the kernel above it accumulates with SIMT f32 FMAs, so the
// card's 67 TFLOP/s f32 rate, not the 989 TFLOP/s of the bf16 tensor cores,
// limits it.  Staging the next chunk while the current one is summed
// (cp.async, TMA) and the tensor cores are later work.

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

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  x [B,H,W,Cin], w [3,3,Cin,Cout], bias
// [Cout] or null, pre_w/pre_b [B,Cin] f32, skip/y [B,H,W,Cout], s1/s2 [B,Cout]
// f32 zeroed by the caller; all contiguous (checked by the Python wrapper).
int natdiff_conv3x3(int dtype, int has_pre, int has_skip, int emit_stats,
                    const void* x, const void* w, const void* bias,
                    const float* pre_w, const float* pre_b, const void* skip,
                    float out_scale, void* y, float* s1, float* s2, int B,
                    int H, int W, int Cin, int Cout, void* stream) {
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch<float>(has_pre, has_skip, emit_stats, grid, st, x, w, bias, pre_w,
                  pre_b, skip, out_scale, y, s1, s2, B, H, W, Cin, Cout);
  else
    launch<__nv_bfloat16>(has_pre, has_skip, emit_stats, grid, st, x, w, bias,
                          pre_w, pre_b, skip, out_scale, y, s1, s2, B, H, W,
                          Cin, Cout);
  return (int)cudaGetLastError();
}

// The halo-tiled conv: x [B,H,W,Cin], w [3,3,Cin,Cout], bias [Cout] or
// null, y [B,H,W,Cout]; contiguous, dtype as above.
int natdiff_conv3x3_tiled(int dtype, const void* x, const void* w,
                          const void* bias, void* y, int B, int H, int W,
                          int Cin, int Cout, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TT_W - 1) / TT_W;
  const long long tiles = (long long)tiles_w * ((H + TT_H - 1) / TT_H);
  dim3 grid((unsigned)tiles, (unsigned)((Cout + TT_N - 1) / TT_N),
            (unsigned)B);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    conv3x3_tiled_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), H, W, Cin,
        Cout, tiles_w);
  else
    conv3x3_tiled_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), H, W, Cin, Cout, tiles_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
