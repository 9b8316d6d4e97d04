// W8A8 3x3, stride-1, SAME-padded NHWC convolution as an int8 implicit
// GEMM, with the activation quantize in its prologue and the dequant in
// its epilogue:
//
//   xq   = clip(rint(DYN ? x / sx[b] : x * q_mul), -127, 127)     (int8)
//   acc  = sum_{tap, ci} xq[b, h+dy, w+dx, ci] * wq[tap, co, ci]   (int32)
//   y    = round_to_bf16(f32(acc) * (s[b] * s_w[co]) + bias[co])
//
// with s[b] = sx[b] (DYN) or s_static.  Every step is an IEEE-rounded
// operation written out (__fdiv_rn, __fmul_rn, __fadd_rn,
// __float2int_rn: round half to even), so nvcc contracts nothing into an
// FMA and the result equals the plain version's
// (ops/quant.py:conv3x3_int8_reference) bit for bit.
//
// Replaces no Pallas kernel: the JAX package's int8 conv is an XLA s8 conv
// (naturaldiffusion_tpu/ops/quant.py:153-156, `conv3x3_int8`), which
// PyTorch cannot run on a card (F.conv2d refuses int8).  Bound on the
// H100: int8 tensor operations at 1,979 TOPS dense, or the bytes (bf16 x
// in, int8 weights, bf16 y out) at 3.35 TB/s; at the CIFAR shapes the two
// are close.
//
// The design is the bf16 kernel's (conv3x3.cu, tc::conv3x3_tc_kernel):
//   * a 2-D halo tile of TH x TW output pixels of one image, or several
//     whole images of the 4x4 and 8x8 maps, times BN output channels;
//   * per chunk of BK = 128 input channels the (TH+2) x (TW+2) halo comes
//     by cp.async into a bf16 staging buffer (zero rows outside the image
//     are not fetched), and each thread quantizes the vectors it copied
//     into an int8 halo buffer ([pixel][channel], 144-byte rows: 128
//     bytes and a pad that puts 8 rows on 8 bank groups), two buffers
//     deep: the next chunk is requested at the current chunk's first tap
//     and quantized after its last; SAME padding writes int8 zeros;
//   * the nine taps are nine shifted ldmatrix reads of the int8 halo (the
//     A fragment of m16n8k32 is the bf16 m16n8k16 fragment's bytes, so
//     the bf16 kernel's addressing carries over byte for byte);
//   * the weights, quantized once per state of the parameter into
//     [9][Cout][Cin] (each output channel's inputs contiguous: the B
//     fragment is 4 consecutive k of one column, which a non-transposed
//     ldmatrix of [n][k] rows delivers), stream through a ring of three
//     BN x BK stages by cp.async, two in flight;
//   * products: mma.sync m16n8k32 s8 x s8 -> s32; 8 warps of (BM/2) x
//     (BN/4); the epilogue dequantizes from the int32 accumulators.
// The tile plan comes from Python (ops/quant.py:_int8_plan), which the
// entry checks against its own constants.  Not yet: wgmma (s8, A from
// shared memory) and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {
namespace q8 {

constexpr int BK = 128;       // input channels (bytes of int8) per chunk
constexpr int STAGES = 3;     // weight ring depth
constexpr int THREADS = 256;  // 8 warps: 2 down the pixels, 4 across channels
constexpr int SA = BK + 16;   // int8 halo row stride, bytes
constexpr int SB = BK + 16;   // weight row stride, bytes
constexpr int CPR = BK / 8;   // 16-byte bf16 vectors per staged row

template <int MI, int NI>
struct Tile {
  static constexpr int BM = 32 * MI;
  static constexpr int BN = 32 * NI;
  static constexpr int HALO_MAX = BM * 9 / 4;
  static constexpr int MAXV = (HALO_MAX * CPR + THREADS - 1) / THREADS;
};

struct Plan {
  int imgs, th, tw, tiles_w, tiles_h;
};

__host__ __device__ inline int halo_rows(const Plan& p) {
  return p.imgs * (p.th + 2) * (p.tw + 2);
}

// staging, two int8 halo buffers, the weight ring, then the tables: the
// per-image scales (16-byte padded) and per halo row its source pixel and
// its image
inline size_t smem_bytes(int bn, const Plan& p) {
  const size_t rows = halo_rows(p);
  return rows * BK * 2 + 2 * rows * SA + (size_t)STAGES * bn * SB +
         ((size_t)p.imgs * 4 + 15) / 16 * 16 + (rows * 5 + 15) / 16 * 16;
}

__device__ __forceinline__ int quantize(float f, bool dyn, float d,
                                        float q_mul) {
  const float s = dyn ? __fdiv_rn(f, d) : __fmul_rn(f, q_mul);
  return max(-127, min(127, __float2int_rn(s)));
}

template <int MI, int NI, bool DYN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_int8_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ s_w,
                    const __nv_bfloat16* __restrict__ bias,
                    const float* __restrict__ sx, float q_mul, float s_static,
                    __nv_bfloat16* __restrict__ y, int B, int H, int W,
                    int Cin, int Cout, Plan pl) {
  using T = Tile<MI, NI>;
  constexpr int BN = T::BN, MAXV = T::MAXV;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = halo_rows(pl);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);  // [rows][BK]
  int8_t* halo = reinterpret_cast<int8_t*>(smem + (size_t)rows * BK * 2);  // [2][rows][SA]
  int8_t* ring = halo + 2 * rows * SA;                             // [STAGES][BN][SB]
  float* sx_s = reinterpret_cast<float*>(ring + STAGES * BN * SB);  // [imgs]
  int* row_src = reinterpret_cast<int*>(sx_s + (pl.imgs + 3) / 4 * 4);  // [rows]
  unsigned char* row_img = reinterpret_cast<unsigned char*>(row_src + rows);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wm = (warp >> 2) * 16 * MI;
  const int wn = (warp & 3) * 8 * NI;

  const int tx = blockIdx.x % pl.tiles_w;
  const int ty = (blockIdx.x / pl.tiles_w) % pl.tiles_h;
  const int b0 = blockIdx.x / (pl.tiles_w * pl.tiles_h) * pl.imgs;
  const int h0 = ty * pl.th, w0 = tx * pl.tw;
  const int n0 = blockIdx.y * BN;
  const int hw_t = pl.th * pl.tw;
  const int hrow = pl.tw + 2;
  const int himg = (pl.th + 2) * hrow;

  if (DYN)
    for (int i = tid; i < pl.imgs; i += THREADS)
      sx_s[i] = b0 + i < B ? sx[b0 + i] : 1.f;
  for (int r = tid; r < rows; r += THREADS) {
    const int img = r / himg, rr = r % himg;
    const int b = b0 + img;
    const int gh = h0 + rr / hrow - 1, gw = w0 + rr % hrow - 1;
    row_src[r] = (b < B && gh >= 0 && gh < H && gw >= 0 && gw < W)
                     ? (b * H + gh) * W + gw : -1;
    row_img[r] = (unsigned char)img;
  }
  __syncthreads();

  // vector v = tid + THREADS j: channels ch8..ch8+7 of halo row v / CPR
  const int ch8 = (tid % CPR) * 8;
  auto issue_x = [&](int c0) {
#pragma unroll 1
    for (int j = 0; j < MAXV; ++j) {
      const int r = (tid + THREADS * j) / CPR;
      if (r >= rows) break;
      const int src = row_src[r];
      if (src >= 0)
        cp_async16(stage + r * BK + ch8, x + (long long)src * Cin + c0 + ch8, 16);
    }
  };
  // the quantize, on the vectors this thread copied (its own wait
  // suffices), into int8 halo buffer buf
  auto quantize_x = [&](int buf) {
    int8_t* hb = halo + buf * rows * SA;
#pragma unroll 1
    for (int j = 0; j < MAXV; ++j) {
      const int r = (tid + THREADS * j) / CPR;
      if (r >= rows) break;
      uint2 out = make_uint2(0u, 0u);
      if (row_src[r] >= 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(stage + r * BK + ch8);
        const uint32_t in[4] = {v.x, v.y, v.z, v.w};
        const float d = DYN ? sx_s[row_img[r]] : 1.f;
        uint32_t p[2] = {0u, 0u};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const unsigned short hb16 = (unsigned short)(in[q / 2] >> (16 * (q % 2)));
          const int qi = quantize(__bfloat162float(__ushort_as_bfloat16(hb16)),
                                  DYN, d, q_mul);
          p[q / 4] |= (uint32_t)(qi & 0xff) << (8 * (q % 4));
        }
        out = make_uint2(p[0], p[1]);
      }
      *reinterpret_cast<uint2*>(hb + r * SA + ch8) = out;
    }
  };

  // weight slices: iteration it = 9 kc + tap reads w[tap][n0 + n][kc BK + k]
  auto load_w = [&](int st, int it) {
    const int kc = it / 9, tap = it - 9 * kc;
    int8_t* dst = ring + st * BN * SB;
#pragma unroll
    for (int rep = 0; rep < BN * BK / 16 / THREADS; ++rep) {
      const int i = tid + THREADS * rep;
      const int n = i / (BK / 16), kb = (i % (BK / 16)) * 16;
      const int co = n0 + n;
      const int8_t* src = w + ((long long)tap * Cout + co) * Cin + kc * BK + kb;
      const bool ok = co < Cout;
      cp_async16(dst + n * SB + kb, ok ? src : w, ok ? 16 : 0);
    }
  };

  // each lane's ldmatrix row: pixel wm + 16 mi + (lane & 15), as the halo
  // row of its top-left tap (two 16-bit rows a register)
  uint32_t abase[(MI + 1) / 2] = {};
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = wm + mi * 16 + (lane & 15);
    const uint32_t a = (p / hw_t) * himg + (p % hw_t / pl.tw) * hrow + p % pl.tw;
    abase[mi / 2] |= a << (16 * (mi % 2));
  }
  const int a_col = (lane >> 4) * 16;                    // bytes
  // B: lane's row n and byte column of the 4 matrices (n 0-7 | 8-15) x
  // (k 0-15 | 16-31) of a 16-column pair
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 16;

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int KC = Cin / BK;
  const int NIT = 9 * KC;
  issue_x(0);
  cp_async_commit();
  cp_async_wait<0>();
  quantize_x(0);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < NIT) load_w(s, s);
    cp_async_commit();
  }

  int kc = 0, tap = 0;
  for (int it = 0; it < NIT; ++it) {
    // weight stage `it` has landed for every thread, every thread is past
    // iteration it - 1, and (at tap 0) chunk kc's int8 halo is complete
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < NIT) load_w((it + STAGES - 1) % STAGES, it + STAGES - 1);
    const bool next = kc + 1 < KC;
    // the staging buffer was last read by this thread's own quantize
    if (tap == 0 && next) issue_x((kc + 1) * BK);
    cp_async_commit();

    const int8_t* hb =
        halo + (kc & 1) * rows * SA + ((tap / 3) * hrow + tap % 3) * SA + a_col;
    const int8_t* wb = ring + (it % STAGES) * BN * SB + b_row * SB + b_col;
#pragma unroll 1
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t bfr[NI][2];
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        uint32_t r[4];
        ldsm_x4(r, wb + (wn + nj * 16) * SB + ks);
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
          mma_s8(acc[mi][ni], af, bfr[ni][0], bfr[ni][1]);
      }
    }
    // chunk kc + 1's copies (issued at tap 0) have landed for this thread
    // by the wait of tap 8; its int8 buffer was last read in chunk kc - 1
    if (tap == 8 && next) quantize_x((kc + 1) & 1);
    if (++tap == 9) {
      tap = 0;
      ++kc;
    }
  }
  cp_async_wait<0>();

  // epilogue: scale = s[b] * s_w[co], f32(acc) * scale, + bias, to bf16
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm + mi * 16 + g + 8 * h;
      const int b = b0 + p / hw_t;
      const int oh = h0 + p % hw_t / pl.tw, ow = w0 + p % pl.tw;
      if (!(b < B && oh < H && ow < W)) continue;
      const float sb = DYN ? sx_s[p / hw_t] : s_static;
      const long long m = ((long long)b * H + oh) * W + ow;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t4;
        if (col >= Cout) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = col + e;
          const float scale = __fmul_rn(sb, s_w[co]);
          v[e] = __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), scale);
          if (bias != nullptr) v[e] = __fadd_rn(v[e], __bfloat162float(bias[co]));
        }
        *reinterpret_cast<__nv_bfloat162*>(y + m * Cout + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <int MI, int NI, bool DYN>
int launch(dim3 grid, size_t smem, cudaStream_t st, const void* x,
           const void* w, const float* s_w, const void* bias, const float* sx,
           float q_mul, float s_static, void* y, int B, int H, int W, int Cin,
           int Cout, const Plan& pl) {
  auto kern = conv3x3_int8_kernel<MI, NI, DYN>;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  using bf = __nv_bfloat16;
  kern<<<grid, THREADS, smem, st>>>(
      static_cast<const bf*>(x), static_cast<const int8_t*>(w), s_w,
      static_cast<const bf*>(bias), sx, q_mul, s_static, static_cast<bf*>(y),
      B, H, W, Cin, Cout, pl);
  return (int)cudaGetLastError();
}

template <int MI, int NI>
int dispatch(int dyn, dim3 grid, size_t smem, cudaStream_t st, const void* x,
             const void* w, const float* s_w, const void* bias,
             const float* sx, float q_mul, float s_static, void* y, int B,
             int H, int W, int Cin, int Cout, const Plan& pl) {
  if (dyn)
    return launch<MI, NI, true>(grid, smem, st, x, w, s_w, bias, sx, q_mul,
                                s_static, y, B, H, W, Cin, Cout, pl);
  return launch<MI, NI, false>(grid, smem, st, x, w, s_w, bias, sx, q_mul,
                               s_static, y, B, H, W, Cin, Cout, pl);
}

}  // namespace q8
}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dyn: 1 = per-sample scales sx [B] f32 (x / sx[b]), 0 = static (x * q_mul,
// dequant by s_static).  x [B,H,W,Cin] bf16, w [9][Cout][Cin] int8 (16-byte
// aligned), s_w [Cout] f32, bias [Cout] bf16 or null, y [B,H,W,Cout] bf16;
// all contiguous (checked by the Python wrapper); Cin and Cout multiples of
// 128.  The plan (cfg .. smem) is ops/quant.py:_int8_plan's.
int natdiff_conv3x3_int8(int dyn, const void* x, const void* w,
                         const float* s_w, const void* bias, const float* sx,
                         float q_mul, float s_static, void* y, int B, int H,
                         int W, int Cin, int Cout, int cfg, int imgs, int th,
                         int tw, int bk, int stages, int grid_x, int grid_y,
                         int smem, void* stream) {
  using namespace q8;
  static const int TILE_BM[3] = {128, 64, 64}, TILE_BN[3] = {128, 128, 64};
  if (cfg < 0 || cfg > 2 || B <= 0 || H <= 0 || W <= 0 || Cin <= 0 ||
      Cout <= 0 || Cin % BK || Cout % 128 || imgs <= 0 || th <= 0 ||
      tw <= 0 || bk != BK || stages != STAGES || (dyn && sx == nullptr) ||
      ((uintptr_t)x & 15) || ((uintptr_t)w & 15))
    return (int)cudaErrorInvalidValue;
  const int bm = TILE_BM[cfg], bn = TILE_BN[cfg];
  Plan pl{imgs, th, tw, (W + tw - 1) / tw, (H + th - 1) / th};
  const bool whole = th == H && tw == W && (th * tw) % 16 == 0;
  const long long gx = (long long)((B + imgs - 1) / imgs) * pl.tiles_w * pl.tiles_h;
  const size_t want = smem_bytes(bn, pl);
  if (imgs * th * tw != bm || (imgs > 1 && !whole) ||
      halo_rows(pl) > bm * 9 / 4 || gx != grid_x || Cout / bn != grid_y ||
      want != (size_t)smem || want > 232448 || grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  cudaStream_t st = (cudaStream_t)stream;
  switch (cfg) {
    case 0:
      return dispatch<4, 4>(dyn, grid, want, st, x, w, s_w, bias, sx, q_mul,
                            s_static, y, B, H, W, Cin, Cout, pl);
    case 1:
      return dispatch<2, 4>(dyn, grid, want, st, x, w, s_w, bias, sx, q_mul,
                            s_static, y, B, H, W, Cin, Cout, pl);
    default:
      return dispatch<2, 2>(dyn, grid, want, st, x, w, s_w, bias, sx, q_mul,
                            s_static, y, B, H, W, Cin, Cout, pl);
  }
}

}  // extern "C"
