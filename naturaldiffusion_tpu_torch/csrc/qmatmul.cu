// W8A16 matrix product: bf16 activations times int8 weights with one f32
// scale per output column,
//
//   y[m, n] = round_to_OutT( (sum_k x[m, k] * w[k, n]) * s_w[n] + bias[n] )
//
// with x in bf16 (the wrapper rounds an f32 x to bf16 first, as the TPU
// kernel does), w int8, the sum in f32, and the scale and bias applied in
// f32.  OutT is the caller's activation type (f32 or bf16).
//
// Replaces the Pallas TPU kernel `_kern` of naturaldiffusion_tpu/ops/
// qmatmul.py (called through `_call` / `matmul_wdq`), the product of every
// DiT `QDense` under NATDIFF_QUANT=w8.
//
// Bound on the H100: operations, not bytes.  The TPU kernel exists to halve
// the weight bytes read on a v5e; on the H100 at DiT-XL/2's 512 rows each
// launch is above the bf16 ridge (fc1: 5.4 GFLOP = 5.5 us at 989 TFLOP/s
// against 11 MB = 3.3 us at 3.35 TB/s), so the kernel pays only if it runs
// on the tensor cores.  It does: warp-level mma.sync m16n8k16 (bf16 in,
// f32 accumulate).  A block computes a 128 x 128 tile of y with 8 warps of
// 64 x 32; K goes in steps of 32 through two shared-memory stages.  The
// int8 weight tile is widened to bf16 on its way into shared memory (exact:
// |int8| < 2^8 fits bf16's 8-bit significand), so the tensor cores see a
// plain bf16 product.  The next stage's global loads are issued before the
// current stage's products and stored after them.  wgmma, TMA and split-K
// (DiT's 1152-column products fill only 36 of 132 SMs) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int SA = BK + 8;  // A row stride (bf16): ldmatrix rows hit 8 bank groups
constexpr int SB = BN + 8;  // B row stride (bf16), same reason

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w, const float* __restrict__ s_w,
               const float* __restrict__ bias, OutT* __restrict__ y, int M,
               int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][SA];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][SB];  // [k][n]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // 2 warps down the rows
  const int wn = (warp & 3) * 32;   // 4 warps across the columns

  // global -> register staging: x as 2 passes of 64 rows x 4 chunks of 8
  // bf16, w as 32 rows x 8 chunks of 16 int8
  const int a_r = tid >> 2;
  const int a_c = (tid & 3) * 8;
  const int b_r = tid >> 3;
  const int b_c = (tid & 7) * 16;
  uint4 ra[2];
  int4 rb;

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int row = m0 + a_r + 64 * p;
      ra[p] = row < M ? *reinterpret_cast<const uint4*>(
                            x + (long long)row * K + k0 + a_c)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    rb = *reinterpret_cast<const int4*>(w + (long long)(k0 + b_r) * N + n0 +
                                        b_c);
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
      *reinterpret_cast<uint4*>(&As[buf][a_r + 64 * p][a_c]) = ra[p];
    const int8_t* v = reinterpret_cast<const int8_t*>(&rb);
    uint32_t pk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pk[j] = pack_bf16x2((float)v[2 * j], (float)v[2 * j + 1]);
    *reinterpret_cast<uint4*>(&Bs[buf][b_r][b_c]) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
    *reinterpret_cast<uint4*>(&Bs[buf][b_r][b_c + 8]) =
        make_uint4(pk[4], pk[5], pk[6], pk[7]);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = K / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load_tile((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], &As[cur][wm + mi * 16 + (lane & 15)][ks + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, &Bs[cur][ks + (lane & 15)][wn + nj * 16 + (lane >> 4) * 8]);
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    // the other stage was last read before the previous barrier
    if (kt + 1 < KT) store_tile(cur ^ 1);
    __syncthreads();
  }

  // epilogue: per-column scale, bias, cast; c0,c1 at row g, c2,c3 at g+8
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn + ni * 8 + 2 * t;
    const float s0 = s_w[col], s1 = s_w[col + 1];
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + 8 * h;
        if (row < M) {
          // two rounded operations, as the plain version computes them
          const float v0 = __fadd_rn(__fmul_rn(acc[mi][ni][2 * h], s0), b0);
          const float v1 = __fadd_rn(__fmul_rn(acc[mi][ni][2 * h + 1], s1), b1);
          store2(y + (long long)row * N + col, v0, v1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out_dtype: 0 = float32, 1 = bfloat16.  x bf16 [M, K], w int8 [K, N],
// s_w f32 [N], bias f32 [N] or null, y [M, N] of out_dtype; all contiguous
// and 16-byte aligned, K % 32 == 0 and N % 128 == 0 (checked by the Python
// wrapper).
int natdiff_qmatmul(int out_dtype, const void* x, const void* w,
                    const float* s_w, const float* bias, void* y, int M, int N,
                    int K, void* stream) {
  if (K % BK != 0 || N % BN != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(N / BN), (unsigned)((M + BM - 1) / BM));
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  if (out_dtype == 0)
    qmatmul_kernel<float><<<grid, THREADS, 0, st>>>(
        xb, wi, s_w, bias, static_cast<float*>(y), M, N, K);
  else
    qmatmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        xb, wi, s_w, bias, static_cast<__nv_bfloat16*>(y), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
