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
// against 11 MB = 3.3 us at 3.35 TB/s), so the kernel pays only if it keeps
// the tensor cores busy.  Design:
//
// * wgmma with swapped operands, y^T = W^T x^T (CUTLASS's mixed-input
//   scheme on Hopper).  A block computes 128 output columns for 128 rows of
//   x with two consumer warpgroups; each owns 64 columns (the wgmma M) and
//   issues m64n128k16 steps: A is the int8 weight widened to bf16 in
//   registers, B the block's rows of x straight from shared memory by
//   descriptor (K-major, 128-byte swizzle), so x needs no transpose.
// * A producer warp feeds a STAGES-deep ring with the Tensor Memory
//   Accelerator: per k tile of BK = 64, x's 128 x 64 tile (a tensor map,
//   swizzled as wgmma reads it, rows at or past M zero-filled) and the int8
//   weight's 4 x 2 KB of packed groups (bulk copies), completion counted by
//   one mbarrier per stage; the consumer warps free a stage through a
//   second mbarrier.  No barrier spans the block.
// * The weight stays int8 in the ring.  It arrives packed in fragment
//   order (ops/qmatmul.py:pack_weight): per 16 k x 32 n, one 512-byte group
//   in which lane l = 4g + t finds, for each of the four n8 tiles, column g
//   at k = 2t, 2t+8, 2t+1, 2t+9, the mma A/B fragment order.  A thread
//   reads its 8 bytes per k16 step with one load and widens them in
//   registers (`i8x2_to_bf16x2`, exact) while the previous tile's wgmma
//   run; the weight's shared-memory bytes are half of bf16's.
// * Split-K where the grid would leave SMs idle (ops/qmatmul.py:_qm_plan
//   chooses it; the entry checks the plan).  Split s takes k tiles
//   [s KT / S, (s + 1) KT / S) and writes its f32 partial tile to a
//   workspace; a second kernel sums the S partials in the order s = 0, 1,
//   ..., S - 1 and only then applies the scale and the bias.
//   Deterministic: no atomics.
//
// Three other forms were built, right at every shape and slower at
// DiT-XL/2's products (PERF.md §6): mma.sync with the same packing and
// a cp.async ring; this wgmma form fed by cp.async from all threads with a
// block barrier per stage; and A widened into shared memory (wgmma with
// both operands there).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BK = 64;                       // k per ring stage
constexpr int STAGES = 4;                    // ring depth
constexpr int BN = 128;                      // output columns per block
constexpr int BM = 128;                      // rows of x per block (the wgmma N)
constexpr int THREADS = 256 + 32;            // two consumer warpgroups + the producer warp
constexpr int GROUP = 512;                   // bytes of one packed 16 k x 32 n weight group
constexpr int XSTAGE = BM * BK * 2;          // bytes of one x stage
constexpr int WSTAGE = BN * BK;              // bytes of one int8 weight stage
// the ring (x stages 1024-aligned), then 2 x STAGES mbarriers; + 1024 of
// alignment slack
constexpr int SMEM = 1024 + STAGES * (XSTAGE + WSTAGE) + 2 * STAGES * 8;

// Two int8 values, in bytes 0 and 2 of w, widened exactly to a bf16x2
// (byte 0 in the lower half).  With s = m - 128 b7 (m the low 7 bits, b7
// the sign bit), 0x4300 | m is the bf16 128 + m and 0x4300 | (s & 0x80)
// the bf16 128 or 256; their difference is s, an integer of at most 128
// in magnitude and so exact in bf16.  Each mask-and-or is one lop3.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t a = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t b = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return bits(r);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- the kernels ------------------------------------------------------------

// xmap: x [M, K] bf16, boxes of 64 k x 128 rows, 128-byte swizzle; wp the
// packed weight.  SPLIT: write the f32 partial sums of this block's k range
// to ws[split][M][N] instead of y.
template <typename OutT, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
qmatmul_kernel(const __grid_constant__ CUtensorMap xmap,
               const int8_t* __restrict__ wp, const float* __restrict__ s_w,
               const float* __restrict__ bias, OutT* __restrict__ y,
               float* __restrict__ ws, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  unsigned char* Xs = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);  // [STAGES][128 rows][128 B]
  int8_t* Ws = reinterpret_cast<int8_t*>(Xs + STAGES * XSTAGE);  // [STAGES][BK/16][BN/32][GROUP]
  const uint32_t bars = smem_addr(Ws + STAGES * WSTAGE);  // full[STAGES], then empty[STAGES]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int KT = K / BK;
  const int kt0 = (int)((long long)blockIdx.z * KT / gridDim.z);
  const int kt1 = (int)((long long)(blockIdx.z + 1) * KT / gridDim.z);
  const int nk = kt1 - kt0;
  const int ngroups = N / 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);             // the producer's arrival + bytes
      mbar_init(bars + 8 * (STAGES + s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // the producer: one thread issues every copy
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        const int kt = kt0 + i;
        if (i >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((i / STAGES) - 1) & 1);
        mbar_expect_tx(bars + 8 * s, XSTAGE + WSTAGE);
        tma_load_2d(smem_addr(Xs + s * XSTAGE), &xmap, kt * BK, m0, bars + 8 * s);
#pragma unroll
        for (int kb = 0; kb < BK / 16; ++kb)  // the block's 4 groups of each k16 row
          bulk_load(smem_addr(Ws + s * WSTAGE + kb * (BN / 32) * GROUP),
                    wp + ((long long)(kt * (BK / 16) + kb) * ngroups + n0 / 32) * GROUP,
                    (BN / 32) * GROUP, bars + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output columns n0 + 64 wg .., its warp wl
  // 16 of them
  const int wg = warp >> 2;
  const int wl = warp & 3;
  // this thread's 8 weight bytes of a 16 k x 32 n group: n8 tiles
  // 2 (wl & 1) and 2 (wl & 1) + 1 of group 2 wg + wl / 2, i.e. columns g
  // and g + 8 of the warp's 16
  const int woff = (2 * wg + (wl >> 1)) * GROUP + lane * 16 + 8 * (wl & 1);
  auto widen = [&](uint32_t (&af)[4][4], int stage) {
    const int8_t* b = Ws + stage * WSTAGE;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint2 r = *reinterpret_cast<const uint2*>(b + ks * (BN / 32) * GROUP + woff);
      af[ks][0] = i8x2_to_bf16x2(r.x);       // column g,     k 2t, 2t+1
      af[ks][1] = i8x2_to_bf16x2(r.y);       // column g + 8, k 2t, 2t+1
      af[ks][2] = i8x2_to_bf16x2(r.x >> 8);  // column g,     k 2t+8, 2t+9
      af[ks][3] = i8x2_to_bf16x2(r.y >> 8);  // column g + 8, k 2t+8, 2t+9
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t af0[4][4], af1[4][4];
  // ptxas serialises the wgmma of a stage when a non-wgmma instruction
  // defines one of its registers inside the stage: the keep() fences make
  // the zeroing, each widening and each descriptor complete before the
  // stage's wgmma.fence, and a wgmma's A registers live until its wait
#pragma unroll
  for (int i = 0; i < 64; ++i) keep(acc[i]);
  mbar_wait(bars, 0);
  widen(af0, 0);
  // tile i: issue its 4 wgmma on af; while they run, wait for tile i + 1
  // and widen it into next; retire tile i and free its stage
  auto step = [&](uint32_t (&af)[4][4], uint32_t (&next)[4][4], int i) {
    const int stage = i % STAGES;
    const uint32_t xs = smem_addr(Xs + stage * XSTAGE);
    uint64_t desc[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      desc[ks] = desc_sw128(xs + ks * 32);
      keep(desc[ks]);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(af[ks][e]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n128k16_rs(acc, af[ks], desc[ks]);
    wgmma_commit();
    if (i + 1 < nk) {
      const int s1 = (i + 1) % STAGES;
      mbar_wait(bars + 8 * s1, ((i + 1) / STAGES) & 1);
      widen(next, s1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(af[ks][e]);
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + stage));  // this warp is done with it
  };
  for (int i = 0; i < nk; i += 2) {
    step(af0, af1, i);
    if (i + 1 < nk) step(af1, af0, i + 1);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) keep(acc[i]);

  // acc[4i + e]: column n0 + 64 wg + 16 wl + g (+ 8 for e >= 2), row
  // m0 + 8 i + 2 t (+ 1 for odd e)
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nA = n0 + 64 * wg + 16 * wl + g;
  float sc[2] = {0.f, 0.f}, bb[2] = {0.f, 0.f};
  if (!SPLIT) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sc[h] = s_w[nA + 8 * h];
      bb[h] = bias != nullptr ? bias[nA + 8 * h] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + 8 * i + 2 * t + (e & 1);
      const int col = nA + 8 * (e >> 1);
      if (row >= M) continue;
      if (SPLIT)
        ws[((long long)blockIdx.z * M + row) * N + col] = acc[4 * i + e];
      else  // two rounded operations, as the plain version computes them
        y[(long long)row * N + col] =
            OutT(__fadd_rn(__fmul_rn(acc[4 * i + e], sc[e >> 1]), bb[e >> 1]));
    }
  }
}

// y = (ws[0] + ws[1] + ... + ws[S-1]) * s_w + bias, summed in that order;
// one thread per 4 consecutive outputs of a row (N % 4 == 0)
template <typename OutT>
__global__ void __launch_bounds__(256)
qmatmul_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ s_w,
                      const float* __restrict__ bias, OutT* __restrict__ y,
                      int M, int N, int S) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const long long mn = (long long)M * N;
  if (e >= mn) return;
  const int col = (int)(e % N);
  float4 acc = *reinterpret_cast<const float4*>(ws + e);
  for (int s = 1; s < S; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(ws + s * mn + e);
    acc.x = __fadd_rn(acc.x, p.x);
    acc.y = __fadd_rn(acc.y, p.y);
    acc.z = __fadd_rn(acc.z, p.z);
    acc.w = __fadd_rn(acc.w, p.w);
  }
  const float4 sc = *reinterpret_cast<const float4*>(s_w + col);
  const float4 bb = bias != nullptr ? *reinterpret_cast<const float4*>(bias + col)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
  store2(y + e, __fadd_rn(__fmul_rn(acc.x, sc.x), bb.x),
         __fadd_rn(__fmul_rn(acc.y, sc.y), bb.y));
  store2(y + e + 2, __fadd_rn(__fmul_rn(acc.z, sc.z), bb.z),
         __fadd_rn(__fmul_rn(acc.w, sc.w), bb.w));
}

template <typename OutT, bool SPLIT>
int launch(dim3 grid, cudaStream_t st, const CUtensorMap& xmap,
           const void* wp, const float* s_w, const float* bias, void* y,
           float* ws, int M, int N, int K) {
  auto kern = qmatmul_kernel<OutT, SPLIT>;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  kern<<<grid, THREADS, SMEM, st>>>(xmap, static_cast<const int8_t*>(wp),
                                    s_w, bias, static_cast<OutT*>(y), ws, M,
                                    N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !SPLIT) return (int)err;
  const long long quads = (long long)M * N / 4;
  qmatmul_reduce_kernel<OutT><<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
      ws, s_w, bias, static_cast<OutT*>(y), M, N, (int)grid.z);
  return (int)cudaGetLastError();
}

// The tensor map of x [M, K] bf16 (K contiguous): boxes of BK x BM with the
// 128-byte swizzle that wgmma's B descriptor expects; rows past M read as
// zeros.
int tensor_map(CUtensorMap* map, const void* x, int M, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, BM};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims,
                           strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out_dtype: 0 = float32, 1 = bfloat16.  x bf16 [M, K]; wp the int8 weight
// packed by ops/qmatmul.py:pack_weight ([K/16][N/32][512]); s_w f32 [N];
// bias f32 [N] or null; y [M, N] of out_dtype; ws f32 [splits, M, N] when splits > 1,
// else null.  All contiguous and 16-byte aligned.  The plan (bm, bn, bk,
// stages, splits, smem, from ops/qmatmul.py:_qm_plan) must agree with this
// file's constants, else nothing runs.
int natdiff_qmatmul(int out_dtype, const void* x, const void* wp,
                    const float* s_w, const float* bias, void* y, float* ws,
                    int M, int N, int K, int bm, int bn, int bk, int stages,
                    int splits, int smem, void* stream) {
  if (bm != BM || bn != BN || bk != BK || stages != STAGES || smem != SMEM ||
      M <= 0 || N % BN != 0 || K % BK != 0 || K <= 0 || splits < 1 ||
      splits > K / BK || (splits > 1) != (ws != nullptr) ||
      (M + BM - 1) / BM > 65535 || splits > 65535 ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  const int err = tensor_map(&xmap, x, M, K);
  if (err) return err;
  dim3 grid((unsigned)(N / BN), (unsigned)((M + BM - 1) / BM), (unsigned)splits);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_dtype == 0)
    return splits > 1 ? launch<float, true>(grid, st, xmap, wp, s_w, bias, y, ws, M, N, K)
                      : launch<float, false>(grid, st, xmap, wp, s_w, bias, y, ws, M, N, K);
  return splits > 1
             ? launch<__nv_bfloat16, true>(grid, st, xmap, wp, s_w, bias, y, ws, M, N, K)
             : launch<__nv_bfloat16, false>(grid, st, xmap, wp, s_w, bias, y, ws, M, N, K);
}

}  // extern "C"
