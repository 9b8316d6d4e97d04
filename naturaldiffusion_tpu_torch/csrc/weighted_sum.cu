// Fused dual-buffer weighted sum, the Natural-Inference step itself:
//   out[i] = sum_{j<live_x} wx[j] * bufx[j, i]  +  sum_{j<live_e} we[j] * bufe[j, i]
// over the flattened image (i < M), in float32.
//
// Replaces the Pallas TPU kernel naturaldiffusion_tpu/ops/weighted_sum.py
// `_fused_kernel` (via `fused_weighted_sum_pallas`).  That kernel skips whole
// 8-row chunks past the live lower-triangular prefix; here each thread walks
// exactly the live rows, so rows >= live are never read at all (the
// TPU contract w[live:] == 0 is then not needed for this kernel, and the
// result is the same whenever it holds).
//
// Bound on the H100: memory.  The kernel does 2 flops per 4 bytes read; it
// must read (live_x + live_e) * M * 4 bytes and write M * 4, far below the
// ~295 flop/byte ridge.  What reaches that bound is enough bytes in flight
// to cover the latency of device memory.  Design: a thread owns 4 outputs
// (16-byte float4 loads, consecutive threads on consecutive addresses, so
// every row is streamed once, fully coalesced) and issues the loads of
// UNROLL rows before their FMAs.  The live rows j = 0 .. L-1 (the x rows,
// then the eps rows) split into `split` contiguous groups, one per slice
// of the block's threads: at a small M (DiT's latent) more threads share
// each column, so the card still fills.  Summation order (fixed): group g
// sums its rows in order, acc = fma(w[j], row_j, acc) from 0; then the
// groups add in order, ((P_0 + P_1) + P_2) + ...  The plan (`_ws_plan` of
// ops/weighted_sum.py) picks `split`; the live weights sit in shared
// memory, loaded once per block.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;
constexpr int SMEM_MAX = 64 * 1024;

// Block: `split` groups of THREADS / split threads; thread (g, col) sums
// the rows of group g for column i = blockIdx.x * (THREADS / split) + col.
// Shared memory: the partials of groups 1 .. split-1 [split-1][cols]
// float4, then the L live weights.
__global__ void __launch_bounds__(THREADS)
weighted_sum_kernel(const float* __restrict__ wx, const float* __restrict__ we,
                    const float4* __restrict__ bufx,
                    const float4* __restrict__ bufe, int live_x, int live_e,
                    long long m4, int split, float4* __restrict__ out) {
  extern __shared__ float4 sh4[];
  const int cols = THREADS / split;
  float* w = reinterpret_cast<float*>(sh4 + (split - 1) * cols);
  const int L = live_x + live_e;
  for (int j = threadIdx.x; j < L; j += THREADS)
    w[j] = j < live_x ? wx[j] : we[j - live_x];
  __syncthreads();
  const int g = threadIdx.x / cols, col = threadIdx.x % cols;
  const long long i = (long long)blockIdx.x * cols + col;
  const int j0 = (int)((long long)g * L / split);
  const int j1 = (int)((long long)(g + 1) * L / split);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < m4) {
    for (int j = j0; j < j1; j += UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int jj = j + u;
        if (jj < j1)
          v[u] = __ldg((jj < live_x ? bufx + (long long)jj * m4
                                    : bufe + (long long)(jj - live_x) * m4) +
                       i);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int jj = j + u;
        if (jj < j1) {
          const float c = w[jj];
          acc.x = fmaf(c, v[u].x, acc.x);
          acc.y = fmaf(c, v[u].y, acc.y);
          acc.z = fmaf(c, v[u].z, acc.z);
          acc.w = fmaf(c, v[u].w, acc.w);
        }
      }
    }
  }
  if (split > 1) {
    if (g > 0) sh4[(g - 1) * cols + col] = acc;
    __syncthreads();
    if (g == 0) {
      for (int k = 1; k < split; ++k) {
        const float4 p = sh4[(k - 1) * cols + col];
        acc.x += p.x;
        acc.y += p.y;
        acc.z += p.z;
        acc.w += p.w;
      }
    }
  }
  if (g == 0 && i < m4) out[i] = acc;
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bufx [>= live_x, m], bufe [>= live_e, m] row-major float32, m % 4 == 0,
// every pointer 16-byte aligned (checked by the Python wrapper); split
// (1, 2, 4 or 8 row groups a column) from `_ws_plan`.
int natdiff_weighted_sum(const float* wx, const float* we, const float* bufx,
                         const float* bufe, int live_x, int live_e,
                         long long m, int split, float* out, void* stream) {
  if (m <= 0 || m % 4 || live_x < 0 || live_e < 0 ||
      (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  const int cols = THREADS / split;
  const size_t smem = sizeof(float4) * (size_t)(split - 1) * cols +
                      sizeof(float) * (size_t)(live_x + live_e);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        weighted_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const long long m4 = m / 4;
  const unsigned blocks = (unsigned)((m4 + cols - 1) / cols);
  weighted_sum_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      wx, we, reinterpret_cast<const float4*>(bufx),
      reinterpret_cast<const float4*>(bufe), live_x, live_e, m4, split,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
