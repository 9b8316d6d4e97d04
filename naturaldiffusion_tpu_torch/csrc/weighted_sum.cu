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
// ~295 flop/byte ridge.  Design: one thread per 4 outputs with 16-byte
// (float4) loads, consecutive threads on consecutive addresses, so every row
// is streamed once, fully coalesced; the live weights sit in shared memory,
// loaded once per block.  No reduction crosses threads, so the order of the
// sum is fixed (x rows then eps rows, each in row order).

#include <cuda_runtime.h>

namespace {

__global__ void weighted_sum_kernel(const float* __restrict__ wx,
                                    const float* __restrict__ we,
                                    const float4* __restrict__ bufx,
                                    const float4* __restrict__ bufe,
                                    int live_x, int live_e, long long m4,
                                    float4* __restrict__ out) {
  extern __shared__ float w[];  // live_x + live_e weights
  for (int j = threadIdx.x; j < live_x + live_e; j += blockDim.x)
    w[j] = j < live_x ? wx[j] : we[j - live_x];
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < live_x; ++j) {
    float4 v = __ldg(bufx + (long long)j * m4 + i);
    float c = w[j];
    acc.x = fmaf(c, v.x, acc.x);
    acc.y = fmaf(c, v.y, acc.y);
    acc.z = fmaf(c, v.z, acc.z);
    acc.w = fmaf(c, v.w, acc.w);
  }
  for (int j = 0; j < live_e; ++j) {
    float4 v = __ldg(bufe + (long long)j * m4 + i);
    float c = w[live_x + j];
    acc.x = fmaf(c, v.x, acc.x);
    acc.y = fmaf(c, v.y, acc.y);
    acc.z = fmaf(c, v.z, acc.z);
    acc.w = fmaf(c, v.w, acc.w);
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bufx [>= live_x, m], bufe [>= live_e, m] row-major float32, m % 4 == 0,
// every pointer 16-byte aligned (checked by the Python wrapper).
int natdiff_weighted_sum(const float* wx, const float* we, const float* bufx,
                         const float* bufe, int live_x, int live_e,
                         long long m, float* out, void* stream) {
  const int threads = 256;
  long long m4 = m / 4;
  unsigned blocks = (unsigned)((m4 + threads - 1) / threads);
  size_t smem = sizeof(float) * (size_t)(live_x + live_e);
  weighted_sum_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      wx, we, reinterpret_cast<const float4*>(bufx),
      reinterpret_cast<const float4*>(bufe), live_x, live_e, m4,
      reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
