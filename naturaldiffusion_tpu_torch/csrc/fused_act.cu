// Fused bias-add and leaky ReLU (StyleGAN2's fused_leaky_relu),
//
//   y[m, c] = scale * leaky_relu(x[m, c] + bias[c], slope)
//
// over a row-major [M, C] tensor, in x's type (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel `_flr_kernel` of
// naturaldiffusion_tpu/ops/fused_act.py (called by
// `fused_leaky_relu_pallas`), which streams 512-row tiles of [M, C]
// through VMEM with the bias block resident.  Here one elementwise pass
// needs no tiling: each thread takes 16-byte vectors (4 float32 or 8
// bfloat16 values) in a grid-stride loop and reads the bias by column.  Any
// M works without padding.  A row whose byte length is not a multiple of
// 16 (or an unaligned pointer) takes the scalar form of the same loop.
//
// Rounding follows the JAX function exactly: the bias is in x's type, and
// the add, the slope product and the scale product each round to x's type
// (JAX computes each in the array's dtype).  `slope` and `scale` arrive
// already rounded to x's type.  __fadd_rn / __fmul_rn keep nvcc from
// contracting the products into an FMA, which would skip a rounding.
//
// Bound on the H100: bytes.  Each element is read once and written once:
// at [4, 256, 256, 128] bf16, 134 MB, 40 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float flr(float x, float b, float slope,
                                     float scale) {
  const float y = rnd(__fadd_rn(x, b), T());
  const float r = y >= 0.f ? y : rnd(__fmul_rn(y, slope), T());
  return __fmul_rn(r, scale);  // rounded to T by the store
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

// 16-byte vectors: V = 16 / sizeof(T) elements, C % V == 0
template <typename T>
__global__ void __launch_bounds__(THREADS)
flr_vec_kernel(const T* __restrict__ x, const T* __restrict__ bias,
               T* __restrict__ y, long long n_vec, int C, float slope,
               float scale) {
  constexpr int V = 16 / sizeof(T);
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * THREADS) {
    const int c0 = (int)((i * V) % C);
    const uint4 xv = reinterpret_cast<const uint4*>(x)[i];
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + c0);
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* be = reinterpret_cast<const T*>(&bv);
    uint4 out;
    T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < V; ++e)
      from_f(oe[e], flr<T>(to_f(xe[e]), to_f(be[e]), slope, scale));
    reinterpret_cast<uint4*>(y)[i] = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flr_scalar_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                  T* __restrict__ y, long long n, int C, float slope,
                  float scale) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    from_f(y[i], flr<T>(to_f(x[i]), to_f(bias[i % C]), slope, scale));
}

unsigned blocks_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename T>
int launch(const void* x, const void* bias, void* y, long long M, int C,
           float slope, float scale, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const long long n = M * C;
  const bool vec = C % V == 0 &&
                   (((uintptr_t)x | (uintptr_t)bias | (uintptr_t)y) & 15) == 0;
  if (vec)
    flr_vec_kernel<T><<<blocks_for(n / V), THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(bias),
        static_cast<T*>(y), n / V, C, slope, scale);
  else
    flr_scalar_kernel<T><<<blocks_for(n), THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(bias),
        static_cast<T*>(y), n, C, slope, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  x, y: contiguous [M, C]; bias: [C],
// x's type.  slope and scale are rounded to x's type by the caller.
int natdiff_fused_leaky_relu(int dtype, const void* x, const void* bias,
                             void* y, long long M, int C, float slope,
                             float scale, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, bias, y, M, C, slope, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias, y, M, C, slope, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
