// GroupNorm over NHWC activations, in two passes:
//
//   pass 1:  s1[b, c] += sum_{h,w} x[b,h,w,c],  s2[b, c] += sum x^2     (f32)
//   pass 2:  fold per group (extra_bias tb[b, c] enters the sums
//            algebraically: s1' = s1 + n*tb, s2' = s2 + 2*tb*s1 + n*tb^2),
//            mu = S1/N, var = S2/N - mu^2 (the fast variance),
//            w_c = rsqrt(var + eps) * scale[c],
//            b_c = bias[c] - mu * w_c + tb * w_c,
//            y = ACT(x * w_c + b_c) in x's type, ACT = identity or SiLU.
//
// Replaces the Pallas TPU kernel `_gn_body` (through `_gn_kernel` /
// `_gn_kernel_eb`, called by `group_norm_pallas`) of
// naturaldiffusion_tpu/ops/group_norm.py.  There one grid step holds whole
// samples in VMEM and reduces and normalises them in one pass; a block here
// has far less on-chip memory than a 256x256x128 map, so the statistics are
// a pass of their own: every block reduces a span of rows of one sample in
// shared memory and adds its per-channel partial sums into a zeroed [B, C]
// buffer with f32 atomics (the scheme of the conv kernel's statistics).
// Pass 2 folds the group sums for its channels in a short prologue and
// streams the same rows again.  The arithmetic is that of the plain version
// (`gn_channel_sums` + `gn_affine_coeffs` in ops/group_norm.py): the
// products and sums that decide the rounding of the output are written with
// __fmul_rn / __fadd_rn, so no contraction into FMAs moves them.
//
// Bound on the H100: bytes.  The least traffic reads x once and writes y
// once (2 x 67 MB at [4, 256, 256, 128] bf16: 40 us at 3.35 TB/s); this
// kernel reads x twice.  Threads own channels, neighbouring threads
// neighbouring channels, so every warp reads contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

// Block (x: row span, y: sample, z: channel slice of CB channels).  Thread
// tid owns channel c0 + tid % CB and rows r0 + tid / CB + k * (THREADS/CB).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ s1,
                float* __restrict__ s2, int HW, int C, int CB,
                int rows_per_block) {
  __shared__ float r1[THREADS], r2[THREADS];
  const int tid = threadIdx.x;
  const int rpp = THREADS / CB;          // rows per pass
  const int cl = tid % CB, rl = tid / CB;
  const int b = blockIdx.y;
  const int c = blockIdx.z * CB + cl;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1e = min(r0 + rows_per_block, HW);
  const T* xb = x + (long long)b * HW * C + c;
  float a1 = 0.f, a2 = 0.f;
  for (int r = r0 + rl; r < r1e; r += rpp) {
    const float v = to_f(xb[(long long)r * C]);
    a1 += v;
    a2 = fmaf(v, v, a2);
  }
  r1[tid] = a1;
  r2[tid] = a2;
  __syncthreads();
  if (tid < CB) {
    for (int k = 1; k < rpp; ++k) {
      a1 += r1[tid + k * CB];
      a2 += r2[tid + k * CB];
    }
    atomicAdd(&s1[(long long)b * C + c], a1);
    atomicAdd(&s2[(long long)b * C + c], a2);
  }
}

template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ s1,
                const float* __restrict__ s2, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ tb,
                int tb_rows, T* __restrict__ y, int HW, int C, int CB,
                int group_size, float eps, int rows_per_block) {
  __shared__ float wsh[THREADS], bsh[THREADS];
  const int tid = threadIdx.x;
  const int rpp = THREADS / CB;
  const int cl = tid % CB, rl = tid / CB;
  const int b = blockIdx.y;
  const int c = blockIdx.z * CB + cl;
  if (tid < CB) {
    // fold the group of channel c; tb_rows = 1 broadcasts one [1, C] row
    const float n_sp = (float)HW;
    const int g0 = (c / group_size) * group_size;
    const float* t_row = tb == nullptr ? nullptr
                         : tb + (long long)(tb_rows == 1 ? 0 : b) * C;
    float sg = 0.f, s2g = 0.f;
    for (int k = 0; k < group_size; ++k) {
      const long long o = (long long)b * C + g0 + k;
      float v1 = s1[o], v2 = s2[o];
      if (t_row != nullptr) {
        const float t = t_row[g0 + k];
        v2 = __fadd_rn(__fadd_rn(v2, __fmul_rn(__fmul_rn(2.f, t), v1)),
                       __fmul_rn(__fmul_rn(n_sp, t), t));
        v1 = __fadd_rn(v1, __fmul_rn(n_sp, t));
      }
      sg += v1;
      s2g += v2;
    }
    const float n = n_sp * (float)group_size;
    const float mu = __fdiv_rn(sg, n);
    const float var = __fsub_rn(__fdiv_rn(s2g, n), __fmul_rn(mu, mu));
    const float inv = rsqrtf(__fadd_rn(var, eps));
    const float w = __fmul_rn(inv, scale[c]);
    float bc = __fsub_rn(bias[c], __fmul_rn(mu, w));
    if (t_row != nullptr) bc = __fadd_rn(bc, __fmul_rn(t_row[c], w));
    wsh[cl] = w;
    bsh[cl] = bc;
  }
  __syncthreads();
  const float w = wsh[cl], bc = bsh[cl];
  const int r0 = blockIdx.x * rows_per_block;
  const int r1e = min(r0 + rows_per_block, HW);
  const long long base = (long long)b * HW * C + c;
  for (int r = r0 + rl; r < r1e; r += rpp) {
    const long long o = base + (long long)r * C;
    float v = __fadd_rn(__fmul_rn(to_f(x[o]), w), bc);
    if (SILU) v = __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
    y[o] = from_f<T>(v);
  }
}

template <typename T>
int run(const void* xv, const float* scale, const float* bias,
        const float* tb, int tb_rows, int silu, void* yv, float* s1,
        float* s2, int B, int HW, int C, int group_size, float eps,
        cudaStream_t st) {
  // channel slice: the widest power of two <= THREADS that divides C
  int cb = 1;
  while (cb * 2 <= THREADS && C % (cb * 2) == 0) cb *= 2;
  const int rpp = THREADS / cb;
  const int nz = C / cb;
  // row spans: about four waves of 132 SMs in all, whole passes per span
  long long want = (4LL * 132 + (long long)B * nz - 1) / ((long long)B * nz);
  if (want < 1) want = 1;
  int rows = (int)((HW + want - 1) / want);
  rows = (rows + rpp - 1) / rpp * rpp;
  if (rows < rpp) rows = rpp;
  dim3 grid((unsigned)((HW + rows - 1) / rows), (unsigned)B, (unsigned)nz);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  gn_stats_kernel<T><<<grid, THREADS, 0, st>>>(x, s1, s2, HW, C, cb, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (silu)
    gn_apply_kernel<T, true><<<grid, THREADS, 0, st>>>(
        x, s1, s2, scale, bias, tb, tb_rows, y, HW, C, cb, group_size, eps,
        rows);
  else
    gn_apply_kernel<T, false><<<grid, THREADS, 0, st>>>(
        x, s1, s2, scale, bias, tb, tb_rows, y, HW, C, cb, group_size, eps,
        rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  x, y [B, H*W, C]; scale, bias [C] f32;
// tb null or f32 [tb_rows, C] with tb_rows 1 (broadcast) or B; s1, s2 f32
// [B, C] scratch zeroed by the caller; all contiguous (checked by the
// Python wrapper).
int natdiff_group_norm(int dtype, const void* x, const float* scale,
                       const float* bias, const float* tb, int tb_rows,
                       int silu, void* y, float* s1, float* s2, int B,
                       int HW, int C, int group_size, float eps,
                       void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || group_size <= 0 || C % group_size ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return run<float>(x, scale, bias, tb, tb_rows, silu, y, s1, s2, B, HW, C,
                      group_size, eps, st);
  return run<__nv_bfloat16>(x, scale, bias, tb, tb_rows, silu, y, s1, s2, B,
                            HW, C, group_size, eps, st);
}

}  // extern "C"
