// GroupNorm over NHWC activations:
//
//   s1[b, c] = sum_{h,w} x[b,h,w,c],  s2[b, c] = sum x^2              (f32)
//   fold per group (extra_bias tb[b, c] enters the sums algebraically:
//   s1' = s1 + n*tb, s2' = s2 + 2*tb*s1 + n*tb^2),
//   mu = S1/N, var = S2/N - mu^2 (the fast variance),
//   w_c = rsqrt(var + eps) * scale[c],  b_c = bias[c] - mu * w_c + tb * w_c,
//   y = ACT(x * w_c + b_c) in x's type, ACT = identity or SiLU.
//
// Replaces the Pallas TPU kernel `_gn_body` (through `_gn_kernel` /
// `_gn_kernel_eb`, called by `group_norm_pallas`) of
// naturaldiffusion_tpu/ops/group_norm.py.  There one grid step holds whole
// samples in VMEM, so x is read once.  That is the aim here too: x read from
// device memory once, y written once, which is all that bounds the kernel on
// the H100 (bytes: 2 x 67 MB at [4, 256, 256, 128] bf16, 40 us at 3.35
// TB/s).  Three forms; the pure plan `_gn_plan` of ops/group_norm.py picks
// one per shape, and this entry refuses a plan that disagrees with its
// constants:
//
// * on-chip (gn_onchip_kernel), one launch.  A unit is one sample x a
//   channel slice of whole groups, >= 32 bytes a pixel where C allows.  A
//   thread-block cluster of 1-8 CTAs holds it in shared memory, each CTA a
//   span of pixels staged by cp.async (16-byte vectors where C allows).
//   Each CTA sums its channels in a fixed order (a thread's pixels in
//   order, xor shuffles within a warp, a tree over the rows in shared
//   memory); after a cluster barrier every CTA reads the partial sums of all
//   CTAs of its cluster over distributed shared memory and adds them in rank
//   order, so all fold the same totals.  Then each normalises its pixels
//   from shared memory and writes y with vector stores.  No atomics, no
//   scratch.
// * grid (gn_grid_kernel), for units too large for a cluster (the 256 x 256
//   maps): one cooperative launch of a block an SM; the whole grid holds one
//   unit at a time (a sample's 128 channels at 256 x 256 bf16: 16.7 MB, 127
//   KB a block), the block sums meet in global memory by atomics before a
//   grid barrier, and while a block writes unit u's y it stages unit u + 1's
//   x, so x is still read once.
// * streamed (gn_stats_kernel, then gn_apply_kernel), where a unit exceeds
//   even the grid, and for the checks: the two passes over chunks of whole
//   samples or whole groups of at most ~20 MB, each chunk's apply pass
//   launched right after its statistics so that its second read of x finds
//   the chunk in the 50 MB L2; UNROLL 16-byte loads in flight a thread; the
//   apply pass walks the spans in reverse, the most recently read first.
//   The statistics go to a [2, B, C] f32 scratch by atomics, zeroed here by
//   cudaMemsetAsync; their order, and so the last bit of the f32 output,
//   varies from run to run.
//
// Rounding: the fold and the affine are written with __fmul_rn / __fadd_rn
// as the plain version (`gn_channel_sums` + `gn_affine_coeffs`) computes
// them, so nvcc contracts nothing into an FMA.  The output differs from the
// plain version's by the order of the f32 channel sums (~1e-7 relative),
// rsqrtf (2 ulp), and the SiLU: __fdividef(v, 1 + __expf(-v)), the fast
// exponential and reciprocal (two MUFU operations, no IEEE division), a few
// ulp (~1e-6 relative for |v| < 10; 0 where 1 + exp(-v) > 2^126, as the
// true value rounds); the f32 check holds it to 1e-4.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;           // streamed form: loads in flight a thread
constexpr int MAX_CLUSTER = 8;      // portable cluster size
constexpr int SMEM_MAX = 232448;    // shared memory a block may use
constexpr int STREAM_SMEM_MAX = 48 * 1024;

template <int VB> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<2> { using type = unsigned short; };

// A vector's 32-bit words, and back (a 2-byte vector is one short word).
// Elements go in and out through these words, never through a pointer to
// the vector, which would put it on the stack.
__device__ __forceinline__ void to_words(const uint4& v, unsigned* w) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void to_words(const uint2& v, unsigned* w) {
  w[0] = v.x; w[1] = v.y;
}
__device__ __forceinline__ void to_words(unsigned v, unsigned* w) { w[0] = v; }
__device__ __forceinline__ void to_words(unsigned short v, unsigned* w) {
  w[0] = v;
}
template <int VB> __device__ __forceinline__ typename VecOf<VB>::type
from_words(const unsigned* w);
template <> __device__ __forceinline__ uint4 from_words<16>(const unsigned* w) {
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <> __device__ __forceinline__ uint2 from_words<8>(const unsigned* w) {
  return make_uint2(w[0], w[1]);
}
template <> __device__ __forceinline__ unsigned from_words<4>(const unsigned* w) {
  return w[0];
}
template <> __device__ __forceinline__ unsigned short from_words<2>(
    const unsigned* w) {
  return (unsigned short)w[0];
}

// the V = VB / sizeof(T) elements of a vector as floats (bf16 -> f32 is a
// shift, exact), and floats to a vector (bf16 rounded to nearest even, as
// torch's cast)
template <typename T, int VB>
__device__ __forceinline__ void unpack(const typename VecOf<VB>::type& v,
                                       float* f) {
  unsigned w[VB >= 4 ? VB / 4 : 1];
  to_words(v, w);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (VB == 2) {
    f[0] = __uint_as_float(w[0] << 16);
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VB>
__device__ __forceinline__ typename VecOf<VB>::type pack(const float* f) {
  unsigned w[VB >= 4 ? VB / 4 : 1];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i) w[i] = __float_as_uint(f[i]);
  } else if constexpr (VB == 2) {
    w[0] = __bfloat16_as_ushort(__float2bfloat16(f[0]));
  } else {
#pragma unroll
    for (int i = 0; i < VB / 4; ++i)   // the low half holds element 2i
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n"
          : "=r"(w[i]) : "f"(f[2 * i + 1]), "f"(f[2 * i]));
  }
  return from_words<VB>(w);
}

// one VB-byte vector global -> shared: cp.async for 4, 8 and 16 bytes, a
// plain copy for 2
template <int VB>
__device__ __forceinline__ void stage(void* dst, const void* src) {
  if constexpr (VB == 2) {
    *static_cast<unsigned short*>(dst) =
        __ldg(static_cast<const unsigned short*>(src));
  } else {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (VB == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(d), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                   :: "r"(d), "l"(src), "n"(VB) : "memory");
  }
}

constexpr int STAGE_GROUPS = 4;  // commit groups of a CTA's copies

// wait until at most n (< STAGE_GROUPS) of this thread's commit groups fly
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// add the V channels of one vector to a thread's sums
template <typename T, int VB>
__device__ __forceinline__ void accumulate(const typename VecOf<VB>::type& v,
                                           float* a1, float* a2) {
  constexpr int V = VB / (int)sizeof(T);
  float f[V];
  unpack<T, VB>(v, f);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a1[i] += f[i];
    a2[i] = fmaf(f[i], f[i], a2[i]);
  }
}

// y = ACT(x * w + b) for the V channels of one vector, in x's type
template <typename T, int VB, bool SILU>
__device__ __forceinline__ typename VecOf<VB>::type affine(
    const typename VecOf<VB>::type& v, const float* w, const float* b) {
  constexpr int V = VB / (int)sizeof(T);
  float u[V];
  unpack<T, VB>(v, u);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    u[i] = __fadd_rn(__fmul_rn(u[i], w[i]), b[i]);
    if (SILU) u[i] = __fdividef(u[i], __fadd_rn(1.f, __expf(-u[i])));
  }
  return pack<T, VB>(u);
}

// Rows of the shared-memory tree of block_sums: the warps where the shuffle
// step applies (nq divides 32), else the block's pixel rows.  The plan in
// ops/group_norm.py (`_red_rows`) computes the same.
__host__ __device__ __forceinline__ int red_rows(int nq) {
  return 32 % nq == 0 ? THREADS / 32 : THREADS / nq;
}

// The block's per-channel sums of the partials a1, a2 of its threads: thread
// tid = r * nq + q (r < rows) holds channels q*V .. q*V+V-1 of pixel row r.
// Fixed order: where nq divides 32 (every thread active), xor shuffles over
// the lanes of a warp that share q, then a pairwise tree over the warps;
// otherwise the tree runs over the rows.  The sums land in red1[0 .. nq*V)
// and red2[0 .. nq*V).  Every thread of the block calls it.
template <int V>
__device__ __forceinline__ void block_sums(float* a1, float* a2, float* red1,
                                           float* red2, int nq, int rows) {
  const int tid = threadIdx.x, width = nq * V;
  const int nrow = red_rows(nq);
  if (32 % nq == 0) {
    for (int o = nq; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a1[i] += __shfl_xor_sync(0xffffffffu, a1[i], o);
        a2[i] += __shfl_xor_sync(0xffffffffu, a2[i], o);
      }
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < nq) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red1[warp * width + lane * V + i] = a1[i];
        red2[warp * width + lane * V + i] = a2[i];
      }
    }
  } else if (tid < nq * rows) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red1[(tid / nq) * width + (tid % nq) * V + i] = a1[i];
      red2[(tid / nq) * width + (tid % nq) * V + i] = a2[i];
    }
  }
  __syncthreads();
  int half = 1;
  while (half < nrow) half <<= 1;
  for (half >>= 1; half >= 1; half >>= 1) {
    for (int e = tid; e < half * width; e += THREADS) {
      if (e / width + half < nrow) {
        red1[e] += red1[e + half * width];
        red2[e] += red2[e + half * width];
      }
    }
    __syncthreads();
  }
}

// w_c and b_c of channel c from the channel sums of its group g0 .. g0+gs-1
// (s1, s2 and t_row indexed alike; t_row null without extra bias), in the
// plain version's arithmetic
__device__ __forceinline__ void fold(const float* s1, const float* s2,
                                     const float* t_row, int c, int gs,
                                     float n_sp, float scale_c, float bias_c,
                                     float eps, float& w, float& bc) {
  const int g0 = (c / gs) * gs;
  float sg = 0.f, s2g = 0.f;
  for (int k = 0; k < gs; ++k) {
    float v1 = s1[g0 + k], v2 = s2[g0 + k];
    if (t_row != nullptr) {
      const float t = t_row[g0 + k];
      v2 = __fadd_rn(__fadd_rn(v2, __fmul_rn(__fmul_rn(2.f, t), v1)),
                     __fmul_rn(__fmul_rn(n_sp, t), t));
      v1 = __fadd_rn(v1, __fmul_rn(n_sp, t));
    }
    sg += v1;
    s2g += v2;
  }
  const float n = n_sp * (float)gs;
  const float mu = __fdiv_rn(sg, n);
  const float var = __fsub_rn(__fdiv_rn(s2g, n), __fmul_rn(mu, mu));
  const float inv = rsqrtf(__fadd_rn(var, eps));
  w = __fmul_rn(inv, scale_c);
  bc = __fsub_rn(bias_c, __fmul_rn(mu, w));
  if (t_row != nullptr) bc = __fadd_rn(bc, __fmul_rn(t_row[c], w));
}

// ------------------------------------------------------------ on-chip form
// Grid (ncta * C / CS, B), clusters of ncta CTAs along x.  CTA rank k of
// the cluster for slice s holds pixels [k * p_per, (k + 1) * p_per) of
// channels [s * CS, (s + 1) * CS) of sample blockIdx.y.  Shared memory:
// the staged pixels [p_per][CS] (16-byte aligned), then, in f32, red1, red2
// [red_rows][CS], the cluster's partials xch1, xch2 [ncta][CS], their
// totals tot1, tot2 [CS], and w (scale first), b (bias first), tb [CS].
template <typename T, int VB, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_onchip_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ tb,
                 int tb_rows, T* __restrict__ y, int HW, int C, int CS,
                 int gs, int p_per, int ncta, float eps) {
  using Vec = typename VecOf<VB>::type;
  constexpr int V = VB / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nq = CS / V, rows = THREADS / nq;
  const int tid = threadIdx.x, q = tid % nq, r = tid / nq;
  const bool active = r < rows;
  const int rank = blockIdx.x % ncta;
  const int c0 = (blockIdx.x / ncta) * CS;
  const int b = blockIdx.y;
  const int p0 = rank * p_per;
  const int np = max(0, min(HW - p0, p_per));
  Vec* data = reinterpret_cast<Vec*>(smem);
  const int data_bytes = (p_per * CS * (int)sizeof(T) + 15) & ~15;
  float* red1 = reinterpret_cast<float*>(smem + data_bytes);
  float* red2 = red1 + red_rows(nq) * CS;
  float* xch1 = red2 + red_rows(nq) * CS;
  float* xch2 = xch1 + ncta * CS;
  float* tot1 = xch2 + ncta * CS;
  float* tot2 = tot1 + CS;
  float* wsh = tot2 + CS;
  float* bsh = wsh + CS;
  float* tbs = bsh + CS;

  // stage this CTA's pixels in STAGE_GROUPS commit groups, the sums taking
  // each group as it lands; a thread reads back only what it staged (pixels
  // r + k * rows, k < nk)
  const T* xb = x + ((long long)b * HW + p0) * C + c0 + q * V;
  const int nk = active && r < np ? (np - r + rows - 1) / rows : 0;
#pragma unroll
  for (int g = 0; g < STAGE_GROUPS; ++g) {
    for (int k = g * nk / STAGE_GROUPS; k < (g + 1) * nk / STAGE_GROUPS; ++k)
      stage<VB>(data + (r + k * rows) * nq + q,
                xb + (long long)(r + k * rows) * C);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the affine's inputs, while the copies fly
  const float* t_row = tb == nullptr ? nullptr
                       : tb + (long long)(tb_rows == 1 ? 0 : b) * C + c0;
  for (int c = tid; c < CS; c += THREADS) {
    wsh[c] = scale[c0 + c];
    bsh[c] = bias[c0 + c];
    if (t_row != nullptr) tbs[c] = t_row[c];
  }
  float a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.f;
#pragma unroll
  for (int g = 0; g < STAGE_GROUPS; ++g) {
    cp_async_wait(STAGE_GROUPS - 1 - g);
    for (int k = g * nk / STAGE_GROUPS; k < (g + 1) * nk / STAGE_GROUPS; ++k)
      accumulate<T, VB>(data[(r + k * rows) * nq + q], a1, a2);
  }
  block_sums<V>(a1, a2, red1, red2, nq, rows);

  // every CTA's row 0, read at once over distributed shared memory, then
  // added in rank order
  cluster.sync();
  for (int e = tid; e < ncta * CS; e += THREADS) {
    xch1[e] = cluster.map_shared_rank(red1, e / CS)[e % CS];
    xch2[e] = cluster.map_shared_rank(red2, e / CS)[e % CS];
  }
  cluster_arrive();  // this CTA reads no other CTA's shared memory again
  __syncthreads();
  for (int c = tid; c < CS; c += THREADS) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < ncta; ++k) {
      t1 += xch1[k * CS + c];
      t2 += xch2[k * CS + c];
    }
    tot1[c] = t1;
    tot2[c] = t2;
  }
  __syncthreads();
  for (int c = tid; c < CS; c += THREADS)
    fold(tot1, tot2, t_row == nullptr ? nullptr : tbs, c, gs, (float)HW,
         wsh[c], bsh[c], eps, wsh[c], bsh[c]);
  __syncthreads();

  if (active) {
    float w[V], bc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      w[i] = wsh[q * V + i];
      bc[i] = bsh[q * V + i];
    }
    T* yb = y + ((long long)b * HW + p0) * C + c0 + q * V;
    for (int p = r; p < np; p += rows)
      *reinterpret_cast<Vec*>(yb + (long long)p * C) =
          affine<T, VB, SILU>(data[p * nq + q], w, bc);
  }
  cluster_wait();  // keep this CTA's shared memory until the cluster has read it
}

// --------------------------------------------------------------- grid form
// A cooperative grid of G blocks, all resident, walks the units (sample b,
// channels c0 .. c0+CS) in order, u = b * (C / CS) + c0 / CS; block i holds
// pixels [i * span, (i + 1) * span) of each.  Per unit the blocks add their
// sums into totals[u % 3] by atomics (an order that varies run to run);
// after a grid barrier every block folds the totals and normalises its
// pixels, staging the next unit's pixels into each slot as soon as it has
// read it, while block 0 zeroes totals[(u + 2) % 3] (read last in unit
// u - 1, written next in unit u + 2, after the next barrier).  work: totals
// [3][2][CS], then the barrier's counter, all zeroed by the entry.  Shared
// memory: the pixels [span][CS], red1, red2 [red_rows][CS], tot1, tot2, w,
// b, tb [CS].
__device__ __forceinline__ void grid_barrier(unsigned* counter,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
                 :: "l"(counter) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// One block an SM: the bound lets ptxas keep the kernel in registers (with
// the plain bound it aimed at more blocks an SM and spilled).
template <typename T, int VB, bool SILU>
__global__ void __launch_bounds__(THREADS, 1)
gn_grid_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, const float* __restrict__ tb,
               int tb_rows, T* __restrict__ y, float* work, int B, int HW,
               int C, int CS, int gs, int span, float eps) {
  using Vec = typename VecOf<VB>::type;
  constexpr int V = VB / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char gsmem[];
  const int G = gridDim.x, blk = blockIdx.x;
  const int nq = CS / V, rows = THREADS / nq;
  const int tid = threadIdx.x, q = tid % nq, r = tid / nq;
  const bool active = r < rows;
  const int p0 = blk * span;
  const int np = max(0, min(HW - p0, span));
  Vec* data = reinterpret_cast<Vec*>(gsmem);
  const int data_bytes = (span * CS * (int)sizeof(T) + 15) & ~15;
  float* red1 = reinterpret_cast<float*>(gsmem + data_bytes);
  float* red2 = red1 + red_rows(nq) * CS;
  float* tot1 = red2 + red_rows(nq) * CS;
  float* tot2 = tot1 + CS;
  float* wsh = tot2 + CS;
  float* bsh = wsh + CS;
  float* tbs = bsh + CS;
  unsigned* counter = reinterpret_cast<unsigned*>(work + 6 * CS);
  const int nslice = C / CS, units = B * nslice;

  if (active)
    for (int p = r; p < np; p += rows)
      stage<VB>(data + p * nq + q, x + (long long)(p0 + p) * C + q * V);
  for (int u = 0; u < units; ++u) {
    const int b = u / nslice, c0 = (u % nslice) * CS;
    const float* t_row = tb == nullptr ? nullptr
                         : tb + (long long)(tb_rows == 1 ? 0 : b) * C + c0;
    for (int c = tid; c < CS; c += THREADS) {
      wsh[c] = scale[c0 + c];
      bsh[c] = bias[c0 + c];
      if (t_row != nullptr) tbs[c] = t_row[c];
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    float a1[V], a2[V];
#pragma unroll
    for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.f;
    if (active)
      for (int p = r; p < np; p += rows)
        accumulate<T, VB>(data[p * nq + q], a1, a2);
    block_sums<V>(a1, a2, red1, red2, nq, rows);
    float* tot = work + (u % 3) * 2 * CS;
    for (int c = tid; c < CS; c += THREADS) {
      atomicAdd(tot + c, red1[c]);
      atomicAdd(tot + CS + c, red2[c]);
    }
    grid_barrier(counter, (unsigned)(u + 1) * G);
    if (blk == 0)
      for (int c = tid; c < 2 * CS; c += THREADS)
        work[((u + 2) % 3) * 2 * CS + c] = 0.f;
    for (int c = tid; c < CS; c += THREADS) {
      tot1[c] = __ldcg(tot + c);
      tot2[c] = __ldcg(tot + CS + c);
    }
    __syncthreads();
    for (int c = tid; c < CS; c += THREADS)
      fold(tot1, tot2, t_row == nullptr ? nullptr : tbs, c, gs, (float)HW,
           wsh[c], bsh[c], eps, wsh[c], bsh[c]);
    __syncthreads();
    if (active) {
      float w[V], bc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        w[i] = wsh[q * V + i];
        bc[i] = bsh[q * V + i];
      }
      const long long off = ((long long)b * HW + p0) * C + c0 + q * V;
      T* yb = y + off;
      if (u + 1 < units) {
        const int bn = (u + 1) / nslice, cn = ((u + 1) % nslice) * CS;
        const T* xn = x + ((long long)bn * HW + p0) * C + cn + q * V;
        for (int p = r; p < np; p += rows) {
          const Vec v = data[p * nq + q];
          *reinterpret_cast<Vec*>(yb + (long long)p * C) =
              affine<T, VB, SILU>(v, w, bc);
          stage<VB>(data + p * nq + q, xn + (long long)p * C);
        }
      } else {
        for (int p = r; p < np; p += rows)
          *reinterpret_cast<Vec*>(yb + (long long)p * C) =
              affine<T, VB, SILU>(data[p * nq + q], w, bc);
      }
    }
    __syncthreads();  // w and b are read before the next unit's scale lands
  }
}

// ----------------------------------------------------------- streamed form
// One chunk: grid (spans, CS / CB, samples); block (sx, t, z) covers pixels
// [sx * span, (sx + 1) * span) of channels c0 + t * CB .. + CB of sample
// b0 + z.  Thread r * nq + q takes channel vector q of pixels r, r + rows,
// ..., UNROLL of them per iteration.
template <typename T, int VB>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ s1,
                float* __restrict__ s2, int HW, int C, int CB, int c0, int b0,
                int span) {
  using Vec = typename VecOf<VB>::type;
  constexpr int V = VB / (int)sizeof(T);
  extern __shared__ float red[];
  const int nq = CB / V, rows = THREADS / nq;
  const int tid = threadIdx.x, q = tid % nq, r = tid / nq;
  const int b = b0 + blockIdx.z;
  const int cb0 = c0 + blockIdx.y * CB;
  const int pb = blockIdx.x * span, pe = min(HW, pb + span);
  const Vec* xb = reinterpret_cast<const Vec*>(x + (long long)b * HW * C +
                                               cb0 + q * V);
  const long long stride = C / V;  // vectors per pixel
  float a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.f;
  if (r < rows) {
    for (int p = pb + r; p < pe; p += rows * UNROLL) {
      Vec v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int pp = p + u * rows;
        v[u] = pp < pe ? __ldg(xb + pp * stride) : Vec{};  // zeros add 0
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) accumulate<T, VB>(v[u], a1, a2);
    }
  }
  float* red1 = red;
  float* red2 = red + red_rows(nq) * CB;
  block_sums<V>(a1, a2, red1, red2, nq, rows);
  for (int k = tid; k < CB; k += THREADS) {
    atomicAdd(&s1[(long long)b * C + cb0 + k], red1[k]);
    atomicAdd(&s2[(long long)b * C + cb0 + k], red2[k]);
  }
}

template <typename T, int VB, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ s1,
                const float* __restrict__ s2, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ tb,
                int tb_rows, T* __restrict__ y, int HW, int C, int CB, int c0,
                int b0, int span, int gs, float eps) {
  using Vec = typename VecOf<VB>::type;
  constexpr int V = VB / (int)sizeof(T);
  extern __shared__ float wb[];  // w [CB], b [CB]
  const int nq = CB / V, rows = THREADS / nq;
  const int tid = threadIdx.x, q = tid % nq, r = tid / nq;
  const int b = b0 + blockIdx.z;
  const int cb0 = c0 + blockIdx.y * CB;
  const float* t_row = tb == nullptr ? nullptr
                       : tb + (long long)(tb_rows == 1 ? 0 : b) * C;
  for (int k = tid; k < CB; k += THREADS)
    fold(s1 + (long long)b * C, s2 + (long long)b * C, t_row, cb0 + k, gs,
         (float)HW, scale[cb0 + k], bias[cb0 + k], eps, wb[k], wb[CB + k]);
  __syncthreads();
  if (r >= rows) return;
  float w[V], bc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    w[i] = wb[q * V + i];
    bc[i] = wb[CB + q * V + i];
  }
  // the spans the statistics pass read last come first
  const int pb = (gridDim.x - 1 - blockIdx.x) * span, pe = min(HW, pb + span);
  const long long off = (long long)b * HW * C + cb0 + q * V;
  const Vec* xb = reinterpret_cast<const Vec*>(x + off);
  Vec* yb = reinterpret_cast<Vec*>(y + off);
  const long long stride = C / V;
  for (int p = pb + r; p < pe; p += rows * UNROLL) {
    Vec v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pp = p + u * rows;
      v[u] = pp < pe ? __ldg(xb + pp * stride) : Vec{};
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int pp = p + u * rows;
      if (pp < pe) yb[pp * stride] = affine<T, VB, SILU>(v[u], w, bc);
    }
  }
}

// ------------------------------------------------------------------- host
struct Args {
  const void* x;
  const float *scale, *bias, *tb;
  int tb_rows;
  void* y;
  float* scratch;
  int B, HW, C, gs;
  float eps;
  int vb, slice, tile, cluster, samples, span, smem;
  cudaStream_t st;
};

// shared memory of an on-chip CTA (ncta > 0) or of a grid block (ncta = 0)
// holding `span` pixels of CS channels; -1 above the card's limit
int unit_smem(int span, int CS, int isz, int nq, int ncta) {
  const long long data = ((long long)span * CS * isz + 15) / 16 * 16;
  const long long s = data + 4LL * (2 * red_rows(nq) * CS + 2 * ncta * CS +
                                    5 * CS);
  return s > SMEM_MAX ? -1 : (int)s;
}

template <typename T, int VB, bool SILU>
int launch_onchip(const Args& a) {
  auto kern = gn_onchip_kernel<T, VB, SILU>;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.cluster * (a.C / a.slice)), (unsigned)a.B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int p_per = (a.HW + a.cluster - 1) / a.cluster;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(a.x), a.scale, a.bias, a.tb,
      a.tb_rows, static_cast<T*>(a.y), a.HW, a.C, a.slice, a.gs, p_per,
      a.cluster, a.eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VB, bool SILU>
int launch_grid(const Args& a) {
  auto kern = gn_grid_kernel<T, VB, SILU>;
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  const int G = (a.HW + a.span - 1) / a.span;
  cudaError_t err = cudaMemsetAsync(
      a.scratch, 0, sizeof(float) * (6 * (size_t)a.slice + 1), a.st);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)a.smem;
  cfg.stream = a.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // every block resident
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.x), a.scale,
                           a.bias, a.tb, a.tb_rows, static_cast<T*>(a.y),
                           a.scratch, a.B, a.HW, a.C, a.slice, a.gs, a.span,
                           a.eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VB, bool SILU>
int launch_streamed(const Args& a) {
  cudaError_t err = cudaMemsetAsync(
      a.scratch, 0, sizeof(float) * 2 * (size_t)a.B * a.C, a.st);
  if (err != cudaSuccess) return (int)err;
  float* s1 = a.scratch;
  float* s2 = a.scratch + (long long)a.B * a.C;
  const unsigned spans = (unsigned)((a.HW + a.span - 1) / a.span);
  for (int b0 = 0; b0 < a.B; b0 += a.samples) {
    const int nb = a.samples < a.B - b0 ? a.samples : a.B - b0;
    for (int c0 = 0; c0 < a.C; c0 += a.slice) {
      const dim3 grid(spans, (unsigned)(a.slice / a.tile), (unsigned)nb);
      gn_stats_kernel<T, VB><<<grid, THREADS, a.smem, a.st>>>(
          static_cast<const T*>(a.x), s1, s2, a.HW, a.C, a.tile, c0, b0,
          a.span);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      gn_apply_kernel<T, VB, SILU><<<grid, THREADS, a.smem, a.st>>>(
          static_cast<const T*>(a.x), s1, s2, a.scale, a.bias, a.tb,
          a.tb_rows, static_cast<T*>(a.y), a.HW, a.C, a.tile, c0, b0, a.span,
          a.gs, a.eps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

template <typename T, int VB>
int run(int form, int silu, const Args& a) {
  if (form == 0)
    return silu ? launch_onchip<T, VB, true>(a) : launch_onchip<T, VB, false>(a);
  if (form == 2)
    return silu ? launch_grid<T, VB, true>(a) : launch_grid<T, VB, false>(a);
  return silu ? launch_streamed<T, VB, true>(a)
              : launch_streamed<T, VB, false>(a);
}

template <typename T>
int run_vb(int form, int silu, const Args& a) {
  switch (a.vb) {
    case 16: return run<T, 16>(form, silu, a);
    case 8: return run<T, 8>(form, silu, a);
    case 4: return run<T, 4>(form, silu, a);
    default:
      if constexpr (sizeof(T) == 2) return run<T, 2>(form, silu, a);
      return (int)cudaErrorInvalidValue;
  }
}

// the plan's numbers against this file's constants; 0 if they agree
int check_plan(int form, int isz, const Args& a) {
  const bool vb_ok = (a.vb == 2 || a.vb == 4 || a.vb == 8 || a.vb == 16) &&
                     a.vb % isz == 0;
  if (!vb_ok || a.slice <= 0 || a.C % a.slice || a.slice % a.gs ||
      (a.slice * isz) % a.vb)
    return 1;
  const int V = a.vb / isz;
  if (form == 0) {
    const int nq = a.slice / V;
    const bool k_ok = a.cluster == 1 || a.cluster == 2 || a.cluster == 4 ||
                      a.cluster == MAX_CLUSTER;
    if (nq > THREADS || !k_ok || a.tile != a.slice || a.samples != 1 ||
        a.span != (a.HW + a.cluster - 1) / a.cluster ||
        (long long)a.cluster * (a.C / a.slice) > 0x7fffffffLL)
      return 1;
    return a.smem == unit_smem(a.span, a.slice, isz, nq, a.cluster) ? 0 : 1;
  }
  if (form == 2) {
    const int nq = a.slice / V;
    if (nq > THREADS || a.tile != a.slice || a.samples != 1 ||
        a.cluster != 1 || a.span < 1 || a.scratch == nullptr)
      return 1;
    return a.smem == unit_smem(a.span, a.slice, isz, nq, 0) ? 0 : 1;
  }
  if (form != 1 || a.scratch == nullptr || a.tile <= 0 ||
      a.slice % a.tile || (a.tile * isz) % a.vb || a.tile / V > THREADS ||
      a.slice / a.tile > 65535 || a.samples < 1 || a.samples > a.B ||
      a.samples > 65535 || a.span < 1 || a.cluster != 1)
    return 1;
  const int smem = 8 * red_rows(a.tile / V) * a.tile;
  return smem <= STREAM_SMEM_MAX && a.smem == smem ? 0 : 1;
}

}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  x, y [B, H*W, C], 16-byte aligned;
// scale, bias [C] f32; tb null or f32 [tb_rows, C] with tb_rows 1
// (broadcast) or B; all contiguous (checked by the Python wrapper).  form 0 = on-chip, 1 = streamed, 2 = grid; vec_bytes, slice
// (channels of a unit or of a chunk), tile (channels of a streamed block),
// cluster (CTAs an on-chip unit), samples (a streamed chunk), span (pixels
// of a CTA or block) and smem (dynamic shared memory a block) come from
// `_gn_plan`.  scratch: f32 [2, B, C] for the streamed form, [6 CS + 1] for
// the grid form (its last word the barrier's counter), both zeroed here;
// null for the on-chip one.
int natdiff_group_norm(int dtype, const void* x, const float* scale,
                       const float* bias, const float* tb, int tb_rows,
                       int silu, void* y, float* scratch, int B, int HW,
                       int C, int group_size, float eps, int form,
                       int vec_bytes, int slice, int tile, int cluster,
                       int samples, int span, int smem, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || group_size <= 0 || C % group_size ||
      B > 65535 || (dtype != 0 && dtype != 1) ||
      (tb != nullptr && tb_rows != 1 && tb_rows != B))
    return (int)cudaErrorInvalidValue;
  const Args a{x,    scale, bias, tb,   tb_rows, y,       scratch,
               B,    HW,    C,    group_size,    eps,     vec_bytes,
               slice, tile, cluster, samples,    span,    smem,
               (cudaStream_t)stream};
  const int isz = dtype == 0 ? 4 : 2;
  if (check_plan(form, isz, a)) return (int)cudaErrorInvalidConfiguration;
  if (dtype == 0) return run_vb<float>(form, silu, a);
  return run_vb<__nv_bfloat16>(form, silu, a);
}

}  // extern "C"
