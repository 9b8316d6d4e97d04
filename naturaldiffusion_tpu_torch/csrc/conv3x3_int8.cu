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
// (ops/quant.py:conv3x3_int8_reference) bit for bit.  Int32 sums are exact
// in any order, so neither the tensor cores' order nor the split-K below
// changes a bit.
//
// Replaces no Pallas kernel: the JAX package's int8 conv is an XLA s8 conv
// (naturaldiffusion_tpu/ops/quant.py:153-156, `conv3x3_int8`), which
// PyTorch cannot run on a card (F.conv2d refuses int8).
//
// Bound on the H100: int8 tensor operations at 1,979 TOPS dense (a CIFAR
// batch-64 forward's 88 launches: 1,258 GOP, 0.64 ms); the bytes (bf16 x
// in, int8 weights, bf16 y out) at 3.35 TB/s are as large at 32x32 with 128
// channels and dominate on the 4x4 maps.  Only wgmma reaches the int8 rate,
// so the design:
//
//   * Products on wgmma.mma_async m64n128k32 s8 x s8 -> s32.  A unit is a
//     tile of BM = 128 output pixels (a 2-D tile of one image, or several
//     whole 4x4 / 8x8 images) times BN = 128 output channels; two consumer
//     warpgroups own 64 pixels each and keep two taps in flight
//     (wgmma.wait_group 1).  A (the activations) comes from registers: per
//     tap and 32 channels one ldmatrix.x4 of the int8 halo, shifted by the
//     tap, gives each warp's 16 rows in m16n8k32's A fragment layout, which
//     is wgmma's register-A layout warp by warp.  B (the weights, packed
//     [tap][Cout][Cin], K-major, the only form 8-bit wgmma takes) comes from
//     shared memory by descriptor.
//   * Weights by TMA: a 5-D tensor map over [9 Cout, Cin] int8 brings one
//     tap's BN rows x 128 bytes (128-byte swizzle, as the descriptor reads
//     it) into a ring of 4 stages with a full and an empty mbarrier each,
//     issued by one producer thread.  The map's strides reorder the rows so
//     that the accumulator column of a thread's pair i holds channel
//     32 t + 2 i + e: each thread's 32 channels of a pixel are 64
//     contiguous bytes of y, stored 16 bytes at a time.
//   * Activations by TMA, quantized by the producer warpgroups: a 4-D
//     tensor map over x [B, H, W, C] bf16 brings a chunk's halo (64
//     channels x (TW+2) x (TH+2) x images, twice a chunk of 128 channels)
//     from (c0, w0 - 1, h0 - 1, b0) into a staging buffer; elements
//     outside the tensor land as zeros, and zero quantizes to zero, so SAME
//     padding and ragged edges take no code.
//     Seven producer warps quantize the landed halo into one of two int8
//     halo buffers while the consumers multiply from the other, then
//     request the next chunk's halo.  The
//     dynamic quantize multiplies by the correctly rounded 1 / s and divides
//     (__fdiv_rn) only where that product lies within 2^-14 of a
//     half-integer: the same integers as dividing every element (see
//     quantize_div).  setmaxnreg moves registers from the producers to the
//     consumers; no barrier spans the block in the main loop.
//   * Filling the card: where the tiles x channel blocks ("units") reach 128
//     (the 16x16 and 32x32 maps), one block an SM walks units persistently,
//     so the producers load and quantize the next unit while the consumers
//     run the epilogue of the last.  Where they do not (4x4, 8x8), the
//     input-channel chunks are split across a cluster of 2-4 blocks: each
//     sums its chunks, the others store their int32 partial tile in their
//     own shared memory and signal the cluster's first block, which adds
//     them through distributed shared memory and dequantizes.
// What still bounds it is open (PERF.md §7): at 32x32 x 128 channels the
// bytes; elsewhere the consumers' per-tap loop (an empty one costs about
// 330 cycles a tap) and the producers' and the epilogue's costs add up
// instead of overlapping.  Ring depth, staging depth, taps in flight, an
// offset between the consumer warpgroups, 256 channels a unit and the
// conversion instructions were each varied without a gain.
// The plan (spatial tile, split, ring, blocks, shared memory) comes from
// Python (ops/quant.py:_int8_plan), which the entry checks against its own
// constants.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {
namespace qconv {

constexpr int BK = 128;          // input channels (bytes of int8) per chunk
constexpr int BM = 128;          // output pixels per unit
constexpr int STAGES = 4;        // weight ring depth
constexpr int BN = 128;          // output channels per unit (the wgmma N)
constexpr int THREADS = 512;     // two producer warpgroups + two consumer warpgroups
constexpr int CONSUMERS = 256;   // two consumer warpgroups
constexpr int QUANT = 224;       // quantizing threads: producer warps 1-7
constexpr int WSTAGE = BN * BK;  // bytes of one weight stage
// registers a thread: setmaxnreg gives the producers' spare ones back and
// raises the consumers' limit, but ptxas allocates every thread within the
// launch bound's 128 (the consumers fit: no spills)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;
constexpr int SA = BK + 16;      // int8 halo row stride, bytes: 8 rows on 8 bank groups
constexpr int HALF = 64 * 2;     // bytes of a staged half row (64 bf16 channels)
constexpr int MAX_SPLITS = 4;
// mbarriers: FULL[STAGES], EMPTY[STAGES], then these
constexpr int SFULL = 2 * STAGES;       // the staged bf16 halo has landed
constexpr int HFULL = SFULL + 1;        // [2] an int8 halo buffer is quantized
constexpr int HEMPTY = HFULL + 2;       // [2] the consumers are done with it
constexpr int RFULL = HEMPTY + 2;       // split-K: the peers' partials are stored
constexpr int RDONE = RFULL + 1;        // split-K: the first block has read them
constexpr int BAR_BYTES = 128;          // (2 STAGES + 7) x 8, rounded up

struct Plan {
  int imgs, th, tw, tiles_w, tiles_h, tiles, units, kc, splits;
};

__host__ __device__ inline int halo_rows(const Plan& p) {
  return p.imgs * (p.th + 2) * (p.tw + 2);
}

// 1024 of alignment slack, the weight ring, the bf16 staging (two halves),
// two int8 halo buffers, the mbarriers
inline size_t smem_bytes(const Plan& p) {
  const size_t rows = halo_rows(p);
  return 1024 + (size_t)STAGES * WSTAGE + rows * 2 * HALF +
         2 * rows * SA + BAR_BYTES;
}

struct Unit {
  int b0, h0, w0, n0;
};

// unit u: pixel tile u % tiles (as ops/conv3x3.py:tile_origin reads it),
// output channels BN (u / tiles) ..
__device__ __forceinline__ Unit unit_at(const Plan& p, int u) {
  const int tile = u % p.tiles;
  const int tx = tile % p.tiles_w;
  const int ty = tile / p.tiles_w % p.tiles_h;
  return {tile / (p.tiles_w * p.tiles_h) * p.imgs, ty * p.th, tx * p.tw,
          u / p.tiles * BN};
}

__device__ __forceinline__ int clip127(float s) {
  return max(-127, min(127, __float2int_rn(s)));
}

// clip(rint(f / d)) with f / d the IEEE quotient (__fdiv_rn), given
// rcp = __frcp_rn(d), d > 0 normal.  q = f * rcp is within |f / d| 2^-23
// of f / d, and __fdiv_rn(f, d) within 2^-18 of it while |f / d| < 128
// (beyond, both clip to the same end); so where q lies more than 2^-14
// from a half-integer, rint(q) equals rint(__fdiv_rn(f, d)), and only
// nearer ones divide (about 1 in 10^5 of the values at random scales).
__device__ __forceinline__ int quantize_div(float f, float d, float rcp) {
  const float q = __fmul_rn(f, rcp);
  if (fabsf(q - floorf(q) - 0.5f) > 0x1p-14f) return clip127(q);
  return clip127(__fdiv_rn(f, d));
}

// xmap: x [B, H, W, Cin] bf16, boxes of 64 channels x (tw + 2) x (th + 2) x
// imgs; wmap: w [9 Cout, Cin] int8, boxes of 128 bytes x BN rows, 128-byte
// swizzle.  Block b walks units b / splits, + gridDim.x / splits, ... and
// sums the input-channel chunks of its cluster rank's share.
template <bool DYN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ s_w,
                    const __nv_bfloat16* __restrict__ bias,
                    const float* __restrict__ sx, float q_mul, float s_static,
                    __nv_bfloat16* __restrict__ y, int B, int H, int W,
                    int Cout, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_s = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + (((raw_s + 1023) & ~1023u) - raw_s);  // [STAGES][BN][BK]
  const int rows = halo_rows(pl);
  unsigned char* stage = ring + STAGES * WSTAGE;                  // [2][rows][64] bf16
  int8_t* halo = reinterpret_cast<int8_t*>(stage + 2 * rows * HALF);  // [2][rows][SA]
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t stage_s = smem_addr(stage);
  const uint32_t halo_s = smem_addr(halo);
  const uint32_t bars = smem_addr(halo + 2 * rows * SA);
  auto bar = [&](int i) { return bars + 8 * i; };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int S = pl.splits;
  const int rank = S > 1 ? (int)cluster_rank() : 0;
  const int u0 = blockIdx.x / S, ustep = gridDim.x / S;
  const int kcs = pl.kc / S;              // chunks per split
  const int c0 = rank * kcs;
  const int hrow = pl.tw + 2;
  const int himg = (pl.th + 2) * hrow;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar(s), 1);               // the issuer's arrival + bytes
      mbar_init(bar(STAGES + s), 8);      // one arrival per consumer warp
    }
    mbar_init(bar(SFULL), 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar(HFULL + b), QUANT);
      mbar_init(bar(HEMPTY + b), 8);
    }
    mbar_init(bar(RFULL), S > 1 ? (S - 1) * CONSUMERS : 1);
    mbar_init(bar(RDONE), CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (S > 1) cluster_sync();  // the peers' mbarriers exist before any remote arrival

  if (warp < 8) {  // the producer warpgroups
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {  // one thread issues every weight copy
      if (lane == 0) {
        int s = 0, ph = 0, it = 0;  // stage, its round's parity, loads issued
        for (int u = u0; u < pl.units; u += ustep) {
          const int n0 = u / pl.tiles * BN;
          for (int c = c0; c < c0 + kcs; ++c)
            for (int tap = 0; tap < 9; ++tap, ++it) {
              if (it >= STAGES) mbar_wait(bar(STAGES + s), ph ^ 1);
              mbar_expect_tx(bar(s), WSTAGE);
              tma_load_5d(ring_s + s * WSTAGE, &wmap, c * BK, 0, 0, 0,
                          tap * (Cout / BN) + n0 / BN, bar(s));
              if (++s == STAGES) {
                s = 0;
                ph ^= 1;
              }
            }
        }
      }
      return;
    }
    // warps 1-7: request each chunk's bf16 halo, quantize it into an int8
    // halo buffer, request the next
    const int qt = tid - 32;
    auto issue_x = [&](int u, int c) {
      const Unit t = unit_at(pl, u);
      mbar_expect_tx(bar(SFULL), 2 * rows * HALF);
      for (int h = 0; h < 2; ++h)
        tma_load_4d(stage_s + h * rows * HALF, &xmap, c * BK + 64 * h, t.w0 - 1,
                    t.h0 - 1, t.b0, bar(SFULL));
    };
    if (qt == 0) issue_x(u0, c0);
    int job = 0;
    for (int u = u0; u < pl.units; u += ustep) {
      const int b0 = unit_at(pl, u).b0;
      const float d0 = DYN && b0 < B ? __ldg(sx + b0) : 1.f;  // a unit of one image
      const float rcp0 = DYN ? __frcp_rn(d0) : 1.f;
      for (int c = c0; c < c0 + kcs; ++c, ++job) {
        const int hb = job & 1;
        mbar_wait(bar(SFULL), job & 1);
        if (job >= 2) mbar_wait(bar(HEMPTY + hb), ((job >> 1) - 1) & 1);
        int8_t* dst = halo + hb * rows * SA;
        // vector v: channels 8 (v & 15) .. + 7 of halo row v >> 4
#pragma unroll 2
        for (int v = qt; v < rows * 16; v += QUANT) {
          const int r = v >> 4, q = v & 15;
          const uint4 in = *reinterpret_cast<const uint4*>(
              stage + (q >> 3) * rows * HALF + r * HALF + (q & 7) * 16);
          float d = d0, rcp = rcp0;
          if (DYN && pl.imgs > 1) {
            const int b = b0 + r / himg;
            d = b < B ? __ldg(sx + b) : 1.f;
            rcp = __frcp_rn(d);
          }
          const uint32_t w4[4] = {in.x, in.y, in.z, in.w};
          uint32_t p[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            int qi[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {  // bf16 -> f32 is the bits shifted up
              const uint32_t w = w4[2 * j + (k >> 1)];
              const float f = __uint_as_float(k & 1 ? w & 0xffff0000u : w << 16);
              qi[k] = DYN ? quantize_div(f, d, rcp) : clip127(__fmul_rn(f, q_mul));
            }
            // the four low bytes, in order
            p[j] = __byte_perm(__byte_perm(qi[0], qi[1], 0x0040),
                               __byte_perm(qi[2], qi[3], 0x0040), 0x5410);
          }
          *reinterpret_cast<uint2*>(dst + r * SA + q * 8) = make_uint2(p[0], p[1]);
        }
        mbar_arrive(bar(HFULL + hb));
        named_barrier(1, QUANT);  // every quantizer is done with the staging
        if (qt == 0) {
          if (c + 1 < c0 + kcs)
            issue_x(u, c + 1);
          else if (u + ustep < pl.units)
            issue_x(u + ustep, c0);
        }
      }
    }
    return;
  }

  // the consumers: warp cw of 8 owns the unit's pixels 16 cw .. 16 cw + 15
  setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = tid - (THREADS - CONSUMERS);
  const int cw = ct >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int hw_t = pl.th * pl.tw;
  // this lane's ldmatrix row: pixel 16 cw + (lane & 15), as the halo row of
  // its top-left tap; byte column 16 (lane >> 4) (the A fragment's k + 16)
  const int pa = 16 * cw + (lane & 15);
  const uint32_t a_lane =
      halo_s + ((pa / hw_t) * himg + (pa % hw_t / pl.tw) * hrow + pa % pl.tw) * SA +
      (lane >> 4) * 16;
  auto load_a = [&](uint32_t (&af)[4][4], int hb, int tap) {
    const uint32_t a = a_lane + hb * rows * SA + ((tap / 3) * hrow + tap % 3) * SA;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) ldsm_x4_at(af[ks], a + 32 * ks);
  };

  constexpr int NACC = BN / 2;  // s32 accumulators a thread
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    acc[i] = 0;
    keep(acc[i]);
  }
  uint32_t af0[4][4], af1[4][4];
  int s = 0, ph = 0, job = 0;  // ring stage and its round's parity; chunks done
  // issue one tap's 4 wgmma on af from ring stage s, and step the ring.  The
  // keep() fences make each descriptor and each A register complete before
  // the wgmma.fence (else ptxas serialises the wgmma).
  auto issue = [&](uint32_t (&af)[4][4]) {
    uint64_t desc[4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      desc[ks] = desc_sw128(ring_s + s * WSTAGE + 32 * ks);
      keep(desc[ks]);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(af[ks][e]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_m64n128k32_s8_rs(acc, af[ks], desc[ks]);
    wgmma_commit();
    if (++s == STAGES) {
      s = 0;
      ph ^= 1;
    }
  };
  // the tap that retired: its A registers live until here, then its stage
  // is free
  auto retire = [&](uint32_t (&af)[4][4], int stage) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(af[ks][e]);
    if (lane == 0) mbar_arrive(bar(STAGES + stage));
  };
  for (int u = u0; u < pl.units; u += ustep) {
    for (int c = 0; c < kcs; ++c, ++job) {
      const int hb = job & 1;
      mbar_wait(bar(HFULL + hb), (job >> 1) & 1);
      // two taps in flight: load tap t's A while tap t - 1 runs, issue it,
      // then retire tap t - 1 (wgmma.wait_group 1)
      auto step = [&](uint32_t (&af)[4][4], uint32_t (&prev)[4][4], int tap) {
        const int s_prev = s == 0 ? STAGES - 1 : s - 1;
        mbar_wait(bar(s), ph);
        load_a(af, hb, tap);
        issue(af);
        wgmma_wait<1>();
        retire(prev, s_prev);
      };
      mbar_wait(bar(s), ph);
      load_a(af0, hb, 0);
      issue(af0);
#pragma unroll
      for (int tap = 1; tap < 9; tap += 2) {
        step(af1, af0, tap);
        step(af0, af1, tap + 1);
      }
      wgmma_wait<0>();
      retire(af0, s == 0 ? STAGES - 1 : s - 1);
      if (lane == 0) mbar_arrive(bar(HEMPTY + hb));  // its last A was loaded
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) keep(acc[i]);

    if (S > 1) {
      // split-K: the peers store their partial tile over their own ring
      // ([BN / 8][256] 16-byte words, this thread's column ct), the first
      // block adds them (int32: exact in any order)
      const uint32_t part = ring_s + ct * 16;
      if (rank != 0) {
        named_barrier(2, CONSUMERS);  // both warpgroups' last wgmma is done
#pragma unroll
        for (int k = 0; k < NACC / 4; ++k)
          *reinterpret_cast<uint4*>(ring + (k * CONSUMERS + ct) * 16) = make_uint4(
              (uint32_t)acc[4 * k], (uint32_t)acc[4 * k + 1],
              (uint32_t)acc[4 * k + 2], (uint32_t)acc[4 * k + 3]);
        mbar_arrive_cluster(map_to_rank(bar(RFULL), 0));
        mbar_wait_cluster(bar(RDONE), 0);  // keep the memory until it is read
        return;
      }
      mbar_wait_cluster(bar(RFULL), 0);
      for (int r = 1; r < S; ++r) {
        const uint32_t src = map_to_rank(part, r);
#pragma unroll
        for (int k = 0; k < NACC / 4; ++k) {
          const uint4 v = ld_cluster_v4(src + k * CONSUMERS * 16);
          acc[4 * k] += (int)v.x;
          acc[4 * k + 1] += (int)v.y;
          acc[4 * k + 2] += (int)v.z;
          acc[4 * k + 3] += (int)v.w;
        }
      }
      for (int r = 1; r < S; ++r) mbar_arrive_cluster(map_to_rank(bar(RDONE), r));
    }

    // epilogue: acc[4 i + 2 h + e] is pixel 16 cw + g + 8 h, channel
    // n0 + (BN / 4) t4 + 2 i + e (the weight map's row order), so a
    // thread's BN / 4 channels of a pixel are contiguous: 16-byte stores;
    // scale = s[b] * s_w[co], f32(acc) * scale, + bias, to bf16
    const Unit t = unit_at(pl, u);
    const int cb = t.n0 + (BN / 4) * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * cw + g + 8 * h;
      const int b = t.b0 + p / hw_t;
      const int oh = t.h0 + p % hw_t / pl.tw, ow = t.w0 + p % pl.tw;
      if (!(b < B && oh < H && ow < W)) continue;
      const float sb = DYN ? sx[b] : s_static;
      __nv_bfloat16* yp = y + (((long long)b * H + oh) * W + ow) * Cout + cb;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {  // channels cb + 8 q .. + 7
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(s_w + cb + 8 * q));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(s_w + cb + 8 * q + 4));
        const float sc[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        uint4 bb = make_uint4(0u, 0u, 0u, 0u);
        if (bias != nullptr) bb = __ldg(reinterpret_cast<const uint4*>(bias + cb + 8 * q));
        const uint32_t bw[4] = {bb.x, bb.y, bb.z, bb.w};
        uint32_t out[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float scale = __fmul_rn(sb, sc[2 * k + e]);
            v[e] = __fmul_rn(__int2float_rn(acc[4 * (4 * q + k) + 2 * h + e]), scale);
            if (bias != nullptr)
              v[e] = __fadd_rn(v[e], __uint_as_float(e ? bw[k] & 0xffff0000u : bw[k] << 16));
          }
          out[k] = bits(__floats2bfloat162_rn(v[0], v[1]));
        }
        *reinterpret_cast<uint4*>(yp + 8 * q) = make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      acc[i] = 0;
      keep(acc[i]);
    }
  }
}

template <bool DYN>
int launch(const Plan& pl, int blocks, size_t smem, cudaStream_t st,
           const CUtensorMap& xmap, const CUtensorMap& wmap, const float* s_w,
           const void* bias, const float* sx, float q_mul, float s_static,
           void* y, int B, int H, int W, int Cout) {
  auto kern = conv3x3_int8_kernel<DYN>;
  static bool opted = false;  // above 48 KB only after this opt-in
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.splits > 1 ? 1 : 0;
  using bf = __nv_bfloat16;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, xmap, wmap, s_w, static_cast<const bf*>(bias), sx, q_mul,
      s_static, static_cast<bf*>(y), B, H, W, Cout, pl);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace qconv
}  // namespace

extern "C" {

const char* natdiff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dyn: 1 = per-sample scales sx [B] f32 (x / sx[b]), 0 = static (x * q_mul,
// dequant by s_static).  x [B,H,W,Cin] bf16, w [9][Cout][Cin] int8, s_w
// [Cout] f32, bias [Cout] bf16 or null, all 16-byte aligned; y [B,H,W,Cout]
// bf16; all contiguous (checked by the Python wrapper); Cin and Cout
// multiples of 128.  The plan (imgs .. smem) is ops/quant.py:_int8_plan's;
// one that disagrees with this file's constants launches nothing.
int natdiff_conv3x3_int8(int dyn, const void* x, const void* w,
                         const float* s_w, const void* bias, const float* sx,
                         float q_mul, float s_static, void* y, int B, int H,
                         int W, int Cin, int Cout, int imgs, int th, int tw,
                         int bk, int stages, int splits, int blocks, int smem,
                         void* stream) {
  using namespace qconv;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % BK ||
      Cout % BN || imgs <= 0 || th <= 0 || tw <= 0 || bk != BK ||
      stages != STAGES || splits < 1 ||
      splits > MAX_SPLITS ||
      (Cin / BK) % splits || (dyn && sx == nullptr) ||
      ((uintptr_t)x & 15) || ((uintptr_t)w & 15) || ((uintptr_t)s_w & 15) ||
      ((uintptr_t)bias & 15))
    return (int)cudaErrorInvalidValue;
  Plan pl{imgs, th, tw, (W + tw - 1) / tw, (H + th - 1) / th, 0, 0, Cin / BK,
          splits};
  const long long tiles =
      (long long)((B + imgs - 1) / imgs) * pl.tiles_w * pl.tiles_h;
  const long long units = tiles * (Cout / BN);
  const bool whole = th == H && tw == W && (th * tw) % 16 == 0;
  const size_t want = smem_bytes(pl);
  if (imgs * th * tw != BM || (imgs > 1 && !whole) ||
      halo_rows(pl) > BM * 9 / 4 || th + 2 > 256 || tw + 2 > 256 ||
      units > (1LL << 30) || want != (size_t)smem || want > 232448 ||
      (splits > 1 ? blocks != units * splits : (blocks < 1 || blocks > units)))
    return (int)cudaErrorInvalidValue;
  pl.tiles = (int)tiles;
  pl.units = (int)units;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                  (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t xbox[4] = {64, (cuuint32_t)tw + 2, (cuuint32_t)th + 2,
                              (cuuint32_t)imgs};
  int err = encode_tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x,
                              xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  // w as [9 Cout / BN][BN / 8 i][4 t][2 e][Cin] with channel
  // (BN / 4) t + 2 i + e of each block of BN, walked e, t, i: ring row
  // 8 i + 2 t + e (the wgmma's column of thread t's pair i) holds channel
  // (BN / 4) t + 2 i + e
  const cuuint64_t wdims[5] = {(cuuint64_t)Cin, 2, 4, BN / 8,
                               (cuuint64_t)9 * Cout / BN};
  const cuuint64_t wstrides[4] = {(cuuint64_t)Cin, (cuuint64_t)BN / 4 * Cin,
                                  (cuuint64_t)2 * Cin, (cuuint64_t)BN * Cin};
  const cuuint32_t wbox[5] = {BK, 2, 4, BN / 8, 1};
  err = encode_tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, w, wdims,
                          wstrides, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dyn)
    return launch<true>(pl, blocks, want, st, xmap, wmap, s_w, bias, sx, q_mul,
                        s_static, y, B, H, W, Cout);
  return launch<false>(pl, blocks, want, st, xmap, wmap, s_w, bias, sx, q_mul,
                       s_static, y, B, H, W, Cout);
}

}  // extern "C"
