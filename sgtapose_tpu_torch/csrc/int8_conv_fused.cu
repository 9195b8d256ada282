// int8 convolution with the activation quantized inside the kernel: float32
// or bf16 x in, s8 x s8 -> s32 implicit GEMM on the tensor cores, JAX's
// rescale epilogue; and the per-sample max|x| reduction that a dynamic scale
// needs first. The int8 serving path's one (static scale) or two (dynamic)
// launches a site.
//
// Replaces sgtapose_tpu/models/layers.py:_int8_conv (:155-195) with its
// `_quantize_operands` (:121-153) for the activation: on the TPU one XLA
// function quantizes x, runs `conv_general_dilated` on s8 with s32
// accumulators and rescales. Not a Pallas kernel. PR 14's design (PyTorch's
// quantize ops, then `int8_conv.cu` on s8 operands) stays as the yardstick,
// on no path.
//
//   a_scale[n] = static:  a_static (max(a_max, 1e-12) / 127 in double, rounded
//                         to float32 on the host)
//                dynamic: max(max|x| over video n % V, 1e-12) / 127 in float32
//   x_q[m, k]  = clamp(rint(float32(x) / a_scale[n(m)]), -127, 127)
//   acc[m, o]  = sum_k x_q[m, k] w_q[o, k]                        (exact s32)
//   out[m, o]  = to_out(float(acc) * (w_scale[o] * a_scale[n(m)]))
//   out[m, o]  = to_out(float(out[m, o]) + float(bias[o]))       (with a bias)
//
// m runs over the output pixels (n, oy, ox) of NHWC x (N, H, W, C), k over
// (ky, kx, c) of the weight (O, Kp) row-major, K = KH KW C zero-padded to Kp
// (a multiple of 32); the input pixel of (m, k) is (oy*stride - pad + ky,
// ox*stride - pad + kx), zero outside the map. Every step is exact or one
// IEEE rounding (__fdiv_rn, rintf, __fmul_rn, __fadd_rn; no fast math), and
// s32 sums are exact in any order, so outputs and accumulators equal the
// plain version's bit for bit whatever the split.
//
// The reduction (int8_absmax_kernel): a grid of (slots, N) blocks, each the
// max of |x| over one contiguous span of its sample, written to its own slot
// partial[n * slots + s]: no atomics in device memory, so nothing to zero
// first. The conv kernel reads in its prologue the slot maxima of the videos
// of its own images (a block's 64 pixels span at most 64 images, so any
// number of videos fits) and takes each video's max with shared-memory
// atomicMax on the float bits (|x| >= 0 orders as an unsigned int; exact and
// order-free).
//
// What bounds it on an H100: at the flagship's 57 sites, 0.130 ms a frame of
// bytes (x in bf16, the s8 weight, the bf16 output) against ~0.02 ms of
// int8 operations at 1,979 TOP/s, so in practice latency and the A
// producer: few pixels meet a long K at the 15x15 and 30x30 maps (K up to
// 4608), where PR 14's kernel gave a few dozen blocks 72-144 serial 32-byte
// steps each; many pixels meet a short K at the 120x120-480x480 maps, where
// each block's first loads and its quantization dominate. Design:
//   * a block owns BM = 64 pixels x BN output channels (BN = 64, or 16 where
//     O <= 16: the stems and the 16-channel level), two warpgroups, each one
//     `wgmma.m64nNk32.s32.s8.s8` column half (N = 32 or 8), A and B from
//     shared memory in wgmma's unswizzled K-major layout of 8-row x 16-byte
//     core matrices (LBO = 144 B: the 8 chunks a row's 8 threads store fall
//     on 8 bank groups);
//   * K goes in stages of 128 bytes through a ring of 3 stages: the weight
//     tile by `cp.async` (zero-filled past Kp and O), two stages ahead of
//     the math;
//   * the A producer, by site (ops/int8_conv.py:a_mode): "patch" for the
//     stems (C_in 3 and 1) and every 3x3 whose patch fits (to 60x60x128 and
//     30x30x256): a block is 64 pixels of one output row, or 64 // Wo whole
//     rows of a narrower map; its input patch is quantized once into shared
//     memory (16-byte loads, or whole contiguous row segments at the stems;
//     each input quantized about KH times where a per-tap producer
//     quantizes it KH KW times) and A is read from it through a tap table
//     (PR 14's kernel did a div/mod per byte at the stems); "vec" for the
//     1x1 sites, the DCN's columns and the 15x15 3x3: x's raw rows (float32
//     or bf16) by `cp.async` into the ring, each thread quantizing the
//     chunks it copied in registers into a double-buffered s8 tile while
//     the tensor cores run the previous stage; "gather", element by
//     element, where neither applies. On the card the patch beat vec at
//     every 3x3 it fits, and a 3-stage vec ring with two blocks an SM beat a
//     5-stage one with one. The quantizer takes the IEEE quotient from the
//     scale's correctly rounded reciprocal and two FMAs (`quotient`), with
//     no division and no branch: bit for bit, at a third of a division's
//     instructions (a division only near a tie cost more: bf16 activations
//     over a bf16 max / 127 put many quotients on a half-integer, and a
//     warp then waited on its divisions every stage);
//   * split-K where the tiles leave block slots idle (`ops/int8_conv.py:
//     plan`, at most 8 ranks, a cluster along z): each rank takes a
//     contiguous range of stages, and the s32 partial tiles are summed
//     through distributed shared memory: one launch, no workspace;
//   * the epilogue (JAX's order) writes NHWC rows; the accumulators can be
//     written beside the result (acc_out, for checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64, kThreads = 256;  // two warpgroups
constexpr int KS = 128;                 // K bytes per stage: 8 chunks of 16
constexpr int NST = 3;                  // stages in the ring
constexpr int kMaxSplits = 8;  // portable cluster size
constexpr int LBO = 144, SBO = 8 * LBO;
constexpr int A_TILE = (BM / 8) * SBO;  // bytes of one s8 A stage
constexpr int kReduceThreads = 256;

// how the A producer forms a stage's x_q (ops/int8_conv.py:a_mode)
enum Mode { GATHER = 0, VEC = 1, PATCH = 2 };
constexpr int kPatchMax = 32768;  // bytes of a patch-mode block's quantized input patch
constexpr int kPatchK = 4608;     // K of a patch-mode block's tap table

struct Geom {
  int N, H, W, C, O, KH, KW, stride, pad, Ho, Wo, K, Kp, M, steps;
  // patch mode: a tile is TR output rows x TW columns (64 columns of one
  // row on maps at least 64 wide, else 64 / Wo whole rows), tiles_w x
  // tiles_h of them an image; the patch is PR = (TR - 1) stride + KH rows
  // x PW = (TW - 1) stride + KW columns x C; vec_fill: the patch loads 16
  // bytes at a time (C a whole number of 16-byte vectors, x aligned)
  int TW, TR, tiles_w, tiles_h, PW, PR, vec_fill;
};

// T: float, or bf16 held as uint16_t. VEC: x's rows go through the cp.async
// ring (each thread's two 16-element chunks as 16-byte vectors). PATCH: the
// block's input patch (PR rows x PW columns x C), quantized once, and the
// patch offset of each k (int16) follow the struct in dynamic shared memory
template <typename T, int BN, int MODE>
struct Smem {
  static constexpr int VPC = sizeof(T);  // 16-byte vectors per 16-element chunk
  uint4 raw[MODE == VEC ? NST : 1][2 * VPC][kThreads];
  uint8_t b[NST][(BN / 8) * SBO];
  uint8_t a[2][A_TILE];  // after the K loop, the s32 partial tile
  int row_m[BM];  // the output pixel of each row, -1 past the edge
  float row_scale[BM];
  // the scales of the videos of the block's images n0 .. n0 + 63, video
  // (n0 + j) % V at j: any V, as a block's 64 pixels span at most 64 images
  float video_scale[BM];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma matrix descriptor of an unswizzled K-major tile starting at p
__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32);
}

// d (64 x 32, s32) += A (64 x 32 s8) * B (32 x 32 s8)^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db));
}

// d (64 x 8, s32) += A (64 x 32 s8) * B (8 x 32 s8)^T
__device__ __forceinline__ void wgmma_s8(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db));
}

// RN(v / s), the IEEE quotient, from r = RN(1 / s) without a division
// (Markstein's theorem): q = RN(v r) lies within an ulp of v / s, so the
// residual v - q s is exact in one FMA and RN(q + residual r) is the
// correctly rounded quotient, wherever v r does not overflow (then q is +-inf
// and clamps to +-127 as the quotient does) and v / s is not subnormal
// (then both round to 0)
__device__ __forceinline__ float quotient(float v, float s, float r) {
  const float q = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-q, s, v), r, q);
  return fabsf(q) < INFINITY ? q1 : q;
}

// x_q = clamp(rint(v / s), -127, 127) as the byte of an s8 (rint and the
// conversion in one cvt.rni, which saturates beyond the int range)
__device__ __forceinline__ uint32_t quant1(float v, float s, float r) {
  return (uint32_t)min(max(__float2int_rn(quotient(v, s, r)), -127), 127) & 0xffu;
}

// x_q of 16 elements packed little-endian into 4 words
__device__ __forceinline__ uint4 quant16(const float (&v)[16], float s, float r) {
  uint32_t wd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wd[i] = __byte_perm(__byte_perm(quant1(v[4 * i], s, r), quant1(v[4 * i + 1], s, r), 0x0040),
                        __byte_perm(quant1(v[4 * i + 2], s, r), quant1(v[4 * i + 3], s, r), 0x0040), 0x5410);
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// the output element (float32, or bf16 held as uint16_t) and its store
__device__ __forceinline__ void store_out(float* out, size_t i, float v, const float* bias, int o) {
  if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + o));
  out[i] = v;
}
__device__ __forceinline__ void store_out(uint16_t* out, size_t i, float v, const uint16_t* bias, int o) {
  uint16_t h = to_bf16(v);
  if (bias != nullptr) h = to_bf16(__fadd_rn(bf16f(h), bf16f(__ldg(bias + o))));
  out[i] = h;
}

// |x| as the bits of a non-negative float
__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }
__device__ __forceinline__ uint32_t abs_bits(uint16_t h) { return ((uint32_t)h << 16) & 0x7fffffffu; }

// blocks an SM as their shared memory allows (ops/int8_conv.py:blocks_per_sm)
template <typename T, int BN, int MODE>
__global__ void __launch_bounds__(kThreads, MODE == PATCH ? (BN == 16 ? 4 : 3)
                                            : MODE == GATHER || sizeof(T) == 2 ? 2 : 1)
    int8_conv_fused_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ w_scale, const float* __restrict__ partial_max, int slots,
                           int videos, float a_static, const T* __restrict__ bias, T* __restrict__ out,
                           int32_t* __restrict__ acc_out, Geom g) {
  constexpr int WN = BN / 2;    // columns per warpgroup
  constexpr int NACC = WN / 2;  // s32 accumulators per thread of an m64nWN product
  constexpr int VPC = Smem<T, BN, MODE>::VPC;
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int LDR = BN + 4;          // row of the partial tile
  static_assert(BM * LDR * 4 <= 2 * A_TILE, "the partial tile must fit in a[]");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T, BN, MODE>& sm = *reinterpret_cast<Smem<T, BN, MODE>*>(smem_raw);
  uint8_t* const patch = smem_raw + sizeof(Smem<T, BN, MODE>);  // patch mode only
  int16_t* const tab = reinterpret_cast<int16_t*>(patch + (g.PR * g.PW * g.C + 15) / 16 * 16);
  const int tid = threadIdx.x;
  const int o0 = blockIdx.y * BN;
  const int rank = blockIdx.z, splits = gridDim.z;  // split-K: the cluster's ranks along z
  const int s_begin = (int)((long long)g.steps * rank / splits);
  const int s_end = (int)((long long)g.steps * (rank + 1) / splits);
  const int hw = g.Ho * g.Wo;

  // the block's rows: flat, pixels 64 bx .. 64 bx + 63 of (n, oy, ox);
  // patch, the TR x TW pixels of tile (ty, tx) of image n, row r at (r / TW,
  // r % TW) within it
  int pn = 0, poy = 0, pox0 = 0;
  if constexpr (MODE == PATCH) {
    pox0 = (blockIdx.x % g.tiles_w) * g.TW;
    poy = (blockIdx.x / g.tiles_w) % g.tiles_h * g.TR;
    pn = blockIdx.x / g.tiles_w / g.tiles_h;
  }
  if (tid < BM) {
    int m;
    if constexpr (MODE == PATCH) {
      const int oy = poy + tid / g.TW, ox = pox0 + tid % g.TW;
      m = tid < g.TR * g.TW && oy < g.Ho && ox < g.Wo ? (pn * g.Ho + oy) * g.Wo + ox : -1;
    } else {
      m = blockIdx.x * BM + tid;
      m = m < g.M ? m : -1;
    }
    sm.row_m[tid] = m;
  }

  // this thread's chunk q (K bytes 16 q .. 16 q + 15 of a stage) of rows rr, rr + 32
  const int q = tid & 7, rr = tid >> 3;
  bool live[2] = {false, false};
  int iy0[2] = {0, 0}, ix0[2] = {0, 0};
  const T* img[2] = {x, x};
  if constexpr (MODE != PATCH) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = blockIdx.x * BM + rr + 32 * i;
      live[i] = m < g.M;
      const int n = live[i] ? m / hw : 0, rem = live[i] ? m - n * hw : 0;
      const int oy = rem / g.Wo, ox = rem - oy * g.Wo;
      iy0[i] = oy * g.stride - g.pad;
      ix0[i] = ox * g.stride - g.pad;
      img[i] = x + (size_t)n * g.H * g.W * g.C;
    }
  }

  // patch mode: the patch offset of each of this thread's rows (a row past
  // the tile reads the patch's first bytes and is never stored)
  int pbase[2] = {0, 0};
  if constexpr (MODE == PATCH) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr + 32 * i, tr = r / g.TW;
      pbase[i] = tr < g.TR ? (tr * g.PW + r % g.TW) * g.stride * g.C : 0;
    }
  }

  // cp.async of stage s into ring slot st: the weight tile, and x's raw rows (VEC)
  auto issue = [&](int s, int st) {
    const int kb = s * KS;
    for (int e = tid; e < BN * 8; e += kThreads) {
      const int o = e >> 3, qq = e & 7, k = kb + 16 * qq;
      const bool ok = o0 + o < g.O && k < g.Kp;
      cp_async16(&sm.b[st][(o >> 3) * SBO + qq * LBO + (o & 7) * 16], ok ? w + (size_t)(o0 + o) * g.Kp + k : w,
                 ok ? 16 : 0);
    }
    if constexpr (MODE == VEC) {
      const int k0 = kb + 16 * q;
      const int tap = k0 / g.C, c = k0 - tap * g.C, ky = tap / g.KW, kx = tap - ky * g.KW;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int iy = iy0[i] + ky, ix = ix0[i] + kx;
        const bool ok = live[i] && k0 < g.K && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
        const T* src = ok ? img[i] + ((size_t)iy * g.W + ix) * g.C + c : x;
#pragma unroll
        for (int j = 0; j < VPC; ++j) cp_async16(&sm.raw[st][i * VPC + j][tid], ok ? src + j * EPV : x, ok ? 16 : 0);
      }
    }
  };

  // stage s's x_q (raw ring slot st) into the s8 tile a[buf]
  auto convert = [&](int s, int st, int buf, const float (&rs)[2], const float (&ri)[2]) {
    const int k0 = s * KS + 16 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rr + 32 * i;
      uint4 packed;
      if constexpr (MODE == PATCH) {
        // the quantized patch bytes of row r: one 16-byte copy where C % 16
        // == 0 (the chunk is one tap's channels)
        const uint8_t* base = patch + pbase[i];
        if (g.C % 16 == 0) {
          packed = k0 < g.K ? *reinterpret_cast<const uint4*>(base + tab[k0]) : make_uint4(0u, 0u, 0u, 0u);
        } else {
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (k0 + e < g.K) wd[e >> 2] |= (uint32_t)base[tab[k0 + e]] << (8 * (e & 3));
          packed = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      } else if (k0 >= g.K) {  // the zero padding of the last stage
        packed = make_uint4(0u, 0u, 0u, 0u);
      } else {
        float v[16];
        if constexpr (MODE == VEC) {
#pragma unroll
          for (int j = 0; j < VPC; ++j) {
            const uint4 u = sm.raw[st][i * VPC + j][tid];
            const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (sizeof(T) == 4) {
                v[j * 4 + e] = __uint_as_float(wd[e]);
              } else {
                v[j * 8 + 2 * e] = bf_lo(wd[e]);
                v[j * 8 + 2 * e + 1] = bf_hi(wd[e]);
              }
            }
          }
        } else {
          // (tap, c) of k0, then stepped element by element
          int tap = k0 / g.C, c = k0 - tap * g.C;
          int ky = tap / g.KW, kx = tap - ky * g.KW;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int iy = iy0[i] + ky, ix = ix0[i] + kx;
            const bool ok = live[i] && k0 + e < g.K && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
            v[e] = ok ? to_float(__ldg(img[i] + ((size_t)iy * g.W + ix) * g.C + c)) : 0.f;
            if (++c == g.C) {
              c = 0;
              if (++kx == g.KW) {
                kx = 0;
                ++ky;
              }
            }
          }
        }
        packed = quant16(v, rs[i], ri[i]);
      }
      *reinterpret_cast<uint4*>(&sm.a[buf][(r >> 3) * SBO + q * LBO + (r & 7) * 16]) = packed;
    }
  };

  // the first stages' copies go out before the scales are formed
#pragma unroll
  for (int p = 0; p < NST - 1; ++p) {
    if (s_begin + p < s_end) issue(s_begin + p, p);
    cp_async_commit();
  }

  // ---- the activation scale of each of the block's rows ----
  // image n's video is n % videos; the block reads only the slot maxima of
  // the videos of its own images n0 .. n1 (at most 64 of them), so any
  // number of videos fits its shared memory: slot j holds video (n0 + j) %
  // videos, and image n takes slot (n - n0) % videos
  const int n0 = MODE == PATCH ? pn : blockIdx.x * BM / hw;
  if (partial_max != nullptr) {
    const int n1 = MODE == PATCH ? pn : (min(blockIdx.x * BM + BM, g.M) - 1) / hw;
    const int nv = min(n1 - n0 + 1, videos), reps = g.N / videos;
    uint32_t* vmax = reinterpret_cast<uint32_t*>(sm.video_scale);
    for (int j = tid; j < nv; j += kThreads) vmax[j] = 0u;
    __syncthreads();
    for (int i = tid; i < nv * reps * slots; i += kThreads) {
      const int j = i / (reps * slots), r = i - j * (reps * slots), rep = r / slots, s = r - rep * slots;
      const int n = (n0 + j) % videos + rep * videos;
      atomicMax(&vmax[j], __float_as_uint(__ldg(partial_max + (size_t)n * slots + s)));
    }
    __syncthreads();
    for (int j = tid; j < nv; j += kThreads) {
      const float mx = __uint_as_float(vmax[j]);
      // torch's clamp_min keeps a NaN
      sm.video_scale[j] = __fdiv_rn(mx != mx ? mx : fmaxf(mx, 1e-12f), 127.f);
    }
    __syncthreads();
  }
  if (tid < BM) {  // the thread that wrote row_m[tid]
    const int m = sm.row_m[tid];
    sm.row_scale[tid] = partial_max != nullptr ? sm.video_scale[(m < 0 ? 0 : m / hw - n0) % videos] : a_static;
  }
  if constexpr (MODE == PATCH) {
    // the tap table, and the patch quantized once (one sample: one scale)
    const float sc = partial_max != nullptr ? sm.video_scale[0] : a_static, sr = __fdiv_rn(1.f, sc);
    for (int k = tid; k < g.K; k += kThreads) {
      const int tap = k / g.C, c = k - tap * g.C, ky = tap / g.KW, kx = tap - ky * g.KW;
      tab[k] = (int16_t)((ky * g.PW + kx) * g.C + c);
    }
    const T* xi = x + (size_t)pn * g.H * g.W * g.C;
    const int iy_top = poy * g.stride - g.pad, ix_left = pox0 * g.stride - g.pad;
    if (g.vec_fill) {
      // 16-byte loads of EPV elements (one index computation each), 8 in
      // flight per thread before any is used
      const int cv = g.C / EPV, row_v = g.PW * cv, total = g.PR * row_v;
      for (int u0 = tid; u0 < total; u0 += 8 * kThreads) {
        uint4 raw[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = u0 + u * kThreads;
          const int ky = e / row_v, j = e - ky * row_v, col = j / cv, c = (j - col * cv) * EPV;
          const int iy = iy_top + ky, ix = ix_left + col;
          raw[u] = e < total && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W
                       ? __ldg(reinterpret_cast<const uint4*>(xi + ((size_t)iy * g.W + ix) * g.C + c))
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int e = u0 + u * kThreads;
          if (e >= total) continue;
          const uint32_t wd[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<uint32_t*>(patch + e * EPV) =
                __byte_perm(__byte_perm(quant1(__uint_as_float(wd[0]), sc, sr), quant1(__uint_as_float(wd[1]), sc, sr),
                                        0x0040),
                            __byte_perm(quant1(__uint_as_float(wd[2]), sc, sr), quant1(__uint_as_float(wd[3]), sc, sr),
                                        0x0040),
                            0x5410);
          } else {
            uint32_t q[2];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              q[h] = __byte_perm(__byte_perm(quant1(bf_lo(wd[2 * h]), sc, sr), quant1(bf_hi(wd[2 * h]), sc, sr), 0x0040),
                                 __byte_perm(quant1(bf_lo(wd[2 * h + 1]), sc, sr),
                                             quant1(bf_hi(wd[2 * h + 1]), sc, sr), 0x0040),
                                 0x5410);
            *reinterpret_cast<uint2*>(patch + e * EPV) = make_uint2(q[0], q[1]);
          }
        }
      }
    } else {
      // row by row: a patch row is PW C contiguous elements of input row iy
      // from column ix_left, those of columns inside the map [j_lo, j_hi);
      // 8 loads in flight per thread before any is used
      const int row_elems = g.PW * g.C;
      const int j_lo = max(0, -ix_left) * g.C, j_hi = min(g.PW, g.W - ix_left) * g.C;
      for (int j0 = tid; j0 < row_elems; j0 += kThreads)
        for (int ky0 = 0; ky0 < g.PR; ky0 += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int iy = iy_top + ky0 + u;
            v[u] = ky0 + u < g.PR && iy >= 0 && iy < g.H && j0 >= j_lo && j0 < j_hi
                       ? to_float(__ldg(xi + (((long long)iy * g.W + ix_left) * g.C + j0)))
                       : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (ky0 + u < g.PR) patch[(ky0 + u) * row_elems + j0] = (uint8_t)quant1(v[u], sc, sr);
        }
    }
  }
  __syncthreads();
  const float rs[2] = {sm.row_scale[rr], sm.row_scale[rr + 32]};
  const float ri[2] = {__fdiv_rn(1.f, rs[0]), __fdiv_rn(1.f, rs[1])};

  const int wg = tid >> 7;  // this warpgroup's output columns: WN wg .. WN wg + WN - 1
  const int b_col = (WN * wg / 8) * SBO;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;

  if (s_begin < s_end) {
    cp_async_wait<NST - 2>();  // this thread's copies of stage s_begin have landed
    convert(s_begin, 0, 0, rs, ri);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = s_begin; s < s_end; ++s) {
    const int i = s - s_begin, st = i % NST, buf = i & 1;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KS / 32; ++kk)  // a k32 product covers 2 chunks along K
      wgmma_s8(acc, desc(&sm.a[buf][kk * 2 * LBO]), desc(&sm.b[st][b_col + kk * 2 * LBO]));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // refill the slot stage s - 1 used (its readers finished before the last barrier)
    if (s + NST - 1 < s_end) issue(s + NST - 1, (i + NST - 1) % NST);
    cp_async_commit();
    if (s + 1 < s_end) {
      cp_async_wait<NST - 2>();
      convert(s + 1, (i + 1) % NST, buf ^ 1, rs, ri);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
  }

  // ---- epilogue: partial tiles summed over the cluster (exact s32), JAX's
  // rescale, NHWC rows stored coalesced ----
  // wgmma m64nNk32 accumulators: warp w of the warpgroup holds rows 16w..;
  // lane (gq, tq) holds d[4j + 2h + c] at (16w + gq + 8h, 8j + 2tq + c)
  int* red = reinterpret_cast<int*>(&sm.a[0][0]);
  const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < WN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        red[(16 * warp + gq + 8 * h) * LDR + WN * wg + 8 * j + 2 * tq + c] = acc[4 * j + 2 * h + c];
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) cluster.sync();  // all partial tiles of the cluster are written
  else __syncthreads();
  // this rank finishes rows rank, rank + splits, ...
  const int my_rows = (BM - rank + splits - 1) / splits;
  for (int e = tid; e < my_rows * BN; e += kThreads) {
    const int row = rank + splits * (e / BN), col = e % BN;
    const int m = sm.row_m[row], o = o0 + col;
    int sum = red[row * LDR + col];
    for (int r = 1; r < splits; ++r) sum += cluster.map_shared_rank(red, (rank + r) % splits)[row * LDR + col];
    if (m >= 0 && o < g.O) {
      const size_t idx = (size_t)m * g.O + o;
      if (acc_out != nullptr) acc_out[idx] = sum;
      const float scale = __fmul_rn(__ldg(w_scale + o), sm.row_scale[row]);
      store_out(out, idx, __fmul_rn(__int2float_rn(sum), scale), bias, o);
    }
  }
  if (splits > 1) cluster.sync();  // no block leaves while another reads its tile
}

template <typename T, int BN, int MODE>
int launch_conv(const T* x, const int8_t* w, const float* w_scale, const float* partial, int slots, int videos,
                float a_static, const T* bias, T* out, int32_t* acc_out, const Geom& g, int splits,
                cudaStream_t stream) {
  auto kern = int8_conv_fused_kernel<T, BN, MODE>;
  const int smem = (int)sizeof(Smem<T, BN, MODE>) +
                   (MODE == PATCH ? (g.PR * g.PW * g.C + 15) / 16 * 16 + 2 * g.K : 0);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_m = MODE == PATCH ? g.N * g.tiles_h * g.tiles_w : (g.M + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_m, (g.O + BN - 1) / BN, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // an unsplit tile needs no cluster
  e = cudaLaunchKernelEx(&cfg, kern, x, w, w_scale, partial, slots, videos, a_static, bias, out, acc_out, g);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int conv_mode(const void* x, const void* w, const void* w_scale, const void* partial, int slots, int videos,
              float a_static, const void* bias, void* out, void* acc_out, const Geom& g, int mode, int splits,
              cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* wt = static_cast<const int8_t*>(w);
  const float* ws = static_cast<const float*>(w_scale);
  const float* pm = static_cast<const float*>(partial);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  int32_t* at = static_cast<int32_t*>(acc_out);
  if (mode == VEC)
    return launch_conv<T, BN, VEC>(xt, wt, ws, pm, slots, videos, a_static, bt, ot, at, g, splits, stream);
  if (mode == PATCH)
    return launch_conv<T, BN, PATCH>(xt, wt, ws, pm, slots, videos, a_static, bt, ot, at, g, splits, stream);
  return launch_conv<T, BN, GATHER>(xt, wt, ws, pm, slots, videos, a_static, bt, ot, at, g, splits, stream);
}

template <typename T>
int conv(const void* x, const void* w, const void* w_scale, const void* partial, int slots, int videos,
         float a_static, const void* bias, void* out, void* acc_out, const Geom& g, int tile_n, int mode, int splits,
         cudaStream_t stream) {
  return tile_n == 16
             ? conv_mode<T, 16>(x, w, w_scale, partial, slots, videos, a_static, bias, out, acc_out, g, mode, splits,
                                stream)
             : conv_mode<T, 64>(x, w, w_scale, partial, slots, videos, a_static, bias, out, acc_out, g, mode, splits,
                                stream);
}

// partial[n * slots + s] = max |x| over elements [E s / slots, E (s + 1) / slots)
// of sample n (E = per_sample), 16-byte loads where the span allows
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    int8_absmax_kernel(const T* __restrict__ x, float* __restrict__ partial, int per_sample, int slots, int vec) {
  constexpr int EPV = 16 / sizeof(T);
  const int n = blockIdx.y, s = blockIdx.x, tid = threadIdx.x;
  const T* xs = x + (size_t)n * per_sample;
  const int lo = (int)((long long)per_sample * s / slots), hi = (int)((long long)per_sample * (s + 1) / slots);
  int a = hi, b = hi;  // the vector span [a, b)
  if (vec) {
    a = min(hi, (lo + EPV - 1) / EPV * EPV);
    b = max(a, hi / EPV * EPV);
  }
  uint32_t m = 0u;
  for (int i = lo + tid; i < a; i += kReduceThreads) m = max(m, abs_bits(__ldg(xs + i)));
  for (int i = b + tid; i < hi; i += kReduceThreads) m = max(m, abs_bits(__ldg(xs + i)));
  const uint4* v = reinterpret_cast<const uint4*>(xs);
  for (int i = a / EPV + tid; i < b / EPV; i += kReduceThreads) {
    const uint4 u = __ldg(v + i);
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (sizeof(T) == 4) {
        m = max(m, wd[e] & 0x7fffffffu);
      } else {
        m = max(m, (wd[e] << 16) & 0x7fffffffu);
        m = max(m, wd[e] & 0x7fff0000u);
      }
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ uint32_t warp_max[kReduceThreads / 32];
  if ((tid & 31) == 0) warp_max[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < kReduceThreads / 32; ++i) m = max(m, warp_max[i]);
    partial[n * slots + s] = __uint_as_float(m);
  }
}

}  // namespace

// x (N,H,W,C) float32 (x_bf16 = 0) or bf16, contiguous; w (O,Kp) s8; w_scale
// (O,) float32; partial_max (N * slots) float32 from int8_absmax (dynamic
// scales, per video of `videos`: sample n is video n % videos) or null
// (static: a_static for every sample); bias (O,) in x's dtype or null; out
// (N,Ho,Wo,O) in x's dtype; acc_out (N,Ho,Wo,O) s32 or null; tile_n 16 or
// 64, mode 0 (gather), 1 (vec: C % 16 == 0, x 16-byte aligned) or 2 (patch)
// and splits 1..8 from ops/int8_conv.py:plan; returns cudaError_t
extern "C" int int8_conv_fused_fwd(const void* x, const void* w, const void* w_scale, const void* partial_max,
                                   int slots, int videos, float a_static, const void* bias, void* out,
                                   void* acc_out, int N, int H, int W, int C, int O, int KH, int KW, int stride,
                                   int pad, int Ho, int Wo, int Kp, int x_bf16, int tile_n, int mode, int splits,
                                   void* stream) {
  const int K = KH * KW * C, TW = Wo >= BM ? BM : Wo, TR = Wo >= BM ? 1 : BM / Wo;
  const int PW = (TW - 1) * stride + KW, PR = (TR - 1) * stride + KH, epv = x_bf16 ? 8 : 4;
  Geom g{N,  H,  W,  C,  O,  KH, KW, stride, pad, Ho, Wo, K, Kp, N * Ho * Wo, (Kp + KS - 1) / KS,
         TW, TR, (Wo + TW - 1) / TW, (Ho + TR - 1) / TR, PW, PR,
         C % epv == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  if (g.M == 0 || O == 0) return 0;
  const bool mode_ok = mode == GATHER ||
                       (mode == VEC && C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) ||
                       (mode == PATCH && K <= kPatchK && PR * PW * C <= kPatchMax);
  if (Kp % 32 != 0 || Kp < K || (tile_n != 16 && tile_n != 64) || !mode_ok || splits < 1 || splits > kMaxSplits ||
      splits > g.steps || (partial_max != nullptr && (slots < 1 || videos < 1 || N % videos != 0)) ||
      (O + tile_n - 1) / tile_n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? conv<uint16_t>(x, w, w_scale, partial_max, slots, videos, a_static, bias, out, acc_out, g, tile_n,
                                 mode, splits, s)
                : conv<float>(x, w, w_scale, partial_max, slots, videos, a_static, bias, out, acc_out, g, tile_n,
                              mode, splits, s);
}

// x (N, per_sample) float32 (x_bf16 = 0) or bf16, contiguous; partial (N *
// slots) float32; returns cudaError_t
extern "C" int int8_absmax(const void* x, void* partial, int N, int per_sample, int slots, int x_bf16,
                           void* stream) {
  if (N <= 0 || slots <= 0) return (int)cudaErrorInvalidValue;
  const int elem = x_bf16 ? 2 : 4;
  const int vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0 && ((long long)per_sample * elem) % 16 == 0) ? 1 : 0;
  const dim3 grid(slots, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    int8_absmax_kernel<uint16_t><<<grid, kReduceThreads, 0, s>>>(static_cast<const uint16_t*>(x),
                                                                 static_cast<float*>(partial), per_sample, slots, vec);
  else
    int8_absmax_kernel<float><<<grid, kReduceThreads, 0, s>>>(static_cast<const float*>(x),
                                                              static_cast<float*>(partial), per_sample, slots, vec);
  return (int)cudaGetLastError();
}
