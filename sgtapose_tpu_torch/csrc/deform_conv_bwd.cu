// Data gradient of the fused modulated deformable convolution (DCNv2), NHWC,
// float32: the cotangent of the sampled columns formed on the tensor cores
// and scattered back in one kernel (deform_conv_dgrad).
//
// Replaces the custom VJP of sgtapose_tpu/models/deform_conv.py
// (deform_sample_batch: _dsb_bwd / _bwd_core, :130-199; XLA gathers and a
// segment_sum on the TPU, not Pallas) composed with the data gradient XLA
// derives for the 1x1 `kernel` contraction at :329-357. With om the raw
// offset/mask conv output ((dy, dx) of row-major tap k in channels 2k, 2k+1,
// its mask logit in 18+k), s_k = sigmoid(om[p, 18+k]) and dY (B,H,W,O):
//   dcols[p, k*C + c] = sum_o dY[p, o] * weight[o, k*C + c]
//   dx[corner, c]    += s_k * w_corner * dcols[p, k*C + c]
//   dom[p, 2k:2k+2]   = sum_c s_k dcols[p, k*C + c] * d samp / d (y, x)
//   dom[p, 18+k]      = (sum_c samp[p, k, c] dcols[p, k*C + c]) * s_k (1 - s_k)
// with the bilinear weights and their derivatives zero for a corner outside
// the map (its value is never read), as in _bwd_core.
//
// What bounds it on an H100: operations, 2 M O 9C for the product at
// 165 TFLOP/s in 3xTF32 (the forward's count); bytes (dY, x, om and the
// weight read once, dx and dom written once) are below that at every
// decoder node. The scatter's ~34 float32 FLOPs per (pixel, tap, channel)
// run on the FMA pipe beside the tensor cores and are not counted.
// What its design does about the route it replaces (a float32 torch.matmul
// writing the (B,H,W,9C) cotangent to device memory, then one warp per
// (pixel, tap) issuing 4 global float atomics per channel):
//   * the cotangent never leaves the SM: a block owns a T x T = 8 x 8 pixel
//     tile of one image and walks the channels in chunks of CC = 16; for each
//     chunk it forms the 64 x 144 tile dcols[pixel, (tap, channel)] with wgmma
//     m64n72k8 in 3xTF32 (each operand split into hi and lo tf32 planes, the
//     lo*lo product dropped: ~2^-22 relative; the three products share one
//     float32 accumulator), one warpgroup per 72 columns, over K = O in
//     steps of 32 through a 3-stage ring, in deform_conv.cu's unswizzled
//     K-major planes with a 144-byte core-matrix pitch. tf32 wgmma reads B
//     K-major only, and B's columns are 9 strided runs of CC channels in each
//     weight row, so a first small kernel of the same launch writes the
//     weight once, split into hi and lo and laid out as the B planes of each
//     (chunk, step); every block then copies its B tiles with cp.async two
//     steps ahead, with no conversion. A (the dY rows of the tile) is split
//     as it is stored, one step ahead;
//   * 384 threads: the third warpgroup runs no products but shares the
//     copies and the scatter, which is latency-bound at one block per SM
//     (~225 KB of shared memory);
//   * the scatter becomes a gather through shared memory: a 17 x 17 halo
//     tile (the pixel tile plus HALO = 3 pixels of offset, the +-1 tap and
//     the +1 corner) holds the chunk's x values, which the 4 corners of each
//     (pixel, tap) read. The sample coordinates are the same for every
//     chunk, so once per block the (pixel, tap, corner) contributions that
//     land inside the halo are sorted by halo cell (a counting sort with
//     integer shared atomics, which are native; float adds into shared memory
//     are compare-and-swap loops on this card, and a first design that
//     scattered with them ran 40 ms a train step). Each chunk, one thread
//     per (cell, 4 channels) then sums its cell's list of mask x weight x
//     dcols and adds the sum into dx with one global atomic per non-zero
//     element (the halos of neighbouring tiles overlap). A corner outside
//     the halo reads x from global memory and adds into dx with a global
//     atomic, so any offset is right. Zero-weight corners are not listed: at
//     zero offsets (flax's init) one corner in four carries weight;
//   * the per-(pixel, tap) sums over the channels (the two offset derivatives
//     and the mask's) stay in the registers of the thread that owns the
//     (pixel, tap) across all chunks, and dom is written once, with no
//     atomics, so dom is the same in every run (dx is not: float atomics);
//   * small maps (15 x 15 at batch 8 is 32 tiles for 132 SMs) split the
//     channel chunks over a thread-block cluster of up to 8 blocks; each
//     rank's chunks own their channels of dx, and the ranks' dom partial
//     sums are added through distributed shared memory in rank order;
//   * pixel, channel and output edges are masked, so any H, W, C and O run
//     (C or O not a multiple of 4, or unaligned pointers, take a scalar-load
//     variant).
//
// bf16 training's first data gradient (deform_conv_dgrad_halo_bf16, now
// the yardstick of csrc/deform_conv_dgrad_bf16.cu, on no path): the same
// design instantiated for bf16 x, om, weight and dY. dY W runs on wgmma
// m64n72k16 in bf16 with float32 accumulators (one product where float32
// issues three, BK = 64 outputs a step: half the steps), from a bf16 copy of
// the weight laid out as the B tiles (no split). Everything after the
// product stays float32: the x halo tile is widened from bf16 as it is
// staged, the scatter and the item sums run in float32, dx is added with
// float atomics into a float32 buffer that a third kernel of the same launch
// rounds once to bf16, and dom is rounded once as it is written (still the
// same bit for bit in every run). Bound: the product's 2 M O 9C operations at
// 989 TFLOP/s, or the bytes at 2 per element, whichever is larger.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int T = 8;              // tile side
constexpr int BM = T * T;         // pixels per block: the wgmma M of 64
constexpr int CC = 16;            // channels per chunk
constexpr int BN = 9 * CC;        // GEMM columns per chunk, (tap, channel)
constexpr int WN = BN / 2;        // 72 per warpgroup
constexpr int kThreads = 384;     // three warpgroups: two run the products, all three the rest
constexpr int kGemmThreads = 256;
constexpr int kMaxSplits = 8;     // portable cluster size
constexpr int HALO = 3;           // offsets the shared-memory tile covers
constexpr int HS = T + 2 * HALO + 3;  // halo tile side
// cells per stored halo row: 19 = 3 (mod 8), so the 9 taps' corners of one
// pixel (cell offsets 19 ky + kx) fall on distinct float4 bank groups
constexpr int HR = 19;
constexpr int HP = HS * HR;
constexpr int ITEMS = BM * 9;     // (pixel, tap) of a block
constexpr int IPT = (ITEMS + kThreads - 1) / kThreads;  // items per thread
constexpr int GS = CC + 4;        // row of dcols and of the x tile (float4 reads)
constexpr int LIST = 4 * ITEMS;   // (pixel, tap, corner) contributions of a block, at most
constexpr int LBO = 144, SBO = 8 * LBO;
constexpr int PLANE_A = (BM / 8) * SBO / 4;  // u32 per plane
constexpr int PLANE_B = (BN / 8) * SBO / 4;
constexpr int NA = BM * 8 / kGemmThreads;    // A chunks (16 bytes) each product thread loads per step
// a step's B plane without the pad slots: 16-byte pieces (row group, K chunk, row % 8)
constexpr int B_PIECES = (BN / 8) * 8 * 8;
constexpr int B_TILE = 4 * B_PIECES;  // u32 per plane of a step in the pre-split weight
static_assert(NA == 2, "each thread loads A rows rr and rr + 32");
static_assert(WN % 8 == 0 && CC % 4 == 0, "wgmma N and float4 channel groups");
static_assert(HR >= HS && ITEMS < 65536, "padded halo rows; 16-bit item indices");

// output channels (the GEMM depth) per step: one 128-byte row of 8 chunks,
// 32 float32 or 64 bf16 (T: float, or bf16 held as uint16_t)
template <typename E>
__host__ __device__ constexpr int bk() {
  return 8 * (16 / (int)sizeof(E));
}
// u32 of the pre-split weight per (chunk, step) tile: float32 keeps a hi and
// a lo tf32 plane, bf16 one plane
template <typename E>
__host__ __device__ constexpr int b_tile_words() {
  return sizeof(E) == 4 ? 2 * B_TILE : B_TILE;
}

struct Stage {
  uint32_t a[2][PLANE_A];  // [hi, lo]: dY rows (pixels), K-major (bf16: plane 0 only)
  uint32_t b[2][PLANE_B];  // [hi, lo]: weight columns (tap, channel), K-major
};
static_assert(ITEMS * GS * sizeof(float) <= sizeof(Stage), "dcols fit in a ring stage");

struct Smem {
  // a 3-stage ring; after a chunk's last step its stage holds the chunk's
  // dcols, [pixel][tap][channel] in rows of GS, and at the end the item sums
  Stage ring[3];
  float xh[HP * GS];          // x on the halo tile, this chunk's channels (float32)
  int start[HP + 1];          // the contributions landing in halo cell h: list[start[h] .. start[h+1])
  int fill[HP];
  uint16_t item[LIST];        // (pixel, tap) of each listed contribution, sorted by halo cell
  float coef[LIST];           // its mask x bilinear weight
  float om[ITEMS * 3];        // (dy, dx, mask logit) of each (pixel, tap)
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void store_split(uint32_t* hi, uint32_t* lo, int off, float4 v) {
  uint4 h, l;
  h.x = tf32(v.x);
  h.y = tf32(v.y);
  h.z = tf32(v.z);
  h.w = tf32(v.w);
  l.x = tf32(v.x - __uint_as_float(h.x));
  l.y = tf32(v.y - __uint_as_float(h.y));
  l.z = tf32(v.z - __uint_as_float(h.z));
  l.w = tf32(v.w - __uint_as_float(h.w));
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

__device__ __forceinline__ uint64_t desc(const uint32_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// asynchronous copies global -> shared (16 or 4 bytes), waited for before
// the barrier that publishes them
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_group1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// d (64 x 72, f32) += A (64 x 8) * B (72 x 8)^T, both tf32 K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_n72(float (&d)[36], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(da), "l"(db));
}

// d (64 x 72, f32) += A (64 x 16) * B (72 x 16)^T, both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_bf16_n72(float (&d)[36], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "%36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(da), "l"(db));
}

// 4 elements at p as floats, those at or past `lim` (elements left in the
// row) zero; VEC: a whole aligned group (16 bytes of float32, 8 of bf16)
// the caller knows is in range
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int lim) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return make_float4(lim > 0 ? __ldg(p) : 0.f, lim > 1 ? __ldg(p + 1) : 0.f,
                       lim > 2 ? __ldg(p + 2) : 0.f, lim > 3 ? __ldg(p + 3) : 0.f);
  }
}
template <bool VEC>
__device__ __forceinline__ float4 load4(const uint16_t* p, int lim) {
  if constexpr (VEC) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
  } else {
    return make_float4(lim > 0 ? bf16f(__ldg(p)) : 0.f, lim > 1 ? bf16f(__ldg(p + 1)) : 0.f,
                       lim > 2 ? bf16f(__ldg(p + 2)) : 0.f, lim > 3 ? bf16f(__ldg(p + 3)) : 0.f);
  }
}

// the 8 bf16 of a 16-byte chunk at p (dY outputs o .. o + 7), those at or
// past `lim` zero; VEC: a whole aligned chunk in range
template <bool VEC>
__device__ __forceinline__ uint4 load8(const uint16_t* p, int lim) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = i < lim ? (uint32_t)__ldg(p + i) : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                      h[6] | (h[7] << 16));
  }
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// a float32 result stored as E: float32 as it is, bf16 rounded once
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(uint16_t* dst, float v) { *dst = to_bf16(v); }

// sample coordinates of (pixel, tap) from o = its (dy, dx, mask logit): the 4 corners (00, 01, 10, 11), each
// either a halo-tile cell (loc >= 0) or, outside the halo, -1 - its image
// pixel; the fractional position and the bilinear weights, zero for a
// corner outside the map (ok false)
struct Tap {
  float mk, fy, fx;
  float wv[4];
  int loc[4];
  bool ok[4];
};

__device__ __forceinline__ Tap tap_coords(const float* o, int img, int pix, int tap, int H, int W,
                                          int hy0, int hx0) {
  Tap t;
  const int px = pix % W, py = (pix / W) % H;
  t.mk = 1.f / (1.f + expf(-o[2]));
  const float sy = (float)(py + tap / 3 - 1) + o[0];
  const float sx = (float)(px + tap % 3 - 1) + o[1];
  const float y0f = floorf(sy), x0f = floorf(sx);
  const float fy = sy - y0f, fx = sx - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f;
  t.fy = fy;
  t.fx = fx;
  const float wv[4] = {(1.f - fy) * (1.f - fx), (1.f - fy) * fx, fy * (1.f - fx), fy * fx};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
    t.ok[k] = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const int hy = yy - hy0, hx = xx - hx0;
    t.loc[k] = (hy >= 0 && hy < HS && hx >= 0 && hx < HS) ? hy * HR + hx
                                                          : -1 - ((img * H + yy) * W + xx);
    t.wv[k] = t.ok[k] ? wv[k] : 0.f;
  }
  return t;
}

// The weight laid out per (chunk, step) as the B planes of shared memory
// without their pad slots: B row r = (tap, channel) of chunk ch is weight
// column tap * C + ch * CC + r % CC, K column k of step ks is output
// ks * BK + k; zero past C and O. float32: split into tf32 hi and lo planes;
// bf16: one plane of the weight's own bits, two outputs to a 32-bit word.
// Every block copies its tiles from here in 16-byte pieces, with no
// conversion.
template <typename E>
__device__ __forceinline__ void split_body(const E* __restrict__ wt, uint32_t* __restrict__ wsplit,
                                           int C, int O, int KS, long long total) {
  constexpr int BK = bk<E>();
  for (long long e = blockIdx.x * 256ll + threadIdx.x; e < total; e += (long long)gridDim.x * 256) {
    // e = ((tile * B_PIECES + piece) * 4 + u), tile = ch * KS + ks; u is a
    // 32-bit word of the piece: one float32, or two bf16
    const int u = (int)(e & 3), piece = (int)((e >> 2) % B_PIECES);
    const long long tile = (e >> 2) / B_PIECES;
    const int ks = (int)(tile % KS), ch = (int)(tile / KS);
    const int r = (piece >> 6) * 8 + (piece & 7);
    const int c = ch * CC + r % CC;
    const size_t col = (size_t)(r / CC) * C + c;
    uint32_t* dst = wsplit + tile * b_tile_words<E>() + 4 * piece + u;
    if constexpr (sizeof(E) == 4) {
      const int o = ks * BK + ((piece >> 3) & 7) * 4 + u;
      const float v = (c < C && o < O) ? __ldg(wt + (size_t)o * 9 * C + col) : 0.f;
      const uint32_t hi = tf32(v);
      dst[0] = hi;
      dst[B_TILE] = tf32(v - __uint_as_float(hi));
    } else {
      const int o = ks * BK + ((piece >> 3) & 7) * 8 + 2 * u;
      const uint32_t lo = (c < C && o < O) ? (uint32_t)__ldg(wt + (size_t)o * 9 * C + col) : 0u;
      const uint32_t hi = (c < C && o + 1 < O) ? (uint32_t)__ldg(wt + (size_t)(o + 1) * 9 * C + col) : 0u;
      dst[0] = lo | (hi << 16);
    }
  }
}

template <typename E, bool VEC>
__device__ __forceinline__ void dgrad_body(const E* __restrict__ x, const E* __restrict__ om,
                                           const uint32_t* __restrict__ wsplit,
                                           const E* __restrict__ dy, float* __restrict__ dx,
                                           E* __restrict__ dom, int H, int W, int C, int O,
                                           int tiles_x, int tiles_per_img) {
  constexpr bool F32 = sizeof(E) == 4;
  constexpr int BK = bk<E>();
  constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int img = blockIdx.x / tiles_per_img, tile = blockIdx.x % tiles_per_img;
  const int ty0 = (tile / tiles_x) * T, tx0 = (tile % tiles_x) * T;
  const int hy0 = ty0 - 1 - HALO, hx0 = tx0 - 1 - HALO;  // the halo tile's origin
  // the blocks of one cluster (along z) take consecutive channel chunks
  const int rank = blockIdx.z, splits = gridDim.z;
  const int CB = (C + CC - 1) / CC, KS = (O + BK - 1) / BK;
  const int ch_begin = (int)((long long)CB * rank / splits);
  const int ch_end = (int)((long long)CB * (rank + 1) / splits);
  const int steps = (ch_end - ch_begin) * KS;

  // image pixel of tile row r, or -1 past the map's edge
  auto pixel = [&](int r) {
    const int py = ty0 + r / T, px = tx0 + r % T;
    return (py < H && px < W) ? (img * H + py) * W + px : -1;
  };
  // float32: asynchronous, waited for before the chunk's scatter; bf16:
  // widened and stored, published by the barrier before the scatter
  auto load_halo = [&](int ch) {
    const int c0 = ch * CC;
    for (int e = tid; e < HP * (CC / 4); e += kThreads) {
      const int hp = e / (CC / 4), c = 4 * (e % (CC / 4));
      if (hp % HR >= HS) continue;  // a pad cell
      const int yy = hy0 + hp / HR, xx = hx0 + hp % HR;
      float* dst = &sm.xh[hp * GS + c];
      const E* src = x + ((size_t)(img * H + yy) * W + xx) * C + c0 + c;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      if constexpr (F32) {
        if (VEC && in && c0 + c < C) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (in && c0 + c + u < C) cp_async4(dst + u, src + u);
            else dst[u] = 0.f;
          }
        }
      } else {
        *reinterpret_cast<float4*>(dst) = (in && c0 + c < C) ? load4<VEC>(src, C - c0 - c)
                                                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  load_halo(ch_begin);

  // ---- the in-halo contributions sorted by halo cell, once ----
  for (int e = tid; e < HP + 1; e += kThreads) {
    sm.start[e] = 0;
    if (e < HP) sm.fill[e] = 0;
  }
  __syncthreads();
  for (int e = tid; e < ITEMS; e += kThreads) {
    const int pix = pixel(e / 9), tap = e % 9;
    if (pix < 0) continue;
    const E* o = om + (size_t)pix * 27;
    float* mine = &sm.om[3 * e];
    mine[0] = to_float(__ldg(o + 2 * tap));
    mine[1] = to_float(__ldg(o + 2 * tap + 1));
    mine[2] = to_float(__ldg(o + 18 + tap));
    const Tap t = tap_coords(mine, img, pix, tap, H, W, hy0, hx0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.wv[k] != 0.f && t.loc[k] >= 0) atomicAdd(&sm.start[t.loc[k] + 1], 1);
  }
  __syncthreads();
  if (tid < 32) {  // inclusive scan of start[1 .. HP] by one warp
    constexpr int PER = (HP + 31) / 32;
    int part[PER], sum = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int h = 1 + tid * PER + i;
      sum += h <= HP ? sm.start[h] : 0;
      part[i] = sum;
    }
    int run = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, run, off);
      if (tid >= off) run += up;
    }
    const int before = run - sum;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int h = 1 + tid * PER + i;
      if (h <= HP) sm.start[h] = before + part[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < ITEMS; e += kThreads) {
    const int pix = pixel(e / 9);
    if (pix < 0) continue;
    const Tap t = tap_coords(&sm.om[3 * e], img, pix, e % 9, H, W, hy0, hx0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.wv[k] != 0.f && t.loc[k] >= 0) {
        const int at = sm.start[t.loc[k]] + atomicAdd(&sm.fill[t.loc[k]], 1);
        sm.item[at] = (uint16_t)e;
        sm.coef[at] = t.mk * t.wv[k];
      }
  }

  // ---- operand staging: step s is (chunk ch_begin + s / KS, outputs (s % KS) * BK ..) ----
  // A (dY rows, one pixel each) through registers (float32: split as it is
  // stored); B copied asynchronously from the pre-split, pre-tiled weight
  const int q = tid & 7, rr = tid >> 3;
  float4 gaf[NA];  // float32: chunk q of rows rr, rr + 32
  uint4 gab[NA];   // bf16: the same chunks
  auto load_step = [&](int s) {
    if (tid >= kGemmThreads) return;
    const int o0 = (s % KS) * BK;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int pix = pixel(rr + 32 * i), o = o0 + EPC * q;
      const bool in = pix >= 0 && o < O;
      if constexpr (F32)
        gaf[i] = in ? load4<VEC>(dy + (size_t)pix * O + o, O - o) : make_float4(0.f, 0.f, 0.f, 0.f);
      else
        gab[i] = in ? load8<VEC>(dy + (size_t)pix * O + o, O - o) : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_step = [&](int st) {
    if (tid >= kGemmThreads) return;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int r = rr + 32 * i;
      const int off = ((r >> 3) * SBO + q * LBO + (r & 7) * 16) >> 2;
      if constexpr (F32) store_split(sm.ring[st].a[0], sm.ring[st].a[1], off, gaf[i]);
      else *reinterpret_cast<uint4*>(&sm.ring[st].a[0][off]) = gab[i];
    }
  };
  auto copy_b = [&](int s, int st) {
    constexpr int planes = F32 ? 2 : 1;
    const uint32_t* src = wsplit + (size_t)((ch_begin + s / KS) * KS + s % KS) * b_tile_words<E>();
    for (int e = tid; e < planes * B_PIECES; e += kThreads) {
      const int pl = e / B_PIECES, i = e % B_PIECES;
      const int off = (i >> 6) * (SBO / 4) + ((i >> 3) & 7) * (LBO / 4) + (i & 7) * 4;
      cp_async16(&sm.ring[st].b[pl][off], src + (size_t)pl * B_TILE + 4 * i);
    }
  };

  // ---- per chunk: the item sums (thread-owned (pixel, tap) items) ----
  float sums[IPT][3];  // d/dy, d/dx, d/dmask over the channels so far
#pragma unroll
  for (int it = 0; it < IPT; ++it) sums[it][0] = sums[it][1] = sums[it][2] = 0.f;
  auto item_sums = [&](int ch, const float* g) {
    const int c0 = ch * CC;
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int e = tid + kThreads * it;
      if (e >= ITEMS) break;
      const int pix = pixel(e / 9);
      if (pix < 0) continue;
      const Tap t = tap_coords(&sm.om[3 * e], img, pix, e % 9, H, W, hy0, hx0);
      const float* gi = g + e * GS;
      float dm = 0.f, gy = 0.f, gx = 0.f;
#pragma unroll
      for (int c = 0; c < CC; c += 4) {
        if (c0 + c >= C) break;
        const float4 g4 = *reinterpret_cast<const float4*>(gi + c);
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t.ok[k])
            v[k] = t.loc[k] >= 0 ? *reinterpret_cast<const float4*>(&sm.xh[t.loc[k] * GS + c])
                                 : load4<VEC>(x + (size_t)(-1 - t.loc[k]) * C + c0 + c, C - c0 - c);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // the bilinear sample and its y and x derivatives; a corner outside
          // the map reads 0, which folds its validity in
          const float gu = comp(g4, u);
          const float v00 = comp(v[0], u), v01 = comp(v[1], u), v10 = comp(v[2], u), v11 = comp(v[3], u);
          const float a = v01 - v00, b = v11 - v10;
          const float top = fmaf(t.fx, a, v00), vy = fmaf(t.fx, b, v10) - top;
          const float samp = fmaf(t.fy, vy, top), vx = fmaf(t.fy, b - a, a);
          const float ds = gu * t.mk;
          dm = fmaf(samp, gu, dm);
          gy = fmaf(ds, vy, gy);
          gx = fmaf(ds, vx, gx);
          // a corner outside the halo adds into dx directly
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (t.wv[k] != 0.f && t.loc[k] < 0 && c0 + c + u < C)
              atomicAdd(dx + (size_t)(-1 - t.loc[k]) * C + c0 + c + u, ds * t.wv[k]);
        }
      }
      sums[it][0] += gy;
      sums[it][1] += gx;
      sums[it][2] += dm;
    }
  };
  // ---- per chunk: dx on the halo tile, gathered cell by cell from the list ----
  auto gather = [&](int ch, const float* g) {
    const int c0 = ch * CC;
    for (int e = tid; e < HP * (CC / 4); e += kThreads) {
      const int hp = e / (CC / 4), c = 4 * (e % (CC / 4));
      const int beg = sm.start[hp], end = sm.start[hp + 1];
      if (beg == end || c0 + c >= C) continue;
      float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = beg; i < end; ++i) {
        const float w = sm.coef[i];
        const float4 g4 = *reinterpret_cast<const float4*>(g + sm.item[i] * GS + c);
        acc4.x = fmaf(w, g4.x, acc4.x);
        acc4.y = fmaf(w, g4.y, acc4.y);
        acc4.z = fmaf(w, g4.z, acc4.z);
        acc4.w = fmaf(w, g4.w, acc4.w);
      }
      float* d = dx + ((size_t)(img * H + hy0 + hp / HR) * W + hx0 + hp % HR) * C + c0 + c;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + c + u < C && comp(acc4, u) != 0.f) atomicAdd(d + u, comp(acc4, u));
    }
  };

  // the warpgroup index as a value the compiler knows is uniform over each
  // warp, so the products are not serialised as if on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const bool mma = wg < kGemmThreads / 128;  // warpgroups 0 and 1
  const int b_row = (WN * wg / 8) * SBO / 4;  // this warpgroup's 72 B rows
  const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  float acc[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) acc[i] = 0.f;

  // B of step s + 2 is copied while step s runs (3 stages); A goes through
  // registers one step ahead of its store
  load_step(0);
  store_step(0);
  copy_b(0, 0);
  cp_async_commit();  // with the first chunk's x tile
  if (1 < steps) {
    load_step(1);
    copy_b(1, 1);
  }
  cp_async_commit();
  cp_async_wait_group1();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int st = s % 3;
    if (s + 2 < steps) copy_b(s + 2, (s + 2) % 3);  // its last reader, step s-1, has finished
    cp_async_commit();
    if (mma) {
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // a k8 tf32 or k16 bf16 product covers 2 chunks along K
        const int k_off = kk * 2 * LBO / 4;
        const Stage& sg = sm.ring[st];
        if constexpr (F32) {
          const uint64_t ah = desc(&sg.a[0][k_off]), al = desc(&sg.a[1][k_off]);
          const uint64_t bh = desc(&sg.b[0][b_row + k_off]), bl = desc(&sg.b[1][b_row + k_off]);
          wgmma_tf32_n72(acc, al, bh);
          wgmma_tf32_n72(acc, ah, bl);
          wgmma_tf32_n72(acc, ah, bh);
        } else {
          wgmma_bf16_n72(acc, desc(&sg.a[0][k_off]), desc(&sg.b[0][b_row + k_off]));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (s + 1 < steps) {
      store_step((s + 1) % 3);
      if (s + 2 < steps) load_step(s + 2);
    }
    cp_async_wait_group1();  // all but the copy just issued: B of step s + 1
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (mma) asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
    if ((s + 1) % KS != 0) continue;
    // ---- the chunk is done: dcols into the stage step s used, scatter ----
    // accumulator of wgmma m64nNk8 / k16: warp w of the warpgroup holds rows
    // 16w..; lane (g, t) holds d[4j + 2h + c] at (16w + g + 8h, 8j + 2t + c)
    const int ch = ch_begin + s / KS;
    float* g = reinterpret_cast<float*>(&sm.ring[st]);
    if (mma) {
#pragma unroll
      for (int j = 0; j < WN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = 16 * warp + gq + 8 * h, col = WN * wg + 8 * j + 2 * tq + c;
            const int i = 4 * j + 2 * h + c;
            g[(row * 9 + col / CC) * GS + col % CC] = acc[i];
            acc[i] = 0.f;
          }
    }
    __syncthreads();  // (the chunk's x tile: an older group than the last wait's)
    item_sums(ch, g);
    gather(ch, g);
    if (ch + 1 < ch_end) {
      __syncthreads();  // the x tile and this stage are no longer read
      load_halo(ch + 1);
      cp_async_commit();  // waited for by the next step's wait, before the next scatter
    }
  }

  // ---- dom: the item sums added over the cluster in rank order ----
  __syncthreads();  // the last chunk's dcols are no longer read
  float* sums_sm = reinterpret_cast<float*>(&sm.ring[0]);
#pragma unroll
  for (int it = 0; it < IPT; ++it) {
    const int e = tid + kThreads * it;
    if (e < ITEMS) {
      sums_sm[3 * e] = sums[it][0];
      sums_sm[3 * e + 1] = sums[it][1];
      sums_sm[3 * e + 2] = sums[it][2];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank + splits * tid; e < ITEMS; e += splits * kThreads) {
    const int tap = e % 9, pix = pixel(e / 9);
    if (pix < 0) continue;
    float gy = 0.f, gx = 0.f, dm = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* part = cluster.map_shared_rank(sums_sm, r);
      gy += part[3 * e];
      gx += part[3 * e + 1];
      dm += part[3 * e + 2];
    }
    const float mk = 1.f / (1.f + expf(-sm.om[3 * e + 2]));
    E* d = dom + (size_t)pix * 27;
    store1(d + 2 * tap, gy);
    store1(d + 2 * tap + 1, gx);
    store1(d + 18 + tap, dm * mk * (1.f - mk));
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// one kernel name per precision, as profilers list them: the bf16
// yardstick's three launches share the prefix deform_conv_dgrad_halo_bf16_
__global__ void __launch_bounds__(256)
    deform_conv_dgrad_split_kernel(const float* __restrict__ wt, uint32_t* __restrict__ wsplit,
                                   int C, int O, int KS, long long total) {
  split_body<float>(wt, wsplit, C, O, KS, total);
}

__global__ void __launch_bounds__(256)
    deform_conv_dgrad_halo_bf16_split_kernel(const uint16_t* __restrict__ wt,
                                        uint32_t* __restrict__ wsplit, int C, int O, int KS,
                                        long long total) {
  split_body<uint16_t>(wt, wsplit, C, O, KS, total);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    deform_conv_dgrad_kernel(const float* __restrict__ x, const float* __restrict__ om,
                             const uint32_t* __restrict__ wsplit, const float* __restrict__ dy,
                             float* __restrict__ dx, float* __restrict__ dom, int H, int W, int C,
                             int O, int tiles_x, int tiles_per_img) {
  dgrad_body<float, VEC>(x, om, wsplit, dy, dx, dom, H, W, C, O, tiles_x, tiles_per_img);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
    deform_conv_dgrad_halo_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ om,
                                  const uint32_t* __restrict__ wsplit,
                                  const uint16_t* __restrict__ dy, float* __restrict__ dx,
                                  uint16_t* __restrict__ dom, int H, int W, int C, int O,
                                  int tiles_x, int tiles_per_img) {
  dgrad_body<uint16_t, VEC>(x, om, wsplit, dy, dx, dom, H, W, C, O, tiles_x, tiles_per_img);
}

// bf16 dx: the float32 sums rounded once
__global__ void __launch_bounds__(256)
    deform_conv_dgrad_halo_bf16_round_kernel(const float* __restrict__ src, uint16_t* __restrict__ dst,
                                        long long n) {
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
    dst[i] = to_bf16(src[i]);
}

template <typename E, bool VEC>
int launch(const E* x, const E* om, const E* wt, uint32_t* wsplit, const E* dy, float* dx,
           E* dom, int B, int H, int W, int C, int O, cudaStream_t stream) {
  const int KS = (O + bk<E>() - 1) / bk<E>();
  const long long split_total = (long long)((C + CC - 1) / CC) * KS * B_PIECES * 4;
  const long long split_blocks = (split_total + 255) / 256;
  const unsigned split_grid = (unsigned)(split_blocks < 4096 ? split_blocks : 4096);
  if constexpr (sizeof(E) == 4)
    deform_conv_dgrad_split_kernel<<<split_grid, 256, 0, stream>>>(wt, wsplit, C, O, KS, split_total);
  else
    deform_conv_dgrad_halo_bf16_split_kernel<<<split_grid, 256, 0, stream>>>(wt, wsplit, C, O, KS,
                                                                        split_total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  void (*kern)(const E*, const E*, const uint32_t*, const E*, float*, E*, int, int, int, int, int, int);
  if constexpr (sizeof(E) == 4)
    kern = deform_conv_dgrad_kernel<VEC>;
  else
    kern = deform_conv_dgrad_halo_bf16_kernel<VEC>;
  const int smem = (int)sizeof(Smem);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int tiles_x = (W + T - 1) / T, tiles_per_img = tiles_x * ((H + T - 1) / T);
  const long long blocks = (long long)B * tiles_per_img;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  // split the channel chunks over a cluster of up to 8 blocks until every SM
  // (one block each: the shared memory) is busy
  const int CB = (C + CC - 1) / CC;
  long long splits = sms / blocks;
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  splits = splits > CB ? CB : splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, (unsigned)splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, x, om, (const uint32_t*)wsplit, dy, dx, dom, H, W, C, O, tiles_x,
                         tiles_per_img);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// float32 x (B,H,W,C), om (B,H,W,27), weight (O, 9C), dy (B,H,W,O) -> dx
// (B,H,W,C), which must hold zeros (the kernel adds into it), and dom
// (B,H,W,27), every element written; wsplit is 16-byte aligned scratch of
// ceil(C / CC) * ceil(O / 32) * 2 * B_TILE floats (CC 16, B_TILE 4608;
// models/deform_conv.py: dgrad_scratch_floats)
extern "C" int deform_conv_dgrad(const void* x, const void* om, const void* weight, void* wsplit,
                                 const void* dy, void* dx, void* dom, int B, int H, int W, int C,
                                 int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  // int pixel indices; size_t element offsets
  if (M >= (1ll << 31) || (long long)O * 9 * C >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(wsplit) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const float* xt = static_cast<const float*>(x);
  const float* omt = static_cast<const float*>(om);
  const float* wt = static_cast<const float*>(weight);
  uint32_t* ws = static_cast<uint32_t*>(wsplit);
  const float* dyt = static_cast<const float*>(dy);
  float* dxt = static_cast<float*>(dx);
  float* domt = static_cast<float*>(dom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need whole groups of 4 channels and outputs, and aligned rows
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  if (C % 4 == 0 && O % 4 == 0 && aligned)
    return launch<float, true>(xt, omt, wt, ws, dyt, dxt, domt, B, H, W, C, O, s);
  return launch<float, false>(xt, omt, wt, ws, dyt, dxt, domt, B, H, W, C, O, s);
}

// The bf16 yardstick: bf16 x, om, weight, dy -> bf16 dx and dom; dx32 is
// float32 scratch (B,H,W,C) holding zeros (the scatter adds into it before
// dx is rounded from it); wsplit is 16-byte aligned scratch of ceil(C / CC) * ceil(O / 64)
// * B_TILE 32-bit words (models/deform_conv.py: dgrad_scratch_floats)
extern "C" int deform_conv_dgrad_halo_bf16(const void* x, const void* om, const void* weight, void* wsplit,
                                           const void* dy, void* dx32, void* dx, void* dom, int B, int H,
                                           int W, int C, int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  if (M >= (1ll << 31) || (long long)O * 9 * C >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(wsplit) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  using bf = uint16_t;
  const bf* xt = static_cast<const bf*>(x);
  const bf* omt = static_cast<const bf*>(om);
  const bf* wt = static_cast<const bf*>(weight);
  uint32_t* ws = static_cast<uint32_t*>(wsplit);
  const bf* dyt = static_cast<const bf*>(dy);
  float* acc = static_cast<float*>(dx32);
  bf* domt = static_cast<bf*>(dom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 8-byte loads of 4 channels and 16-byte loads of 8 outputs need whole
  // groups and aligned rows
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 7) == 0 && (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  const int err = (C % 4 == 0 && O % 8 == 0 && aligned)
                      ? launch<bf, true>(xt, omt, wt, ws, dyt, acc, domt, B, H, W, C, O, s)
                      : launch<bf, false>(xt, omt, wt, ws, dyt, acc, domt, B, H, W, C, O, s);
  if (err != 0) return err;
  const long long n = M * C;
  const long long blocks = (n + 255) / 256;
  deform_conv_dgrad_halo_bf16_round_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, s>>>(
      acc, static_cast<bf*>(dx), n);
  return (int)cudaGetLastError();
}
