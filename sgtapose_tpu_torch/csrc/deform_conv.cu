// Fused modulated deformable convolution (DCNv2 forward), NHWC: sampling,
// the (9C -> O) contraction and the bias in one kernel; one design in two
// instantiations: float32 (deform_conv_fwd, wgmma in 3xTF32) and bf16 serving
// (deform_conv_bf16_fwd, wgmma bf16 with float32 accumulators).
//
// Replaces sgtapose_tpu/models/deform_conv.py:329-357 (DeformConv2d.__call__:
// sigmoid of the mask logits, deform_sample_batch, then the 1x1 `kernel`
// conv; XLA gathers and an MXU product on the TPU, no Pallas). For output
// pixel p and row-major 3x3 tap k (ky = k/3 - 1, kx = k%3 - 1), with
// om = conv_offset_mask(x) holding (dy, dx) of tap k in channels (2k, 2k+1)
// and its mask logit in channel 18+k:
//   A[p, k*C + c] = sigmoid(om[p, 18+k]) * bilinear(x[.., c], p + (ky, kx) + (dy, dx))
//   out[p, o]     = bias[o] + sum_{k, c} A[p, k*C + c] * weight[o, k*C + c]
// with zero padding: a bilinear corner outside the map gets weight 0 (its
// value is read at the clamped index, as the reference does).
//
// bf16 serving: the JAX module's offset/mask conv outputs bf16, the sampling
// coordinates are float32 from the bf16 offsets, the bilinear weights (times
// validity) are cast to bf16, the corner products, their sum and the mask
// product are bf16, and the 1x1 contraction is bf16 in and out (:38-100).
// Here each A element is formed in float32 (coordinates, sigmoid, the four
// weighted corners) and rounded to bf16 once, where JAX rounds after every
// product and sum; the product accumulates in float32 and is rounded once
// after the bias, where JAX adds a bf16 bias to a bf16 product.
//
// What bounds it on an H100: operations. The 16 decoder nodes of a frame do
// 12.5 GFLOP on ~60 MB of float32 inputs and outputs (~30 MB in bf16); the
// sampled A (B,H,W,9C), 9x the input and ~303 MB per frame in float32, never
// reaches device memory here.
//   * float32: a card-vs-CPU bar of 1e-4, so plain TF32 (10-bit mantissa) is
//     out; 3xTF32 keeps float32 accuracy on the tensor cores: each operand is
//     split into hi = tf32(x) and lo = tf32(x - hi), and hi*hi + hi*lo + lo*hi
//     (the dropped lo*lo is ~2^-22 relative) go through wgmma m64n32k8, at up
//     to 495/3 = 165 TFLOP/s against 67 for float32 FMAs;
//   * bf16: no split, one wgmma m64n32k16 where float32 issues three k8
//     products, on half the bytes per operand (989 TFLOP/s dense).
// Design (implicit GEMM):
//   * a block owns BM = 64 pixels x BN = 64 output channels and loops K over
//     9 taps x C in steps of BK channels, one step row being 128 bytes (32
//     float32 or 64 bf16); two warpgroups, each one 32-column half (float32:
//     the hi*hi and the correction products in separate sums);
//   * once per block, the 4 clamped corner offsets and the 4 bilinear weights
//     of each (pixel, tap), folded with validity and sigmoid(mask logit), go
//     to shared memory (the sigmoid runs here: no slice copies, no launch);
//   * each step, 8 threads read one pixel's 4 corners and one weight row as
//     coalesced 128-byte rows (16-byte chunks), two steps ahead of their use;
//     the sampled A and the weight tile are stored once (float32: split into
//     hi and lo tf32 planes), into a 2-stage ring in shared memory, while the
//     tensor cores run the previous step's products asynchronously;
//   * the planes use wgmma's unswizzled K-major layout of 8-row x 16-byte
//     core matrices, with LBO = 144 B (not 128) between core matrices along
//     K: chunk q of row r starts at 16 (9q + r%8 + 72 (r/8)) bytes, and 9q mod
//     8 = q, so the 8 chunks a row's 8 threads store fall on 8 different bank
//     groups and a warp's 4 rows x 8 chunks store in the minimum of 4
//     wavefronts. The pitch follows from 8 chunks per row and 16-byte rows
//     within a core matrix, not from the element size, so both precisions
//     share it (SBO = 8 x 144 between 8-row groups; a k8 tf32 or k16 bf16
//     product advances 2 chunks);
//   * split-K on thread block clusters: where the tiles alone leave the SMs
//     idle (15x15 is 16 tiles, 30x30 15-60), up to 8 blocks of a cluster take
//     consecutive K steps of one tile, and their partial tiles are summed
//     through distributed shared memory in rank order (deterministic, no
//     atomics, no second launch, no workspace);
//   * the epilogue adds the bias and writes NHWC rows coalesced (bf16:
//     rounded once); pixel, channel and output edges are masked, so any H, W,
//     C and O run (C not a whole number of chunks, or unaligned pointers,
//     take a scalar-load variant).
// What still holds it above its bound (PERF.md): not the tensor cores, but a
// fixed cost per launch (coordinates and first loads from a cold L2, the
// cluster epilogue) and, per K step, the gather, the stores and the barrier,
// which the products overlap only in part.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64, BN = 64, kThreads = 256;  // two warpgroups
constexpr int kMaxSplits = 8;  // portable cluster size
constexpr int kBlocksPerSM = 2;  // what the shared memory and registers allow
constexpr int LDR = BN + 4;    // row of the partial tile in the split-K reduction
// unswizzled K-major layout of a 64-row x 128-byte plane: chunk (16 bytes) q
// of row r at byte (r/8)*SBO + q*LBO + (r%8)*16
constexpr int LBO = 144, SBO = 8 * LBO;
constexpr int PLANE = (BM / 8) * SBO / 4;  // u32 per plane
constexpr int NR = BM * 8 / kThreads;  // rows each thread loads per step (8 chunks a row)
static_assert(NR == 2, "each thread loads rows rr and rr + 32");
static_assert(BM == BN, "A and B planes share one layout");

// T: element type (float, or bf16 as uint16_t); float32 keeps a hi and a lo plane
template <typename T>
struct Smem {
  static constexpr int kPlanes = sizeof(T) == 4 ? 2 : 1;
  uint32_t a[2][kPlanes][PLANE];  // [stage][plane]; after the K loop, the partial tile
  uint32_t b[2][kPlanes][PLANE];
  int4 idx[BM * 9];    // corner offsets (elements into x) of (pixel, tap)
  float4 w[BM * 9];    // corner weights x validity x sigmoid(mask)
};
static_assert(BM * LDR <= 2 * PLANE, "the partial tile must fit in a[]");

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// store v's hi and lo tf32 parts at u32 offset `off` of two planes
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

// two floats -> packed bf16x2 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// wgmma matrix descriptor of an unswizzled K-major plane starting at p
__device__ __forceinline__ uint64_t desc(const uint32_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// d (64 x 32, f32) += A (64 x 8) * B (32 x 8)^T, both tf32 from shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

// d (64 x 32, f32) += A (64 x 16) * B (32 x 16)^T, both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

// One 16-byte chunk at p: channels c .. c + 16/sizeof(T) - 1 of C, zero past C
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* p, int c, int C) {
  if constexpr (VEC) {
    return c < C ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint4(c < C ? __float_as_uint(__ldg(p)) : 0u, c + 1 < C ? __float_as_uint(__ldg(p + 1)) : 0u,
                      c + 2 < C ? __float_as_uint(__ldg(p + 2)) : 0u,
                      c + 3 < C ? __float_as_uint(__ldg(p + 3)) : 0u);
  } else {
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = c + i < C ? (uint32_t)__ldg(p + i) : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                      h[6] | (h[7] << 16));
  }
}

// w.x c0 + w.y c1 + w.z c2 + w.w c3 in float32
__device__ __forceinline__ float blend1(const float4 w, float c0, float c1, float c2, float c3) {
  return fmaf(w.w, c3, fmaf(w.z, c2, fmaf(w.y, c1, w.x * c0)));
}

// the same for the two bf16 of each word, rounded once to a packed bf16x2
__device__ __forceinline__ uint32_t blend2(const float4 w, uint32_t c0, uint32_t c1, uint32_t c2,
                                           uint32_t c3) {
  return pack_bf16(blend1(w, bf_lo(c0), bf_lo(c1), bf_lo(c2), bf_lo(c3)),
                   blend1(w, bf_hi(c0), bf_hi(c1), bf_hi(c2), bf_hi(c3)));
}

template <typename T, bool VEC>
__device__ __forceinline__ void deform_conv_body(const T* __restrict__ x, const T* __restrict__ om,
                                                 const T* __restrict__ wt, const T* __restrict__ bias,
                                                 T* __restrict__ out, int M, int H, int W, int C,
                                                 int O) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int BK = 8 * EPC;          // channels per K step: 8 chunks
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN;
  // split-K: the blocks of one cluster (along z) take consecutive K steps
  const int rank = blockIdx.z, splits = gridDim.z;
  const int CB = (C + BK - 1) / BK;
  const int steps = 9 * CB;
  const int s_begin = (int)((long long)steps * rank / splits);
  const int s_end = (int)((long long)steps * (rank + 1) / splits);
  const int tap_lo = s_begin / CB, tap_hi = (s_end - 1) / CB;

  // ---- coordinates of every (pixel, tap) this block uses, once ----
  for (int e = tid; e < BM * 9; e += kThreads) {
    const int pix = m0 + e / 9, tap = e % 9;
    int4 id = make_int4(0, 0, 0, 0);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pix < M && tap >= tap_lo && tap <= tap_hi) {
      const int px = pix % W, row = pix / W, py = row % H, b = row / H;
      const T* o = om + (size_t)pix * 27;
      const float dy = to_float(__ldg(o + 2 * tap)), dx = to_float(__ldg(o + 2 * tap + 1));
      const float mk = 1.f / (1.f + expf(-to_float(__ldg(o + 18 + tap))));
      const float sy = (float)(py + tap / 3 - 1) + dy;
      const float sx = (float)(px + tap % 3 - 1) + dx;
      const float y0f = floorf(sy), x0f = floorf(sx);
      const float fy = sy - y0f, fx = sx - x0f;
      const int y0 = (int)y0f, x0 = (int)x0f, y1 = y0 + 1, x1 = x0 + 1;
      const float vy0 = (y0 >= 0 && y0 < H) ? 1.f : 0.f;
      const float vy1 = (y1 >= 0 && y1 < H) ? 1.f : 0.f;
      const float vx0 = (x0 >= 0 && x0 < W) ? 1.f : 0.f;
      const float vx1 = (x1 >= 0 && x1 < W) ? 1.f : 0.f;
      w.x = (1.f - fy) * (1.f - fx) * (vy0 * vx0) * mk;
      w.y = (1.f - fy) * fx * (vy0 * vx1) * mk;
      w.z = fy * (1.f - fx) * (vy1 * vx0) * mk;
      w.w = fy * fx * (vy1 * vx1) * mk;
      const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
      const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);
      const int base = b * H;
      id.x = ((base + yc0) * W + xc0) * C;
      id.y = ((base + yc0) * W + xc1) * C;
      id.z = ((base + yc1) * W + xc0) * C;
      id.w = ((base + yc1) * W + xc1) * C;
    }
    sm.idx[e] = id;
    sm.w[e] = w;
  }

  // thread -> chunk q (channels EPC q .. EPC q + EPC - 1 of the step) of rows
  // rr, rr + 32: 8 consecutive threads read one row's 128 bytes
  const int q = tid & 7, rr = tid >> 3;
  uint4 ga[NR][4];  // the 4 corners of each row's chunk
  uint4 gb[NR];     // the weight row's chunk
  auto load_step = [&](int s) {
    const int tap = s / CB, c = (s % CB) * BK + EPC * q;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rr + 32 * i;
      const int4 id = sm.idx[r * 9 + tap];
      ga[i][0] = load_chunk<T, VEC>(x + id.x + c, c, C);
      ga[i][1] = load_chunk<T, VEC>(x + id.y + c, c, C);
      ga[i][2] = load_chunk<T, VEC>(x + id.z + c, c, C);
      ga[i][3] = load_chunk<T, VEC>(x + id.w + c, c, C);
      const int o = o0 + r;
      gb[i] = o < O ? load_chunk<T, VEC>(wt + (size_t)o * 9 * C + (size_t)tap * C + c, c, C)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_step = [&](int s, int st) {
    const int tap = s / CB;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = rr + 32 * i;
      const float4 w = sm.w[r * 9 + tap];
      const int off = ((r >> 3) * SBO + q * LBO + (r & 7) * 16) >> 2;
      const uint4* g = ga[i];
      if constexpr (F32) {
        float4 v;
        v.x = blend1(w, __uint_as_float(g[0].x), __uint_as_float(g[1].x), __uint_as_float(g[2].x),
                     __uint_as_float(g[3].x));
        v.y = blend1(w, __uint_as_float(g[0].y), __uint_as_float(g[1].y), __uint_as_float(g[2].y),
                     __uint_as_float(g[3].y));
        v.z = blend1(w, __uint_as_float(g[0].z), __uint_as_float(g[1].z), __uint_as_float(g[2].z),
                     __uint_as_float(g[3].z));
        v.w = blend1(w, __uint_as_float(g[0].w), __uint_as_float(g[1].w), __uint_as_float(g[2].w),
                     __uint_as_float(g[3].w));
        store_split(sm.a[st][0], sm.a[st][1], off, v);
        const float4 b = make_float4(__uint_as_float(gb[i].x), __uint_as_float(gb[i].y),
                                     __uint_as_float(gb[i].z), __uint_as_float(gb[i].w));
        store_split(sm.b[st][0], sm.b[st][1], off, b);
      } else {
        uint4 v;
        v.x = blend2(w, g[0].x, g[1].x, g[2].x, g[3].x);
        v.y = blend2(w, g[0].y, g[1].y, g[2].y, g[3].y);
        v.z = blend2(w, g[0].z, g[1].z, g[2].z, g[3].z);
        v.w = blend2(w, g[0].w, g[1].w, g[2].w, g[3].w);
        *reinterpret_cast<uint4*>(&sm.a[st][0][off]) = v;
        *reinterpret_cast<uint4*>(&sm.b[st][0][off]) = gb[i];
      }
    }
  };

  const int wg = tid >> 7;  // this warpgroup's output columns: 32 wg .. 32 wg + 31
  const int b_col = (32 * wg / 8) * SBO / 4;
  float acc[16], cor[16];  // cor: float32's hi*lo + lo*hi products
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = cor[i] = 0.f;

  __syncthreads();  // coordinates ready
  load_step(s_begin);
  store_step(s_begin, 0);
  if (s_begin + 1 < s_end) load_step(s_begin + 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  for (int s = s_begin; s < s_end; ++s) {
    const int st = (s - s_begin) & 1;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // a product covers 2 chunks (8 tf32 or 16 bf16) along K
      const int k_off = kk * 2 * LBO / 4;
      if constexpr (F32) {
        const uint64_t ah = desc(&sm.a[st][0][k_off]), al = desc(&sm.a[st][1][k_off]);
        const uint64_t bh = desc(&sm.b[st][0][b_col + k_off]), bl = desc(&sm.b[st][1][b_col + k_off]);
        wgmma_tf32(cor, al, bh);
        wgmma_tf32(cor, ah, bl);
        wgmma_tf32(acc, ah, bh);
      } else {
        wgmma_bf16(acc, desc(&sm.a[st][0][k_off]), desc(&sm.b[st][0][b_col + k_off]));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (s + 1 < s_end) {  // the other stage's last reader, step s-1, has finished
      store_step(s + 1, st ^ 1);                // from the loads issued one step ago
      if (s + 2 < s_end) load_step(s + 2);      // in flight during the next step
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
  }

  // ---- epilogue: partial tiles summed over the cluster in rank order
  // (deterministic), bias added, NHWC rows stored coalesced ----
  // wgmma m64nNk8/k16 accumulators: warp w of the warpgroup holds rows 16w..;
  // lane (g, t) holds d[4j + 2h + c] at (16w + g + 8h, 8j + 2t + c)
  float* red = reinterpret_cast<float*>(&sm.a[0][0][0]);
  const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = 16 * warp + gq + 8 * h, col = 32 * wg + 8 * j + 2 * tq + c;
        const int i = 4 * j + 2 * h + c;
        if constexpr (F32) red[row * LDR + col] = acc[i] + cor[i];
        else red[row * LDR + col] = acc[i];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // all partial tiles of the cluster are written
  // this rank finishes rows rank, rank + splits, ...
  const int my_rows = (BM - rank + splits - 1) / splits;
  for (int e = tid; e < my_rows * BN; e += kThreads) {
    const int row = rank + splits * (e / BN), col = e % BN;
    const int pix = m0 + row, o = o0 + col;
    float sum = 0.f;
    for (int r = 0; r < splits; ++r) sum += cluster.map_shared_rank(red, r)[row * LDR + col];
    if (pix < M && o < O) {
      if constexpr (F32) out[(size_t)pix * O + o] = sum + __ldg(bias + o);
      else out[(size_t)pix * O + o] = to_bf16(sum + bf16f(__ldg(bias + o)));  // rounded once
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// one kernel name per precision, as profilers list them
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    deform_conv_kernel(const float* __restrict__ x, const float* __restrict__ om,
                       const float* __restrict__ wt, const float* __restrict__ bias,
                       float* __restrict__ out, int M, int H, int W, int C, int O) {
  deform_conv_body<float, VEC>(x, om, wt, bias, out, M, H, W, C, O);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    deform_conv_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ om,
                            const uint16_t* __restrict__ wt, const uint16_t* __restrict__ bias,
                            uint16_t* __restrict__ out, int M, int H, int W, int C, int O) {
  deform_conv_body<uint16_t, VEC>(x, om, wt, bias, out, M, H, W, C, O);
}

template <typename T, bool VEC>
int launch(const T* x, const T* om, const T* wt, const T* bias, T* out, int M, int H, int W, int C,
           int O, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<T>);
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return deform_conv_kernel<VEC>;
    else return deform_conv_bf16_kernel<VEC>;
  }();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  // split K over a cluster of up to 8 blocks until every block slot is busy
  const int BK = 8 * (16 / (int)sizeof(T));
  const int mt = (M + BM - 1) / BM, nt = (O + BN - 1) / BN, steps = 9 * ((C + BK - 1) / BK);
  int splits = (kBlocksPerSM * sms) / (mt * nt);
  splits = splits < 1 ? 1 : (splits > kMaxSplits ? kMaxSplits : splits);
  splits = splits > steps ? steps : splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mt, nt, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, x, om, wt, bias, out, M, H, W, C, O);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* x, const void* om, const void* weight, const void* bias, void* out, int B, int H,
        int W, int C, int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  // int offsets into x, om and out; the grid's y extent
  if (M * (C > 27 ? C : 27) >= (1ll << 31) || M * O >= (1ll << 31) || (O + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* omt = static_cast<const T*>(om);
  const T* wt = static_cast<const T*>(weight);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte chunk loads need whole chunks per channel row and aligned rows
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(weight)) & 15) == 0;
  if (C % (16 / (int)sizeof(T)) == 0 && aligned)
    return launch<T, true>(xt, omt, wt, bt, ot, (int)M, H, W, C, O, s);
  return launch<T, false>(xt, omt, wt, bt, ot, (int)M, H, W, C, O, s);
}

}  // namespace

// float32 x, om, weight, bias, out
extern "C" int deform_conv_fwd(const void* x, const void* om, const void* weight, const void* bias,
                               void* out, int B, int H, int W, int C, int O, void* stream) {
  return fwd<float>(x, om, weight, bias, out, B, H, W, C, O, stream);
}

// the same, all bf16
extern "C" int deform_conv_bf16_fwd(const void* x, const void* om, const void* weight,
                                    const void* bias, void* out, int B, int H, int W, int C, int O,
                                    void* stream) {
  return fwd<uint16_t>(x, om, weight, bias, out, B, H, W, C, O, stream);
}
