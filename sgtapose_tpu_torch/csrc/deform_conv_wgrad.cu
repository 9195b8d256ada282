// DCN weight gradient (DCNv2 backward, the 1x1 contraction's kernel
// gradient), NHWC, as one implicit GEMM with the sampler fused in; one design
// in two instantiations: float32 (deform_conv_wgrad, wgmma in 3xTF32) and
// bf16 training (deform_conv_wgrad_bf16, wgmma bf16 with float32
// accumulators, dW rounded once).
//
// Replaces the kernel gradient XLA derives for the 1x1 `Conv` named `kernel`
// over the columns of deform_sample_batch,
// sgtapose_tpu/models/deform_conv.py:349-356 (columns from :103-123,
// _sample_pieces; XLA gathers and an MXU product on the TPU, no Pallas):
//   dW[o, k*C + c] = sum over (b, pixel) of dY[b, p, o] * A[b, p, k*C + c]
//   A[p, k*C + c]  = mask[p, k] * bilinear(x[.., c], p + (ky, kx) + offset[p, k])
// with A formed exactly as csrc/deform_sample.cu forms each column element
// (the same corner weights and summation order, the offsets and sigmoided
// masks float32; bf16: formed in float32 and rounded once), so dW equals the
// route it replaces (the sampler, then dY^T A) up to the order of summation.
//
// The GEMM: M = O output channels, N = 9C (tap-major), K = B*H*W pixels.
// What bounds it on an H100: operations, 2 K O 9C (99.8 GFLOP a training
// step at batch 8 over the 16 decoder nodes; 0.605 ms at 165 TFLOP/s 3xTF32,
// 0.101 ms at 989 TFLOP/s bf16), against ~0.6 GB of float32 inputs. The
// columns, 606 M elements a step (2.4 GB in float32), never reach device
// memory here.
// Design:
//   * a block owns a 64-output x 64-channel tile of one tap and a fixed,
//     contiguous range of the pixels (split K), and loops over it in steps
//     of 32 pixels (float32) or 64 (bf16): one 128-byte chunk row of K;
//   * per step, each thread gathers, for 2 pixels, the 4 corners of a group
//     of 4 (float32) or 8 (bf16) consecutive channels and the dY values of
//     as many outputs, one 16-byte load each (8 + 2 loads a step), into
//     registers one step ahead of their use; the corner offsets and weights
//     of each pixel come from a 4-slot ring in shared memory that the first
//     warp(s) fill three steps ahead;
//   * both operands are transposed into wgmma's K-major layout as they are
//     stored (TF32 wgmma takes K-major operands only): a thread writes its 2
//     pixels of each of its rows (8 bytes float32, split into hi and lo tf32
//     planes; 4 bytes bf16); chunk q (16 bytes) of row r lies at (r/8) SBO +
//     q LBO + (r%8) 16 bytes with LBO = 144 and SBO = 8 LBO + 16, so a
//     quarter-warp's pieces fall on distinct banks;
//   * two warpgroups, each the whole 64 x 64 tile over half of each step's
//     K: wgmma m64n64k8 (3xTF32: hi*hi, hi*lo and lo*hi into one sum) or
//     m64n64k16 (bf16), from a 2-stage ring, while the next step is
//     gathered; their sums are added at the end in a fixed order;
//   * each block writes its float32 partial tile to a workspace slice of its
//     split; a second small launch adds the splits' partials in split order
//     (no atomics: dW is the same bit for bit in two runs) and writes dW
//     (bf16: rounded once). The caller picks the split count so that the
//     tiles times the splits fill the SMs at two blocks each in near-whole
//     waves (the 120x120 nodes have only 9 tiles at O = 64 and 9C = 576);
//   * C or O not a whole number of 16-byte chunks, or unaligned bases, take
//     a scalar-load variant.
// What holds it above its bound (PERF.md): a K step costs an SM ~1 us
// whatever the offsets and the dtype (bf16's steps hold twice the pixels),
// several times its products and its bytes. Variants tried on the card and
// dropped, each slower: 4-byte loads (one channel a lane); warpgroups
// splitting N as m64n32 products (their operand reads from shared memory
// are a third more); the raw operands copied by cp.async three steps ahead
// into a shared-memory ring at one block an SM (its traffic through shared
// memory); 512-thread blocks whose four warpgroups all gather two steps
// ahead. Suspects: the shared-memory round trip of every operand and the
// barrier each step; larger steps (more outputs or taps a block, so that
// the 9 taps' corners come from L1) are the next design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BO = 64, BC = 64, kThreads = 256;  // two warpgroups
constexpr int kRing = 4;  // corner offset / weight slots
// K-major layout of a 64-row x 128-byte plane: chunk (16 bytes) q of row r at
// byte (r/8)*SBO + q*LBO + (r%8)*16
constexpr int LBO = 144, SBO = 8 * LBO + 16;
constexpr int PLANE = 8 * SBO / 4;  // u32 per plane

template <typename T>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int EPC = 16 / sizeof(T);  // pixels per 16-byte chunk
  static constexpr int KP = 8 * EPC;          // pixels per K step
  static constexpr int kPlanes = F32 ? 2 : 1;
};

template <typename T>
struct Smem {
  static constexpr int KP = Cfg<T>::KP;
  uint32_t a[2][Cfg<T>::kPlanes][PLANE];  // [stage][plane] dY^T: 64 outputs x KP pixels
  uint32_t b[2][Cfg<T>::kPlanes][PLANE];  // [stage][plane] A^T: 64 channels x KP pixels
  int4 idx[kRing][KP];                    // corner offsets (elements into x) of each pixel
  float4 w[kRing][KP];                    // corner weights x validity
  float mk[kRing][KP];                    // sigmoided mask
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// two floats -> packed bf16x2 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// wgmma matrix descriptor of an unswizzled K-major plane starting at p
__device__ __forceinline__ uint64_t desc(const uint32_t* p) {
  const uint32_t addr = smem_addr(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

// d (64 x 64, f32) += A (64 x 8) * B (64 x 8)^T, both tf32 from shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d (64 x 64, f32) += A (64 x 16) * B (64 x 16)^T, both bf16 K-major in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// a column element as csrc/deform_sample.cu forms it:
// (((v00 w00 + v01 w01) + v10 w10) + v11 w11) * mask
__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, const float4 w,
                                         float mk) {
  float r = v00 * w.x;
  r = r + v01 * w.y;
  r = r + v10 * w.z;
  r = r + v11 * w.w;
  return r * mk;
}

// u32 offset of chunk q of row r in a plane
__device__ __forceinline__ int plane_off(int r, int q) { return ((r >> 3) * SBO + q * LBO + (r & 7) * 16) >> 2; }

// One 16-byte chunk at p: elements i .. i + 16/sizeof(T) - 1 of n, zero past
// n; VEC: one 16-byte load (n a whole number of chunks, p 16-byte aligned)
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* p, int i, int n) {
  if constexpr (VEC) {
    return i < n ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  } else if constexpr (sizeof(T) == 4) {
    return make_uint4(i < n ? __float_as_uint(__ldg(p)) : 0u, i + 1 < n ? __float_as_uint(__ldg(p + 1)) : 0u,
                      i + 2 < n ? __float_as_uint(__ldg(p + 2)) : 0u,
                      i + 3 < n ? __float_as_uint(__ldg(p + 3)) : 0u);
  } else {
    uint32_t h[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = i + k < n ? (uint32_t)__ldg(p + k) : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
}

// element e of a chunk as a float: float32 word e, or bf16 e of 8
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& v, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  } else {
    const uint32_t u = (e >> 1) == 0 ? v.x : (e >> 1) == 1 ? v.y : (e >> 1) == 2 ? v.z : v.w;
    return (e & 1) ? bf_hi(u) : bf_lo(u);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void wgrad_body(const T* __restrict__ x, const float* __restrict__ offsets,
                                           const float* __restrict__ masks, const T* __restrict__ dy,
                                           float* __restrict__ part, int M, int H, int W, int C, int O,
                                           int steps) {
  using K = Cfg<T>;
  constexpr int KP = K::KP;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x;
  const int ctiles = (C + BC - 1) / BC;
  const int ctile = blockIdx.x % ctiles;
  const int tap = (blockIdx.x / ctiles) % 9;
  const int o0 = (blockIdx.x / ctiles / 9) * BO, c0 = ctile * BC;
  const int rank = blockIdx.y, splits = gridDim.y;
  const int s_begin = (int)((long long)steps * rank / splits);
  const int s_end = (int)((long long)steps * (rank + 1) / splits);
  // corner offsets, weights and mask of step s's pixels into slot s % kRing
  // (threads tid < KP, one pixel each)
  auto coords = [&](int s) {
    const int pix = s * KP + tid;
    int4 id = make_int4(0, 0, 0, 0);
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    float mk = 0.f;
    if (pix < M) {
      const int px = pix % W, row = pix / W, py = row % H, b = row / H;
      const float dyo = __ldg(offsets + (size_t)pix * 18 + 2 * tap);
      const float dxo = __ldg(offsets + (size_t)pix * 18 + 2 * tap + 1);
      mk = __ldg(masks + (size_t)pix * 9 + tap);
      const float sy = (float)(py + tap / 3 - 1) + dyo;
      const float sx = (float)(px + tap % 3 - 1) + dxo;
      const float y0f = floorf(sy), x0f = floorf(sx);
      const float fy = sy - y0f, fx = sx - x0f;
      const int y0 = (int)y0f, x0 = (int)x0f, y1 = y0 + 1, x1 = x0 + 1;
      const float vy0 = (y0 >= 0 && y0 < H) ? 1.f : 0.f;
      const float vy1 = (y1 >= 0 && y1 < H) ? 1.f : 0.f;
      const float vx0 = (x0 >= 0 && x0 < W) ? 1.f : 0.f;
      const float vx1 = (x1 >= 0 && x1 < W) ? 1.f : 0.f;
      w.x = (1.f - fy) * (1.f - fx) * (vy0 * vx0);
      w.y = (1.f - fy) * fx * (vy0 * vx1);
      w.z = fy * (1.f - fx) * (vy1 * vx0);
      w.w = fy * fx * (vy1 * vx1);
      const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
      const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);
      const int base = b * H;
      id.x = ((base + yc0) * W + xc0) * C;
      id.y = ((base + yc0) * W + xc1) * C;
      id.z = ((base + yc1) * W + xc0) * C;
      id.w = ((base + yc1) * W + xc1) * C;
    }
    const int slot = s & (kRing - 1);
    sm.idx[slot][tid] = id;
    sm.w[slot][tid] = w;
    sm.mk[slot][tid] = mk;
  };
  // Thread (chunk q = warp, pixel pair pq, element group g): a warp forms
  // the chunk q of the step (4 float32 or 8 bf16 pixels); its lanes split it
  // into pixel pairs pq and groups g of EPC consecutive channels (and
  // outputs), read as one 16-byte chunk per (pixel, corner): 8 loads of the
  // corners and 2 of dY per thread and step. Lane l: pq = l mod PP, g = l /
  // PP, so a quarter-warp's stores of the 4-byte (bf16) or 8-byte (float32)
  // pieces of its rows fall on distinct banks.
  constexpr int EPC = K::EPC;
  constexpr int PP = EPC / 2;  // pixel pairs a chunk: 2 (float32) or 4 (bf16)
  const int q = tid >> 5, ln = tid & 31;
  const int pq = ln % PP, g = ln / PP;
  uint4 gx[2][4];  // [pixel of the pair][corner]: EPC channels
  uint4 gd[2];     // [pixel of the pair]: EPC outputs of dY
  auto load_step = [&](int s) {
    const int slot = s & (kRing - 1), p0 = s * KP;
    const int c = c0 + EPC * g, o = o0 + EPC * g;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = EPC * q + 2 * pq + u;
      const int4 id = sm.idx[slot][j];
      gx[u][0] = load_chunk<T, VEC>(x + id.x + c, c, C);
      gx[u][1] = load_chunk<T, VEC>(x + id.y + c, c, C);
      gx[u][2] = load_chunk<T, VEC>(x + id.z + c, c, C);
      gx[u][3] = load_chunk<T, VEC>(x + id.w + c, c, C);
      gd[u] = p0 + j < M ? load_chunk<T, VEC>(dy + (size_t)(p0 + j) * O + o, o, O) : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_step = [&](int s, int st) {
    const int slot = s & (kRing - 1);
    float4 w[2];
    float mk[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = EPC * q + 2 * pq + u;
      w[u] = sm.w[slot][j];
      mk[u] = sm.mk[slot][j];
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      float a[2], d[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        a[u] = combine(chunk_elem<T>(gx[u][0], e), chunk_elem<T>(gx[u][1], e), chunk_elem<T>(gx[u][2], e),
                       chunk_elem<T>(gx[u][3], e), w[u], mk[u]);
        d[u] = chunk_elem<T>(gd[u], e);
      }
      // row EPC g + e, chunk q: this pair's piece, 8 bytes (float32) or 4 (bf16)
      const int off = plane_off(EPC * g + e, q) + (sizeof(T) == 4 ? 2 * pq : pq);
      if constexpr (K::F32) {
        uint2 h, l;
        h.x = tf32(a[0]);
        h.y = tf32(a[1]);
        l.x = tf32(a[0] - __uint_as_float(h.x));
        l.y = tf32(a[1] - __uint_as_float(h.y));
        *reinterpret_cast<uint2*>(&sm.b[st][0][off]) = h;
        *reinterpret_cast<uint2*>(&sm.b[st][1][off]) = l;
        h.x = tf32(d[0]);
        h.y = tf32(d[1]);
        l.x = tf32(d[0] - __uint_as_float(h.x));
        l.y = tf32(d[1] - __uint_as_float(h.y));
        *reinterpret_cast<uint2*>(&sm.a[st][0][off]) = h;
        *reinterpret_cast<uint2*>(&sm.a[st][1][off]) = l;
      } else {
        sm.b[st][0][off] = pack_bf16(a[0], a[1]);
        sm.a[st][0][off] = pack_bf16(d[0], d[1]);  // exact: bf16 values
      }
    }
  };

  // warpgroup wg takes half of each step's K: products kk = 2 wg, 2 wg + 1,
  // each the whole 64 x 64 tile (float32: hi*hi, hi*lo and lo*hi into one sum)
  const int wg = tid >> 7;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  if (s_begin < s_end) {
    for (int s = s_begin; s < s_begin + kRing - 1 && s < s_end; ++s)
      if (tid < KP) coords(s);
    __syncthreads();
    load_step(s_begin);
    store_step(s_begin, 0);
    if (s_begin + 1 < s_end) load_step(s_begin + 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int st = (s - s_begin) & 1;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {  // a product covers 2 chunks (8 tf32 or 16 bf16 pixels)
      const int k_off = (2 * wg + kh) * 2 * LBO / 4;
      if constexpr (K::F32) {
        const uint64_t ah = desc(&sm.a[st][0][k_off]), al = desc(&sm.a[st][1][k_off]);
        const uint64_t bh = desc(&sm.b[st][0][k_off]), bl = desc(&sm.b[st][1][k_off]);
        wgmma_tf32(acc, al, bh);
        wgmma_tf32(acc, ah, bl);
        wgmma_tf32(acc, ah, bh);
      } else {
        wgmma_bf16(acc, desc(&sm.a[st][0][k_off]), desc(&sm.b[st][0][k_off]));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // slot (s + 3) % 4 last held step s - 1, whose readers ran by step s - 2
    if (s + kRing - 1 < s_end && tid < KP) coords(s + kRing - 1);
    if (s + 1 < s_end) {  // the other stage's last reader, step s - 1, has finished
      store_step(s + 1, st ^ 1);            // from the loads issued one step ago
      if (s + 2 < s_end) load_step(s + 2);  // in flight during the next step
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
  }

  // the partial tile of this split, warpgroup 0's sum plus warpgroup 1's
  // (through shared memory, in that order). wgmma m64nNk8/k16 accumulators:
  // warp w of the warpgroup holds rows 16w..; lane (g, t) holds d[4j + 2h +
  // c] at (16w + g + 8h, 8j + 2t + c)
  constexpr int LDR = BC + 2;
  float* red = reinterpret_cast<float*>(&sm.a[0][0][0]);  // 64 x LDR floats, after the loop
  static_assert(BO * LDR <= 2 * K::kPlanes * PLANE, "the reduction tile must fit in a[]");
  const int warp = (tid >> 5) & 3, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + gq + 8 * h, col = 8 * j + 2 * tq;
        red[r * LDR + col] = acc[4 * j + 2 * h];
        red[r * LDR + col + 1] = acc[4 * j + 2 * h + 1];
      }
  }
  __syncthreads();
  if (wg != 0) return;
  const size_t n9 = (size_t)9 * C;
  float* dst = part + (size_t)rank * O * n9 + (size_t)tap * C;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + gq + 8 * h, col = 8 * j + 2 * tq;
      const int o = o0 + r, c = c0 + col;
      const float v0 = acc[4 * j + 2 * h] + red[r * LDR + col];
      const float v1 = acc[4 * j + 2 * h + 1] + red[r * LDR + col + 1];
      if (o < O) {
        if (c < C) dst[o * n9 + c] = v0;
        if (c + 1 < C) dst[o * n9 + c + 1] = v1;
      }
    }
}

// one kernel name per precision, as profilers list them
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    deform_conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                             const float* __restrict__ masks, const float* __restrict__ dy,
                             float* __restrict__ part, int M, int H, int W, int C, int O, int steps) {
  wgrad_body<float, VEC>(x, offsets, masks, dy, part, M, H, W, C, O, steps);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    deform_conv_bf16_wgrad_kernel(const uint16_t* __restrict__ x, const float* __restrict__ offsets,
                                  const float* __restrict__ masks, const uint16_t* __restrict__ dy,
                                  float* __restrict__ part, int M, int H, int W, int C, int O, int steps) {
  wgrad_body<uint16_t, VEC>(x, offsets, masks, dy, part, M, H, W, C, O, steps);
}

// dW = the splits' partials added in split order (float32), stored as T
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(uint16_t* p, float v) { *p = to_bf16(v); }

template <typename T>
__device__ __forceinline__ void sum_body(const float* __restrict__ part, T* __restrict__ dw, int n,
                                         int splits) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    float s = part[e];
    for (int r = 1; r < splits; ++r) s += part[(size_t)r * n + e];
    store_out(dw + e, s);
  }
}

__global__ void __launch_bounds__(256)
    deform_conv_wgrad_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int n, int splits) {
  sum_body<float>(part, dw, n, splits);
}

__global__ void __launch_bounds__(256)
    deform_conv_bf16_wgrad_sum_kernel(const float* __restrict__ part, uint16_t* __restrict__ dw, int n,
                                      int splits) {
  sum_body<uint16_t>(part, dw, n, splits);
}

template <typename T, bool VEC>
int launch(const T* x, const float* offsets, const float* masks, const T* dy, float* part, T* dw, int M,
           int H, int W, int C, int O, int splits, cudaStream_t stream) {
  void (*kern)(const T*, const float*, const float*, const T*, float*, int, int, int, int, int, int);
  void (*sum)(const float*, T*, int, int);
  if constexpr (sizeof(T) == 4) {
    kern = deform_conv_wgrad_kernel<VEC>;
    sum = deform_conv_wgrad_sum_kernel;
  } else {
    kern = deform_conv_bf16_wgrad_kernel<VEC>;
    sum = deform_conv_bf16_wgrad_sum_kernel;
  }
  const int smem = (int)sizeof(Smem<T>);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int steps = (M + Cfg<T>::KP - 1) / Cfg<T>::KP;
  if (splits < 1 || splits > steps || splits > 65535) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((O + BO - 1) / BO) * 9 * ((C + BC - 1) / BC);
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, splits), kThreads, smem, stream>>>(x, offsets, masks, dy, part, M, H, W, C,
                                                                  O, steps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = O * 9 * C;
  const int blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  sum<<<blocks, 256, 0, stream>>>(part, dw, n, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad(const void* x, const void* offsets, const void* masks, const void* dy, void* part, void* dw,
          int B, int H, int W, int C, int O, int splits, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  // int offsets into x (corner offsets), dY and dW
  if (M * C >= (1ll << 31) || M * O >= (1ll << 31) || (long long)O * 9 * C * splits >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* o = static_cast<const float*>(offsets);
  const float* m = static_cast<const float*>(masks);
  float* p = static_cast<float*>(part);
  T* d = static_cast<T*>(dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte chunk loads need whole chunks per channel and output row and
  // aligned bases; else the scalar-load variant
  constexpr int EPC = Cfg<T>::EPC;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  if (C % EPC == 0 && O % EPC == 0 && aligned)
    return launch<T, true>(xt, o, m, dyt, p, d, (int)M, H, W, C, O, splits, s);
  return launch<T, false>(xt, o, m, dyt, p, d, (int)M, H, W, C, O, splits, s);
}

}  // namespace

// float32 x (B,H,W,C), offsets (B,H,W,18), masks (B,H,W,9, sigmoided), dy
// (B,H,W,O); part: float32 scratch (splits, O, 9C) -> dw (O, 9C)
extern "C" int deform_conv_wgrad(const void* x, const void* offsets, const void* masks, const void* dy,
                                 void* part, void* dw, int B, int H, int W, int C, int O, int splits,
                                 void* stream) {
  return wgrad<float>(x, offsets, masks, dy, part, dw, B, H, W, C, O, splits, stream);
}

// the same with bf16 x, dy and dw; offsets, masks and the scratch float32
extern "C" int deform_conv_wgrad_bf16(const void* x, const void* offsets, const void* masks,
                                      const void* dy, void* part, void* dw, int B, int H, int W, int C,
                                      int O, int splits, void* stream) {
  return wgrad<uint16_t>(x, offsets, masks, dy, part, dw, B, H, W, C, O, splits, stream);
}
