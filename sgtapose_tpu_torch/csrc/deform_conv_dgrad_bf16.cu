// Data gradient of the fused modulated deformable convolution (DCNv2) for
// bf16 training, NHWC (deform_conv_dgrad_bf16): the columns' cotangent
// formed on the tensor cores and scattered straight from shared memory with
// vector atomics, in one kernel.
//
// Replaces, in bf16, the custom VJP of sgtapose_tpu/models/deform_conv.py
// (deform_sample_batch: _dsb_bwd / _bwd_core, :130-199; XLA gathers and a
// segment_sum on the TPU, not Pallas) composed with the data gradient XLA
// derives for the 1x1 `kernel` contraction (:349-356). With om the raw
// offset/mask conv output ((dy, dx) of row-major tap k in channels 2k, 2k+1,
// its mask logit in 18+k), s_k = sigmoid(om[p, 18+k]) and dY (B,H,W,O), all
// bf16 and widened exactly:
//   dcols[p, k*C + c] = sum_o dY[p, o] * weight[o, k*C + c]     (float32)
//   dx[corner, c]    += s_k * w_corner * dcols[p, k*C + c]     (float32 sums)
//   dom[p, 2k:2k+2]   = sum_c s_k dcols[p, k*C + c] * d samp / d (y, x)
//   dom[p, 18+k]      = (sum_c samp[p, k, c] dcols[p, k*C + c]) * s_k (1 - s_k)
// with the bilinear weights and their derivatives zero for a corner outside
// the map; dx and dom each rounded once to bf16.
//
// What bounds it on an H100: operations, 2 M O 9C for the product at 989
// TFLOP/s dense bf16 (0.152 ms over the 16 decoder nodes of a step at batch
// 8); the bytes (dY, x, om and the weight read once, dx and dom written once,
// 2 bytes an element) are below that. What it meets first is the scatter:
// every (pixel, tap, corner) of non-zero weight adds its C values into dx,
// 605.5 M (pixel, tap, channel) elements a step, up to 36 contributions per dx
// element. The first design (the float32 kernel instantiated in bf16,
// csrc/deform_conv_bwd.cu, kept as the yardstick deform_conv_dgrad_halo_bf16)
// spent its time there: one block an SM (a 17 x 17 x 16-channel float32 halo
// of x, a per-block counting sort of the contributions by halo cell, 3
// ring stages), a barrier-bound gather per 16-channel chunk, scalar float
// atomics, and a launch that lays the weight out for tf32's K-major B.
// Design:
//   * a block is one warpgroup and owns an 8 x 8 pixel tile of one image and
//     a range of 64-channel chunks; it walks its units (tap, chunk) tap by
//     tap, and forms each unit's dcols tile [64 pixels, 64 channels] with
//     wgmma m64n64k16 bf16 (float32 accumulators) over K = O in steps of 32
//     through a 3-stage cp.async ring: A is the tile's dY rows (K-major), B
//     the weight rows as they are (channels contiguous: the wgmma transpose
//     bit reads B N-major), so the weight needs no layout launch and no
//     scratch; edges are zero-filled by the copies;
//   * warp w holds accumulator rows 16w .. 16w + 15 and scatters just those
//     pixels: it stores them to a float32 tile in shared memory and reads
//     them back in deform_sample_bwd.cu's lane layout with no block barrier:
//     16 lanes per (pixel, tap), 4 channels a lane, x read as bf16 at the 4
//     corners (8 bytes a lane), dx added with float4 vector atomics
//     (red.global.add.v4.f32, whole 32-byte sectors per pair of lanes); the
//     warp's lanes form its pixels' coordinates once per tap, the raw
//     offsets fetched a tap ahead;
//   * no halo, no sort, no widened copy: ~53 KB of shared memory and 128
//     threads a block, 4 blocks an SM, so one block's scatter overlaps the
//     copies and products of the others;
//   * the three per-(pixel, tap) channel sums are added over the item's 16
//     lanes with shuffles in a fixed order and kept by one owner lane across
//     the tap's chunks; small maps (15 x 15 at batch 8 is 32 tiles) split
//     the chunks over a thread-block cluster of up to 8 blocks, whose sums
//     are added through distributed shared memory in rank order; dom is
//     written once, with no atomics, the same bit for bit in every run (dx
//     is not: float atomics);
//   * dx is summed in a float32 buffer that a second kernel of the launch
//     rounds once to bf16;
//   * any H, W, C and O: pixel, channel and output edges are masked; C or O
//     not a multiple of 8, or unaligned rows, take a variant with element
//     copies, scalar loads and scalar atomics.
// Where its time goes (sgtapose_tpu_torch/ops/dgrad_ablation.py builds it
// with parts switched off): the float4 atomics and the corner loads are the
// work; the rest is latency of each block's chain of ring steps, barriers
// and products, which the 4 resident blocks only partly hide.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dcn_columns.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int T = 8;           // tile side
constexpr int BM = T * T;      // pixels per block: the wgmma M of 64
constexpr int CN = 64;         // channels per unit: the wgmma N
constexpr int BK = 32;         // outputs (the GEMM depth) per ring step
constexpr int NST = 3;         // ring stages
constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxSplits = 8;  // portable cluster size
constexpr int L = 16;          // lanes per (pixel, tap) in the scatter, 4 channels each
constexpr int SR = CN + 4;     // row of the dcols tile in floats (16-byte aligned rows)
// A: 64 pixels x BK outputs, K-major core matrices of 8 pixels x 16 bytes:
// K-adjacent ones 128 bytes apart, M-adjacent ones a K row of them apart
constexpr int A_LBO = 128, A_SBO = (BK / 8) * A_LBO;
constexpr int A_BYTES = (BM / 8) * A_SBO;
// B: BK outputs x 64 channels, N-major core matrices of 8 outputs x 16
// bytes (8 channels): N-adjacent ones 144 bytes apart (a 16-byte pad, so
// the 8 threads copying one weight row hit distinct banks), K-adjacent ones
// a row of 8 of them apart
constexpr int B_NS = 144, B_KS = (CN / 8) * B_NS;
constexpr int B_BYTES = (BK / 8) * B_KS;
constexpr int COPIES = BM * (BK / 8) / kThreads;  // 16-byte copies a thread of A, and of B, per step
static_assert(BM * (BK / 8) == COPIES * kThreads && BK * (CN / 8) == COPIES * kThreads, "whole copies");
static_assert(CN == 4 * L && BM == 4 * 8 * 2, "a warp scatters 8 pairs of items, 16 lanes each");

struct Smem {
  unsigned char a[NST][A_BYTES];
  unsigned char b[NST][B_BYTES];
  float g[BM * SR];        // the unit's dcols, [pixel][channel]
  float sums[9 * BM * 3];  // per (tap, pixel): d/dy, d/dx, d/dmask over the block's channels
  float dmk[9 * BM];       // per (tap, pixel): the mask's derivative s (1 - s)
  Corners co[BM];          // sample coordinates of the current tap
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a shared-memory matrix descriptor without swizzle: start address, leading
// (K-direction) and stride (M- or N-direction) byte offsets
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// 8 bf16 at src into 16 bytes of shared memory, those at or past `lim`
// (elements left in the row) zero. VEC: one asynchronous 16-byte copy, the
// caller knows lim is a multiple of 8 (zero-filled when lim <= 0; `base`, a
// readable address, stands in for src then); else element loads and a store.
template <bool VEC>
__device__ __forceinline__ void copy8(unsigned char* dst, const uint16_t* src, const uint16_t* base, int lim) {
  if constexpr (VEC) {
    const int bytes = lim > 0 ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(bytes ? src : base), "r"(bytes)
                 : "memory");
  } else {
    uint32_t h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = i < lim ? (uint32_t)__ldg(src + i) : 0u;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (64 x 64, f32) += A (64 x 16, K-major) * B (16 x 64, N-major: the
// transpose bit), both bf16 in shared memory
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// x at 4 channels of a corner row as floats, those at or past lim zero;
// VEC: one 8-byte load of a whole group
template <bool VEC>
__device__ __forceinline__ void load_x4(const uint16_t* p, int lim, float (&v)[4]) {
  if constexpr (VEC) {
    Chan<uint16_t, 4>::load(p, v);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = u < lim ? bf16f(__ldg(p + u)) : 0.f;
  }
}

// 4 channels added into dx: one float4 atomic, or scalar atomics below lim
template <bool VEC>
__device__ __forceinline__ void add_dx4(float* p, int lim, const float (&r)[4]) {
  if constexpr (VEC) {
    red_add<4>(p, r);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < lim) atomicAdd(p + u, r[u]);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
    deform_conv_dgrad_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ om,
                                  const uint16_t* __restrict__ wt, const uint16_t* __restrict__ dout,
                                  float* __restrict__ dx, uint16_t* __restrict__ dom, int H, int W, int C,
                                  int O, int tiles_x, int tiles_per_img) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int img = blockIdx.x / tiles_per_img, tile = blockIdx.x % tiles_per_img;
  const int ty0 = (tile / tiles_x) * T, tx0 = (tile % tiles_x) * T;
  // the blocks of one cluster (along z) take consecutive channel chunks
  const int rank = blockIdx.z, splits = gridDim.z;
  const int CB = (C + CN - 1) / CN, KS = (O + BK - 1) / BK;
  const int ch_begin = CB * rank / splits, nch = CB * (rank + 1) / splits - ch_begin;
  const int steps = 9 * nch * KS;
  const size_t img_px = (size_t)img * H * W;
  const uint16_t* xb = x + img_px * C;
  float* dxb = dx + img_px * C;

  // the image pixel y * W + x of tile row r, or -1 past the map's edge
  auto pixel = [&](int r) {
    const int py = ty0 + r / T, px = tx0 + r % T;
    return (py < H && px < W) ? py * W + px : -1;
  };

  // ---- the ring: step t is unit t / KS (tap-major: tap (t / KS) / nch,
  // chunk ch_begin + (t / KS) % nch), outputs (t % KS) * BK .. ----
  auto copy_step = [&](int t) {
    if (t >= steps) return;
    const int u = t / KS, st = t % NST, o0 = (t % KS) * BK;
    const int tap = u / nch, c0 = (ch_begin + u % nch) * CN;
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {  // A: pixel r, outputs o0 + 8q ..
      const int e = tid + kThreads * i, r = e / (BK / 8), q = e % (BK / 8);
      const int p = pixel(r), o = o0 + 8 * q;
      copy8<VEC>(&sm.a[st][(r >> 3) * A_SBO + q * A_LBO + (r & 7) * 16],
                 dout + (img_px + (p < 0 ? 0 : p)) * O + o, dout, p < 0 ? 0 : O - o);
    }
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {  // B: output o0 + o, channels c0 + 8j ..
      const int e = tid + kThreads * i, o = e >> 3, j = e & 7;
      const int c = c0 + 8 * j;
      copy8<VEC>(&sm.b[st][(o >> 3) * B_KS + j * B_NS + (o & 7) * 16],
                 wt + (size_t)(o0 + o) * 9 * C + tap * C + c, wt, o0 + o < O ? C - c : 0);
    }
  };

  // ---- the sample coordinates of a tap's items: lane i < 16 of warp w
  // forms those of tile row 16w + i, which only warp w scatters; the raw
  // offsets and mask logit are loaded a tap ahead ----
  const int my_r = 16 * warp + (lane & 15), my_p = pixel(my_r);
  const bool former = lane < 16 && my_p >= 0;
  const uint16_t* my_om = om + (img_px + (my_p < 0 ? 0 : my_p)) * 27;
  uint16_t nxt[3] = {0, 0, 0};  // (dy, dx, mask logit) of the next tap
  auto fetch = [&](int tap) {
    if (former) {
      nxt[0] = __ldg(my_om + 2 * tap);
      nxt[1] = __ldg(my_om + 2 * tap + 1);
      nxt[2] = __ldg(my_om + 18 + tap);
    }
  };
  auto coords = [&](int tap) {
    if (former) {
      const float mk = 1.f / (1.f + expf(-bf16f(nxt[2])));
      sm.co[my_r] = corners_at(my_p % W, my_p / W, tap, bf16f(nxt[0]), bf16f(nxt[1]), mk, H, W);
      sm.dmk[tap * BM + my_r] = mk * (1.f - mk);
    }
    if (tap + 1 < 9) fetch(tap + 1);
    __syncwarp();
  };
  fetch(0);

  const int seg = lane / L, sl = lane % L;  // the item of a pair, the lane within it
  float acc[32];
  float own[3] = {0.f, 0.f, 0.f};  // lanes sl < 8: the sums of item (sl, seg) of this warp, this tap

#pragma unroll
  for (int t = 0; t < NST - 1; ++t) {
    copy_step(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    const int u = t / KS, ks = t % KS, st = t % NST;
    const int tap = u / nch, chunk = u % nch;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      if (chunk == 0) coords(tap);  // this warp's scatter of the last tap is done
    }
    cp_async_wait<NST - 2>();  // this thread's copies of step t have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's, and every reader of step t - 1's stage has finished
    copy_step(t + NST - 1);
    cp_async_commit();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n64(acc, desc(&sm.a[st][kk * 2 * A_LBO], A_LBO, A_SBO), desc(&sm.b[st][kk * 2 * B_KS], B_KS, B_NS));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (ks != KS - 1) continue;

    // ---- the unit is done: dcols into shared memory. Accumulator of wgmma
    // m64nNk16: warp w holds rows 16w..; lane (g, t) holds d[4j + 2h + c]
    // at (16w + g + 8h, 8j + 2t + c). Warp w scatters just these rows, so
    // the tile needs no barrier, only the warp's own order ----
    {
      const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int j = 0; j < CN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(&sm.g[(16 * warp + gq + 8 * h) * SR + 8 * j + 2 * tq]) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    __syncwarp();

    // ---- scatter: warp w takes tile rows 2w, 2w + 1, a pair of items at a
    // time (pixels 16w + 2s and 16w + 2s + 1), 16 lanes and 64 channels each ----
    const int c = (ch_begin + chunk) * CN + 4 * sl, lim = C - c;
#pragma unroll 2
    for (int s = 0; s < 8; ++s) {
      const int r = 16 * warp + 2 * s + seg;
      float dm = 0.f, gy = 0.f, gx = 0.f;
      if (lim > 0 && pixel(r) >= 0) {
        const Corners it = sm.co[r];
        const float4 g4 = *reinterpret_cast<const float4*>(&sm.g[r * SR + 4 * sl]);
        const float gc[4] = {g4.x, g4.y, g4.z, g4.w};
        float v[4][4], upd[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) load_x4<VEC>(xb + (size_t)it.idx[q] * C + c, lim, v[q]);
        const Factors f = factors_of(it);
        item_chunk<4>(gc, v, f, it.mk, dm, gy, gx, upd);
        // the weights are the same in the item's lanes: each branch is
        // uniform over them
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (f.w[q] != 0.f) add_dx4<VEC>(dxb + (size_t)it.idx[q] * C + c, lim, upd[q]);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        dm += __shfl_xor_sync(0xffffffffu, dm, off);
        gy += __shfl_xor_sync(0xffffffffu, gy, off);
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
      }
      if (sl == s) {
        own[0] += gy;
        own[1] += gx;
        own[2] += dm;
      }
    }
    if (chunk == nch - 1) {  // the tap's last chunk: its sums to shared memory
      if (sl < 8) {
        float* d = &sm.sums[(tap * BM + 16 * warp + 2 * sl + seg) * 3];
        d[0] = own[0];
        d[1] = own[1];
        d[2] = own[2];
      }
      own[0] = own[1] = own[2] = 0.f;
    }
  }

  // ---- dom: the sums added over the cluster in rank order ----
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank + splits * tid; e < 9 * BM; e += splits * kThreads) {
    const int tap = e / BM, p = pixel(e % BM);
    if (p < 0) continue;
    float gy = 0.f, gx = 0.f, dm = 0.f;
    for (int q = 0; q < splits; ++q) {
      const float* part = cluster.map_shared_rank(&sm.sums[0], q);
      gy += part[3 * e];
      gx += part[3 * e + 1];
      dm += part[3 * e + 2];
    }
    uint16_t* d = dom + (img_px + p) * 27;
    d[2 * tap] = to_bf16(gy);
    d[2 * tap + 1] = to_bf16(gx);
    d[18 + tap] = to_bf16(dm * sm.dmk[e]);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// bf16 dx: the float32 sums rounded once
__global__ void __launch_bounds__(256)
    deform_conv_dgrad_bf16_round_kernel(const float* __restrict__ src, uint16_t* __restrict__ dst, long long n) {
  round_body(src, dst, n);
}

template <bool VEC>
int launch(const uint16_t* x, const uint16_t* om, const uint16_t* wt, const uint16_t* dout, float* dx32,
           uint16_t* dom, int B, int H, int W, int C, int O, cudaStream_t stream) {
  auto kern = deform_conv_dgrad_bf16_kernel<VEC>;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // all of the SM's shared memory, so 4 blocks fit (left to itself the
  // driver may size the carveout for fewer)
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms <= 0 || per_sm <= 0) return (int)cudaErrorInvalidDevice;
  const int tiles_x = (W + T - 1) / T, tiles_per_img = tiles_x * ((H + T - 1) / T);
  const long long blocks = (long long)B * tiles_per_img;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  // split the channel chunks over a cluster of up to 8 blocks while the
  // blocks fill fewer than the card's resident slots
  const int CB = (C + CN - 1) / CN;
  long long splits = (long long)sms * per_sm / blocks;
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
  e = cudaLaunchKernelEx(&cfg, kern, x, om, wt, dout, dx32, dom, H, W, C, O, tiles_x, tiles_per_img);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 x (B,H,W,C), om (B,H,W,27), weight (O, 9C), dy (B,H,W,O) -> bf16 dx
// (B,H,W,C) and dom (B,H,W,27), every element written; dx32 is float32
// scratch (B,H,W,C) holding zeros (the scatter adds into it before dx is
// rounded from it)
extern "C" int deform_conv_dgrad_bf16(const void* x, const void* om, const void* weight, const void* dy,
                                      void* dx32, void* dx, void* dom, int B, int H, int W, int C, int O,
                                      void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  // int pixel indices within an image; size_t element offsets
  if (M >= (1ll << 31) || (long long)O * 9 * C >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  using bf = uint16_t;
  const bf* xt = static_cast<const bf*>(x);
  const bf* omt = static_cast<const bf*>(om);
  const bf* wt = static_cast<const bf*>(weight);
  const bf* dyt = static_cast<const bf*>(dy);
  float* acc = static_cast<float*>(dx32);
  bf* domt = static_cast<bf*>(dom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies of 8 outputs and 8 channels, 8-byte loads of 4 channels
  // and 16-byte atomics need whole groups of 8 and aligned rows
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(weight) |
                         reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx32);
  const int err = (C % 8 == 0 && O % 8 == 0 && (addr & 15) == 0)
                      ? launch<true>(xt, omt, wt, dyt, acc, domt, B, H, W, C, O, s)
                      : launch<false>(xt, omt, wt, dyt, acc, domt, B, H, W, C, O, s);
  if (err != 0) return err;
  const long long n = M * C;
  deform_conv_dgrad_bf16_round_kernel<<<round_blocks(n), 256, 0, s>>>(acc, static_cast<bf*>(dx), n);
  return (int)cudaGetLastError();
}
