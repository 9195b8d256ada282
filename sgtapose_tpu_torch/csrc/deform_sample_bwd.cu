// Modulated deformable sampling backward (DCNv2), NHWC: float32
// (deform_sample_bwd) and bf16 (deform_sample_bwd_bf16), one design.
//
// Replaces the custom VJP of sgtapose_tpu/models/deform_conv.py:
// deform_sample_batch, _dsb_bwd / _bwd_core (:126-202; XLA gathers and a
// segment_sum on the TPU, not Pallas). The forward (deform_sample.cu) is
//   samp[b, p, k, c] = sum_corner w_corner * feat[b, corner, c]
//   out[b, p, k*C + c] = mask[b, p, k] * samp[b, p, k, c]
// at (y, x) = (p_y + k/3 - 1 + dy_k, p_x + k%3 - 1 + dx_k), bilinear weights
// with each corner's validity (inside the map) folded in. Given
// g = d loss / d out (B, H, W, 9C), this kernel writes
//   dfeat[b, corner, c] += g * mask * w_corner          (float atomics: the
//                          JAX segment_sum is unordered too; an invalid corner
//                          has weight 0 and adds nothing)
//   doffsets (dy_k, dx_k) = sum_c g * mask * d samp / d (y, x), the analytic
//                          bilinear derivatives with validity folded in
//   dmask_k = sum_c samp * g
// and emits the gradient of the raw offset/mask conv output om (B, H, W, 27)
// directly: om[..., 2k:2k+2] are the offsets and om[..., 18+k] the mask
// logit, whose gradient is dmask * s (1 - s) with s = mask = sigmoid(logit).
//
// Where it runs: on the quantization-aware training path
// (models/deform_conv.py: deform_columns, under int8_train) it is the DCN
// columns' backward, 16 launches a step; bf16 QAT (--quant_train --bf16)
// launches the bf16 instantiation. The fused training path takes
// csrc/deform_conv_bwd.cu instead.
//
// What bounds it on an H100. The bytes (g, feat, offsets, masks read once,
// dfeat and dom written once: g, the (B,H,W,9C) stream, is 90 % of them)
// would take 0.93 ms over the 16 decoder nodes at batch 8 in float32 and
// 0.48 ms in bf16, but the scatter bounds it: every (pixel, tap, corner) of
// non-zero weight adds its C values into dfeat, up to 36 contributions per
// dfeat element, 605.5 M (pixel, tap, channel) elements a step. The design
// that preceded this one (kept as the yardstick, deform_sample_bwd_warp:
// one warp per (pixel, tap), lanes over channels, 4 scalar float atomics
// per channel, 2.42 G of them a step) took 6.2 ms; this one takes 3.9 on an
// H100 80GB HBM3 at 700 W (chip_smoke.py, the two in turns). Builds timed
// while it was designed, not kept: without its scatter 2.18 ms (so its
// float4 atomics cost ~1.7 and do not overlap the reads), with scalar
// atomics in its layout 13.1, its items in tap-major order 5.76 (the
// atomics need their dfeat lines in the L2: pixel-major order keeps them
// there), x staged over a shared-memory halo tile for the corner reads 4.24
// against 3.93 (a block table, a barrier a slice, two blocks an SM).
// Not built: a halo of dfeat in shared memory that each thread owns a
// 4-channel column of, so that it adds with no atomics. A 17 x 17 halo (an
// 8 x 8 tile at +-3 px) is 4.6 KB a column: under 50 such threads fit an
// SM's 228 KB, ~200 if the 4 corners of an item are split by the parity of
// their cell (one corner in each class); at +-12 px 19.6 KB a column. Each
// item's three channel sums would then be spread over 4 x C/4 threads, a
// shuffle tree of 3 values for every 32 channels of every item. Float adds
// into shared memory are compare-and-swap loops on this card (a first
// design of deform_conv_dgrad that scattered with them ran 40 ms a train
// step). Design:
//   * the scatter uses Hopper's vector atomics, atomicAdd(float4*,
//     float4) (red.global.add.v4.f32): 4 channels a lane in float32 and in
//     bf16, so an instruction's lanes cover whole 32-byte sectors of a
//     corner row (8 bf16 channels a lane, two half-sector atomics each,
//     took 6.76 ms), and 4x fewer atomic operations than scalar adds;
//   * L lanes (a power of two) per (pixel, tap), G items a warp
//     (dcn_columns.cuh), so a 64-channel map keeps every lane busy and a
//     15 x 15 x 512 node still fills the card; an item's coordinates are
//     formed once, by one lane, and shuffled to its lanes; g is read with
//     evict-first loads;
//   * the three per-(pixel, tap) channel sums stay in registers, are added
//     over the L lanes with shuffles in a fixed order, and dom is written
//     once, with no atomics: the same bit for bit in every run (dfeat is
//     not: float atomics);
//   * bf16: x and g read as bf16 (no widened copies), every product and sum
//     in float32, dfeat added into a float32 buffer that a second kernel of
//     the same launch rounds once to bf16; dom rounded once as it is
//     written (3.69 ms a step against 8.57 for the route it replaced:
//     widen x and g, the warp kernel, round);
//   * C not a multiple of 4, or unaligned rows, take a one-element-a-lane
//     variant with scalar atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dcn_columns.cuh"

namespace {

// The warp-per-item design, the yardstick: one warp per (pixel, tap), lanes
// over the channels, 4 scalar float atomics per channel
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(256)
    deform_sample_bwd_warp_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
                                  const float* __restrict__ masks, const float* __restrict__ grad,
                                  float* __restrict__ dfeat, float* __restrict__ dom, int H, int W,
                                  int C, unsigned total) {
  const int lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (blockDim.x / 32);
  for (unsigned item = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32; item < total; item += warps) {
    const int tap = item % 9;
    const unsigned pix = item / 9;  // (b*H + y)*W + x
    const int x = pix % W;
    const unsigned row = pix / W;
    const int y = row % H;
    const int b = row / H;

    const float dy = __ldg(offsets + (size_t)pix * 18 + 2 * tap);
    const float dx = __ldg(offsets + (size_t)pix * 18 + 2 * tap + 1);
    const float mk = __ldg(masks + (size_t)pix * 9 + tap);
    const float py = (float)(y + tap / 3 - 1) + dy;
    const float px = (float)(x + tap % 3 - 1) + dx;
    const float y0f = floorf(py), x0f = floorf(px);
    const float fy = py - y0f, fx = px - x0f;
    const int y0 = (int)y0f, x0 = (int)x0f, y1 = y0 + 1, x1 = x0 + 1;
    const float vy0 = (y0 >= 0 && y0 < H) ? 1.f : 0.f;
    const float vy1 = (y1 >= 0 && y1 < H) ? 1.f : 0.f;
    const float vx0 = (x0 >= 0 && x0 < W) ? 1.f : 0.f;
    const float vx1 = (x1 >= 0 && x1 < W) ? 1.f : 0.f;
    const float val00 = vy0 * vx0, val01 = vy0 * vx1, val10 = vy1 * vx0, val11 = vy1 * vx1;
    const float w00 = (1.f - fy) * (1.f - fx) * val00;
    const float w01 = (1.f - fy) * fx * val01;
    const float w10 = fy * (1.f - fx) * val10;
    const float w11 = fy * fx * val11;
    // d samp / dy and d samp / dx per corner, validity folded in
    const float cy00 = -(1.f - fx) * val00, cy01 = -fx * val01, cy10 = (1.f - fx) * val10, cy11 = fx * val11;
    const float cx00 = -(1.f - fy) * val00, cx01 = (1.f - fy) * val01, cx10 = -fy * val10, cx11 = fy * val11;
    const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
    const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);
    const size_t base = (size_t)b * H * W * C;
    const size_t i00 = base + ((size_t)yc0 * W + xc0) * C, i01 = base + ((size_t)yc0 * W + xc1) * C;
    const size_t i10 = base + ((size_t)yc1 * W + xc0) * C, i11 = base + ((size_t)yc1 * W + xc1) * C;
    const float* g = grad + ((size_t)pix * 9 + tap) * C;

    float dm = 0.f, gy = 0.f, gx = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gc = __ldg(g + c);
      const float v00 = __ldg(feat + i00 + c), v01 = __ldg(feat + i01 + c);
      const float v10 = __ldg(feat + i10 + c), v11 = __ldg(feat + i11 + c);
      float samp = v00 * w00;
      samp = samp + v01 * w01;
      samp = samp + v10 * w10;
      samp = samp + v11 * w11;
      dm = fmaf(samp, gc, dm);
      const float ds = gc * mk;
      gy = fmaf(ds, v00 * cy00 + v01 * cy01 + v10 * cy10 + v11 * cy11, gy);
      gx = fmaf(ds, v00 * cx00 + v01 * cx01 + v10 * cx10 + v11 * cx11, gx);
      // the weights are the same in every lane: each branch is warp-uniform
      if (w00 != 0.f) atomicAdd(dfeat + i00 + c, ds * w00);
      if (w01 != 0.f) atomicAdd(dfeat + i01 + c, ds * w01);
      if (w10 != 0.f) atomicAdd(dfeat + i10 + c, ds * w10);
      if (w11 != 0.f) atomicAdd(dfeat + i11 + c, ds * w11);
    }
    dm = warp_sum(dm);
    gy = warp_sum(gy);
    gx = warp_sum(gx);
    if (lane == 0) {
      float* o = dom + (size_t)pix * 27;
      o[2 * tap] = gy;
      o[2 * tap + 1] = gx;
      o[18 + tap] = dm * mk * (1.f - mk);
    }
  }
}


__device__ __forceinline__ void store_dom(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_dom(uint16_t* p, float v) { *p = to_bf16(v); }

// T: feat and g (float, or bf16 as uint16_t); D: dom (float32, or bf16
// rounded once); dfeat: float32 sums
template <typename T, typename D, int VEC, int L>
__device__ __forceinline__ void flat_body(const T* __restrict__ feat, const float* __restrict__ offsets,
                                          const float* __restrict__ masks, const T* __restrict__ grad,
                                          float* __restrict__ dfeat, D* __restrict__ dom, int H, int W, int C,
                                          unsigned total, int G) {
  constexpr int IPW = 32 / L;  // items a warp works on at once
  const int lane = threadIdx.x & 31, seg = lane / L, sl = lane % L;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, warps = (gridDim.x * blockDim.x) >> 5;
  const unsigned hw = (unsigned)H * W;
  for (unsigned base = warp * G; base < total; base += warps * G) {
    const Corners mine = corners_of(min(base + min(lane, G - 1), total - 1), offsets, masks, H, W);
    for (int k = 0; k < G; k += IPW) {
      const Corners t = shfl_corners(mine, k + seg);
      const unsigned item = min(base + k + seg, total - 1);  // the same in the item's L lanes
      float dm = 0.f, gy = 0.f, gx = 0.f;
      if (base + k + seg < total) {
        const Factors f = factors_of(t);
        const size_t img = (size_t)((item / 9) / hw) * hw;
        const T* fb = feat + img * C;
        float* db = dfeat + img * C;
        const T* g = grad + (size_t)item * C;
        for (int c = sl * VEC; c < C; c += L * VEC) {
          float gc[VEC], v[4][VEC], r[4][VEC];
          Chan<T, VEC>::stream(g + c, gc);
#pragma unroll
          for (int q = 0; q < 4; ++q) Chan<T, VEC>::load(fb + (size_t)t.idx[q] * C + c, v[q]);
          item_chunk<VEC>(gc, v, f, t.mk, dm, gy, gx, r);
          // the weights are the same in the item's lanes: each branch is
          // uniform over them
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (f.w[q] != 0.f) red_add<VEC>(db + (size_t)t.idx[q] * C + c, r[q]);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        dm += __shfl_xor_sync(0xffffffffu, dm, off);
        gy += __shfl_xor_sync(0xffffffffu, gy, off);
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
      }
      if (base + k + seg < total && sl == 0) {
        const int tap = item % 9;
        D* o = dom + (size_t)(item / 9) * 27;
        store_dom(o + 2 * tap, gy);
        store_dom(o + 2 * tap + 1, gx);
        store_dom(o + 18 + tap, dm * t.mk * (1.f - t.mk));
      }
    }
  }
}

// one kernel name per precision, as profilers list them
template <int VEC, int L>
__global__ void __launch_bounds__(256)
    deform_sample_bwd_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
                             const float* __restrict__ masks, const float* __restrict__ grad,
                             float* __restrict__ dfeat, float* __restrict__ dom, int H, int W, int C,
                             unsigned total, int G) {
  flat_body<float, float, VEC, L>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, G);
}

template <int VEC, int L>
__global__ void __launch_bounds__(256)
    deform_sample_bwd_bf16_kernel(const uint16_t* __restrict__ feat, const float* __restrict__ offsets,
                                  const float* __restrict__ masks, const uint16_t* __restrict__ grad,
                                  float* __restrict__ dfeat, uint16_t* __restrict__ dom, int H, int W, int C,
                                  unsigned total, int G) {
  flat_body<uint16_t, uint16_t, VEC, L>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, G);
}

// bf16 dx: the float32 sums rounded once
__global__ void __launch_bounds__(256)
    deform_sample_bwd_bf16_round_kernel(const float* __restrict__ src, uint16_t* __restrict__ dst, long long n) {
  round_body(src, dst, n);
}

template <typename T, typename D, int VEC, int L>
int launch_flat_lanes(const T* feat, const float* offsets, const float* masks, const T* grad, float* dfeat, D* dom,
                      int H, int W, int C, unsigned total, cudaStream_t stream) {
  const int G = items_per_warp(total, L);
  const unsigned warps = (total + G - 1) / G;
  const unsigned blocks = (warps + 7) / 8;
  if constexpr (sizeof(T) == 4)
    deform_sample_bwd_kernel<VEC, L><<<blocks, 256, 0, stream>>>(feat, offsets, masks, grad, dfeat, dom, H, W, C,
                                                                 total, G);
  else
    deform_sample_bwd_bf16_kernel<VEC, L><<<blocks, 256, 0, stream>>>(feat, offsets, masks, grad, dfeat, dom, H,
                                                                      W, C, total, G);
  return (int)cudaGetLastError();
}

template <typename T, typename D, int VEC>
int launch_flat(const T* feat, const float* offsets, const float* masks, const T* grad, float* dfeat, D* dom,
                int H, int W, int C, unsigned total, cudaStream_t s) {
  switch (lanes_per_item(C, VEC)) {
    case 1: return launch_flat_lanes<T, D, VEC, 1>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, s);
    case 2: return launch_flat_lanes<T, D, VEC, 2>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, s);
    case 4: return launch_flat_lanes<T, D, VEC, 4>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, s);
    case 8: return launch_flat_lanes<T, D, VEC, 8>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, s);
    case 16: return launch_flat_lanes<T, D, VEC, 16>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, s);
    default: return launch_flat_lanes<T, D, VEC, 32>(feat, offsets, masks, grad, dfeat, dom, H, W, C, total, s);
  }
}

template <typename T, typename D>
int bwd(const void* feat, const void* offsets, const void* masks, const void* grad, void* dfeat, void* dom, int B,
        int H, int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const uint64_t total = (uint64_t)B * H * W * 9;
  if (total >= (1ull << 31) - 32 || total * C >= (1ull << 40)) return (int)cudaErrorInvalidValue;
  const T* f = static_cast<const T*>(feat);
  const T* g = static_cast<const T*>(grad);
  const float* o = static_cast<const float*>(offsets);
  const float* m = static_cast<const float*>(masks);
  float* df = static_cast<float*>(dfeat);
  D* dm = static_cast<D*>(dom);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 4 channels a lane (16 bytes of float32, 8 of bf16; float4 atomics) need
  // whole groups of 4 and aligned rows
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(df)) & 15) == 0;
  if (C % 4 == 0 && aligned) return launch_flat<T, D, 4>(f, o, m, g, df, dm, H, W, C, (unsigned)total, s);
  return launch_flat<T, D, 1>(f, o, m, g, df, dm, H, W, C, (unsigned)total, s);
}

}  // namespace

// feat (B,H,W,C), offsets (B,H,W,18), masks (B,H,W,9) sigmoided, grad
// (B,H,W,9C), all float32 -> dfeat (B,H,W,C), which must hold zeros (the
// kernel adds into it), and dom (B,H,W,27), every element written
extern "C" int deform_sample_bwd(const void* feat, const void* offsets, const void* masks, const void* grad,
                                 void* dfeat, void* dom, int B, int H, int W, int C, void* stream) {
  return bwd<float, float>(feat, offsets, masks, grad, dfeat, dom, B, H, W, C, stream);
}

// bf16 feat and grad, float32 offsets and masks -> bf16 dx and dom; dx32 is
// float32 scratch (B,H,W,C) holding zeros (the scatter adds into it before dx
// is rounded from it)
extern "C" int deform_sample_bwd_bf16(const void* feat, const void* offsets, const void* masks, const void* grad,
                                      void* dx32, void* dx, void* dom, int B, int H, int W, int C, void* stream) {
  const int err = bwd<uint16_t, uint16_t>(feat, offsets, masks, grad, dx32, dom, B, H, W, C, stream);
  if (err != 0) return err;
  const long long n = (long long)B * H * W * C;
  deform_sample_bwd_bf16_round_kernel<<<round_blocks(n), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dx32), static_cast<uint16_t*>(dx), n);
  return (int)cudaGetLastError();
}


// The warp-per-item design, the yardstick (on no path): the arguments of
// deform_sample_bwd
extern "C" int deform_sample_bwd_warp(const void* feat, const void* offsets, const void* masks,
                                      const void* grad, void* dfeat, void* dom, int B, int H, int W,
                                      int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const uint64_t total = (uint64_t)B * H * W * 9;
  if (total >= (1ull << 31) || total * C >= (1ull << 40)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const uint64_t blocks = (total * 32 + threads - 1) / threads;  // one warp per item
  deform_sample_bwd_warp_kernel<<<(unsigned)blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const float*>(offsets),
      static_cast<const float*>(masks), static_cast<const float*>(grad),
      static_cast<float*>(dfeat), static_cast<float*>(dom), H, W, C, (unsigned)total);
  return (int)cudaGetLastError();
}
