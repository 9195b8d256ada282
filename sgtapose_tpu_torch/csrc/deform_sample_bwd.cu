// Modulated deformable sampling backward (DCNv2), NHWC, float32.
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
// What bounds it on an H100: bytes. At the decoder's largest node
// (120 x 120 x 64, batch 8) g is 265 MB and dfeat 29 MB read and written
// once (~0.1 ms at 3.35 TB/s); the 4 corner reads of feat come from L2.
// Design: one warp per (pixel, tap), lanes over the channels, so the reads of
// g and of each corner row and the atomics into each corner row are 32
// consecutive floats; the coordinate math is repeated by the 32 lanes (the
// same offset and mask words, a broadcast) and the three per-tap sums are
// added with shuffles. The atomics into dfeat are the part that is not a
// plain stream.
//
// On the quantization-aware training path (models/deform_conv.py:
// deform_columns, under int8_train) it is the columns' backward, 16 launches
// a step; the fused training path takes csrc/deform_conv_bwd.cu instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(256)
    deform_sample_bwd_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
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

}  // namespace

// feat (B,H,W,C), offsets (B,H,W,18), masks (B,H,W,9) sigmoided, grad
// (B,H,W,9C) -> dfeat (B,H,W,C), which must hold zeros (the kernel adds into
// it), and dom (B,H,W,27), every element written
extern "C" int deform_sample_bwd(const void* feat, const void* offsets, const void* masks,
                                 const void* grad, void* dfeat, void* dom, int B, int H, int W,
                                 int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const uint64_t total = (uint64_t)B * H * W * 9;
  if (total >= (1ull << 31) || total * C >= (1ull << 40)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const uint64_t blocks = (total * 32 + threads - 1) / threads;  // one warp per item
  deform_sample_bwd_kernel<<<(unsigned)blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feat), static_cast<const float*>(offsets),
      static_cast<const float*>(masks), static_cast<const float*>(grad),
      static_cast<float*>(dfeat), static_cast<float*>(dom), H, W, C, (unsigned)total);
  return (int)cudaGetLastError();
}
