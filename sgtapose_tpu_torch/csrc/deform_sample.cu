// Modulated deformable sampling (DCNv2 forward sampling), NHWC.
//
// Replaces sgtapose_tpu/models/deform_conv.py:deform_sample_batch (an XLA
// gather program on the TPU, not Pallas; the GPU machine has no library op
// for it). For every output pixel p and row-major 3x3 tap k (ky = k/3 - 1,
// kx = k%3 - 1):
//   (y, x) = (p_y + ky + dy_k, p_x + kx + dx_k),  offsets[..., 2k:2k+2] = (dy, dx)
//   out[b, p, k*C + c] = mask[b, p, k] * bilinear(feat[b, :, :, c], y, x)
// with zero padding: each of the 4 bilinear corners gets weight 0 when it
// lies outside the map (its value is read at the clamped index, as the
// reference does). The mask is already sigmoided. The output channel order is
// tap-major (k*C + c), the order the following (9C -> O) contraction expects.
//
// What bounds it on an H100: bytes. The output (B,H,W,9C) is the big stream
// (33.2 MB at 120x120x64, ~11.5 us at 3.35 TB/s with the ~5 MB of inputs);
// the arithmetic is a few FLOPs per output element. Design: one thread per
// 4 consecutive output channels (float4) of one (pixel, tap), so consecutive
// threads write consecutive 16-byte chunks of the output and read consecutive
// channels of the same corner pixel (both coalesced); the per-(pixel, tap)
// coordinate math is repeated by the C/4 threads that share it (they read the
// same offset/mask words, a broadcast), which is cheaper than staging it.
// A scalar variant handles C % 4 != 0 or unaligned pointers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, float w00,
                                         float w01, float w10, float w11, float mk) {
  // same order as the reference: (((v00 w00 + v01 w01) + v10 w10) + v11 w11) * mask
  float r = v00 * w00;
  r = r + v01 * w01;
  r = r + v10 * w10;
  r = r + v11 * w11;
  return r * mk;
}

template <int VEC>
__global__ void __launch_bounds__(256)
    deform_sample_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
                         const float* __restrict__ masks, float* __restrict__ out, int H, int W,
                         int C, unsigned total) {
  const int CV = C / VEC;
  for (unsigned idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int cv = idx % CV;
    const unsigned rest = idx / CV;
    const int tap = rest % 9;
    const unsigned pix = rest / 9;  // (b*H + y)*W + x
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
    const float w00 = (1.f - fy) * (1.f - fx) * (vy0 * vx0);
    const float w01 = (1.f - fy) * fx * (vy0 * vx1);
    const float w10 = fy * (1.f - fx) * (vy1 * vx0);
    const float w11 = fy * fx * (vy1 * vx1);
    const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
    const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);

    const float* fb = feat + (size_t)b * H * W * C + (size_t)cv * VEC;
    const auto v00 = Vec<VEC>::load(fb + ((size_t)yc0 * W + xc0) * C);
    const auto v01 = Vec<VEC>::load(fb + ((size_t)yc0 * W + xc1) * C);
    const auto v10 = Vec<VEC>::load(fb + ((size_t)yc1 * W + xc0) * C);
    const auto v11 = Vec<VEC>::load(fb + ((size_t)yc1 * W + xc1) * C);
    if constexpr (VEC == 4) {
      float4 r;
      r.x = combine(v00.x, v01.x, v10.x, v11.x, w00, w01, w10, w11, mk);
      r.y = combine(v00.y, v01.y, v10.y, v11.y, w00, w01, w10, w11, mk);
      r.z = combine(v00.z, v01.z, v10.z, v11.z, w00, w01, w10, w11, mk);
      r.w = combine(v00.w, v01.w, v10.w, v11.w, w00, w01, w10, w11, mk);
      reinterpret_cast<float4*>(out)[idx] = r;
    } else {
      out[idx] = combine(v00, v01, v10, v11, w00, w01, w10, w11, mk);
    }
  }
}

template <int VEC>
int launch(const float* feat, const float* offsets, const float* masks, float* out, int B, int H,
           int W, int C, cudaStream_t stream) {
  const uint64_t total = (uint64_t)B * H * W * 9 * (C / VEC);
  if (total == 0) return (int)cudaSuccess;
  if (total >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  deform_sample_kernel<VEC><<<blocks, threads, 0, stream>>>(feat, offsets, masks, out, H, W, C,
                                                            (unsigned)total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int deform_sample_fwd(const void* feat, const void* offsets, const void* masks,
                                 void* out, int B, int H, int W, int C, void* stream) {
  const float* f = static_cast<const float*>(feat);
  const float* o = static_cast<const float*>(offsets);
  const float* m = static_cast<const float*>(masks);
  float* dst = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (C % 4 == 0 && aligned) return launch<4>(f, o, m, dst, B, H, W, C, s);
  return launch<1>(f, o, m, dst, B, H, W, C, s);
}
