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
//
// The fused paths do not launch it (the DCN weight gradient forms the same
// columns inside csrc/deform_conv_wgrad.cu, for which it stays the
// yardstick: the sampler, then torch.matmul, as chip_smoke.py times it).
// The int8 paths do: under int8 serving and quantization-aware training the
// DCN's contraction is a quantizable site over these columns
// (models/deform_conv.py:deform_columns), 16 launches a frame or step.
//
// Two instantiations: float32 (deform_sample_fwd) and bf16
// (deform_sample_bf16_fwd), the columns of bf16 training's weight gradient
// before deform_conv_wgrad_bf16: bf16 features, the coordinates and the
// sigmoided masks float32 (the offsets widened exactly from bf16, the mask
// sigmoid taken in float32, as the bf16 fused forward forms them), each
// column element formed in float32 and rounded once to bf16 (what the fused
// forward feeds its product). Bytes bound it as in float32, at half the
// output stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// VEC consecutive channels of T (float, or bf16 held as uint16_t) as floats,
// and VEC floats stored as T (bf16: rounded once)
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};
template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<uint16_t, 1> {
  static __device__ __forceinline__ void load(const uint16_t* p, float (&v)[1]) { v[0] = bf16f(__ldg(p)); }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&v)[1]) { *p = to_bf16(v[0]); }
};
template <>
struct Vec<uint16_t, 4> {
  static __device__ __forceinline__ void load(const uint16_t* p, float (&v)[4]) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf_lo(u.x); v[1] = bf_hi(u.x); v[2] = bf_lo(u.y); v[3] = bf_hi(u.y);
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2((uint32_t)to_bf16(v[0]) | ((uint32_t)to_bf16(v[1]) << 16),
                                              (uint32_t)to_bf16(v[2]) | ((uint32_t)to_bf16(v[3]) << 16));
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

template <typename T, int VEC>
__device__ __forceinline__ void sample_body(const T* __restrict__ feat, const float* __restrict__ offsets,
                                            const float* __restrict__ masks, T* __restrict__ out, int H,
                                            int W, int C, unsigned total) {
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

    const T* fb = feat + (size_t)b * H * W * C + (size_t)cv * VEC;
    float v00[VEC], v01[VEC], v10[VEC], v11[VEC], r[VEC];
    Vec<T, VEC>::load(fb + ((size_t)yc0 * W + xc0) * C, v00);
    Vec<T, VEC>::load(fb + ((size_t)yc0 * W + xc1) * C, v01);
    Vec<T, VEC>::load(fb + ((size_t)yc1 * W + xc0) * C, v10);
    Vec<T, VEC>::load(fb + ((size_t)yc1 * W + xc1) * C, v11);
#pragma unroll
    for (int u = 0; u < VEC; ++u) r[u] = combine(v00[u], v01[u], v10[u], v11[u], w00, w01, w10, w11, mk);
    Vec<T, VEC>::store(out + (size_t)idx * VEC, r);
  }
}

// one kernel name per precision, as profilers list them
template <int VEC>
__global__ void __launch_bounds__(256)
    deform_sample_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
                         const float* __restrict__ masks, float* __restrict__ out, int H, int W,
                         int C, unsigned total) {
  sample_body<float, VEC>(feat, offsets, masks, out, H, W, C, total);
}

template <int VEC>
__global__ void __launch_bounds__(256)
    deform_sample_bf16_kernel(const uint16_t* __restrict__ feat, const float* __restrict__ offsets,
                              const float* __restrict__ masks, uint16_t* __restrict__ out, int H,
                              int W, int C, unsigned total) {
  sample_body<uint16_t, VEC>(feat, offsets, masks, out, H, W, C, total);
}

template <typename T, int VEC>
int launch(const T* feat, const float* offsets, const float* masks, T* out, int B, int H, int W,
           int C, cudaStream_t stream) {
  const uint64_t total = (uint64_t)B * H * W * 9 * (C / VEC);
  if (total == 0) return (int)cudaSuccess;
  if (total >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if constexpr (sizeof(T) == 4)
    deform_sample_kernel<VEC><<<blocks, threads, 0, stream>>>(feat, offsets, masks, out, H, W, C,
                                                              (unsigned)total);
  else
    deform_sample_bf16_kernel<VEC><<<blocks, threads, 0, stream>>>(feat, offsets, masks, out, H, W,
                                                                   C, (unsigned)total);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* feat, const void* offsets, const void* masks, void* out, int B, int H, int W,
        int C, void* stream) {
  const T* f = static_cast<const T*>(feat);
  const float* o = static_cast<const float*>(offsets);
  const float* m = static_cast<const float*>(masks);
  T* dst = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  // VEC = 4: 4 channels a thread, read and written as one 16-byte (float32)
  // or 8-byte (bf16) word
  const uintptr_t line = 4 * sizeof(T) - 1;
  const bool aligned = ((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(dst)) & line) == 0;
  if (C % 4 == 0 && aligned) return launch<T, 4>(f, o, m, dst, B, H, W, C, s);
  return launch<T, 1>(f, o, m, dst, B, H, W, C, s);
}

}  // namespace

// float32 feat (B,H,W,C), offsets (B,H,W,18), masks (B,H,W,9) -> out (B,H,W,9C)
extern "C" int deform_sample_fwd(const void* feat, const void* offsets, const void* masks,
                                 void* out, int B, int H, int W, int C, void* stream) {
  return fwd<float>(feat, offsets, masks, out, B, H, W, C, stream);
}

// the same with bf16 feat and out; offsets and masks float32
extern "C" int deform_sample_bf16_fwd(const void* feat, const void* offsets, const void* masks,
                                      void* out, int B, int H, int W, int C, void* stream) {
  return fwd<uint16_t>(feat, offsets, masks, out, B, H, W, C, stream);
}
