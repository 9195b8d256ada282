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
// What bounds it on an H100. The bytes (feat, offsets, masks read once, the
// (B,H,W,9C) columns written once) take 0.83 ms in float32 and 0.43 ms in
// bf16 over the 16 decoder nodes at batch 8 (a QAT step); the arithmetic is
// a few FLOPs per output element. The flat design that preceded this one
// (kept as the yardstick, deform_sample_flat / _flat_bf16: one thread per 4
// consecutive channels of a (pixel, tap), every thread forming its item's
// coordinates) ran 1.56 ms in float32 and 1.53 ms in bf16: in bf16 a thread
// moved 8 bytes where float32 moves 16 in the same instructions, and each
// output element's 4 corners are read through the L2 (4x the columns'
// bytes). Design (the lane layout of dcn_columns.cuh):
//   * 16 bytes a lane, 4 float32 or 8 bf16 channels: half the load and
//     store instructions of the flat bf16 kernel;
//   * L lanes per (pixel, tap), G items a warp (all 32 lanes busy at C = 64
//     in float32 and at C = 32 in bf16; fewer items a warp where a map has
//     few of them, so a 15 x 15 x 512 node still fills the card);
//   * each item's coordinates and corner weights formed once, by one lane,
//     and shuffled to its L lanes;
//   * the columns written with evict-first stores, so they do not push the
//     corners' rows out of the L2.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, the yardsticks in turns):
// 1.27 ms in float32, 0.79 in bf16 a QAT step; the corners' L2 reads keep
// it above the bytes bound. A one-element-a-lane variant handles C not a
// multiple of the vector or unaligned pointers.
//
// The fused paths do not launch it (the DCN weight gradient forms the same
// columns inside csrc/deform_conv_wgrad.cu, for which it stays the
// yardstick: the sampler, then torch.matmul, as chip_smoke.py times it).
// The int8 paths do: under int8 serving and quantization-aware training the
// DCN's contraction is a quantizable site over these columns
// (models/deform_conv.py:deform_columns), 16 launches a frame or step.
//
// Two instantiations: float32 (deform_sample_fwd) and bf16
// (deform_sample_bf16_fwd), the columns of bf16 int8 serving and bf16 QAT:
// bf16 features, the coordinates and the sigmoided masks float32 (the
// offsets widened exactly from bf16, the mask sigmoid taken in float32, as
// the bf16 fused forward forms them), each column element formed in
// float32 and rounded once to bf16 (what the fused forward feeds its
// product).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dcn_columns.cuh"

namespace {

__device__ __forceinline__ float combine(float v00, float v01, float v10, float v11, float w00,
                                         float w01, float w10, float w11, float mk) {
  // same order as the reference: (((v00 w00 + v01 w01) + v10 w10) + v11 w11) * mask
  float r = v00 * w00;
  r = r + v01 * w01;
  r = r + v10 * w10;
  r = r + v11 * w11;
  return r * mk;
}

// The flat design, the yardsticks: one thread per VEC consecutive channels
// of a (pixel, tap), every thread forming its item's coordinates
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
    Chan<T, VEC>::load(fb + ((size_t)yc0 * W + xc0) * C, v00);
    Chan<T, VEC>::load(fb + ((size_t)yc0 * W + xc1) * C, v01);
    Chan<T, VEC>::load(fb + ((size_t)yc1 * W + xc0) * C, v10);
    Chan<T, VEC>::load(fb + ((size_t)yc1 * W + xc1) * C, v11);
#pragma unroll
    for (int u = 0; u < VEC; ++u) r[u] = combine(v00[u], v01[u], v10[u], v11[u], w00, w01, w10, w11, mk);
    Chan<T, VEC>::put(out + (size_t)idx * VEC, r);
  }
}

// one kernel name per precision, as profilers list them
template <int VEC>
__global__ void __launch_bounds__(256)
    deform_sample_flat_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
                         const float* __restrict__ masks, float* __restrict__ out, int H, int W,
                         int C, unsigned total) {
  sample_body<float, VEC>(feat, offsets, masks, out, H, W, C, total);
}

template <int VEC>
__global__ void __launch_bounds__(256)
    deform_sample_flat_bf16_kernel(const uint16_t* __restrict__ feat, const float* __restrict__ offsets,
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
    deform_sample_flat_kernel<VEC><<<blocks, threads, 0, stream>>>(feat, offsets, masks, out, H, W, C,
                                                              (unsigned)total);
  else
    deform_sample_flat_bf16_kernel<VEC><<<blocks, threads, 0, stream>>>(feat, offsets, masks, out, H, W,
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


// the lane layout (dcn_columns.cuh): L lanes per (pixel, tap), VEC channels
// (16 bytes) a lane a step, the coordinates formed once per item and
// shuffled; the columns written with evict-first stores
template <typename T, int VEC, int L>
__device__ __forceinline__ void sample_lanes_body(const T* __restrict__ feat, const float* __restrict__ offsets,
                                                  const float* __restrict__ masks, T* __restrict__ out, int H,
                                                  int W, int C, unsigned total, int G) {
  constexpr int IPW = 32 / L;
  const int lane = threadIdx.x & 31, seg = lane / L, sl = lane % L;
  const unsigned warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, warps = (gridDim.x * blockDim.x) >> 5;
  const unsigned hw = (unsigned)H * W;
  for (unsigned base = warp * G; base < total; base += warps * G) {
    const Corners mine = corners_of(min(base + min(lane, G - 1), total - 1), offsets, masks, H, W);
#pragma unroll 4
    for (int k = 0; k < G; k += IPW) {
      const Corners t = shfl_corners(mine, k + seg);
      const unsigned item = base + k + seg;
      if (item >= total) continue;
      float w[4];
      corner_weights(t, w);
      const T* fb = feat + (size_t)((item / 9) / hw) * hw * C;
      T* o = out + (size_t)item * C;
      for (int c = sl * VEC; c < C; c += L * VEC) {
        float a[VEC], b[VEC], e[VEC], f[VEC], r[VEC];
        Chan<T, VEC>::load(fb + (size_t)t.idx[0] * C + c, a);
        Chan<T, VEC>::load(fb + (size_t)t.idx[1] * C + c, b);
        Chan<T, VEC>::load(fb + (size_t)t.idx[2] * C + c, e);
        Chan<T, VEC>::load(fb + (size_t)t.idx[3] * C + c, f);
#pragma unroll
        for (int u = 0; u < VEC; ++u) r[u] = combine(a[u], b[u], e[u], f[u], w[0], w[1], w[2], w[3], t.mk);
        Chan<T, VEC>::store(o + c, r);
      }
    }
  }
}

template <int VEC, int L>
__global__ void __launch_bounds__(256)
    deform_sample_kernel(const float* __restrict__ feat, const float* __restrict__ offsets,
                         const float* __restrict__ masks, float* __restrict__ out, int H, int W, int C,
                         unsigned total, int G) {
  sample_lanes_body<float, VEC, L>(feat, offsets, masks, out, H, W, C, total, G);
}

template <int VEC, int L>
__global__ void __launch_bounds__(256)
    deform_sample_bf16_kernel(const uint16_t* __restrict__ feat, const float* __restrict__ offsets,
                              const float* __restrict__ masks, uint16_t* __restrict__ out, int H, int W, int C,
                              unsigned total, int G) {
  sample_lanes_body<uint16_t, VEC, L>(feat, offsets, masks, out, H, W, C, total, G);
}

template <typename T, int VEC, int L>
int launch_lanes(const T* feat, const float* offsets, const float* masks, T* out, int H, int W, int C,
                 unsigned total, cudaStream_t stream) {
  const int G = items_per_warp(total, L);
  const unsigned blocks = ((total + G - 1) / G + 7) / 8;  // a warp per G items
  if constexpr (sizeof(T) == 4)
    deform_sample_kernel<VEC, L><<<blocks, 256, 0, stream>>>(feat, offsets, masks, out, H, W, C, total, G);
  else
    deform_sample_bf16_kernel<VEC, L><<<blocks, 256, 0, stream>>>(feat, offsets, masks, out, H, W, C, total, G);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_vec(const T* feat, const float* offsets, const float* masks, T* out, int H, int W, int C,
               unsigned total, cudaStream_t s) {
  switch (lanes_per_item(C, VEC)) {
    case 1: return launch_lanes<T, VEC, 1>(feat, offsets, masks, out, H, W, C, total, s);
    case 2: return launch_lanes<T, VEC, 2>(feat, offsets, masks, out, H, W, C, total, s);
    case 4: return launch_lanes<T, VEC, 4>(feat, offsets, masks, out, H, W, C, total, s);
    case 8: return launch_lanes<T, VEC, 8>(feat, offsets, masks, out, H, W, C, total, s);
    case 16: return launch_lanes<T, VEC, 16>(feat, offsets, masks, out, H, W, C, total, s);
    default: return launch_lanes<T, VEC, 32>(feat, offsets, masks, out, H, W, C, total, s);
  }
}

template <typename T>
int fwd_lanes(const void* feat, const void* offsets, const void* masks, void* out, int B, int H, int W, int C,
              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const uint64_t total = (uint64_t)B * H * W * 9;
  if (total >= (1ull << 31) - 32 || total * C >= (1ull << 40)) return (int)cudaErrorInvalidValue;
  const T* f = static_cast<const T*>(feat);
  const float* o = static_cast<const float*>(offsets);
  const float* m = static_cast<const float*>(masks);
  T* dst = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int VEC = 16 / sizeof(T);  // 16 bytes a lane: 4 float32 or 8 bf16 channels
  const bool aligned = ((reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (C % VEC == 0 && aligned) return launch_vec<T, VEC>(f, o, m, dst, H, W, C, (unsigned)total, s);
  return launch_vec<T, 1>(f, o, m, dst, H, W, C, (unsigned)total, s);
}

}  // namespace

// float32 feat (B,H,W,C), offsets (B,H,W,18), masks (B,H,W,9) -> out (B,H,W,9C)
extern "C" int deform_sample_fwd(const void* feat, const void* offsets, const void* masks,
                                 void* out, int B, int H, int W, int C, void* stream) {
  return fwd_lanes<float>(feat, offsets, masks, out, B, H, W, C, stream);
}

// the same with bf16 feat and out; offsets and masks float32
extern "C" int deform_sample_bf16_fwd(const void* feat, const void* offsets, const void* masks,
                                      void* out, int B, int H, int W, int C, void* stream) {
  return fwd_lanes<uint16_t>(feat, offsets, masks, out, B, H, W, C, stream);
}

// the flat design that preceded them, the yardsticks (on no path): the
// arguments of deform_sample_fwd and deform_sample_bf16_fwd
extern "C" int deform_sample_flat_fwd(const void* feat, const void* offsets, const void* masks,
                                      void* out, int B, int H, int W, int C, void* stream) {
  return fwd<float>(feat, offsets, masks, out, B, H, W, C, stream);
}

extern "C" int deform_sample_flat_bf16_fwd(const void* feat, const void* offsets, const void* masks,
                                           void* out, int B, int H, int W, int C, void* stream) {
  return fwd<uint16_t>(feat, offsets, masks, out, B, H, W, C, stream);
}
