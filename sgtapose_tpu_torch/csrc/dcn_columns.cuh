// Helpers of the DCN column kernels (deform_sample.cu, deform_sample_bwd.cu):
// the sample coordinates of one (pixel, tap), formed once by one lane and
// handed to the lanes that cover its channels, and 16-byte vectors of
// channels as floats.
//
// Lane layout shared by both kernels: a warp takes G consecutive items
// (pixel, tap) at a time (`items_per_warp`); lane i forms item i's
// coordinates, then the warp walks the G items 32 / L at a time, L lanes (a
// power of two) per item, each lane VEC consecutive channels of the item per
// step, the item's coordinates taken from lane i by shuffles.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// the 4 bilinear corners (00, 01, 10, 11) of one (pixel, tap): the clamped
// cell index y * W + x of each, the fractional position, the mask, and the
// corners inside the map (bit j, corner j; a corner outside has weight 0
// and is read at its clamped index, as the reference does)
struct Corners {
  int idx[4];
  float fy, fx, mk;
  unsigned valid;
};

// the corners of tap `tap` of the pixel at (x, y), offset by (oy, ox)
__device__ __forceinline__ Corners corners_at(int x, int y, int tap, float oy, float ox, float mk, int H, int W) {
  Corners t;
  t.mk = mk;
  const float py = (float)(y + tap / 3 - 1) + oy;
  const float px = (float)(x + tap % 3 - 1) + ox;
  const float y0f = floorf(py), x0f = floorf(px);
  t.fy = py - y0f;
  t.fx = px - x0f;
  const int y0 = (int)y0f, x0 = (int)x0f, y1 = y0 + 1, x1 = x0 + 1;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  t.valid = (vy0 && vx0 ? 1u : 0u) | (vy0 && vx1 ? 2u : 0u) | (vy1 && vx0 ? 4u : 0u) | (vy1 && vx1 ? 8u : 0u);
  const int yc0 = min(max(y0, 0), H - 1), yc1 = min(max(y1, 0), H - 1);
  const int xc0 = min(max(x0, 0), W - 1), xc1 = min(max(x1, 0), W - 1);
  t.idx[0] = yc0 * W + xc0;
  t.idx[1] = yc0 * W + xc1;
  t.idx[2] = yc1 * W + xc0;
  t.idx[3] = yc1 * W + xc1;
  return t;
}

__device__ __forceinline__ Corners corners_of(unsigned item, const float* __restrict__ offsets,
                                              const float* __restrict__ masks, int H, int W) {
  const int tap = item % 9;
  const unsigned pix = item / 9;  // (b*H + y)*W + x
  return corners_at(pix % W, (pix / W) % H, tap, __ldg(offsets + (size_t)pix * 18 + 2 * tap),
                    __ldg(offsets + (size_t)pix * 18 + 2 * tap + 1), __ldg(masks + (size_t)pix * 9 + tap), H, W);
}

__device__ __forceinline__ Corners shfl_corners(const Corners& c, int src) {
  Corners t;
#pragma unroll
  for (int j = 0; j < 4; ++j) t.idx[j] = __shfl_sync(0xffffffffu, c.idx[j], src);
  t.fy = __shfl_sync(0xffffffffu, c.fy, src);
  t.fx = __shfl_sync(0xffffffffu, c.fx, src);
  t.mk = __shfl_sync(0xffffffffu, c.mk, src);
  t.valid = __shfl_sync(0xffffffffu, c.valid, src);
  return t;
}

// the bilinear weights with validity folded in, in the reference's order
__device__ __forceinline__ void corner_weights(const Corners& t, float (&w)[4]) {
  w[0] = (t.valid & 1u) ? (1.f - t.fy) * (1.f - t.fx) : 0.f;
  w[1] = (t.valid & 2u) ? (1.f - t.fy) * t.fx : 0.f;
  w[2] = (t.valid & 4u) ? t.fy * (1.f - t.fx) : 0.f;
  w[3] = (t.valid & 8u) ? t.fy * t.fx : 0.f;
}

// lanes per item: VEC channels a lane, at most a warp
inline int lanes_per_item(int C, int vec) {
  const int chunks = (C + vec - 1) / vec;
  int L = 1;
  while (L < chunks && L < 32) L *= 2;
  return L;
}

// items a warp takes at a time (G, a power of two from 32 / L to 32): 32
// where that still gives kMinWarps warps, else fewer, so a small map with
// wide channels (15 x 15 x 512 at batch 8: 16,200 items) fills the card
constexpr unsigned kMinWarps = 16384;
inline int items_per_warp(unsigned total, int L) {
  int G = 32;
  while (G > 32 / L && (total + G - 1) / G < kMinWarps) G /= 2;
  return G;
}

// VEC consecutive channels of T (float, or bf16 held as uint16_t) as
// floats: one 16-byte vector (VEC 4 float32, 8 bf16; 4 bf16, 8 bytes, for
// the flat sampler) or one element. `stream` loads skip the L1 and are
// evicted first (a stream read once); `store` writes VEC floats as T (bf16
// rounded once) evicted first, `put` (the flat sampler) with plain stores.
template <typename T, int VEC>
struct Chan;
template <>
struct Chan<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void stream(const float* p, float (&v)[1]) { v[0] = __ldcs(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { __stcs(p, v[0]); }
  static __device__ __forceinline__ void put(float* p, const float (&v)[1]) { *p = v[0]; }
};
template <>
struct Chan<float, 4> {
  static __device__ __forceinline__ void unpack(const float4 u, float (&v)[4]) {
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    unpack(__ldg(reinterpret_cast<const float4*>(p)), v);
  }
  static __device__ __forceinline__ void stream(const float* p, float (&v)[4]) {
    unpack(__ldcs(reinterpret_cast<const float4*>(p)), v);
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  static __device__ __forceinline__ void put(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Chan<uint16_t, 1> {
  static __device__ __forceinline__ void load(const uint16_t* p, float (&v)[1]) { v[0] = bf16f(__ldg(p)); }
  static __device__ __forceinline__ void stream(const uint16_t* p, float (&v)[1]) {
    v[0] = bf16f((uint16_t)__ldcs(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&v)[1]) { *p = to_bf16(v[0]); }
  static __device__ __forceinline__ void put(uint16_t* p, const float (&v)[1]) { *p = to_bf16(v[0]); }
};
template <>
struct Chan<uint16_t, 4> {
  static __device__ __forceinline__ void unpack(const uint2 u, float (&v)[4]) {
    v[0] = bf_lo(u.x); v[1] = bf_hi(u.x); v[2] = bf_lo(u.y); v[3] = bf_hi(u.y);
  }
  static __device__ __forceinline__ void load(const uint16_t* p, float (&v)[4]) {
    unpack(__ldg(reinterpret_cast<const uint2*>(p)), v);
  }
  static __device__ __forceinline__ void stream(const uint16_t* p, float (&v)[4]) {
    unpack(__ldcs(reinterpret_cast<const uint2*>(p)), v);
  }
  static __device__ __forceinline__ void put(uint16_t* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2((uint32_t)to_bf16(v[0]) | ((uint32_t)to_bf16(v[1]) << 16),
                                              (uint32_t)to_bf16(v[2]) | ((uint32_t)to_bf16(v[3]) << 16));
  }
};
template <>
struct Chan<uint16_t, 8> {
  static __device__ __forceinline__ void unpack(const uint4 u, float (&v)[8]) {
    v[0] = bf_lo(u.x); v[1] = bf_hi(u.x); v[2] = bf_lo(u.y); v[3] = bf_hi(u.y);
    v[4] = bf_lo(u.z); v[5] = bf_hi(u.z); v[6] = bf_lo(u.w); v[7] = bf_hi(u.w);
  }
  static __device__ __forceinline__ void load(const uint16_t* p, float (&v)[8]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  static __device__ __forceinline__ void stream(const uint16_t* p, float (&v)[8]) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  }
  static __device__ __forceinline__ uint32_t pack2(float a, float b) {
    return (uint32_t)to_bf16(a) | ((uint32_t)to_bf16(b) << 16);
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7])));
  }
};

// The sampling backward's arithmetic (deform_sample_bwd.cu, deform_conv_dgrad_bf16.cu)

// VEC floats added into p (16-byte aligned when VEC > 1)
template <int VEC>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    atomicAdd(p, v[0]);
  } else {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
}

// the per-(pixel, tap) factors: bilinear weights and their derivatives
// along y and x, validity folded in
struct Factors {
  float w[4], cy[4], cx[4];
};

__device__ __forceinline__ Factors factors_of(const Corners& t) {
  Factors f;
  corner_weights(t, f.w);
  const bool v00 = t.valid & 1u, v01 = t.valid & 2u, v10 = t.valid & 4u, v11 = t.valid & 8u;
  f.cy[0] = v00 ? -(1.f - t.fx) : 0.f;
  f.cy[1] = v01 ? -t.fx : 0.f;
  f.cy[2] = v10 ? 1.f - t.fx : 0.f;
  f.cy[3] = v11 ? t.fx : 0.f;
  f.cx[0] = v00 ? -(1.f - t.fy) : 0.f;
  f.cx[1] = v01 ? 1.f - t.fy : 0.f;
  f.cx[2] = v10 ? -t.fy : 0.f;
  f.cx[3] = v11 ? t.fy : 0.f;
  return f;
}

// VEC channels of one (pixel, tap): the three channel sums (dm = samp . g,
// gy, gx) and the corners' updates r[q] = g mask w_q
template <int VEC>
__device__ __forceinline__ void item_chunk(const float (&gc)[VEC], const float (&v)[4][VEC], const Factors& f,
                                           float mk, float& dm, float& gy, float& gx, float (&r)[4][VEC]) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    float samp = v[0][u] * f.w[0];
    samp = samp + v[1][u] * f.w[1];
    samp = samp + v[2][u] * f.w[2];
    samp = samp + v[3][u] * f.w[3];
    dm = fmaf(samp, gc[u], dm);
    const float ds = gc[u] * mk;
    gy = fmaf(ds, v[0][u] * f.cy[0] + v[1][u] * f.cy[1] + v[2][u] * f.cy[2] + v[3][u] * f.cy[3], gy);
    gx = fmaf(ds, v[0][u] * f.cx[0] + v[1][u] * f.cx[1] + v[2][u] * f.cx[2] + v[3][u] * f.cx[3], gx);
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q][u] = ds * f.w[q];
  }
}

// float32 sums rounded once to bf16 (a grid-stride loop of 256-thread
// blocks), 4 a thread where n % 4 == 0
__device__ __forceinline__ void round_body(const float* __restrict__ src, uint16_t* __restrict__ dst, long long n) {
  const long long stride = (long long)gridDim.x * 256;
  if (n % 4 == 0) {
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n / 4; i += stride) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(src) + i);
      reinterpret_cast<uint2*>(dst)[i] = make_uint2((uint32_t)to_bf16(v.x) | ((uint32_t)to_bf16(v.y) << 16),
                                                    (uint32_t)to_bf16(v.z) | ((uint32_t)to_bf16(v.w) << 16));
    }
  } else {
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += stride) dst[i] = to_bf16(src[i]);
  }
}

// blocks of round_body for n elements
inline unsigned round_blocks(long long n) {
  const long long blocks = ((n % 4 == 0 ? n / 4 : n) + 255) / 256;
  return (unsigned)(blocks < 8192 ? blocks : 8192);
}

}  // namespace
