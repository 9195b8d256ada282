// int8 convolution: s8 x s8 -> s32 implicit GEMM, NHWC, with the rescale
// epilogue of the JAX package's int8 serving mode.
//
// Replaces sgtapose_tpu/models/layers.py:_int8_conv (:155-195), the
// `lax.conv_general_dilated(x_q int8, w_q int8, preferred_element_type=int32)`
// that XLA runs on the TPU's MXU under `quantized("int8")`, followed by its
// rescale and the flax bias add. Not a Pallas kernel; every quantizable site
// of the model (`models/layers.py`: the trunk's and the decoder's convs, the
// heads' 3x3, the DCN's (9C -> O) contraction over its sampled columns) runs
// here under --quant int8.
//
//   acc[m, o]  = sum_k x_q[m, k] w_q[o, k]                       (exact s32)
//   out[m, o]  = to_out(float(acc) * (w_scale[o] * a_scale[n(m)]))
//   out[m, o]  = to_out(float(out[m, o]) + float(bias[o]))       (with a bias)
//
// m runs over the output pixels (n, oy, ox) of NHWC x_q (N, H, W, C); k over
// (ky, kx, c) of the weight, stored (O, Kp) row-major with K = KH KW C
// zero-padded to Kp, a multiple of 32; the input pixel of (m, k) is
// (oy*stride - pad + ky, ox*stride - pad + kx), zero outside the map. The
// epilogue is JAX's, in JAX's order: the product of the two scales first, in
// float32; the accumulator times it, rounded to float32, then to the output
// dtype (float32 or bf16); then the bias in the output dtype (flax adds it
// after the conv). Every step is rounded on its own (__fmul_rn, __fadd_rn:
// no contraction into an FMA). a_scale is per image: the batched runner's
// per-video scales, expanded by the caller.
//
// What bounds it on an H100: at the flagship's 3x3 sites (K = 576 ... 4608,
// O = 64 ... 512) operations, against the 1,979 TOP/s of dense int8 on the
// tensor cores; at the small-channel sites (the stems, C_in 1 and 3, and the
// 16- and 32-channel levels) bytes. Design, a simple one first (no TMA, no
// wgmma s8): a block of 8 warps computes a 128-pixel x 64-output tile with
// `mma.sync.aligned.m16n8k32` s8 (each warp 32 x 32: 2 x 4 mma per 32-deep
// step, s32 accumulators in registers); each step's A tile (128 x 32 bytes,
// gathered from the image: 16-byte loads where C % 16 == 0, byte loads for
// the stems' C_in of 1 and 3) and B tile (64 x 32 bytes) go through
// registers into a double-buffered shared-memory tile (rows padded to 48
// bytes: conflict-free fragment reads), one barrier a step, the next step's
// global loads in flight during this step's mma. The s32 accumulators can be
// written out beside the result (acc_out, for the checks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // K bytes per step (one mma k32)
constexpr int ROW = 48;  // shared-memory row pitch in bytes (32 + 16 pad)
constexpr int THREADS = 256;

struct Geom {
  int N, H, W, C, O, KH, KW, stride, pad, Ho, Wo, K, Kp, M;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the output element (float32, or bf16 held as uint16_t) and its store
__device__ __forceinline__ void store_out(float* out, long i, float v, const float* bias, int o) {
  if (bias != nullptr) v = __fadd_rn(v, bias[o]);
  out[i] = v;
}
__device__ __forceinline__ void store_out(uint16_t* out, long i, float v, const uint16_t* bias, int o) {
  uint16_t h = to_bf16(v);
  if (bias != nullptr) h = to_bf16(__fadd_rn(bf16f(h), bf16f(bias[o])));
  out[i] = h;
}

template <typename OutT, bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const int8_t* __restrict__ x,
                                                            const int8_t* __restrict__ w,
                                                            const float* __restrict__ w_scale,
                                                            const float* __restrict__ a_scale,
                                                            const OutT* __restrict__ bias, OutT* __restrict__ out,
                                                            int32_t* __restrict__ acc_out, Geom g) {
  __shared__ __align__(16) uint8_t As[2][BM * ROW];
  __shared__ __align__(16) uint8_t Bs[2][BN * ROW];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, o0 = blockIdx.y * BN;

  // this thread's A row (output pixel) and 16-byte half of the 32-deep step
  const int ar = tid >> 1, ah = tid & 1;
  const int am = m0 + ar;
  const bool a_live = am < g.M;
  int iy0 = 0, ix0 = 0;
  const int8_t* img = x;
  if (a_live) {
    const int hw = g.Ho * g.Wo;
    const int n = am / hw, rem = am - n * hw;
    const int oy = rem / g.Wo, ox = rem - oy * g.Wo;
    iy0 = oy * g.stride - g.pad;
    ix0 = ox * g.stride - g.pad;
    img = x + (long)n * g.H * g.W * g.C;
  }
  // this thread's B row (output channel) and half; threads 128.. load none
  const int br = (tid & 127) >> 1, bh = tid & 1;
  const bool b_thread = tid < 128;
  const bool b_live = b_thread && (o0 + br) < g.O;
  const int8_t* wrow = w + (long)(o0 + br) * g.Kp + bh * 16;

  auto load_a = [&](int k0) -> int4 {
    int4 v = make_int4(0, 0, 0, 0);
    if (!a_live) return v;
    const int kb = k0 + ah * 16;
    if (VEC) {
      if (kb < g.K) {
        const int tap = kb / g.C, c = kb - tap * g.C;
        const int ky = tap / g.KW, kx = tap - ky * g.KW;
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
          v = __ldg(reinterpret_cast<const int4*>(img + ((long)iy * g.W + ix) * g.C + c));
      }
    } else {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = kb + j;
        if (k < g.K) {
          const int tap = k / g.C, c = k - tap * g.C;
          const int ky = tap / g.KW, kx = tap - ky * g.KW;
          const int iy = iy0 + ky, ix = ix0 + kx;
          if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
            const uint32_t byte = (uint8_t)__ldg(img + ((long)iy * g.W + ix) * g.C + c);
            word[j >> 2] |= byte << (8 * (j & 3));
          }
        }
      }
      v = make_int4((int)word[0], (int)word[1], (int)word[2], (int)word[3]);
    }
    return v;
  };
  auto load_b = [&](int k0) -> int4 {
    if (!b_live) return make_int4(0, 0, 0, 0);
    return __ldg(reinterpret_cast<const int4*>(wrow + k0));
  };
  auto stash = [&](int buf, int4 va, int4 vb) {
    *reinterpret_cast<int4*>(&As[buf][ar * ROW + ah * 16]) = va;
    if (b_thread) *reinterpret_cast<int4*>(&Bs[buf][br * ROW + bh * 16]) = vb;
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gid = lane >> 2, tig = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int steps = g.Kp / BK;
  stash(0, load_a(0), load_b(0));
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    int4 na = make_int4(0, 0, 0, 0), nb = make_int4(0, 0, 0, 0);
    const bool more = s + 1 < steps;
    if (more) {
      na = load_a((s + 1) * BK);
      nb = load_b((s + 1) * BK);
    }
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = &As[buf][(wm + i * 16 + gid) * ROW + tig * 4];
      const uint8_t* r8 = r0 + 8 * ROW;
      a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* r = &Bs[buf][(wn + j * 8 + gid) * ROW + tig * 4];
      b[j][0] = *reinterpret_cast<const uint32_t*>(r);
      b[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    if (more) stash(buf ^ 1, na, nb);
    __syncthreads();
  }

  // epilogue: c0, c1 at row gid, columns 2 tig, 2 tig + 1; c2, c3 at row gid + 8
  const int hw = g.Ho * g.Wo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= g.M) continue;
      const float as = a_scale[m / hw];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + j * 8 + tig * 2 + e;
          if (o >= g.O) continue;
          const int v = acc[i][j][half * 2 + e];
          const long idx = (long)m * g.O + o;
          if (acc_out != nullptr) acc_out[idx] = v;
          const float scale = __fmul_rn(w_scale[o], as);
          store_out(out, idx, __fmul_rn(__int2float_rn(v), scale), bias, o);
        }
      }
    }
  }
}

template <typename OutT>
int launch(const void* x, const void* w, const void* w_scale, const void* a_scale, const void* bias,
           void* out, void* acc_out, const Geom& g, void* stream) {
  const dim3 grid((g.M + BM - 1) / BM, (g.O + BN - 1) / BN);
  const bool vec = g.C % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  void (*kernel)(const int8_t*, const int8_t*, const float*, const float*, const OutT*, OutT*, int32_t*, Geom) =
      vec ? int8_conv_kernel<OutT, true> : int8_conv_kernel<OutT, false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(w_scale),
      static_cast<const float*>(a_scale), static_cast<const OutT*>(bias), static_cast<OutT*>(out),
      static_cast<int32_t*>(acc_out), g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N,H,W,C) s8, w (O,Kp) s8, w_scale (O,) and a_scale (N,) float32, bias
// (O,) in the output dtype or null, out (N,Ho,Wo,O) float32 (out_bf16 = 0)
// or bf16, acc_out (N,Ho,Wo,O) s32 or null; returns cudaError_t
extern "C" int int8_conv_fwd(const void* x, const void* w, const void* w_scale, const void* a_scale,
                             const void* bias, void* out, void* acc_out, int N, int H, int W, int C, int O,
                             int KH, int KW, int stride, int pad, int Ho, int Wo, int Kp, int out_bf16,
                             void* stream) {
  Geom g{N, H, W, C, O, KH, KW, stride, pad, Ho, Wo, KH * KW * C, Kp, N * Ho * Wo};
  if (g.M == 0 || O == 0) return 0;
  if (Kp % BK != 0 || Kp < g.K) return (int)cudaErrorInvalidValue;
  return out_bf16 ? launch<uint16_t>(x, w, w_scale, a_scale, bias, out, acc_out, g, stream)
                  : launch<float>(x, w, w_scale, a_scale, bias, out, acc_out, g, stream);
}
