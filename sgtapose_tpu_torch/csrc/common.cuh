// Helpers shared by the port's CUDA sources: the SM count of the current
// device, and bf16 <-> float32 (a bf16 is held as its 16 bits, uint16_t).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

// the low and high bf16 of a 32-bit word as floats (exact: a 16-bit shift)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf16f(uint16_t h) { return __uint_as_float((uint32_t)h << 16); }

// an element of T (float, or bf16 as uint16_t) as a float
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t h) { return bf16f(h); }

// float32 -> bf16, round to nearest even
__device__ __forceinline__ uint16_t to_bf16(float x) {
  uint16_t h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return h;
}

}  // namespace
