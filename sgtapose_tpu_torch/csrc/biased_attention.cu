// Biased attention forward: out = softmax(q k^T / sqrt(d) + bias) v.
//
// Replaces the Pallas TPU kernel sgtapose_tpu/ops/attention_kernel.py:55-116
// (_fwd_kernel, called from _fwd at :108, reached by fused_biased_attention
// at :131-138): same function, float32 arithmetic, no logits in device memory.
//
// Shapes: q, k, v, out are (B, heads, n, d) contiguous float32; bias is a
// learned (heads, n, n) float32 tensor shared across the batch. On the
// flagship model (n, d) is (1183, 4), (343, 8) and (63, 16).
//
// What bounds it on an H100: bytes. d <= 16, so the products are ~0.18 GFLOP
// at level 0 (0.003 ms at 67 TFLOP/s); the work is reading the bias once
// (8 * 1183^2 * 4 B = 44.8 MB at level 0, 13.4 us at 3.35 TB/s). No tensor
// cores: at d = 4..16 a product tile would be a few percent full, and the
// FMAs are not what takes the time. The design keeps the bias stream busy:
//   * work items are (batch, head, tile of RS query rows); one tile's bias
//     rows are one contiguous span, copied to shared memory with 16-byte
//     cp.async from its 16-byte-aligned start (the span of a 1183-wide row
//     starts anywhere, so the offset is carried into the index math; a 2-D
//     tensor map cannot describe rows of 4732 B);
//   * a persistent grid (as many blocks as fit on the 132 SMs: 2 per SM at
//     level 0, 113.6 KB each) walks contiguous runs of items through a
//     2-stage ring per block, so one span per block (~38 KB at level 0, 76 KB
//     per SM) is in flight while the other is computed; K and V of the
//     item's (batch, head) are loaded into shared memory only when it
//     changes, by cp.async in a group ahead of the next item's bias span, and
//     each thread's next query row is loaded one item ahead;
//   * a row's whole bias is in shared memory, so its softmax takes two passes
//     over it: pass 1 writes the logits over the bias and takes the row max;
//     pass 2 sums p = 2^(s log2 e - max log2 e) (one FMA and one MUFU.EX2)
//     and p v. One exponential per element and no rescaling;
//   * the 32 lanes of a warp share a row, lane t taking keys t, t+32, ...;
//     their partial sums (all relative to the same max) are added with
//     shuffles. A block finishes each of its 8 rows in one round of loads;
//     at level 2 (n = 63, the whole bias 127 KB) that is 64 items on 64
//     blocks (8 lanes a row and 32 rows a block was slower there: fewer,
//     longer items lose when all is latency);
//   * the ragged n edge is masked in the kernel: nothing is padded.
// What still holds level 0 above its bound (PERF.md): the start-up of each
// launch (K/V and first span, 4-5 items a block), and the two passes'
// shared-memory traffic, ~44 B per (row, key), most of it K and V as float4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int RS = kWarps;  // rows per work item: one per warp
// two stages: the K/V group of item t is committed after item t's span and
// before item t+1's, so waiting for all but the newest group covers both
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(float* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A global load the compiler may not sink to its use (the next item's query
// row is loaded one item ahead, and must stay ahead).
__device__ __forceinline__ float4 ld_nc4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Float offset of p inside its 16-byte line.
__device__ __forceinline__ int line_offset(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Copy the floats [start, end) to dst + line_offset(start), in whole 16-byte
// lines. The lines at both ends hold valid floats, so no read leaves the
// allocation's pages.
__device__ __forceinline__ void issue_span(float* dst, const float* start, const float* end) {
  const char* a0 = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(start) & ~(uintptr_t)15);
  const int lines = (int)((reinterpret_cast<const char*>(end) - a0 + 15) >> 4);
  for (int c = threadIdx.x; c < lines; c += kThreads) cp_async16(dst + 4 * c, a0 + 16 * c);
}

// 2^x for x <= 0: one MUFU.EX2 (results below 2^-126 flush to 0, which a
// softmax weight relative to its row max can ignore)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ float dot(const float (&qr)[D], const float* kj) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = reinterpret_cast<const float4*>(kj)[c];
    s = fmaf(qr[4 * c], x.x, s);
    s = fmaf(qr[4 * c + 1], x.y, s);
    s = fmaf(qr[4 * c + 2], x.z, s);
    s = fmaf(qr[4 * c + 3], x.w, s);
  }
  return s;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    biased_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ out, int heads, int n, int tiles, int items,
                            float scale, int stage_floats) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [n][D]
  float* vs = smem + n * D;       // [n][D]
  float* ring = smem + 2 * n * D;  // kStages x stage_floats

  const int per = items / gridDim.x, extra = items % gridDim.x;
  const int it0 = blockIdx.x * per + min((int)blockIdx.x, extra);
  const int it1 = it0 + per + ((int)blockIdx.x < extra ? 1 : 0);

  auto span_start = [&](int t) {
    const int h = (t / tiles) % heads, r0 = (t % tiles) * RS;
    return bias + ((size_t)h * n + r0) * n;
  };
  auto issue = [&](int t, int slot) {
    if (t < it1) {
      const int h = (t / tiles) % heads, r0 = (t % tiles) * RS, r1 = min(r0 + RS, n);
      issue_span(ring + slot * stage_floats, span_start(t), bias + ((size_t)h * n + r1) * n);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
  issue(it0, 0);

  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  // this warp's query row of item t, loaded one item ahead
  auto load_q = [&](int t, float (&dst)[D]) {
    const int row = min((t % tiles) * RS + warp, n - 1);
    const float* qi = q + ((size_t)(t / tiles) * n + row) * D;
#pragma unroll
    for (int c = 0; c < D / 4; ++c) {
      const float4 x = ld_nc4(qi + 4 * c);
      dst[4 * c] = x.x;
      dst[4 * c + 1] = x.y;
      dst[4 * c + 2] = x.z;
      dst[4 * c + 3] = x.w;
    }
  };
  float qr[D], qn[D];
  if (it0 < it1) load_q(it0, qn);
  int kv_bh = -1;
  for (int t = it0; t < it1; ++t) {
    const int local = t - it0;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = qn[c];
    if (t + 1 < it1) load_q(t + 1, qn);
    const int bh = t / tiles;
    const int i = (t % tiles) * RS + warp;  // this warp's row
    if (bh != kv_bh) {  // the same for the whole block
      const float* kg = k + (size_t)bh * n * D;
      const float* vg = v + (size_t)bh * n * D;
      for (int e = threadIdx.x; e < n * D / 4; e += kThreads) {
        cp_async16(ks + 4 * e, kg + 4 * e);
        cp_async16(vs + 4 * e, vg + 4 * e);
      }
      cp_async_commit();
      kv_bh = bh;
    }
    issue(t + 1, (local + 1) % kStages);
    cp_async_wait<1>();
    __syncthreads();

    float* sb = ring + (local % kStages) * stage_floats + line_offset(span_start(t)) + warp * n;
    const int jend = i < n ? n : 0;  // a warp past n computes nothing and stores nothing

    // pass 1: logits over the bias, and the row max
    float m = -INFINITY;
#pragma unroll 4
    for (int j = lt; j < jend; j += 32) {
      const float s = fmaf(dot<D>(qr, ks + j * D), scale, sb[j]);
      sb[j] = s;
      m = fmaxf(m, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float neg_m2 = -m * kLog2e;  // exp(s - max) = 2^(s log2 e - max log2 e)

    // pass 2: one exp2 per element, sums relative to the row max
    float l = 0.f, acc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = 0.f;
#pragma unroll 4
    for (int j = lt; j < jend; j += 32) {
      const float p = exp2_ftz(fmaf(sb[j], kLog2e, neg_m2));
      l += p;
      const float4* vj = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 x = vj[c];
        acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
    if (i < n) {
      float* oi = out + ((size_t)bh * n + i) * D;
      const float inv = 1.f / l;
#pragma unroll
      for (int c = 0; c < D; ++c)
        if ((c & 31) == lt) oi[c] = acc[c] * inv;
    }
    __syncthreads();  // the slot and K/V are free for the next item's writes
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias, float* out, int B,
           int heads, int n, cudaStream_t stream) {
  const int stage_floats = 4 * ((RS * n + 3 + 3) / 4);
  const size_t smem = (2 * (size_t)n * D + (size_t)kStages * stage_floats) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = biased_attention_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (n + RS - 1) / RS;
  const long long items = (long long)B * heads * tiles;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(items < slots ? items : slots);
  kern<<<grid, kThreads, smem, stream>>>(q, k, v, bias, out, heads, n, tiles, (int)items,
                                         1.f / sqrtf((float)D), stage_floats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int biased_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, int B, int heads, int n, int d, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  // q/k/v rows are read as float4
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (d) {
    case 4: return launch<4>(qf, kf, vf, bf, of, B, heads, n, s);
    case 8: return launch<8>(qf, kf, vf, bf, of, B, heads, n, s);
    case 16: return launch<16>(qf, kf, vf, bf, of, B, heads, n, s);
    case 32: return launch<32>(qf, kf, vf, bf, of, B, heads, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
