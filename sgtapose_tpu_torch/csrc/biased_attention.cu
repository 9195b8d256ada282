// Biased attention forward: out = softmax(q k^T / sqrt(d) + bias) v, one
// design in two instantiations: float32 (biased_attention_fwd) and bf16
// serving (biased_attention_bf16_fwd).
//
// Replaces the Pallas TPU kernel sgtapose_tpu/ops/attention_kernel.py:55-116
// (_fwd_kernel, called from _fwd at :108, reached by fused_biased_attention
// at :131-138): same function, float32 arithmetic, no logits in device memory.
//
// Shapes: q, k, v are (B, heads, n, d) contiguous; bias is a learned
// (heads, n, n) tensor shared across the batch; out is (B, heads, n, d)
// float32. On the flagship model (n, d) is (1183, 4), (343, 8) and (63, 16).
//   * float32: q, k, v and bias float32.
//   * bf16 serving: the arithmetic of the JAX package's DEFAULT (einsum)
//     attention under bf16 (sgtapose_tpu/models/attention.py:175-180), which
//     the detector runs (fused_attention=False). k, v and the bias (pos_embed)
//     are bf16. On the first of the 3 tied layers q is bf16 and einsum(q, k)
//     returns bf16, so the q.k logit is rounded to bf16 before the scale; on
//     the later layers q comes from a float32 LayerNorm and nothing is
//     rounded. Dividing by the float32 sqrt(d) makes the logits float32; the
//     bias add, the softmax and p.v run in float32 and the output is float32.
//     bf16 -> float32 is a 16-bit shift, done as elements are read.
//
// What bounds it on an H100: bytes. d <= 16, so the products are ~0.18 GFLOP
// at level 0 (0.003 ms at 67 TFLOP/s); the work is reading the bias once
// (8 * 1183^2 elements: 44.8 MB float32, 13.4 us at 3.35 TB/s; 22.4 MB bf16,
// 6.7 us). No tensor cores: at d = 4..16 a product tile would be a few percent
// full, and the FMAs are not what takes the time. The design keeps the bias
// stream busy:
//   * work items are (batch, head, tile of RS query rows); one tile's bias
//     rows are one contiguous span, copied to shared memory with 16-byte
//     cp.async from its 16-byte-aligned start (the span of a 1183-wide row
//     starts anywhere, so the byte offset is carried into the index math; a
//     2-D tensor map cannot describe rows of 4732 B);
//   * a persistent grid (as many blocks as fit on the 132 SMs: 2 per SM at
//     level 0 in float32, 113.6 KB each) walks contiguous runs of items
//     through a 2-stage ring per block, so one span per block (~38 KB at
//     level 0 in float32) is in flight while the other is computed; K and V
//     of the item's (batch, head) are copied to shared memory the same way
//     (a bf16 block of n*d at d = 4 is not a whole number of lines) only when
//     it changes, by cp.async in a group ahead of the next item's bias span,
//     and each thread's next query row is loaded one item ahead;
//   * a row's whole bias is in shared memory, so its softmax takes two passes
//     over it: pass 1 takes the row max of the logits (in float32 it writes
//     them over the bias; a bf16 span cannot hold float32 logits in place, so
//     bf16 recomputes them in pass 2: d <= 16 FMAs from shared memory cost
//     less than a float32 row buffer's traffic); pass 2 sums
//     p = 2^(s log2 e - max log2 e) (one FMA and one MUFU.EX2) and p v. One
//     exponential per element and no rescaling;
//   * the 32 lanes of a warp share a row, lane t taking keys t, t+32, ...;
//     their partial sums (all relative to the same max) are added with
//     shuffles. A block finishes each of its 8 rows in one round of loads;
//     at level 2 (n = 63, the whole bias 127 KB) that is 64 items on 64
//     blocks (8 lanes a row and 32 rows a block was slower there: fewer,
//     longer items lose when all is latency);
//   * the ragged n edge is masked in the kernel: nothing is padded.
// What still holds level 0 above its bound (PERF.md): the start-up of each
// launch (K/V and first span, 4-5 items a block), and the two passes'
// shared-memory traffic, ~44 B per (row, key) in float32, most of it K and V.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int RS = kWarps;  // rows per work item: one per warp
// two stages: the K/V group of item t is committed after item t's span and
// before item t+1's, so waiting for all but the newest group covers both
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
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

// Global loads the compiler may not sink to their use (the next item's query
// row is loaded one item ahead, and must stay ahead).
__device__ __forceinline__ uint4 ld_nc_u4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint2 ld_nc_u2(const void* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// Byte offset of p inside its 16-byte line.
__device__ __forceinline__ int line_offset(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Copy the bytes [start, end) to dst + line_offset(start), in whole 16-byte
// lines. The lines at both ends hold valid elements, so no read leaves the
// allocation's pages.
__device__ __forceinline__ void issue_span(unsigned char* dst, const void* start, const void* end) {
  const char* a0 = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(start) & ~(uintptr_t)15);
  const int lines = (int)((reinterpret_cast<const char*>(end) - a0 + 15) >> 4);
  for (int c = threadIdx.x; c < lines; c += kThreads) cp_async16(dst + 16 * c, a0 + 16 * c);
}

// bytes of a span of `elems` elements of `size` bytes copied in whole lines
// from any element-aligned start: up to 16 - size bytes of line offset
int span_bytes(long long elems, int size) { return (int)(16 * ((size * elems + 16 - size + 15) / 16)); }

// float32 -> bf16 -> float32, round to nearest even
__device__ __forceinline__ float round_bf16(float x) { return bf16f(to_bf16(x)); }

// 2^x for x <= 0: one MUFU.EX2 (results below 2^-126 flush to 0, which a
// softmax weight relative to its row max can ignore)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the floats of a 16-byte word: 4 float32 or 8 bf16
template <typename T>
__device__ __forceinline__ void unpack16(uint4 u, float* r) {
  if constexpr (sizeof(T) == 4) {
    r[0] = __uint_as_float(u.x); r[1] = __uint_as_float(u.y);
    r[2] = __uint_as_float(u.z); r[3] = __uint_as_float(u.w);
  } else {
    r[0] = bf_lo(u.x); r[1] = bf_hi(u.x); r[2] = bf_lo(u.y); r[3] = bf_hi(u.y);
    r[4] = bf_lo(u.z); r[5] = bf_hi(u.z); r[6] = bf_lo(u.w); r[7] = bf_hi(u.w);
  }
}

// The D elements of T at p as floats: a row is whole 16-byte words, or 8
// bytes (D = 4 bf16). GLOBAL: p is in device memory, loaded with ld_nc.
template <int D, typename T, bool GLOBAL>
__device__ __forceinline__ void load_row(const unsigned char* p, float (&r)[D]) {
  if constexpr (D * sizeof(T) < 16) {
    uint2 u;
    if constexpr (GLOBAL) u = ld_nc_u2(p);
    else u = *reinterpret_cast<const uint2*>(p);
    r[0] = bf_lo(u.x); r[1] = bf_hi(u.x); r[2] = bf_lo(u.y); r[3] = bf_hi(u.y);
  } else {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < D / per; ++c) {
      uint4 u;
      if constexpr (GLOBAL) u = ld_nc_u4(p + 16 * c);
      else u = reinterpret_cast<const uint4*>(p)[c];
      unpack16<T>(u, r + per * c);
    }
  }
}

// q.k / sqrt(d) + b; with ROUND (bf16 q and k) the dot is rounded to bf16
template <int D, typename T, bool ROUND>
__device__ __forceinline__ float logit(const float (&qr)[D], const unsigned char* kj, float scale,
                                       float b) {
  float kr[D];
  load_row<D, T, false>(kj, kr);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) s = fmaf(qr[c], kr[c], s);
  if (ROUND) s = round_bf16(s);  // einsum of two bf16 operands returns bf16
  return fmaf(s, scale, b);
}

// T: element of k, v and bias (float, or bf16 as uint16_t); TQ: of q
template <int D, typename T, typename TQ>
__device__ __forceinline__ void attention_body(const TQ* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, const T* __restrict__ bias,
                                               float* __restrict__ out, int heads, int n, int tiles,
                                               int items, float scale, int stage_bytes, int kv_bytes) {
  constexpr bool kInPlace = sizeof(T) == 4;  // pass 1 writes the logits over the bias
  constexpr bool kRound = sizeof(T) == 2 && sizeof(TQ) == 2;
  constexpr int kRow = D * sizeof(T);  // bytes of a K or V row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;  // [n][D] at the K/V block's line offset
  unsigned char* vs = smem + kv_bytes;
  unsigned char* ring = smem + 2 * kv_bytes;  // kStages x stage_bytes

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
      issue_span(ring + slot * stage_bytes, span_start(t), bias + ((size_t)h * n + r1) * n);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
  issue(it0, 0);

  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  // this warp's query row of item t, loaded one item ahead
  auto load_q = [&](int t, float (&dst)[D]) {
    const size_t row = (size_t)(t / tiles) * n + min((t % tiles) * RS + warp, n - 1);
    load_row<D, TQ, true>(reinterpret_cast<const unsigned char*>(q + row * D), dst);
  };
  float qr[D], qn[D];
  if (it0 < it1) load_q(it0, qn);
  int kv_bh = -1, kv_off = 0;
  for (int t = it0; t < it1; ++t) {
    const int local = t - it0;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = qn[c];
    if (t + 1 < it1) load_q(t + 1, qn);
    const int bh = t / tiles;
    const int i = (t % tiles) * RS + warp;  // this warp's row
    if (bh != kv_bh) {  // the same for the whole block
      const T* kg = k + (size_t)bh * n * D;
      const T* vg = v + (size_t)bh * n * D;
      issue_span(ks, kg, kg + (size_t)n * D);
      issue_span(vs, vg, vg + (size_t)n * D);
      cp_async_commit();
      kv_bh = bh;
      kv_off = line_offset(kg);  // k and v share it: both bases are 16-byte aligned
    }
    issue(t + 1, (local + 1) % kStages);
    cp_async_wait<1>();
    __syncthreads();

    T* sb = reinterpret_cast<T*>(ring + (local % kStages) * stage_bytes + line_offset(span_start(t))) +
            warp * n;
    const unsigned char* kb = ks + kv_off;
    const unsigned char* vb = vs + kv_off;
    const int jend = i < n ? n : 0;  // a warp past n computes nothing and stores nothing

    // pass 1: the row max of the logits (float32: written over the bias)
    float m = -INFINITY;
#pragma unroll 4
    for (int j = lt; j < jend; j += 32) {
      const float s = logit<D, T, kRound>(qr, kb + j * kRow, scale, to_float(sb[j]));
      if constexpr (kInPlace) sb[j] = s;
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
      float s;
      if constexpr (kInPlace) s = sb[j];
      else s = logit<D, T, kRound>(qr, kb + j * kRow, scale, to_float(sb[j]));
      const float p = exp2_ftz(fmaf(s, kLog2e, neg_m2));
      l += p;
      float vr[D];
      load_row<D, T, false>(vb + j * kRow, vr);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
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

// one kernel name per precision, as profilers list them
template <int D>
__global__ void __launch_bounds__(kThreads)
    biased_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ out, int heads, int n, int tiles, int items,
                            float scale, int stage_bytes, int kv_bytes) {
  attention_body<D, float, float>(q, k, v, bias, out, heads, n, tiles, items, scale, stage_bytes,
                                  kv_bytes);
}

template <int D, typename TQ>
__global__ void __launch_bounds__(kThreads)
    biased_attention_bf16_kernel(const TQ* __restrict__ q, const uint16_t* __restrict__ k,
                                 const uint16_t* __restrict__ v, const uint16_t* __restrict__ bias,
                                 float* __restrict__ out, int heads, int n, int tiles, int items,
                                 float scale, int stage_bytes, int kv_bytes) {
  attention_body<D, uint16_t, TQ>(q, k, v, bias, out, heads, n, tiles, items, scale, stage_bytes,
                                  kv_bytes);
}

template <int D, typename T, typename TQ>
int launch(const TQ* q, const T* k, const T* v, const T* bias, float* out, int B, int heads, int n,
           cudaStream_t stream) {
  const int stage_bytes = span_bytes((long long)RS * n, sizeof(T));
  const int kv_bytes = span_bytes((long long)n * D, sizeof(T));
  const size_t smem = 2 * (size_t)kv_bytes + (size_t)kStages * stage_bytes;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = [] {
    if constexpr (sizeof(T) == 4) return biased_attention_kernel<D>;
    else return biased_attention_bf16_kernel<D, TQ>;
  }();
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
                                         1.f / sqrtf((float)D), stage_bytes, kv_bytes);
  return (int)cudaGetLastError();
}

template <typename T, typename TQ>
int fwd(const void* q, const void* k, const void* v, const void* bias, void* out, int B, int heads,
        int n, int d, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  // q rows are read as 8- or 16-byte vectors; K/V spans start at the same
  // line offset in shared memory as in device memory; the bias is read in
  // elements
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bias) & (sizeof(T) - 1)) != 0)
    return (int)cudaErrorMisalignedAddress;
  const TQ* qt = static_cast<const TQ*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* bt = static_cast<const T*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 4: return launch<4, T, TQ>(qt, kt, vt, bt, of, B, heads, n, s);
    case 8: return launch<8, T, TQ>(qt, kt, vt, bt, of, B, heads, n, s);
    case 16: return launch<16, T, TQ>(qt, kt, vt, bt, of, B, heads, n, s);
    case 32: return launch<32, T, TQ>(qt, kt, vt, bt, of, B, heads, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- key-tiled float32 forward: any n ----------------------------------
// The design above holds a head's whole K and V and a tile's whole bias rows
// in shared memory, which caps n (about 2400 at d = 4, 1800 at d = 8). A
// 42-keypoint model at the flagship windows has n = 42 x 13^2 = 7098 at
// level 0 (d = 4) and 42 x 7^2 = 2058 at level 1 (d = 8): its bias alone is
// 1.6 GB. There the work is still reading the bias once, so this kernel
// streams it straight from device memory, one coalesced 128-byte read per
// warp and 32 keys, and stages only K and V, in chunks of kTileKeys keys
// shared by the block's 8 rows. One block per (batch, head, 8 query rows),
// one warp per row, lane t taking keys t, t+32, ... as above. Each lane runs
// an online softmax over the chunks: per chunk it takes its own max of the
// chunk's logits (held in registers), rescales its running sums once when
// the max grows, and adds p = 2^(s log2 e - max log2 e) and p v; the lanes'
// sums are merged at the end relative to the row max. One exponential per
// element, plus one per lane and chunk.
constexpr int kTileKeys = 256;

template <int D>
__global__ void __launch_bounds__(kThreads)
    biased_attention_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ bias,
                                  float* __restrict__ out, int heads, int n, int tiles,
                                  float scale) {
  extern __shared__ __align__(16) float tile_smem[];
  float* ks = tile_smem;  // [kTileKeys][D]
  float* vs = tile_smem + kTileKeys * D;
  const int bh = blockIdx.x / tiles;
  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  const int i = (blockIdx.x % tiles) * RS + warp;
  const int row = min(i, n - 1);  // a warp past n computes a copy and stores nothing
  float qr[D];
  load_row<D, float, true>(reinterpret_cast<const unsigned char*>(q + ((size_t)bh * n + row) * D), qr);
  const float* brow = bias + ((size_t)(bh % heads) * n + row) * n;
  const float4* kg = reinterpret_cast<const float4*>(k + (size_t)bh * n * D);
  const float4* vg = reinterpret_cast<const float4*>(v + (size_t)bh * n * D);

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kTileKeys) {
    const int cnt = min(kTileKeys, n - j0);
    __syncthreads();  // the previous chunk's K and V are read
    for (int e = threadIdx.x; e < cnt * D / 4; e += kThreads) {
      reinterpret_cast<float4*>(ks)[e] = kg[j0 * D / 4 + e];
      reinterpret_cast<float4*>(vs)[e] = vg[j0 * D / 4 + e];
    }
    __syncthreads();
    float s[kTileKeys / 32];
    float cm = -INFINITY;
#pragma unroll
    for (int u = 0; u < kTileKeys / 32; ++u) {
      const int j = 32 * u + lt;
      s[u] = -INFINITY;
      if (j < cnt) {
        s[u] = logit<D, float, false>(qr, reinterpret_cast<const unsigned char*>(ks + j * D), scale,
                                      __ldg(brow + j0 + j));
        cm = fmaxf(cm, s[u]);
      }
    }
    const float mn = fmaxf(m, cm);
    if (mn == -INFINITY) continue;  // this lane has no key yet
    const float f = exp2_ftz((m - mn) * kLog2e);  // 0 while m is -inf
    l *= f;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= f;
    const float neg_m2 = -mn * kLog2e;
#pragma unroll
    for (int u = 0; u < kTileKeys / 32; ++u) {
      const int j = 32 * u + lt;
      if (j < cnt) {
        const float p = exp2_ftz(fmaf(s[u], kLog2e, neg_m2));
        l += p;
        float vr[D];
        load_row<D, float, false>(reinterpret_cast<const unsigned char*>(vs + j * D), vr);
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
    }
    m = mn;
  }
  float mx = m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float f = m == -INFINITY ? 0.f : exp2_ftz((m - mx) * kLog2e);
  l *= f;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] *= f;
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
}

template <int D>
int launch_tiled(const float* q, const float* k, const float* v, const float* bias, float* out, int B,
                 int heads, int n, cudaStream_t stream) {
  const int tiles = (n + RS - 1) / RS;
  const long long items = (long long)B * heads * tiles;
  if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int smem = 2 * kTileKeys * D * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(biased_attention_tiled_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  biased_attention_tiled_kernel<D><<<(int)items, kThreads, smem, stream>>>(
      q, k, v, bias, out, heads, n, tiles, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// float32 q, k, v, bias
extern "C" int biased_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                    void* out, int B, int heads, int n, int d, void* stream) {
  return fwd<float, float>(q, k, v, bias, out, B, heads, n, d, stream);
}

// bf16 k, v, bias; q_bf16: 1 if q is bf16 (the logit is rounded to bf16), 0 if float32
extern "C" int biased_attention_bf16_fwd(const void* q, const void* k, const void* v,
                                         const void* bias, void* out, int B, int heads, int n,
                                         int d, int q_bf16, void* stream) {
  if (q_bf16) return fwd<uint16_t, uint16_t>(q, k, v, bias, out, B, heads, n, d, stream);
  return fwd<uint16_t, float>(q, k, v, bias, out, B, heads, n, d, stream);
}

// float32 q, k, v, bias, any n: the key-tiled kernel
extern "C" int biased_attention_tiled_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* out, int B, int heads, int n,
                                          int d, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bias) & 3) != 0)
    return (int)cudaErrorMisalignedAddress;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 4: return launch_tiled<4>(qf, kf, vf, bf, of, B, heads, n, s);
    case 8: return launch_tiled<8>(qf, kf, vf, bf, of, B, heads, n, s);
    case 16: return launch_tiled<16>(qf, kf, vf, bf, of, B, heads, n, s);
    case 32: return launch_tiled<32>(qf, kf, vf, bf, of, B, heads, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
