// Attention without a bias at a few dozen tokens, forward and backward: the
// plain MHA of the global-attention variant SGTAPoseGlobal
// (sgtapose_tpu/models/variants.py:222-274, pos_embed=False) at (n, d) =
// (28, 4 ... 128), 8 heads, batch 1 when serving and 4 in training.
//   O  = softmax(S) v,   S = q k^T / sqrt(d)
//   D_i = dO_i . O_i,   dS = P (dO v^T - D),   dq = dS k / sqrt(d),
//   dk = dS^T q / sqrt(d),   dv = P^T dO
// float32 (biased_attention_nobias_fwd, biased_attention_bwd_nobias) and
// bf16 (..._bf16: k and v bf16, q bf16 or float32, O and dO float32) with
// the rounding points of the JAX package's default attention form under
// bf16 (sgtapose_tpu/models/attention.py:174-180, and its autodiff): with a
// bf16 q the q.k logit is rounded to bf16, and so is its cotangent
// dS / sqrt(d) before the dq and dk products; everything else is float32
// and each output is rounded once to its dtype (the forward's is float32).
// Both divide by sqrt(d) rounded to float32, as `jnp.sqrt(jnp.float32(d))`.
//
// Replaces the Pallas TPU kernel sgtapose_tpu/ops/attention_kernel.py:55-116
// (_fwd_kernel, called from _fwd at :108) without its bias, and that
// kernel's custom VJP (_bwd_rule, :141-153) without dbias.
//
// What bounds it on an H100: latency. A global-variant launch moves ~30 KB
// (bytes bound < 1 us) and does at most 0.5 MFLOP per (batch, head); what a
// launch costs is the chain from its start to its last store, and an empty
// launch already takes ~5 us of it (PERF.md). The design shortens the rest:
//   * a block stages what it reads once, by cp.async (float32 rows in
//     16-byte pieces; bf16 rows in 8-byte pieces, kept as bf16 and widened
//     as they are read, so bf16 moves half the bytes); one barrier, then no
//     global access but the output stores;
//   * forward: one block per (batch, head), or 2 and 4 at d = 64 and 128,
//     each taking a band of query rows and staging K and V (a wide head's
//     FMAs spread over more SMs); one warp per 2 query rows (forward and
//     backward), one key per lane: a lane forms whole d-long
//     dots from its K row (padded by 4 elements beyond d = 4, so the lanes'
//     rows fall on distinct banks) and broadcast q rows; the row's max is
//     reduced once over the warp; exp and P v stay in registers: the lanes
//     of a 4-wide chunk of the output split the keys, P passes by shuffles,
//     the row sums ride along, and the lanes' sums are added across the warp
//     once (no per-logit reduction, no D-wide merge, no barrier after
//     staging);
//   * backward: one plain launch of 3 blocks per (batch, head), one forming
//     dq, one dk and one dv, each recomputing P (and dS) from its staged
//     rows, so no dS or lse goes through device memory and no block reads
//     another's shared memory: dq as the forward forms P v; dk and dv after
//     one more barrier, from dS / sqrt(d) or P written to an n x n tile,
//     over the whole block; outputs written once, without atomics (reruns
//     are bit for bit the same);
//   * no occupancy query: the grid is the problem count; the launchers set
//     each kernel's shared-memory limit once per device.
// Shared memory (fwd_smem, bwd_smem below): in float32 the backward's never
// exceeds the one-block cluster design it replaced (biased_attention_bwd.cu,
// cluster_floats(n, d, false)), so it takes every (n, d) that design took
// (n <= 163); a lane takes up to 6 keys (n <= 192).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kSmemMax = 227 * 1024;

// 2^x for x <= 0: one MUFU.EX2 (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float round_bf16(float x) { return bf16f(to_bf16(x)); }

// asynchronous copies global -> shared, waited for with cp_async_wait before
// the barrier that publishes them
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// `rows` rows of D elements of T (contiguous in device memory) into shared
// memory rows of pitch P elements, as they are: float32 in 16-byte pieces,
// bf16 in 8-byte ones (4 elements either way)
template <int D, int P, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int rows) {
  for (int e = threadIdx.x; e < rows * D / 4; e += blockDim.x) {
    T* to = dst + (e / (D / 4)) * P + 4 * (e % (D / 4));
    if constexpr (sizeof(T) == 4) cp_async16(to, src + 4 * e);
    else cp_async8(to, src + 4 * e);
  }
}

// 4 consecutive elements from shared memory as floats: float32 in one
// 16-byte read, bf16 in one 8-byte read widened (a 16-bit shift)
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const uint16_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
}

// Sum N values of each lane over the lane bits OFF, OFF / 2, ..., LO: while
// N is even, lanes swap halves across a bit (each keeps the half its bit
// selects, plus its partner's copy of that half: one shuffle per value
// kept), then the rest are summed across the remaining bits. Afterwards a
// lane holds the sums of values base .. base + Folded - 1; lanes that differ
// only in `dup` hold the same. Each sum pairs lanes across the highest bit
// first.
template <int N, int OFF, int LO>
__device__ __forceinline__ void fold(float* v, int lane, int& base, int& dup) {
  if constexpr (OFF >= LO && OFF > 0) {
    if constexpr (N % 2 == 0) {
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += N / 2;
      fold<N / 2, OFF / 2, LO>(v, lane, base, dup);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
      dup |= OFF;
      fold<N, OFF / 2, LO>(v, lane, base, dup);
    }
  }
}
template <int N, int OFF, int LO>
struct Folded {
  static constexpr int value =
      (OFF >= LO && OFF > 0) ? (N % 2 == 0 ? Folded<N / 2, OFF / 2, LO>::value : Folded<N, OFF / 2, LO>::value) : N;
};
template <int N, int LO>
struct Folded<N, 0, LO> {
  static constexpr int value = N;
};

// acc[r] = A[r0 + r] . b over D for the warp's R rows (clamped to rows - 1):
// the rows of A (pitch D) are broadcasts, b is this lane's own row
template <int D, int R, typename TA, typename TB>
__device__ __forceinline__ void dots(const TA* A, int r0, int rows, const TB* b, float (&acc)[R]) {
  const TA* a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = A + min(r0 + r, rows - 1) * D;
    acc[r] = 0.f;
  }
#pragma unroll 8
  for (int c = 0; c < D; c += 4) {
    const float4 y = ld4(b + c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = ld4(a[r] + c);
      acc[r] = fmaf(x.x, y.x, acc[r]);
      acc[r] = fmaf(x.y, y.y, acc[r]);
      acc[r] = fmaf(x.z, y.z, acc[r]);
      acc[r] = fmaf(x.w, y.w, acc[r]);
    }
  }
}

// The logits of the warp's rows r0 .. r0 + R - 1 of qs (`rows` of them)
// against keys j = lane + 32 m (m < NK), one whole d-long dot per lane and
// row: s[m][r] (-inf for j >= n), the q.k dot rounded to bf16 for a bf16 q
// (QB), then divided by sqrt(d); mx[r] the row's max over the warp.
template <int D, int R, int NK, int PK, bool QB, typename TQ, typename TK>
__device__ __forceinline__ void row_logits(const TQ* qs, int rows, const TK* ks, int n, int r0, float sqrt_d,
                                           float (&s)[NK][R], float (&mx)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
  // one key a lane (NK = 1) is the global variant's case; beyond it the
  // keys loop without unrolling (off its path)
#pragma unroll 1
  for (int m = 0; m < NK; ++m) {
    const int j = lane + 32 * m;
    float e[R];
    dots<D, R>(qs, r0, rows, ks + min(j, n - 1) * PK, e);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (QB) e[r] = round_bf16(e[r]);  // einsum of two bf16 operands returns bf16
      s[m][r] = j < n ? e[r] / sqrt_d : -INFINITY;
      mx[r] = fmaxf(mx[r], s[m][r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) mx[r] = warp_max(mx[r]);
}

// p = 2^(s log2 e - max log2 e) = exp(s - max), in place; 0 where s = -inf
template <int R, int NK>
__device__ __forceinline__ void row_exp(float (&s)[NK][R], const float (&mx)[R]) {
#pragma unroll 1
  for (int m = 0; m < NK; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) s[m][r] = exp2_ftz(fmaf(s[m][r], kLog2e, -mx[r] * kLog2e));
}

// acc[r][e] = sum_k w_rk B[k][4 ch + e] for the warp's rows, the weights
// held as w[m][r] by lane k & 31 (m = k >> 5) and passed by shuffles; lane =
// (kg, ch), ch fastest: it owns the float4 chunk ch of the columns, and the
// KG = 32 / (D / 4) lanes of a chunk split the keys (kg, kg + KG, ...);
// their sums are added across the kg lane bits, highest first (every lane
// ends with them). With SUM, lsum[r] = sum_k w_rk the same way.
template <int D, int R, int NK, int PB, bool SUM, typename TB>
__device__ __forceinline__ void rows_times(const float (&w)[NK][R], const TB* B, int n, float (&acc)[R][4],
                                           float (&lsum)[R]) {
  constexpr int C4 = D / 4, KG = 32 / C4;
  const int lane = threadIdx.x & 31, ch = lane % C4, kg = lane / C4;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    lsum[r] = 0.f;
  }
#pragma unroll 1
  for (int m = 0; m < NK; ++m) {
#pragma unroll
    for (int k1 = 0; k1 < 32; k1 += KG) {
      if (32 * m + k1 >= n) break;  // warp-uniform
      const float4 y = ld4(B + min(32 * m + k1 + kg, n - 1) * PB + 4 * ch);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = __shfl_sync(0xffffffffu, w[m][r], k1 + kg);  // 0 for keys >= n
        acc[r][0] = fmaf(x, y.x, acc[r][0]);
        acc[r][1] = fmaf(x, y.y, acc[r][1]);
        acc[r][2] = fmaf(x, y.z, acc[r][2]);
        acc[r][3] = fmaf(x, y.w, acc[r][3]);
        if constexpr (SUM) lsum[r] += x;
      }
    }
  }
#pragma unroll
  for (int off = 16; off >= C4; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
      if constexpr (SUM) lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], off);
    }
  }
}

// C[r][c] = sum_k A(r, k) B[k][c] for r, k < n, c < D, over the whole block;
// B row-major of pitch D, A(r, k) = A[k pa + r] (an n x n float32 tile, pa
// a multiple of 4: 4 rows in one float4). A warp item is 4 rows 4a .. 4a +
// 3 by all D columns; lane = (kg, chunk) as in rows_times, the kg lanes'
// partial sums folded (highest lane bit first). epi(r, c, value) for each
// element the lane ends with.
template <int D, typename TB, typename Epi>
__device__ __forceinline__ void product_nn(const float* A, int pa, const TB* B, int n, Epi epi) {
  constexpr int C4 = D / 4;
  constexpr int KG = 32 / C4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch = lane % C4, kg = lane / C4;
  for (int a = warp; a < (n + 3) / 4; a += blockDim.x >> 5) {
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int k = kg; k < n; k += KG) {
      const float4 y = ld4(B + k * D + 4 * ch);
      // rows past n read the tile's padding, whose sums are never stored
      const float4 w = ld4(A + k * pa + 4 * a);
      const float x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc[4 * t] = fmaf(x[t], y.x, acc[4 * t]);
        acc[4 * t + 1] = fmaf(x[t], y.y, acc[4 * t + 1]);
        acc[4 * t + 2] = fmaf(x[t], y.z, acc[4 * t + 2]);
        acc[4 * t + 3] = fmaf(x[t], y.w, acc[4 * t + 3]);
      }
    }
    int base = 0, dup = 0;
    fold<16, 16, C4>(acc, lane, base, dup);
    if ((lane & dup) == 0) {
#pragma unroll
      for (int e = 0; e < Folded<16, 16, C4>::value; ++e) {
        const int idx = base + e, r = 4 * a + idx / 4;
        if (r < n) epi(r, 4 * ch + idx % 4, acc[e]);
      }
    }
  }
}

// a float32 result stored as T: float32 as it is, bf16 rounded once
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(uint16_t* dst, float v) { *dst = to_bf16(v); }
__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(uint16_t* dst, const float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = to_bf16(v[e]);
}

// The forward's blocks per (batch, head): its query rows split in 1, 2 or 4
// (d <= 32, 64, 128), so that each block's warps hold 2 rows each and a
// wide head's FMAs spread over more SMs; each block stages K and V.
__host__ __device__ constexpr int fwd_splits(int d) { return d <= 32 ? 1 : (d == 64 ? 2 : 4); }
// query rows per warp, forward and backward: each K (or V) row a lane reads
// serves 2 rows; more rows a warp (4, 7) measured slower at d = 64 and 128
// on the H100 (PERF.md): fewer warps leave each SMSP one long chain
constexpr int kRows = 2;
// K (and, in the backward, V) rows padded by 4 elements beyond d = 4, so
// the lanes' reads of distinct rows fall on distinct banks
__host__ __device__ constexpr int key_pitch(int d) { return d == 4 ? 4 : d + 4; }
// bytes rounded up to a 16-byte line (each shared-memory region starts on one)
__host__ __device__ constexpr size_t line(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

// shared-memory bytes (ops/attention_kernel.py: nobias_fwd_smem_bytes,
// nobias_bwd_smem_bytes mirror them); q of TQ, k and v of TKV
size_t fwd_smem(int n, int d, int sq, int skv) {
  const size_t rows = (n + fwd_splits(d) - 1) / fwd_splits(d);
  return line(rows * d * sq) + line((size_t)n * key_pitch(d) * skv) + line((size_t)n * d * skv);
}
size_t bwd_smem(int n, int d, int sq, int skv) {
  return line(4 * (size_t)n * ((n + 3) & ~3)) + line((size_t)n * d * sq) + 2 * line(4 * (size_t)n * d) +
         2 * line((size_t)n * key_pitch(d) * skv);
}

// TQ: q (and dq); TKV: k, v (and dk, dv); each kept in shared memory in its
// own type. float32 runs <float, float>; bf16 <bf16, bf16> (the first tied
// layer: the q.k logit rounded to bf16) and <float, bf16> (the later
// layers). NK: keys per lane, 1 for n <= 32. Block (bh * S + split) owns
// query rows [split rb, split rb + rb), rb = ceil(n / S); one warp per 2
// rows: logits, row max, exp and P v (the row sums riding along) all in its
// registers and shuffles; one barrier, after staging.
template <int D, int NK, typename TQ, typename TKV>
__device__ __forceinline__ void fwd_body(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                         const TKV* __restrict__ v, float* __restrict__ out, int n,
                                         float sqrt_d) {
  constexpr bool QB = sizeof(TQ) == 2;
  constexpr int R = kRows, PK = key_pitch(D), S = fwd_splits(D);
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x / S, rb = (n + S - 1) / S, i0 = (blockIdx.x % S) * rb;
  const int rows = min(rb, n - i0);
  if (rows <= 0) return;
  TQ* qs = reinterpret_cast<TQ*>(smem);                                      // [rows][D]
  TKV* ks = reinterpret_cast<TKV*>(smem + line((size_t)rb * D * sizeof(TQ)));  // [n][PK]
  TKV* vs = ks + line((size_t)n * PK * sizeof(TKV)) / sizeof(TKV);           // [n][D]
  const size_t off = (size_t)bh * n * D;
  stage<D, D>(qs, q + off + (size_t)i0 * D, rows);
  stage<D, PK>(ks, k + off, n);
  stage<D, D>(vs, v + off, n);
  cp_async_wait();
  __syncthreads();
  const int lane = threadIdx.x & 31, ch = lane % (D / 4), kg = lane / (D / 4);
  for (int r0 = (threadIdx.x >> 5) * R; r0 < rows; r0 += (blockDim.x >> 5) * R) {
    float s[NK][R], mx[R], acc[R][4], l[R];
    row_logits<D, R, NK, PK, QB>(qs, rows, ks, n, r0, sqrt_d, s, mx);
    row_exp<R, NK>(s, mx);
    rows_times<D, R, NK, D, true>(s, vs, n, acc, l);
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r >= rows) break;
        const float inv = 1.f / l[r];
        const float o[4] = {acc[r][0] * inv, acc[r][1] * inv, acc[r][2] * inv, acc[r][3] * inv};
        store4(out + off + (size_t)(i0 + r0 + r) * D + 4 * ch, o);
      }
    }
  }
}

// Block (bh, kind) of the backward: kind 0 forms dq, 1 dk, 2 dv. A warp
// owns R query rows: it recomputes their logits and P (kinds 0, 1 also dO
// v^T, D and dS / sqrt(d)) in registers. Kind 0 forms dq = dS k / sqrt(d)
// of its rows there; kinds 1 and 2 write dS / sqrt(d) or P to an n x n tile
// and, after a barrier, form dk = dS^T q / sqrt(d) or dv = P^T dO over the
// whole block.
template <int D, int NK, typename TQ, typename TKV>
__device__ __forceinline__ void bwd_body(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                         const TKV* __restrict__ v, const float* __restrict__ out,
                                         const float* __restrict__ dout, TQ* __restrict__ dq,
                                         TKV* __restrict__ dk, TKV* __restrict__ dv, int n,
                                         float sqrt_d) {
  constexpr bool QB = sizeof(TQ) == 2;
  constexpr int R = kRows, PK = key_pitch(D);
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = (n + 3) & ~3;
  const int kind = blockIdx.y;
  float* xs = reinterpret_cast<float*>(smem);  // [n][p] dS / sqrt(d) or P (kinds 1, 2)
  unsigned char* at = smem + line(4 * (size_t)n * p);
  TQ* qs = reinterpret_cast<TQ*>(at);  // [n][D]
  at += line((size_t)n * D * sizeof(TQ));
  float* gs = reinterpret_cast<float*>(at);  // [n][D] dO
  at += line(4 * (size_t)n * D);
  float* os = reinterpret_cast<float*>(at);  // [n][D] O (kinds 0, 1)
  at += line(4 * (size_t)n * D);
  TKV* ks = reinterpret_cast<TKV*>(at);  // [n][PK]
  TKV* vs = ks + line((size_t)n * PK * sizeof(TKV)) / sizeof(TKV);  // [n][PK] (kinds 0, 1)
  const size_t off = (size_t)blockIdx.x * n * D;
  stage<D, D>(qs, q + off, n);
  stage<D, D>(gs, dout + off, n);
  stage<D, PK>(ks, k + off, n);
  if (kind != 2) {
    stage<D, PK>(vs, v + off, n);
    stage<D, D>(os, out + off, n);
  }
  cp_async_wait();
  __syncthreads();
  const int lane = threadIdx.x & 31, ch = lane % (D / 4), kg = lane / (D / 4);
  for (int r0 = (threadIdx.x >> 5) * R; r0 < n; r0 += (blockDim.x >> 5) * R) {
    float s[NK][R], mx[R];
    row_logits<D, R, NK, PK, QB>(qs, n, ks, n, r0, sqrt_d, s, mx);
    row_exp<R, NK>(s, mx);
    float red[2 * R];  // the rows' sums of p, then (kinds 0, 1) D = dO . O
#pragma unroll
    for (int r = 0; r < R; ++r) {
      red[r] = 0.f;
#pragma unroll 1
      for (int m = 0; m < NK; ++m) red[r] += s[m][r];
      red[R + r] = 0.f;
      if (kind != 2) {
        const int i = min(r0 + r, n - 1);
        for (int c = lane; c < D; c += 32) red[R + r] = fmaf(gs[i * D + c], os[i * D + c], red[R + r]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2 * R; ++e) red[e] = warp_sum(red[e]);
    if (kind != 2) {
#pragma unroll 1
      for (int m = 0; m < NK; ++m) {
        float g[R];  // dO v^T
        dots<D, R>(gs, r0, n, vs + min(lane + 32 * m, n - 1) * PK, g);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float de = s[m][r] * (1.f / red[r]) * (g[r] - red[R + r]) / sqrt_d;
          s[m][r] = QB ? round_bf16(de) : de;  // the bf16 logit's cotangent is bf16; 0 past n
        }
      }
    } else {
#pragma unroll 1
      for (int m = 0; m < NK; ++m)
#pragma unroll
        for (int r = 0; r < R; ++r) s[m][r] *= 1.f / red[r];
    }
    if (kind == 0) {  // dq = dS k / sqrt(d), this warp's rows
      float acc[R][4], unused[R];
      rows_times<D, R, NK, PK, false>(s, ks, n, acc, unused);
      if (kg == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r0 + r < n) store4(dq + off + (r0 + r) * D + 4 * ch, acc[r]);
      }
    } else {
#pragma unroll 1
      for (int m = 0; m < NK; ++m)
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r0 + r < n && lane + 32 * m < n) xs[(r0 + r) * p + lane + 32 * m] = s[m][r];
    }
  }
  if (kind == 0) return;
  __syncthreads();
  if (kind == 1) {  // dk = dS^T q / sqrt(d): A(j, i) = xs[i][j]
    product_nn<D>(xs, p, qs, n, [&](int r, int c, float o) { store1(dk + off + r * D + c, o); });
  } else {  // dv = P^T dO
    product_nn<D>(xs, p, gs, n, [&](int r, int c, float o) { store1(dv + off + r * D + c, o); });
  }
}

// one kernel name per precision, as profilers list them
template <int D, int NK>
__global__ void __launch_bounds__(kThreads)
    nobias_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ out, int n,
                                float sqrt_d) {
  fwd_body<D, NK, float, float>(q, k, v, out, n, sqrt_d);
}

template <int D, int NK, typename TQ>
__global__ void __launch_bounds__(kThreads)
    nobias_attention_fwd_bf16_kernel(const TQ* __restrict__ q, const uint16_t* __restrict__ k,
                                     const uint16_t* __restrict__ v, float* __restrict__ out, int n,
                                     float sqrt_d) {
  fwd_body<D, NK, TQ, uint16_t>(q, k, v, out, n, sqrt_d);
}

template <int D, int NK>
__global__ void __launch_bounds__(kThreads)
    nobias_attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ out,
                                const float* __restrict__ dout, float* __restrict__ dq,
                                float* __restrict__ dk, float* __restrict__ dv, int n, float sqrt_d) {
  bwd_body<D, NK, float, float>(q, k, v, out, dout, dq, dk, dv, n, sqrt_d);
}

template <int D, int NK, typename TQ>
__global__ void __launch_bounds__(kThreads)
    nobias_attention_bwd_bf16_kernel(const TQ* __restrict__ q, const uint16_t* __restrict__ k,
                                     const uint16_t* __restrict__ v, const float* __restrict__ out,
                                     const float* __restrict__ dout, TQ* __restrict__ dq,
                                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int n,
                                     float sqrt_d) {
  bwd_body<D, NK, TQ, uint16_t>(q, k, v, out, dout, dq, dk, dv, n, sqrt_d);
}

// keys per lane: one up to a warp's 32, else up to kMaxKeys
constexpr int kMaxKeys = 6;

// Raise a kernel's dynamic shared-memory limit to the card's maximum, once
// per kernel and device (not per call): `done` is the calling launcher's,
// one per instantiation, so one per kernel.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t bytes, bool (&done)[64]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

// threads of a block with `rows` rows at R a warp, at most kWarps warps
int block_threads(int rows, int R) {
  const int warps = (rows + R - 1) / R;
  return 32 * (warps < kWarps ? warps : kWarps);
}

template <int D, int NK, typename TQ, typename TKV>
int launch_fwd_nk(const TQ* q, const TKV* k, const TKV* v, float* out, int B, int heads, int n,
                  cudaStream_t stream) {
  constexpr int S = fwd_splits(D);
  const size_t smem = fwd_smem(n, D, sizeof(TQ), sizeof(TKV));
  const long long blocks = (long long)B * heads * S;
  if (smem > kSmemMax || blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto kern = [] {
    if constexpr (sizeof(TKV) == 4) return nobias_attention_fwd_kernel<D, NK>;
    else return nobias_attention_fwd_bf16_kernel<D, NK, TQ>;
  }();
  static bool allowed[64] = {false};
  const cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const int threads = block_threads((n + S - 1) / S, kRows);
  kern<<<(unsigned)blocks, threads, smem, stream>>>(q, k, v, out, n, sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, typename TQ, typename TKV>
int launch_fwd(const TQ* q, const TKV* k, const TKV* v, float* out, int B, int heads, int n,
               cudaStream_t stream) {
  if (n <= 32) return launch_fwd_nk<D, 1>(q, k, v, out, B, heads, n, stream);
  if (n <= 32 * kMaxKeys) return launch_fwd_nk<D, kMaxKeys>(q, k, v, out, B, heads, n, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D, int NK, typename TQ, typename TKV>
int launch_bwd_nk(const TQ* q, const TKV* k, const TKV* v, const float* out, const float* dout, TQ* dq,
                  TKV* dk, TKV* dv, int B, int heads, int n, cudaStream_t stream) {
  const size_t smem = bwd_smem(n, D, sizeof(TQ), sizeof(TKV));
  const long long blocks = (long long)B * heads;
  if (smem > kSmemMax || blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  auto kern = [] {
    if constexpr (sizeof(TKV) == 4) return nobias_attention_bwd_kernel<D, NK>;
    else return nobias_attention_bwd_bf16_kernel<D, NK, TQ>;
  }();
  static bool allowed[64] = {false};
  const cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((unsigned)blocks, 3), block_threads(n, kRows), smem, stream>>>(
      q, k, v, out, dout, dq, dk, dv, n, sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, typename TQ, typename TKV>
int launch_bwd(const TQ* q, const TKV* k, const TKV* v, const float* out, const float* dout, TQ* dq,
               TKV* dk, TKV* dv, int B, int heads, int n, cudaStream_t stream) {
  if (n <= 32) return launch_bwd_nk<D, 1>(q, k, v, out, dout, dq, dk, dv, B, heads, n, stream);
  if (n <= 32 * kMaxKeys)
    return launch_bwd_nk<D, kMaxKeys>(q, k, v, out, dout, dq, dk, dv, B, heads, n, stream);
  return (int)cudaErrorInvalidValue;
}

// q, k, v (and out, dout) start on 16-byte lines (float32 slices are copied
// in 16-byte pieces, bf16 ones in 8-byte pieces)
bool aligned(const void* a, const void* b, const void* c, const void* d = nullptr,
             const void* e = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
           reinterpret_cast<uintptr_t>(e)) & 15) == 0;
}

}  // namespace

#define NOBIAS_DIMS(X) X(4) X(8) X(16) X(32) X(64) X(128)

// float32 q, k, v (B, heads, n, d) -> out (B, heads, n, d)
extern "C" int biased_attention_nobias_fwd(const void* q, const void* k, const void* v, void* out,
                                           int B, int heads, int n, int d, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned(q, k, v)) return (int)cudaErrorMisalignedAddress;
  const float* a[3] = {static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD) \
  case DD: return launch_fwd<DD, float, float>(a[0], a[1], a[2], static_cast<float*>(out), B, heads, n, s);
    NOBIAS_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 k, v; q bf16 when q_bf16 (the logit rounded to bf16), else float32;
// float32 out
extern "C" int biased_attention_nobias_bf16_fwd(const void* q, const void* k, const void* v,
                                                void* out, int B, int heads, int n, int d,
                                                int q_bf16, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned(q, k, v)) return (int)cudaErrorMisalignedAddress;
  using bf = uint16_t;
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                  \
  case DD:                                                                                        \
    return q_bf16 ? launch_fwd<DD, bf, bf>(static_cast<const bf*>(q), kb, vb, o, B, heads, n, s) \
                  : launch_fwd<DD, float, bf>(static_cast<const float*>(q), kb, vb, o, B, heads, n, s);
    NOBIAS_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32 q, k, v, out, dout -> dq, dk, dv
extern "C" int biased_attention_bwd_nobias(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, void* dq, void* dk,
                                           void* dv, int B, int heads, int n, int d, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned(q, k, v, out, dout)) return (int)cudaErrorMisalignedAddress;
  const float* a[5] = {static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(out),
                       static_cast<const float*>(dout)};
  float* g[3] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                   \
  case DD:                                                                                         \
    return launch_bwd<DD, float, float>(a[0], a[1], a[2], a[3], a[4], g[0], g[1], g[2], B, heads, \
                                        n, s);
    NOBIAS_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 k, v; q bf16 when q_bf16, else float32; out and dout float32 -> dq in
// q's dtype, dk and dv bf16
extern "C" int biased_attention_bwd_nobias_bf16(const void* q, const void* k, const void* v,
                                                const void* out, const void* dout, void* dq,
                                                void* dk, void* dv, int B, int heads, int n, int d,
                                                int q_bf16, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned(q, k, v, out, dout)) return (int)cudaErrorMisalignedAddress;
  using bf = uint16_t;
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                  \
  case DD:                                                                                        \
    return q_bf16 ? launch_bwd<DD, bf, bf>(static_cast<const bf*>(q), kb, vb, o, g,              \
                                           static_cast<bf*>(dq), dkb, dvb, B, heads, n, s)       \
                  : launch_bwd<DD, float, bf>(static_cast<const float*>(q), kb, vb, o, g,        \
                                              static_cast<float*>(dq), dkb, dvb, B, heads, n, s);
    NOBIAS_DIMS(CASE)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
