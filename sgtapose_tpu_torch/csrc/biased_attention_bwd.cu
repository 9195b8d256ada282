// Biased attention backward (and, on the cluster path, its no-bias
// instantiation: the plain MHA of the global-attention variant, no dbias):
// the gradients of
//   O = softmax(S) v,   S = q k^T / sqrt(d) + bias
// with respect to q, k, v (B, heads, n, d) and the (heads, n, n) bias shared
// across the batch, given dO (B, heads, n, d) and the forward's output O.
// float32 (biased_attention_bwd), and bf16 training's instantiations of the
// cluster path (biased_attention_bwd_bf16) and of the row-split path
// (biased_attention_bwd_rows_bf16): bf16 k, v and bias, q bf16 or
// float32, O and dO float32, float32 arithmetic inside, each output rounded
// once (with a bf16 q the q.k logit and its cotangent dS / sqrt(d) are
// rounded as the JAX default attention's autodiff rounds them under bf16:
// ops/attention_kernel.py:plain_biased_attention_backward_bf16).
//
// Replaces the custom VJP of the Pallas TPU kernel,
// sgtapose_tpu/ops/attention_kernel.py:141-153 (_bwd_rule, a recompute
// through the XLA formulation _xla_attention at :119-128). Like that rule it
// saves no probabilities: P is recomputed from q, k and the bias.
//   D_i   = sum_c dO_ic O_ic
//   P_ij  = exp(S_ij - lse_i),                    lse_i = log sum_j exp S_ij
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dq    = dS k / sqrt(d),   dk = dS^T q / sqrt(d),   dv = P^T dO
//   dbias = sum_b dS   (summed over the batch in a fixed order, no atomics,
//                       so a training step is reproducible)
//
// Three paths; the caller picks one by shared-memory size
// (ops/attention_kernel.py: bwd_uses_cluster, bwd_uses_rows): the one-pass
// cluster path and the two-pass path behind one entry point
// (biased_attention_bwd), the row-split cluster path behind its own
// (biased_attention_bwd_rows).
//
// The one-pass cluster path, for every (n, d) whose whole (batch, head)
// problem fits in one block's shared memory (level 2 of the flagship,
// (63, 16), the only level whose backward training runs, ~86 KB):
//   * one block per (batch element, head), the blocks of one head grouped in
//     a thread-block cluster along the batch (up to 8, the portable size;
//     for B > 8 rank r takes b = r, r + 8, ... in order);
//   * the block stages q, k, v, O and dO of its (b, head) (K and V rows
//     padded to d + 4 floats, so the lanes' float4 reads of 8 keys fall on
//     distinct banks) and the head's bias tile, once for all its b;
//   * a row phase, one of the block's 16 warps per query row, lanes strided
//     over the keys: logits, max, sum, then P and dS into two n x n tiles,
//     and dS added into the block's own dbias tile (the same warp and lane
//     own an element for every b, so its sum runs in b order);
//   * a column phase: one thread per row of dq, dk and dv, each a length-n
//     sum over a column (or row) of the P or dS tile against broadcast rows
//     of K, q or dO, written once (no lse or D round trip through device
//     memory, no second kernel);
//   * dbias: after a cluster barrier, rank r owns a band of rows and adds the
//     ranks' dbias tiles 0 .. 7 in rank order through distributed shared
//     memory, then writes the band once.
// What bounds it on an H100: bytes, ~2.3 MB at level 2, batch 8 (0.7 us);
// the block's latency chain (a cold load, two phases, a cluster barrier) is
// what remains, not work.
// Without a bias (biased_attention_bwd_nobias_cluster and _cluster_bf16,
// the global variant's (28, d) for d = 4 ... 128; on no path since
// attention_nobias.cu's backward replaced them, kept as its yardstick): the same blocks stage no bias tile
// and keep no dbias tile, form no dS sum over b, write no dbias and need no
// cluster barrier. Beyond d = 32 the row phase reads the query and dO rows
// from shared memory (broadcasts) instead of holding them in registers, and
// the column phase gives each thread a 32-wide slice of a row.
//
// The row-split cluster path, for each (n, d) too large for one block whose
// query rows split over the 8 ranks of a cluster at most 48 rows a rank and
// whose rank fits a block's shared memory (a 42-keypoint model's level 2,
// (378, 16), which `cli/train.py --depth` differentiates; ~210 KB):
//   * one cluster of 8 blocks per head; rank r owns the query rows
//     [r R, r R + R), R = ceil(n / 8), and walks the batch in order;
//   * per b it stages K and V (padded rows, as above), its q, O and dO rows
//     and its bias rows, these into the P / dS tile where the logits are
//     formed in place (from L2 after the first b: one copy for all b does not
//     fit beside the tile, K, V and the rank's dbias rows);
//   * for its rows and all n keys it recomputes the logits, P and dS in one
//     R x n tile in shared memory (warp w owns rows w, w + 16, w + 32; each K
//     or V row a lane reads serves all 3 rows), forms the dv partial P^T dO
//     from P before overwriting P with dS in place, adds dS into its own
//     dbias rows (summed in b order and written once at the end, no atomics),
//     and writes dq rows once;
//   * it forms the partial dk = dS^T q over its rows; after a cluster
//     barrier the ranks' partials are added in rank order through
//     distributed shared memory, each rank writing a band of dk and dv rows;
//   * one launch: lse and D never go through device memory.
// What bounds it on an H100: operations, ~10d + 5 FLOPs per (b, head, i, j),
// 0.377 GFLOP at (378, 16), batch 2, 8 heads (5.6 us at 67 TFLOP/s), against
// ~9.8 MB of bytes (2.9 us). Float32 FMAs throughout; 64 blocks (8 heads x 8
// ranks) at that shape. Each b costs a rank several times its FMAs (PERF.md);
// versions with the five d-wide products on the tensor cores (3xTF32
// mma.sync), S, P and dS in the tile or in registers, ran slower on the
// card, so the products are not what holds it: suspects are the tile's
// passes through shared memory, the staging and the cluster exchange per b.
//
// The two-pass path, for larger n (levels 0 and 1 of the flagship and of a
// 42-keypoint model, which training never differentiates) and as the
// yardstick of the row-split path, launched back to back by one entry point:
//   * the row pass: one block per (head, tile of 8 query rows), one warp per
//     row, lanes strided over the keys. The tile's bias rows are read once
//     into shared memory and serve every batch element; for each b (in
//     order) the block stages K and V of (b, head), and each warp takes the
//     row max, the row sum and then dS in three passes over the keys,
//     recomputing the logits (d <= 32 FMAs from shared memory). It writes
//     dq, lse and D for the column pass and adds dS into a shared-memory
//     dbias row that the warp alone owns; the tile's dbias rows are written
//     once at the end.
//   * the column pass: one block per (b, head, tile of 32 keys), one key per
//     lane, the 8 warps strided over the query rows. The bias columns of the
//     tile are strided in memory, so rounds of 32 query rows stage q, dO,
//     lse, D and the bias sub-tile (32 rows of 32 contiguous floats, one
//     coalesced line a row) in shared memory; each lane accumulates dk_j and
//     dv_j in registers and the 8 warps' sums are added in shared memory.
//
// What bounds the two-pass path on an H100: at level 0 of the flagship ((n, d) = (1183, 4),
// 8 heads, batch 8) operations: ~10d + 5 FLOPs per (b, head, i, j) are 4.0
// GFLOP, ~60 us at 67 TFLOP/s, against ~99 MB of bytes (the bias read once,
// dbias written once, q, k, v, O, dO and the gradients), ~30 us at
// 3.35 TB/s. This design is simple and
// right rather than fast: the row pass re-reads K and V of each (b, head) for
// every tile (from L2) and walks the batch in series; the column pass re-reads
// the bias for every b (from L2 when the b blocks of one tile run together).
// q, k, v, O and dO rows are read as float4 (they start on 16-byte lines,
// as the forward requires).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int RS = kWarps;  // query rows per row-pass block: one per warp
constexpr int CT = 32;      // keys per column-pass block: one per lane
constexpr int CR = 32;      // query rows per column-pass staging round
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr int kCWarps = 16;     // the cluster path's block: one (batch, head) problem
constexpr int kCThreads = 32 * kCWarps;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x for x <= 0: one MUFU.EX2 (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// asynchronous copies global -> shared (16 or 4 bytes), waited for with
// cp_async_wait before the barrier that publishes them
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// the D floats of a row that starts on a 16-byte line
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&r)[D]) {
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p) + c);
    r[4 * c] = u.x; r[4 * c + 1] = u.y; r[4 * c + 2] = u.z; r[4 * c + 3] = u.w;
  }
}

// a . b for a and b 16-byte aligned rows in shared memory (d > 32: unrolled
// by 8 float4 pairs, so the loads in flight stay within the 128 registers a
// 512-thread block leaves a thread)
template <int D>
__device__ __forceinline__ float dot4s(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = reinterpret_cast<const float4*>(a)[c];
    const float4 u = reinterpret_cast<const float4*>(b)[c];
    s = fmaf(x.x, u.x, s);
    s = fmaf(x.y, u.y, s);
    s = fmaf(x.z, u.z, s);
    s = fmaf(x.w, u.w, s);
  }
  return s;
}

// a . b for b a 16-byte aligned row in shared memory
template <int D>
__device__ __forceinline__ float dot4(const float (&a)[D], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 u = reinterpret_cast<const float4*>(b)[c];
    s = fmaf(a[4 * c], u.x, s);
    s = fmaf(a[4 * c + 1], u.y, s);
    s = fmaf(a[4 * c + 2], u.z, s);
    s = fmaf(a[4 * c + 3], u.w, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    biased_attention_bwd_row_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ bias,
                                    const float* __restrict__ out, const float* __restrict__ dout,
                                    float* __restrict__ dq, float* __restrict__ dbias,
                                    float* __restrict__ lse, float* __restrict__ delta, int B,
                                    int heads, int n, int tiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;            // [RS][n] this tile's bias rows
  float* acc = sb + RS * n;    // [RS][n] this tile's dbias rows
  float* ks = acc + RS * n;    // [n][D] K of the current (b, head)
  float* vs = ks + n * D;      // [n][D] V of the current (b, head)
  const int h = blockIdx.x / tiles, r0 = (blockIdx.x % tiles) * RS;
  const int rows = min(RS, n - r0);
  const float* bias_tile = bias + ((size_t)h * n + r0) * n;
  for (int e = threadIdx.x; e < rows * n; e += kThreads) {
    sb[e] = __ldg(bias_tile + e);
    acc[e] = 0.f;
  }
  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  const int i = r0 + warp;
  const float* srow = sb + warp * n;
  float* arow = acc + warp * n;

  for (int b = 0; b < B; ++b) {
    const size_t bh = (size_t)b * heads + h;
    __syncthreads();  // the bias is in; the previous b's K and V are no longer read
    const float4* kg = reinterpret_cast<const float4*>(k + bh * n * D);
    const float4* vg = reinterpret_cast<const float4*>(v + bh * n * D);
    for (int e = threadIdx.x; e < n * D / 4; e += kThreads) {
      reinterpret_cast<float4*>(ks)[e] = __ldg(kg + e);
      reinterpret_cast<float4*>(vs)[e] = __ldg(vg + e);
    }
    __syncthreads();
    if (i >= n) continue;  // warp-uniform; no barrier below in this iteration

    const size_t row = bh * n + i;
    float qr[D], gr[D], orow[D];
    load_row<D>(q + row * D, qr);
    load_row<D>(dout + row * D, gr);
    load_row<D>(out + row * D, orow);
    const float dlt = dot<D>(gr, orow);

    // pass 1: the row max of the logits
    float m = -INFINITY;
    for (int j = lt; j < n; j += 32) m = fmaxf(m, fmaf(dot<D>(qr, ks + j * D), scale, srow[j]));
    m = warp_max(m);
    const float neg_m2 = -m * kLog2e;
    // pass 2: the row sum
    float l = 0.f;
    for (int j = lt; j < n; j += 32)
      l += exp2_ftz(fmaf(fmaf(dot<D>(qr, ks + j * D), scale, srow[j]), kLog2e, neg_m2));
    l = warp_sum(l);
    const float inv_l = 1.f / l;
    // pass 3: dS; dq and this row's dbias
    float dqa[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dqa[c] = 0.f;
    for (int j = lt; j < n; j += 32) {
      const float* kj = ks + j * D;
      const float s = fmaf(dot<D>(qr, kj), scale, srow[j]);
      const float p = exp2_ftz(fmaf(s, kLog2e, neg_m2)) * inv_l;
      const float ds = p * (dot<D>(gr, vs + j * D) - dlt);
      arow[j] += ds;
#pragma unroll
      for (int c = 0; c < D; ++c) dqa[c] = fmaf(ds, kj[c], dqa[c]);
    }
#pragma unroll
    for (int c = 0; c < D; ++c) dqa[c] = warp_sum(dqa[c]);
#pragma unroll
    for (int c = 0; c < D; ++c)
      if (c == lt) dq[row * D + c] = dqa[c] * scale;
    if (lt == 0) {
      lse[row] = m + logf(l);
      delta[row] = dlt;
    }
  }
  __syncthreads();
  float* dtile = dbias + ((size_t)h * n + r0) * n;
  for (int e = threadIdx.x; e < rows * n; e += kThreads) dtile[e] = acc[e];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    biased_attention_bwd_col_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ bias,
                                    const float* __restrict__ dout, const float* __restrict__ lse,
                                    const float* __restrict__ delta, float* __restrict__ dk,
                                    float* __restrict__ dv, int heads, int n, int ctiles,
                                    float scale) {
  // staging for one round of CR query rows; after the rows, the same bytes
  // hold the warps' partial sums
  constexpr int kStage = CR * (CT + 1) + 2 * CR * D + 2 * CR;
  constexpr int kReduce = kWarps * CT * D;
  __shared__ __align__(16) float smem[kStage > kReduce ? kStage : kReduce];
  float* sbias = smem;                  // [CR][CT + 1]
  float* sq = sbias + CR * (CT + 1);    // [CR][D]
  float* sg = sq + CR * D;              // [CR][D] dO
  float* slse = sg + CR * D;            // [CR] lse * log2(e)
  float* sdl = slse + CR;               // [CR] D

  const size_t bh = blockIdx.x / ctiles;
  const int h = (int)(bh % heads);
  const int j0 = (blockIdx.x % ctiles) * CT;
  const int warp = threadIdx.x >> 5, lt = threadIdx.x & 31;
  const int j = j0 + lt;
  const bool jv = j < n;
  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int c = 0; c < D; ++c) kr[c] = vr[c] = dka[c] = dva[c] = 0.f;
  if (jv) {
    load_row<D>(k + (bh * n + j) * D, kr);
    load_row<D>(v + (bh * n + j) * D, vr);
  }
  const int cols = min(CT, n - j0);
  for (int i0 = 0; i0 < n; i0 += CR) {
    const int rows = min(CR, n - i0);
    __syncthreads();  // the previous round's rows are no longer read
    for (int e = threadIdx.x; e < rows * CT; e += kThreads) {
      const int r = e / CT, c = e % CT;
      sbias[r * (CT + 1) + c] = c < cols ? __ldg(bias + ((size_t)h * n + i0 + r) * n + j0 + c) : 0.f;
    }
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      sq[e] = __ldg(q + (bh * n + i0) * D + e);
      sg[e] = __ldg(dout + (bh * n + i0) * D + e);
    }
    for (int e = threadIdx.x; e < rows; e += kThreads) {
      slse[e] = __ldg(lse + bh * n + i0 + e) * kLog2e;
      sdl[e] = __ldg(delta + bh * n + i0 + e);
    }
    __syncthreads();
    if (jv) {
      for (int r = warp; r < rows; r += kWarps) {
        const float* qi = sq + r * D;  // the same address in every lane: a broadcast
        const float* gi = sg + r * D;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          s = fmaf(qi[c], kr[c], s);
          dp = fmaf(gi[c], vr[c], dp);
        }
        s = fmaf(s, scale, sbias[r * (CT + 1) + lt]);
        const float p = exp2_ftz(fmaf(s, kLog2e, -slse[r]));
        const float ds = p * (dp - sdl[r]);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          dka[c] = fmaf(ds, qi[c], dka[c]);
          dva[c] = fmaf(p, gi[c], dva[c]);
        }
      }
    }
  }
  // add the 8 warps' sums: [warp][c][lane], then one thread per (key, c)
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < D; ++c) smem[(warp * D + c) * CT + lt] = pass == 0 ? dka[c] : dva[c];
    __syncthreads();
    float* dst = pass == 0 ? dk : dv;
    const float mul = pass == 0 ? scale : 1.f;
    for (int e = threadIdx.x; e < cols * D; e += kThreads) {
      const int jl = e / D, c = e % D;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += smem[(w * D + c) * CT + jl];
      dst[(bh * n + j0) * D + e] = s * mul;
    }
  }
}

// shared-memory floats of the cluster path (ops/attention_kernel.py:
// bwd_cluster_smem_bytes mirrors it); the bf16 instantiation stages its
// inputs as float32, so both share it; without a bias no bias or dbias tile
size_t cluster_floats(int n, int d, bool bias = true) {
  return 2 * (size_t)n * (d + 4) + 3 * (size_t)n * d + (bias ? 4 : 2) * (size_t)n * n + n;
}

// one element of T (float, or bf16 held as uint16_t) into shared memory as
// float32: float32 by an asynchronous copy, bf16 widened (a 16-bit shift)
__device__ __forceinline__ void stage1(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void stage1(float* dst, const uint16_t* src) { *dst = bf16f(__ldg(src)); }
// four consecutive elements starting on a 16-byte line (float32) or an
// 8-byte one (bf16)
__device__ __forceinline__ void stage4(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void stage4(float* dst, const uint16_t* src) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(src));
  *reinterpret_cast<float4*>(dst) = make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
}
// a float32 result stored as T: float32 as it is, bf16 rounded once
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(uint16_t* dst, float v) { *dst = to_bf16(v); }
__device__ __forceinline__ float round_bf16(float v) { return bf16f(to_bf16(v)); }

// TQ: q and dq; TKV: k, v, the bias and their gradients. float32 training
// runs <float, float>. bf16 training runs TKV = bf16 with TQ = bf16 (the
// first tied layer: the q.k logit is rounded to bf16 in the forward, so its
// cotangent dS / sqrt(d) is rounded to bf16 before the dq and dk products)
// or TQ = float (the later layers: dq float32, dk and dv rounded once). O
// and dO are float32 in both (the bf16 forward returns float32). All
// arithmetic is float32; every output is rounded once, dbias after the
// rank-ordered sum of float32 dS.
template <int D, typename TQ, typename TKV, bool BIAS>
__device__ __forceinline__ void cluster_body(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                             const TKV* __restrict__ v,
                                             const TKV* __restrict__ bias,
                                             const float* __restrict__ out,
                                             const float* __restrict__ dout, TQ* __restrict__ dq,
                                             TKV* __restrict__ dk, TKV* __restrict__ dv,
                                             TKV* __restrict__ dbias, int B, int heads, int n,
                                             float scale) {
  constexpr bool QB = sizeof(TQ) == 2;  // q bf16: logits and their cotangent rounded
  constexpr bool F32 = sizeof(TKV) == 4 && !QB;
  constexpr int DP = D + 4;  // padded K and V rows
  constexpr bool kRegRows = D <= 32;  // q and dO rows held in registers in the row phase
  constexpr int DC = D < 32 ? D : 32;  // columns of a column-phase thread
  constexpr int NC = D / DC;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;          // [n][DP]
  float* vs = ks + n * DP;   // [n][DP]
  float* qs = vs + n * DP;   // [n][D]
  float* os = qs + n * D;    // [n][D] the forward's output
  float* gs = os + n * D;    // [n][D] dO
  float* ps = gs + n * D;    // [n][n] P of the current b
  float* dss = ps + n * n;   // [n][n] dS of the current b (bf16 q: dS / sqrt(d), rounded)
  float* bs = dss + n * n;   // [n][n] the head's bias (BIAS only)
  float* acc = bs + n * n;   // [n][n] this block's dbias: dS summed over its b (BIAS only)
  const int rank = blockIdx.x, cs = gridDim.x;  // one cluster spans the x extent
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lt = tid & 31;
  if constexpr (BIAS) {
    const TKV* bias_h = bias + (size_t)h * n * n;
    for (int e = tid; e < n * n; e += kCThreads) {
      stage1(bs + e, bias_h + e);
      acc[e] = 0.f;
    }
  }
  for (int b = rank; b < B; b += cs) {
    const size_t bh = (size_t)b * heads + h;
    __syncthreads();  // the previous b's tiles are no longer read
    for (int e = tid; e < n * D / 4; e += kCThreads) {
      const int row = 4 * e / D, c = 4 * e % D;
      const size_t at = bh * n * D + 4 * e;
      stage4(qs + 4 * e, q + at);
      cp_async16(os + 4 * e, out + at);
      cp_async16(gs + 4 * e, dout + at);
      stage4(ks + row * DP + c, k + at);
      stage4(vs + row * DP + c, v + at);
    }
    cp_async_wait();  // this b's rows (and the first time, the bias)
    __syncthreads();
    // row phase: one warp per query row, lanes strided over the keys
    for (int i = warp; i < n; i += kCWarps) {
      // q_i and dO_i: in registers, or (d > 32) read from shared memory
      // at each use; the same addresses in every lane: broadcasts
      float qr[kRegRows ? D : 1], gr[kRegRows ? D : 1];
      if constexpr (kRegRows) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          qr[c] = qs[i * D + c];
          gr[c] = gs[i * D + c];
        }
      }
      const float* brow = bs + i * n;
      float* prow = ps + i * n;
      float* drow = dss + i * n;
      float* arow = acc + i * n;
      float m = -INFINITY;
      for (int j = lt; j < n; j += 32) {
        float e;
        if constexpr (kRegRows) e = dot4<D>(qr, ks + j * DP);
        else e = dot4s<D>(qs + i * D, ks + j * DP);
        if constexpr (QB) e = round_bf16(e);  // the forward's bf16 logit
        const float s = BIAS ? fmaf(e, scale, brow[j]) : e * scale;
        prow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      const float neg_m2 = -m * kLog2e;
      float l = 0.f;
      for (int j = lt; j < n; j += 32) {
        const float p = exp2_ftz(fmaf(prow[j], kLog2e, neg_m2));
        prow[j] = p;
        l += p;
      }
      l = warp_sum(l);
      const float inv_l = 1.f / l;
      float dlt;
      if constexpr (kRegRows) dlt = dot4<D>(gr, os + i * D);
      else dlt = dot4s<D>(gs + i * D, os + i * D);
      for (int j = lt; j < n; j += 32) {
        const float p = prow[j] * inv_l;
        float gv;
        if constexpr (kRegRows) gv = dot4<D>(gr, vs + j * DP);
        else gv = dot4s<D>(gs + i * D, vs + j * DP);
        const float ds = p * (gv - dlt);
        prow[j] = p;
        if constexpr (QB) drow[j] = round_bf16(ds * scale);  // the bf16 logit's cotangent
        else drow[j] = ds;
        if constexpr (BIAS) arow[j] += ds;
      }
    }
    __syncthreads();
    // column phase: one thread per row of dq, dk or dv (per 32-wide slice
    // of it beyond d = 32); each step of its length-n sum reads one P or dS
    // element and one broadcast row of K, q or dO for its products
    for (int e = tid; e < 3 * n * NC; e += kCThreads) {
      const int which = e / (n * NC), r = (e / NC) % n, c0 = (e % NC) * DC;
      float a[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) a[c] = 0.f;
      const float* tile = which == 2 ? ps : dss;
      const float* rows = which == 0 ? ks : (which == 1 ? qs : gs);
      const int pitch = which == 0 ? DP : D;
      for (int j = 0; j < n; ++j) {
        const float w = which == 0 ? tile[r * n + j] : tile[j * n + r];
        const float4* row = reinterpret_cast<const float4*>(rows + j * pitch + c0);
#pragma unroll
        for (int c = 0; c < DC / 4; ++c) {
          const float4 u = row[c];
          a[4 * c] = fmaf(w, u.x, a[4 * c]);
          a[4 * c + 1] = fmaf(w, u.y, a[4 * c + 1]);
          a[4 * c + 2] = fmaf(w, u.z, a[4 * c + 2]);
          a[4 * c + 3] = fmaf(w, u.w, a[4 * c + 3]);
        }
      }
      const float mul = (which == 2 || QB) ? 1.f : scale;
      if constexpr (F32) {
        float* dst = (which == 0 ? dq : (which == 1 ? dk : dv)) + (bh * n + r) * D + c0;
#pragma unroll
        for (int c = 0; c < DC / 4; ++c)
          reinterpret_cast<float4*>(dst)[c] =
              make_float4(a[4 * c] * mul, a[4 * c + 1] * mul, a[4 * c + 2] * mul, a[4 * c + 3] * mul);
      } else if (which == 0) {
#pragma unroll
        for (int c = 0; c < DC; ++c) store1(dq + (bh * n + r) * D + c0 + c, a[c] * mul);
      } else {
        TKV* dst = (which == 1 ? dk : dv) + (bh * n + r) * D + c0;
#pragma unroll
        for (int c = 0; c < DC; ++c) store1(dst + c, a[c] * mul);
      }
    }
  }
  if constexpr (!BIAS) return;
  // dbias: rank r adds the ranks' tiles over its band of rows in rank order
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r0 = n * rank / cs, r1 = n * (rank + 1) / cs;
  TKV* dbias_h = dbias + (size_t)h * n * n;
  for (int e = r0 * n + tid; e < r1 * n; e += kCThreads) {
    float part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) part[r] = r < cs ? cluster.map_shared_rank(acc, r)[e] : 0.f;
    float s = part[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r) s += part[r];
    store1(dbias_h + e, s);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// one kernel name per precision, as profilers list them
template <int D>
__global__ void __launch_bounds__(kCThreads)
    biased_attention_bwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                        const float* __restrict__ v, const float* __restrict__ bias,
                                        const float* __restrict__ out, const float* __restrict__ dout,
                                        float* __restrict__ dq, float* __restrict__ dk,
                                        float* __restrict__ dv, float* __restrict__ dbias, int B,
                                        int heads, int n, float scale) {
  cluster_body<D, float, float, true>(q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n,
                                      scale);
}

template <int D, typename TQ>
__global__ void __launch_bounds__(kCThreads)
    biased_attention_bf16_bwd_kernel(const TQ* __restrict__ q, const uint16_t* __restrict__ k,
                                     const uint16_t* __restrict__ v,
                                     const uint16_t* __restrict__ bias,
                                     const float* __restrict__ out, const float* __restrict__ dout,
                                     TQ* __restrict__ dq, uint16_t* __restrict__ dk,
                                     uint16_t* __restrict__ dv, uint16_t* __restrict__ dbias, int B,
                                     int heads, int n, float scale) {
  cluster_body<D, TQ, uint16_t, true>(q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n,
                                      scale);
}

template <int D>
__global__ void __launch_bounds__(kCThreads)
    attention_bwd_nobias_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                const float* __restrict__ out, const float* __restrict__ dout,
                                float* __restrict__ dq, float* __restrict__ dk,
                                float* __restrict__ dv, float* __restrict__ dbias, int B,
                                int heads, int n, float scale) {
  cluster_body<D, float, float, false>(q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n,
                                       scale);
}

template <int D, typename TQ>
__global__ void __launch_bounds__(kCThreads)
    attention_bwd_nobias_bf16_kernel(const TQ* __restrict__ q, const uint16_t* __restrict__ k,
                                     const uint16_t* __restrict__ v,
                                     const uint16_t* __restrict__ bias,
                                     const float* __restrict__ out,
                                     const float* __restrict__ dout, TQ* __restrict__ dq,
                                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                                     uint16_t* __restrict__ dbias, int B, int heads, int n,
                                     float scale) {
  cluster_body<D, TQ, uint16_t, false>(q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n,
                                       scale);
}

// ---- the row-split cluster path ----------------------------------------
constexpr int kRWarps = 16;  // the row-split path's block: 16 warps, RW query rows each
constexpr int kRThreads = 32 * kRWarps;
constexpr int RW = 3;
constexpr int kRowsMax = kRWarps * RW;  // 48 query rows a rank

// shared-memory floats of the row-split path (ops/attention_kernel.py:
// bwd_rows_smem_bytes mirrors it): K and V padded, the rank's q, O and dO
// rows, its P / dS tile (which then holds the dk and dv partials), its dbias
// rows
size_t rows_floats(int n, int d) {
  const size_t R = (n + kMaxCluster - 1) / kMaxCluster;
  const size_t tile = R > (size_t)2 * d ? R : (size_t)2 * d;
  return 2 * (size_t)n * (d + 4) + 3 * R * d + (size_t)n * tile + R * n;
}

// Sum N values of each lane over the warp's 32 lanes: while N is even, lanes
// swap halves across a lane bit (each keeps the half its bit selects, plus
// its partner's copy of that half), then the rest are summed across the
// remaining bits. Afterwards a lane holds the sums of values base .. base +
// (N after the halvings) - 1; lanes that differ only in `dup` hold the same.
template <int N, int OFF>
__device__ __forceinline__ void fold_lanes(float* v, int lt, int& base, int& dup) {
  if constexpr (OFF > 0) {
    if constexpr (N % 2 == 0) {
      const bool up = (lt & OFF) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += N / 2;
      fold_lanes<N / 2, OFF / 2>(v, lt, base, dup);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
      dup |= OFF;
      fold_lanes<N, OFF / 2>(v, lt, base, dup);
    }
  }
}
template <int N, int OFF>
struct Folded {
  static constexpr int value = OFF == 0 ? N : (N % 2 == 0 ? Folded<N / 2, OFF / 2>::value : Folded<N, OFF / 2>::value);
};
template <int N>
struct Folded<N, 0> {
  static constexpr int value = N;
};

// One thread-block cluster of 8 ranks per head; rank r owns query rows
// [r R, r R + R), R = ceil(n / 8), and walks the batch in order. Per b:
// stage K and V (padded rows) and the rank's q, O and dO rows; a row phase
// (warp w owns rows w, w + 16, w + 32 for all b, lanes strided over the keys;
// each K or V row read from shared memory serves its 3 rows) forms the
// logits, P and its row sums in the R x n tile; a column phase (a thread per
// key) forms the rank's dv partial P^T dO in registers; the row phase
// overwrites P with dS in place and adds dS into the rank's dbias rows (in b
// order: the same lane owns an element for every b); it forms dq = dS K of
// its rows (lanes' partial sums folded across the warp) and writes them
// once; a column phase forms the dk partial dS^T q; the partials go to the
// tile, and after a cluster barrier each rank adds the ranks' partials in
// rank order through distributed shared memory for a band of keys and
// writes those rows of dk and dv once. The dbias rows are written once at
// the end. lse and D never leave the block. TQ / TKV as in cluster_body:
// float32 training runs <float, float> (biased_attention_bwd_rows), bf16
// training <bf16, bf16> and <float, bf16> (biased_attention_bwd_rows_bf16,
// a 42-keypoint model's level 2 under --bf16 --depth). K, V and the rank's
// rows are staged as float32 either way, so both share one shared-memory
// layout; dbias is rounded once after its b-ordered float32 sum.
template <int D, typename TQ, typename TKV>
__device__ __forceinline__ void rows_body(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                          const TKV* __restrict__ v, const TKV* __restrict__ bias,
                                          const float* __restrict__ out, const float* __restrict__ dout,
                                          TQ* __restrict__ dq, TKV* __restrict__ dk, TKV* __restrict__ dv,
                                          TKV* __restrict__ dbias, int B, int heads, int n, float scale) {
  constexpr bool QB = sizeof(TQ) == 2;  // q bf16: logits and their cotangent rounded
  constexpr int DP = D + 4;             // padded K and V rows
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x, cs = gridDim.x;  // one cluster spans the x extent
  const int h = blockIdx.y;
  const int R = (n + cs - 1) / cs, r0 = rank * R, rows = max(0, min(R, n - r0));
  float* ks = smem;                 // [n][DP]
  float* vs = ks + n * DP;          // [n][DP]
  float* qs = vs + n * DP;          // [R][D] the rank's q rows
  float* gs = qs + R * D;           // [R][D] dO
  float* os = gs + R * D;           // [R][D] the forward's output
  float* tile = os + R * D;         // [R][n] logits, P, then dS; then [2][n][D] dk, dv partials
  float* acc = tile + n * max(R, 2 * D);  // [R][n] the rank's dbias rows, dS summed over b
  const int tid = threadIdx.x, warp = tid >> 5, lt = tid & 31;
  for (int e = tid; e < R * n; e += kRThreads) acc[e] = 0.f;
  int lr[RW];   // this warp's local rows
  bool iv[RW];  // ... within the rank's rows
#pragma unroll
  for (int t = 0; t < RW; ++t) {
    lr[t] = warp + kRWarps * t;
    iv[t] = lr[t] < rows;
  }
  const TKV* bias_h = bias + ((size_t)h * n + r0) * n;
  cg::cluster_group cluster = cg::this_cluster();

  for (int b = 0; b < B; ++b) {
    const size_t bh = (size_t)b * heads + h;
    __syncthreads();  // the previous b's K, V and rows are no longer read
    for (int e = tid; e < n * D / 4; e += kRThreads) {
      const int row = 4 * e / D, c = 4 * e % D;
      stage4(ks + row * DP + c, k + bh * n * D + 4 * e);
      stage4(vs + row * DP + c, v + bh * n * D + 4 * e);
    }
    for (int e = tid; e < rows * D / 4; e += kRThreads) {
      const size_t at = (bh * n + r0) * D + 4 * e;
      stage4(qs + 4 * e, q + at);
      cp_async16(os + 4 * e, out + at);
      cp_async16(gs + 4 * e, dout + at);
    }
    for (int e = tid; e < rows * n; e += kRThreads) stage1(tile + e, bias_h + e);  // the logits' bias
    cp_async_wait();
    __syncthreads();
    float dka[D], dva[D];
#pragma unroll
    for (int c = 0; c < D; ++c) dka[c] = dva[c] = 0.f;
    const int j = tid;  // the column phases' key
    if (rows > 0) {
      // row phase: logits into the tile, row max, then exp and row sum,
      // then P normalised (each lane rereads only what it wrote)
      float inv_l[RW];
      {
        float qr[RW][D], m[RW];
#pragma unroll
        for (int t = 0; t < RW; ++t) {
          m[t] = -INFINITY;
#pragma unroll
          for (int c = 0; c < D; ++c) qr[t][c] = iv[t] ? qs[lr[t] * D + c] : 0.f;
        }
        for (int jj = lt; jj < n; jj += 32) {
          float kj[D];
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            const float4 u = reinterpret_cast<const float4*>(ks + jj * DP)[c];
            kj[4 * c] = u.x; kj[4 * c + 1] = u.y; kj[4 * c + 2] = u.z; kj[4 * c + 3] = u.w;
          }
#pragma unroll
          for (int t = 0; t < RW; ++t) {
            if (!iv[t]) continue;
            float e = 0.f;
#pragma unroll
            for (int c = 0; c < D; ++c) e = fmaf(qr[t][c], kj[c], e);
            if constexpr (QB) e = round_bf16(e);  // the forward's bf16 logit
            float* at = tile + lr[t] * n + jj;
            const float s = fmaf(e, scale, *at);
            *at = s;
            m[t] = fmaxf(m[t], s);
          }
        }
        float l[RW];
#pragma unroll
        for (int t = 0; t < RW; ++t) {
          m[t] = warp_max(m[t]) * kLog2e;
          l[t] = 0.f;
        }
        for (int jj = lt; jj < n; jj += 32) {
#pragma unroll
          for (int t = 0; t < RW; ++t) {
            if (!iv[t]) continue;
            float* p = tile + lr[t] * n + jj;
            const float e = exp2_ftz(fmaf(*p, kLog2e, -m[t]));
            *p = e;
            l[t] += e;
          }
        }
#pragma unroll
        for (int t = 0; t < RW; ++t) inv_l[t] = 1.f / warp_sum(l[t]);
        for (int jj = lt; jj < n; jj += 32) {
#pragma unroll
          for (int t = 0; t < RW; ++t)
            if (iv[t]) tile[lr[t] * n + jj] *= inv_l[t];
        }
      }
      __syncthreads();
      // column phase: the rank's dv partial, P^T dO over its rows
      if (j < n) {
        for (int i = 0; i < rows; ++i) {
          const float p = tile[i * n + j];
          const float4* g = reinterpret_cast<const float4*>(gs + i * D);  // a broadcast
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            const float4 u = g[c];
            dva[4 * c] = fmaf(p, u.x, dva[4 * c]);
            dva[4 * c + 1] = fmaf(p, u.y, dva[4 * c + 1]);
            dva[4 * c + 2] = fmaf(p, u.z, dva[4 * c + 2]);
            dva[4 * c + 3] = fmaf(p, u.w, dva[4 * c + 3]);
          }
        }
      }
      __syncthreads();
      // row phase: dS = P (dO . v - D) over P in place, into the dbias rows
      {
        float gr[RW][D], dlt[RW];
#pragma unroll
        for (int t = 0; t < RW; ++t) {
          dlt[t] = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            gr[t][c] = iv[t] ? gs[lr[t] * D + c] : 0.f;
            if (iv[t]) dlt[t] = fmaf(gr[t][c], os[lr[t] * D + c], dlt[t]);
          }
        }
        for (int jj = lt; jj < n; jj += 32) {
          float vj[D];
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            const float4 u = reinterpret_cast<const float4*>(vs + jj * DP)[c];
            vj[4 * c] = u.x; vj[4 * c + 1] = u.y; vj[4 * c + 2] = u.z; vj[4 * c + 3] = u.w;
          }
#pragma unroll
          for (int t = 0; t < RW; ++t) {
            if (!iv[t]) continue;
            float dp = 0.f;
#pragma unroll
            for (int c = 0; c < D; ++c) dp = fmaf(gr[t][c], vj[c], dp);
            const int at = lr[t] * n + jj;
            const float ds = tile[at] * (dp - dlt[t]);
            acc[at] += ds;
            if constexpr (QB) tile[at] = round_bf16(ds * scale);  // the bf16 logit's cotangent
            else tile[at] = ds;
          }
        }
      }
      // row phase: dq = dS K of the warp's rows, lanes' sums folded
      {
        float dqa[RW * D];
#pragma unroll
        for (int e = 0; e < RW * D; ++e) dqa[e] = 0.f;
        for (int jj = lt; jj < n; jj += 32) {
          float kj[D];
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            const float4 u = reinterpret_cast<const float4*>(ks + jj * DP)[c];
            kj[4 * c] = u.x; kj[4 * c + 1] = u.y; kj[4 * c + 2] = u.z; kj[4 * c + 3] = u.w;
          }
#pragma unroll
          for (int t = 0; t < RW; ++t) {
            if (!iv[t]) continue;
            const float ds = tile[lr[t] * n + jj];
#pragma unroll
            for (int c = 0; c < D; ++c) dqa[t * D + c] = fmaf(ds, kj[c], dqa[t * D + c]);
          }
        }
        int base = 0, dup = 0;
        fold_lanes<RW * D, 16>(dqa, lt, base, dup);
        constexpr int kLeft = Folded<RW * D, 16>::value;
        const float mul = QB ? 1.f : scale;
        if ((lt & dup) == 0) {
#pragma unroll
          for (int e = 0; e < kLeft; ++e) {
            const int t = (base + e) / D, c = (base + e) % D;
            if (lr[t] < rows) store1(dq + (bh * n + r0 + lr[t]) * D + c, dqa[e] * mul);
          }
        }
      }
      __syncthreads();
      // column phase: the rank's dk partial, dS^T q over its rows
      if (j < n) {
        for (int i = 0; i < rows; ++i) {
          const float ds = tile[i * n + j];
          const float4* qv = reinterpret_cast<const float4*>(qs + i * D);  // a broadcast
#pragma unroll
          for (int c = 0; c < D / 4; ++c) {
            const float4 u = qv[c];
            dka[4 * c] = fmaf(ds, u.x, dka[4 * c]);
            dka[4 * c + 1] = fmaf(ds, u.y, dka[4 * c + 1]);
            dka[4 * c + 2] = fmaf(ds, u.z, dka[4 * c + 2]);
            dka[4 * c + 3] = fmaf(ds, u.w, dka[4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // the tile is read; it now takes the partials
    if (j < n) {
      float4* pk = reinterpret_cast<float4*>(tile + j * D);
      float4* pv = reinterpret_cast<float4*>(tile + (n + j) * D);
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        pk[c] = make_float4(dka[4 * c], dka[4 * c + 1], dka[4 * c + 2], dka[4 * c + 3]);
        pv[c] = make_float4(dva[4 * c], dva[4 * c + 1], dva[4 * c + 2], dva[4 * c + 3]);
      }
    }
    cluster.sync();  // every rank's partials are in
    // rank r adds the ranks' partials in rank order over its band of keys
    const int j0 = n * rank / cs, j1 = n * (rank + 1) / cs;
    const int band = (j1 - j0) * D / 4;
    for (int e = tid; e < 2 * band; e += kRThreads) {
      const int which = e / band, f = e % band;  // 0: dk, 1: dv
      const int at = (which * n + j0) * D + 4 * f;
      float4 u[kMaxCluster];  // the launch makes cs = kMaxCluster
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        u[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, r) + at);
      float4 s = u[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        s.x += u[r].x; s.y += u[r].y; s.z += u[r].z; s.w += u[r].w;
      }
      const float mul = (which == 1 || QB) ? 1.f : scale;
      TKV* dst = (which == 0 ? dk : dv) + (bh * n + j0) * D + 4 * f;
      store1(dst, s.x * mul);
      store1(dst + 1, s.y * mul);
      store1(dst + 2, s.z * mul);
      store1(dst + 3, s.w * mul);
    }
    cluster.sync();  // no rank overwrites its tile while another reads it
  }
  TKV* dbias_r = dbias + ((size_t)h * n + r0) * n;
  for (int e = tid; e < rows * n; e += kRThreads) store1(dbias_r + e, acc[e]);
}

template <int D>
__global__ void __launch_bounds__(kRThreads)
    biased_attention_rows_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, const float* __restrict__ bias,
                                     const float* __restrict__ out, const float* __restrict__ dout,
                                     float* __restrict__ dq, float* __restrict__ dk,
                                     float* __restrict__ dv, float* __restrict__ dbias, int B, int heads,
                                     int n, float scale) {
  rows_body<D, float, float>(q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n, scale);
}

template <int D, typename TQ>
__global__ void __launch_bounds__(kRThreads)
    biased_attention_rows_bf16_bwd_kernel(const TQ* __restrict__ q, const uint16_t* __restrict__ k,
                                          const uint16_t* __restrict__ v,
                                          const uint16_t* __restrict__ bias,
                                          const float* __restrict__ out, const float* __restrict__ dout,
                                          TQ* __restrict__ dq, uint16_t* __restrict__ dk,
                                          uint16_t* __restrict__ dv, uint16_t* __restrict__ dbias, int B,
                                          int heads, int n, float scale) {
  rows_body<D, TQ, uint16_t>(q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n, scale);
}

template <int D, typename TQ, typename TKV>
int launch_rows(const TQ* q, const TKV* k, const TKV* v, const TKV* bias, const float* out,
                const float* dout, TQ* dq, TKV* dk, TKV* dv, TKV* dbias, int B, int heads, int n,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * rows_floats(n, D);
  if (smem > 227 * 1024 || heads > 65535 || (n + kMaxCluster - 1) / kMaxCluster > kRowsMax)
    return (int)cudaErrorInvalidValue;
  void (*kern)(const TQ*, const TKV*, const TKV*, const TKV*, const float*, const float*, TQ*, TKV*,
               TKV*, TKV*, int, int, int, float);
  if constexpr (sizeof(TKV) == 4)
    kern = biased_attention_rows_bwd_kernel<D>;
  else
    kern = biased_attention_rows_bf16_bwd_kernel<D, TQ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster, heads, 1);
  cfg.blockDim = dim3(kRThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n,
                         1.f / sqrtf((float)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D, typename TQ, typename TKV, bool BIAS = true>
int launch_cluster(const TQ* q, const TKV* k, const TKV* v, const TKV* bias, const float* out,
                   const float* dout, TQ* dq, TKV* dk, TKV* dv, TKV* dbias, int B, int heads, int n,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * cluster_floats(n, D, BIAS);
  if (smem > 227 * 1024 || heads > 65535) return (int)cudaErrorInvalidValue;
  void (*kern)(const TQ*, const TKV*, const TKV*, const TKV*, const float*, const float*, TQ*, TKV*,
               TKV*, TKV*, int, int, int, float);
  if constexpr (sizeof(TKV) == 4 && BIAS)
    kern = biased_attention_bwd_cluster_kernel<D>;
  else if constexpr (sizeof(TKV) == 4)
    kern = attention_bwd_nobias_kernel<D>;
  else if constexpr (BIAS)
    kern = biased_attention_bf16_bwd_kernel<D, TQ>;
  else
    kern = attention_bwd_nobias_bf16_kernel<D, TQ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int cs = B < kMaxCluster ? B : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, heads, 1);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, q, k, v, bias, out, dout, dq, dk, dv, dbias, B, heads, n,
                         1.f / sqrtf((float)D));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias, const float* out,
           const float* dout, float* dq, float* dk, float* dv, float* dbias, float* lse,
           float* delta, int B, int heads, int n, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)RS * n + 2 * (size_t)n * D);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(biased_attention_bwd_row_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (n + RS - 1) / RS;
  const int ctiles = (n + CT - 1) / CT;
  const long long col_blocks = (long long)B * heads * ctiles;
  if ((long long)heads * tiles >= (1ll << 31) || col_blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)D);
  biased_attention_bwd_row_kernel<D><<<heads * tiles, kThreads, smem, stream>>>(
      q, k, v, bias, out, dout, dq, dbias, lse, delta, B, heads, n, tiles, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  biased_attention_bwd_col_kernel<D><<<(unsigned)col_blocks, kThreads, 0, stream>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, heads, n, ctiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 q, k, v, out, dout (B, heads, n, d), bias (heads, n, n) -> dq, dk, dv
// (B, heads, n, d), dbias (heads, n, n). cluster != 0 takes the one-pass
// cluster path (lse and delta unused); else the two-pass path, for which lse
// and delta (B, heads, n) are scratch the row pass fills for the column pass
extern "C" int biased_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                    const void* out, const void* dout, void* dq, void* dk, void* dv,
                                    void* dbias, void* lse, void* delta, int B, int heads, int n,
                                    int d, int cluster, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(dout)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bias) & 3) != 0)
    return (int)cudaErrorMisalignedAddress;
  const float* a[6] = {static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(bias),
                       static_cast<const float*>(out), static_cast<const float*>(dout)};
  float* o[6] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                 static_cast<float*>(dbias), static_cast<float*>(lse), static_cast<float*>(delta)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                 \
  case DD:                                                                                       \
    return cluster ? launch_cluster<DD, float, float>(a[0], a[1], a[2], a[3], a[4], a[5], o[0],   \
                                                      o[1], o[2], o[3], B, heads, n, s)          \
                   : launch<DD>(a[0], a[1], a[2], a[3], a[4], a[5], o[0], o[1], o[2], o[3], o[4], \
                                o[5], B, heads, n, s);
    CASE(4)
    CASE(8)
    CASE(16)
    CASE(32)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32, the row-split cluster path (d <= 16, rows_floats(n, d) * 4 bytes
// within a block's shared memory and ceil(n / 8) <= 48): the arguments and outputs of
// biased_attention_bwd, no scratch
extern "C" int biased_attention_bwd_rows(const void* q, const void* k, const void* v, const void* bias,
                                         const void* out, const void* dout, void* dq, void* dk, void* dv,
                                         void* dbias, int B, int heads, int n, int d, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(dout)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bias) & 3) != 0)
    return (int)cudaErrorMisalignedAddress;
  const float* a[6] = {static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(bias),
                       static_cast<const float*>(out), static_cast<const float*>(dout)};
  float* o[4] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                 static_cast<float*>(dbias)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                   \
  case DD:                                                                                         \
    return launch_rows<DD, float, float>(a[0], a[1], a[2], a[3], a[4], a[5], o[0], o[1], o[2], o[3], B,  \
                                         heads, n, s);
    CASE(4)
    CASE(8)
    CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 training's backward, the cluster path only (cluster_floats(n, d) * 4
// bytes within a block's shared memory, as at the flagship's level 2): k, v,
// bias bf16 (B, heads, n, d) and (heads, n, n); q bf16 when q_bf16, else
// float32; out and dout float32 -> dq in q's dtype, dk, dv and dbias bf16
extern "C" int biased_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                         const void* bias, const void* out, const void* dout,
                                         void* dq, void* dk, void* dv, void* dbias, int B, int heads,
                                         int n, int d, int q_bf16, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  // q, k, v rows are read in groups of 4 elements: 8-byte lines in bf16,
  // 16-byte ones for a float32 q; O and dO as float4
  if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 7) != 0 ||
      (reinterpret_cast<uintptr_t>(q) & (q_bf16 ? 7 : 15)) != 0 ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dout)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bias) & 1) != 0)
    return (int)cudaErrorMisalignedAddress;
  using bf = uint16_t;
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* bb = static_cast<const bf*>(bias);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  bf* dbb = static_cast<bf*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                   \
  case DD:                                                                                         \
    return q_bf16 ? launch_cluster<DD, bf, bf>(static_cast<const bf*>(q), kb, vb, bb, o, g,       \
                                               static_cast<bf*>(dq), dkb, dvb, dbb, B, heads, n, s) \
                  : launch_cluster<DD, float, bf>(static_cast<const float*>(q), kb, vb, bb, o, g,  \
                                                  static_cast<float*>(dq), dkb, dvb, dbb, B, heads, \
                                                  n, s);
    CASE(4)
    CASE(8)
    CASE(16)
    CASE(32)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 training's backward on the row-split path (as biased_attention_bwd_rows:
// d <= 16, rows_floats(n, d) * 4 bytes within a block's shared memory and
// ceil(n / 8) <= 48, as at a 42-keypoint model's level 2, (378, 16)): the
// arguments, types and outputs of biased_attention_bwd_bf16
extern "C" int biased_attention_bwd_rows_bf16(const void* q, const void* k, const void* v,
                                              const void* bias, const void* out, const void* dout,
                                              void* dq, void* dk, void* dv, void* dbias, int B,
                                              int heads, int n, int d, int q_bf16, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 7) != 0 ||
      (reinterpret_cast<uintptr_t>(q) & (q_bf16 ? 7 : 15)) != 0 ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dout)) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(bias) & 1) != 0)
    return (int)cudaErrorMisalignedAddress;
  using bf = uint16_t;
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const bf* bb = static_cast<const bf*>(bias);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  bf* dbb = static_cast<bf*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                   \
  case DD:                                                                                         \
    return q_bf16 ? launch_rows<DD, bf, bf>(static_cast<const bf*>(q), kb, vb, bb, o, g,          \
                                            static_cast<bf*>(dq), dkb, dvb, dbb, B, heads, n, s)   \
                  : launch_rows<DD, float, bf>(static_cast<const float*>(q), kb, vb, bb, o, g,     \
                                               static_cast<float*>(dq), dkb, dvb, dbb, B, heads, n, \
                                               s);
    CASE(4)
    CASE(8)
    CASE(16)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// no bias, the cluster path (cluster_floats(n, d, false) * 4 bytes within a
// block's shared memory, as at the global variant's (28, d <= 128)): float32
// q, k, v, out, dout -> dq, dk, dv; no dbias. The yardstick of
// attention_nobias.cu's backward (on no path)
extern "C" int biased_attention_bwd_nobias_cluster(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, void* dq, void* dk,
                                           void* dv, int B, int heads, int n, int d, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(dout)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const float* a[5] = {static_cast<const float*>(q), static_cast<const float*>(k),
                       static_cast<const float*>(v), static_cast<const float*>(out),
                       static_cast<const float*>(dout)};
  float* o[3] = {static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                   \
  case DD:                                                                                         \
    return launch_cluster<DD, float, float, false>(a[0], a[1], a[2], nullptr, a[3], a[4], o[0],    \
                                                   o[1], o[2], nullptr, B, heads, n, s);
    CASE(4)
    CASE(8)
    CASE(16)
    CASE(32)
    CASE(64)
    CASE(128)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// no bias, bf16 training's cluster path: k, v bf16, q bf16 when q_bf16, else
// float32; out and dout float32 -> dq in q's dtype, dk and dv bf16. The
// yardstick of attention_nobias.cu's bf16 backward (on no path)
extern "C" int biased_attention_bwd_nobias_cluster_bf16(const void* q, const void* k, const void* v,
                                                const void* out, const void* dout, void* dq,
                                                void* dk, void* dv, int B, int heads, int n, int d,
                                                int q_bf16, void* stream) {
  if (B <= 0 || heads <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 7) != 0 ||
      (reinterpret_cast<uintptr_t>(q) & (q_bf16 ? 7 : 15)) != 0 ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dout)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  using bf = uint16_t;
  const bf* kb = static_cast<const bf*>(k);
  const bf* vb = static_cast<const bf*>(v);
  const float* o = static_cast<const float*>(out);
  const float* g = static_cast<const float*>(dout);
  bf* dkb = static_cast<bf*>(dk);
  bf* dvb = static_cast<bf*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
#define CASE(DD)                                                                                   \
  case DD:                                                                                         \
    return q_bf16 ? launch_cluster<DD, bf, bf, false>(static_cast<const bf*>(q), kb, vb, nullptr,  \
                                                      o, g, static_cast<bf*>(dq), dkb, dvb,        \
                                                      nullptr, B, heads, n, s)                     \
                  : launch_cluster<DD, float, bf, false>(static_cast<const float*>(q), kb, vb,     \
                                                         nullptr, o, g, static_cast<float*>(dq),   \
                                                         dkb, dvb, nullptr, B, heads, n, s);
    CASE(4)
    CASE(8)
    CASE(16)
    CASE(32)
    CASE(64)
    CASE(128)
#undef CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
