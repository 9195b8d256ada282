// Biased attention forward: out = softmax(q k^T / sqrt(d) + bias) v.
//
// Replaces the Pallas TPU kernel sgtapose_tpu/ops/attention_kernel.py
// (_fwd_kernel / _fwd / fused_biased_attention): same function, float32
// accumulation, no logits written to device memory.
//
// Shapes: q, k, v, out are (B, heads, n, d) contiguous float32; bias is a
// learned (heads, n, n) float32 tensor shared across the batch. On the
// flagship model (n, d) is (1183, 4), (343, 8) and (63, 16).
//
// What bounds it on an H100: d <= 16, so the products are a few hundred
// MFLOP; the work is reading the bias once (8 * 1183^2 * 4 B = 44.8 MB at
// level 0, ~13.4 us at 3.35 TB/s). Design:
//   * one block per (batch, head, tile of 8*R query rows); its head's K and V
//     (n*d floats each, 38 KB at level 0) are staged in shared memory,
//     transposed to [d][n] so a warp's 32 key columns are 32 banks;
//   * each warp owns R query rows; lane j walks keys j, j+32, ... so the 32
//     lanes read 32 neighbouring bias columns of a row (coalesced) and every
//     bias element is read exactly once per batch element;
//   * each lane keeps an online softmax (running max, sum, d-vector) per row
//     over its keys, merged across the warp with shuffles at the end;
//   * the ragged n edge is masked in the kernel: no padding of q/k/v/bias
//     (the TPU version pads the bias to a multiple of 128 on every call).
// R = 16 / d rows per warp keeps R independent bias loads in flight per lane
// while the per-thread state (R * (2 + 2d) floats) stays in registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;

template <int D, int R>
__global__ void __launch_bounds__(kWarps * 32)
    biased_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ out, int heads, int n, float scale) {
  extern __shared__ float smem[];
  float* kT = smem;          // [D][n]
  float* vT = smem + D * n;  // [D][n]
  const int h = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * heads + h;
  const float* kb = k + bh * n * D;
  const float* vb = v + bh * n * D;
  for (int e = threadIdx.x; e < n * D; e += blockDim.x) {
    const int j = e / D, c = e % D;
    kT[c * n + j] = kb[e];
    vT[c * n + j] = vb[e];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  if (row0 >= n) return;

  float qr[R][D], m[R], l[R], acc[R][D];
  const float* brow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + r, n - 1);  // rows past n compute row n-1, never stored
    const float* qi = q + (bh * n + i) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qr[r][c] = qi[c];
      acc[r][c] = 0.f;
    }
    brow[r] = bias + ((size_t)h * n + i) * n;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int j = lane; j < n; j += 32) {
    float kj[D], vj[D], bj[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bj[r] = __ldg(brow[r] + j);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      kj[c] = kT[c * n + j];
      vj[c] = vT[c * n + j];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) s = fmaf(qr[r][c], kj[c], s);
      s = s * scale + bj[r];
      const float mn = fmaxf(m[r], s);
      const float corr = (m[r] == -INFINITY) ? 0.f : expf(m[r] - mn);
      const float p = (mn == -INFINITY) ? 0.f : expf(s - mn);
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[r][c] = acc[r][c] * corr + p * vj[c];
      m[r] = mn;
    }
  }

  // butterfly merge of the 32 per-lane softmax states: every lane ends with
  // the full row
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], m_o);
      const float c1 = (m[r] == -INFINITY) ? 0.f : expf(m[r] - mn);
      const float c2 = (m_o == -INFINITY) ? 0.f : expf(m_o - mn);
      l[r] = l[r] * c1 + l_o * c2;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float a_o = __shfl_xor_sync(0xffffffffu, acc[r][c], off);
        acc[r][c] = acc[r][c] * c1 + a_o * c2;
      }
      m[r] = mn;
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= n) break;
    float* oi = out + (bh * n + i) * D;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < D; ++c)
      if (lane == c) oi[c] = acc[r][c] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias, float* out, int B,
           int heads, int n, cudaStream_t stream) {
  constexpr int R = D >= 16 ? 1 : 16 / D;
  const size_t smem = 2 * (size_t)n * D * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(biased_attention_kernel<D, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows_per_block = kWarps * R;
  dim3 grid((n + rows_per_block - 1) / rows_per_block, heads, B);
  const float scale = 1.0f / sqrtf((float)D);
  biased_attention_kernel<D, R><<<grid, kWarps * 32, smem, stream>>>(q, k, v, bias, out, heads, n,
                                                                     scale);
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
  if (B <= 0 || heads <= 0 || n <= 0 || B > 65535 || heads > 65535) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 4: return launch<4>(qf, kf, vf, bf, of, B, heads, n, s);
    case 8: return launch<8>(qf, kf, vf, bf, of, B, heads, n, s);
    case 16: return launch<16>(qf, kf, vf, bf, of, B, heads, n, s);
    case 32: return launch<32>(qf, kf, vf, bf, of, B, heads, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
