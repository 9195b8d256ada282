"""Biased attention softmax(q k^T / sqrt(d) + bias) v: the CUDA kernels
(`csrc/biased_attention.cu`, one design instantiated for float32 and for bf16
serving) and their plain PyTorch versions.

Counterpart of `sgtapose_tpu/ops/attention_kernel.py:fused_biased_attention`
(a Pallas TPU kernel). On the card the port always runs a kernel; the plain
versions are what a CPU tensor gets, and what the kernels are held against.
Forward only: training is a later slice.

bf16: the port follows the JAX package's DEFAULT attention form
(`fused_attention=False`, `sgtapose_tpu/models/attention.py:175-180`), which
is what its detector and benchmark run, not the Pallas path. Under bf16
serving that form takes bf16 k, v and pos_embed, and a q that is bf16 on the
first of the tied layers and float32 on the others (their query comes from a
float32 LayerNorm). With a bf16 q the q.k logit is rounded to bf16; dividing
by the float32 sqrt(d) makes the logits float32, and the bias add, softmax
and p.v product run in float32, so the output is float32. (The Pallas path
casts the bias to q's dtype and returns q's dtype, bf16: another function.)
"""

from __future__ import annotations

import math

import torch

from sgtapose_tpu_torch.ops import build

KERNEL = "biased_attention"
KERNEL_BF16 = "biased_attention_bf16"
SUPPORTED_HEAD_DIMS = (4, 8, 16, 32)
# the kernel's layout (csrc/biased_attention.cu): blocks of 8 warps, one
# warp (ROW_LANES lanes) per query row, a 2-stage ring of bias spans
ROW_LANES, _ROWS, _STAGES = 32, 8, 2
_SMEM_LIMIT = 227 * 1024


def kernel_smem_bytes(n: int, d: int, elem_bytes: int = 4) -> int:
    """Shared memory the kernel needs: K and V of one head and the ring of
    8-row bias spans, each copied in whole 16-byte lines from any element's
    start (up to 16 - elem_bytes bytes of line offset); elem_bytes is 4 for
    float32, 2 for bf16."""
    def span(elems):
        return 16 * ((elem_bytes * elems + 31 - elem_bytes) // 16)
    return 2 * span(n * d) + _STAGES * span(_ROWS * n)


def plain_biased_attention(q, k, v, bias):
    """q, k, v: (B, heads, n, d); bias: (heads, n, n) -> (B, heads, n, d)."""
    d = q.shape[-1]
    energy = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d)
    p = torch.softmax(energy + bias, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v)


def plain_biased_attention_bf16(q, k, v, bias):
    """The JAX default form under bf16 serving, step by step (module
    docstring): k, v, bias bf16; q bf16 (the q.k logit rounded to bf16) or
    float32 (not rounded) -> float32 (B, heads, n, d)."""
    f32 = torch.float32
    d = q.shape[-1]
    energy = torch.einsum("bhid,bhjd->bhij", q.to(f32), k.to(f32))
    if q.dtype == torch.bfloat16:
        energy = energy.to(torch.bfloat16).to(f32)
    p = torch.softmax(energy / math.sqrt(d) + bias.to(f32), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v.to(f32))


def split_lane_attention(q, k, v, bias):
    """The kernel's arithmetic in plain PyTorch: the logits, the row max,
    then keys split strided over 32 lanes (lane t takes keys t, t+32, ...),
    each lane's sums of p = 2^(s log2 e - max log2 e) and of p v, and the
    lanes' sums added. Same function as `plain_biased_attention`; it shows
    the split-and-merge is exact."""
    d, n = q.shape[-1], q.shape[-2]
    lanes = ROW_LANES
    log2e = 1.0 / math.log(2.0)
    s = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d) + bias
    p = torch.exp2(s * log2e - s.amax(dim=-1, keepdim=True) * log2e)
    owner = torch.nn.functional.one_hot(torch.arange(n, device=q.device) % lanes, lanes).to(q.dtype)
    lane_l = torch.einsum("bhij,jg->bhig", p, owner)
    lane_acc = torch.einsum("bhij,jg,bhjd->bhigd", p, owner, v)
    return lane_acc.sum(dim=-2) / lane_l.sum(dim=-1, keepdim=True)


def _check(q, k, v, bias, bf16: bool = False):
    """Shapes, devices, dtypes (float32; or bf16 k, v, bias with a bf16 or
    float32 q), contiguity and the kernel's limits."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, heads, n, d) shape, got {q.shape}, {k.shape}, {v.shape}")
    B, h, n, d = q.shape
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be (heads, n, n) = {(h, n, n)}, got {tuple(bias.shape)}")
    kv_dtype = torch.bfloat16 if bf16 else torch.float32
    q_dtypes = (torch.bfloat16, torch.float32) if bf16 else (torch.float32,)
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in (q_dtypes if name == "q" else (kv_dtype,)):
            raise ValueError(f"{name} must be {q_dtypes if name == 'q' else kv_dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the CUDA kernel {SUPPORTED_HEAD_DIMS}")
    smem = kernel_smem_bytes(n, d, 2 if bf16 else 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"n={n}, d={d} needs {smem} B of shared memory, more than the kernel's {_SMEM_LIMIT}")


def biased_attention_cuda(q, k, v, bias):
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    _check(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_cuda needs CUDA tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as float4)")
    B, h, n, d = q.shape
    out = torch.empty_like(q)
    fn = build.kernel_fn(KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 B, h, n, d, stream)
    build.check(KERNEL, err)
    build.count_launch(KERNEL)
    return out


def biased_attention_bf16_cuda(q, k, v, bias):
    """Launch the bf16 CUDA kernel on the current stream (CUDA tensors only):
    bf16 k, v, bias; bf16 or float32 q; float32 out."""
    _check(q, k, v, bias, bf16=True)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_bf16_cuda needs CUDA tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as vectors)")
    B, h, n, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = build.kernel_fn(KERNEL_BF16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 B, h, n, d, int(q.dtype == torch.bfloat16), stream)
    build.check(KERNEL_BF16, err)
    build.count_launch(KERNEL_BF16)
    return out


def fused_biased_attention(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v with q, k, v (B, heads, n, d) and a
    (heads, n, n) bias shared across the batch; float32, or bf16 k, v, bias
    (module docstring), always returning float32. CUDA tensors go through the
    hand-written kernel of their dtype (or raise); CPU tensors take the plain
    version."""
    bf16 = k.dtype == torch.bfloat16
    if q.device.type == "cpu":
        return plain_biased_attention_bf16(q, k, v, bias) if bf16 else plain_biased_attention(q, k, v, bias)
    return biased_attention_bf16_cuda(q, k, v, bias) if bf16 else biased_attention_cuda(q, k, v, bias)
