"""Biased attention softmax(q k^T / sqrt(d) + bias) v: the CUDA kernel
(`csrc/biased_attention.cu`) and its plain PyTorch version.

Counterpart of `sgtapose_tpu/ops/attention_kernel.py:fused_biased_attention`
(a Pallas TPU kernel). On the card the port always runs the kernel; the plain
version (the JAX package's `_xla_attention`) is what a CPU tensor gets, and
what the kernel is held against. Forward only: training is a later slice.
"""

from __future__ import annotations

import math

import torch

from sgtapose_tpu_torch.ops import build

KERNEL = "biased_attention"
SUPPORTED_HEAD_DIMS = (4, 8, 16, 32)


def plain_biased_attention(q, k, v, bias):
    """q, k, v: (B, heads, n, d); bias: (heads, n, n) -> (B, heads, n, d)."""
    d = q.shape[-1]
    energy = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d)
    p = torch.softmax(energy + bias, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v)


def _check(q, k, v, bias):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, heads, n, d) shape, got {q.shape}, {k.shape}, {v.shape}")
    B, h, n, d = q.shape
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be (heads, n, n) = {(h, n, n)}, got {tuple(bias.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the CUDA kernel {SUPPORTED_HEAD_DIMS}")


def biased_attention_cuda(q, k, v, bias):
    """Launch the CUDA kernel on the current stream (CUDA tensors only)."""
    _check(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_cuda needs CUDA tensors")
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


def fused_biased_attention(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v with q, k, v (B, heads, n, d) and a
    (heads, n, n) bias shared across the batch. CUDA tensors go through the
    hand-written kernel (or raise); CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return plain_biased_attention(q, k, v, bias)
    return biased_attention_cuda(q, k, v, bias)
