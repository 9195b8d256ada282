"""Biased attention softmax(q k^T / sqrt(d) + bias) v: the CUDA kernels
(`csrc/biased_attention.cu`: one forward design instantiated for float32 and
for bf16 serving, which holds a head's K, V and a tile's bias rows in shared
memory, and a key-tiled float32 forward for the n beyond that, as a
42-keypoint model's levels 0 and 1 have; `csrc/biased_attention_bwd.cu`: the
float32 backward, one cluster launch where a (batch, head) problem fits in a
block's shared memory, as at training's level 2, else two passes) and their
plain PyTorch versions.

Counterpart of `sgtapose_tpu/ops/attention_kernel.py:fused_biased_attention`
(a Pallas TPU kernel) and of its custom VJP `_bwd_rule` (a recompute through
the XLA formulation). `fused_biased_attention` is a `torch.autograd.Function`:
on the card its forward and backward always run kernels; the plain versions
are what a CPU tensor gets, and what the kernels are held against. The
backward saves the forward's output beside q, k, v and the bias, and
recomputes the probabilities. Training runs float32; a bf16 backward raises
(bf16 training is not ported).

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
KERNEL_TILED = "biased_attention_tiled"
BWD_KERNEL = "biased_attention_bwd"
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


def fits_smem(n: int, d: int, elem_bytes: int = 4) -> bool:
    """Whether the shared-memory kernel takes (n, d); beyond it float32 runs
    the key-tiled kernel."""
    return kernel_smem_bytes(n, d, elem_bytes) <= _SMEM_LIMIT


def plain_biased_attention(q, k, v, bias):
    """q, k, v: (B, heads, n, d); bias: (heads, n, n) -> (B, heads, n, d)."""
    d = q.shape[-1]
    energy = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d)
    p = torch.softmax(energy + bias, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v)


def plain_biased_attention_backward(q, k, v, bias, out, dout):
    """The backward's formulas step by step (float32): with S = q k^T / sqrt(d)
    + bias, P = softmax(S), D_i = dO_i . O_i and dS = P (dO v^T - D),
    returns dq = dS k / sqrt(d), dk = dS^T q / sqrt(d), dv = P^T dO and
    dbias = sum over the batch of dS."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * scale + bias, dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, v) - delta)
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q) * scale
    dv = torch.einsum("bhij,bhid->bhjd", p, dout)
    return dq, dk, dv, ds.sum(0)


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


TILE_KEYS = 256  # keys per chunk of the key-tiled kernel


def key_tiled_attention(q, k, v, bias, tile_keys: int = TILE_KEYS):
    """The key-tiled kernel's arithmetic in plain PyTorch: keys in chunks of
    `tile_keys`, lane t of a row taking keys t, t+32, ... of each chunk; per
    chunk each lane takes its own max, rescales its running sums of p and p v
    by 2^((old max - new max) log2 e) and adds the chunk's terms relative to
    the new max; the lanes' sums are merged relative to the row max. Same
    function as `plain_biased_attention`."""
    d, n = q.shape[-1], q.shape[-2]
    lanes = ROW_LANES
    log2e = 1.0 / math.log(2.0)
    s = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(d) + bias
    lead = s.shape[:-1]
    m = torch.full(lead + (lanes,), -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros(lead + (lanes,), dtype=q.dtype, device=q.device)
    acc = torch.zeros(lead + (lanes, d), dtype=q.dtype, device=q.device)
    for j0 in range(0, n, tile_keys):
        cnt = min(tile_keys, n - j0)
        pad = -cnt % lanes
        sc = torch.nn.functional.pad(s[..., j0:j0 + cnt], (0, pad), value=-math.inf)
        vc = torch.nn.functional.pad(v[..., j0:j0 + cnt, :], (0, 0, 0, pad))
        sc = sc.unflatten(-1, (-1, lanes))  # (..., key // 32, lane)
        vc = vc.unflatten(-2, (-1, lanes))  # (b, h, key // 32, lane, d)
        mn = torch.maximum(m, sc.amax(dim=-2))
        f = torch.where(mn == -math.inf, torch.ones_like(m), torch.exp2((m - mn) * log2e))
        p = torch.exp2(sc * log2e - torch.where(mn == -math.inf, torch.zeros_like(mn), mn)[..., None, :] * log2e)
        l = l * f + p.sum(dim=-2)
        acc = acc * f[..., None] + torch.einsum("bhiul,bhuld->bhild", p, vc)
        m = mn
    mx = m.amax(dim=-1, keepdim=True)
    f = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2((m - mx) * log2e))
    return (acc * f[..., None]).sum(dim=-2) / (l * f).sum(dim=-1, keepdim=True)


def _check(q, k, v, bias, bf16: bool = False, smem: bool = True):
    """Shapes, devices, dtypes (float32; or bf16 k, v, bias with a bf16 or
    float32 q), contiguity and the kernel's limits (with smem, the
    shared-memory kernel's)."""
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
    need = kernel_smem_bytes(n, d, 2 if bf16 else 4)
    if smem and need > _SMEM_LIMIT:
        raise ValueError(f"n={n}, d={d} needs {need} B of shared memory, more than the kernel's {_SMEM_LIMIT}")


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


def biased_attention_tiled_cuda(q, k, v, bias):
    """Launch the float32 key-tiled kernel on the current stream (CUDA
    tensors only): any n, K and V staged in chunks, the bias read straight
    from device memory."""
    _check(q, k, v, bias, smem=False)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_tiled_cuda needs CUDA tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as float4)")
    B, h, n, d = q.shape
    out = torch.empty_like(q)
    fn = build.kernel_fn(KERNEL_TILED)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 B, h, n, d, stream)
    build.check(KERNEL_TILED, err)
    build.count_launch(KERNEL_TILED)
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


def bwd_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the two-pass backward's row pass: 8 bias rows, their
    8 dbias rows, and K and V of one (batch, head)."""
    return 4 * (2 * _ROWS * n + 2 * n * d)


# the backward's cluster path (csrc/biased_attention_bwd.cu): one block per
# (batch element, head), up to 8 batch elements per cluster
BWD_CLUSTER = 8


def bwd_cluster_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the backward's one-pass cluster path: K and V of one
    (batch, head) in rows padded to d + 4 floats, q, O and dO, the head's
    bias, P, dS and the block's dbias sum (n x n each), and D (n)."""
    return 4 * (2 * n * (d + 4) + 3 * n * d + 4 * n * n + n)


def bwd_uses_cluster(n: int, d: int) -> bool:
    """The backward's path: one cluster launch when a whole (batch, head)
    problem fits in one block's shared memory (level 2 of the flagship,
    (63, 16), and (100, 8)), else the two-pass kernels (levels 0 and 1)."""
    return bwd_cluster_smem_bytes(n, d) <= _SMEM_LIMIT


def cluster_biased_attention_backward(q, k, v, bias, out, dout, cluster: int = BWD_CLUSTER):
    """The cluster path's dbias order in plain PyTorch: rank r of a cluster
    of min(B, cluster) blocks sums dS of b = r, r + cluster, ... in order,
    and the ranks' sums are added in rank order. dq, dk and dv are those of
    `plain_biased_attention_backward`, whose dbias this equals up to the
    order of the float32 additions."""
    dq, dk, dv, _ = plain_biased_attention_backward(q, k, v, bias, out, dout)
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * scale + bias, dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, v) - delta)
    B = q.shape[0]
    cs = min(B, cluster)
    ranks = []
    for r in range(cs):
        acc = torch.zeros_like(bias)
        for b in range(r, B, cs):
            acc = acc + ds[b]
        ranks.append(acc)
    dbias = ranks[0]
    for acc in ranks[1:]:
        dbias = dbias + acc
    return dq, dk, dv, dbias


def biased_attention_bwd_cuda(q, k, v, bias, out, dout):
    """Launch the float32 backward on the current stream (CUDA tensors only):
    (dq, dk, dv, dbias) of `plain_biased_attention_backward`, dbias summed
    over the batch in a fixed order (no atomics). One launch either way: the
    cluster path where `bwd_uses_cluster`, else the two-pass kernels."""
    _check(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_bwd_cuda needs CUDA tensors")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape)} tensor on {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("q, k, v, out, dout must start on a 16-byte boundary (rows are read as float4)")
    B, h, n, d = q.shape
    cluster = bwd_uses_cluster(n, d)
    smem = bwd_smem_bytes(n, d)
    if not cluster and smem > _SMEM_LIMIT:
        raise ValueError(f"n={n}, d={d}: the backward needs {smem} B of shared memory, more than {_SMEM_LIMIT}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    scratch = 0 if cluster else (B, h, n)
    lse, delta = (torch.empty(scratch, dtype=torch.float32, device=q.device) for _ in range(2))
    fn = build.kernel_fn(BWD_KERNEL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), B, h, n, d, int(cluster), stream)
    build.check(BWD_KERNEL, err)
    build.count_launch(BWD_KERNEL)
    return dq, dk, dv, dbias


class _BiasedAttention(torch.autograd.Function):
    """Forward through the kernel of the inputs' dtype and size (plain on
    the CPU); backward through `biased_attention_bwd_cuda` (plain on the
    CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        bf16 = k.dtype == torch.bfloat16
        if q.device.type == "cpu":
            out = plain_biased_attention_bf16(q, k, v, bias) if bf16 else plain_biased_attention(q, k, v, bias)
        elif bf16:
            out = biased_attention_bf16_cuda(q, k, v, bias)
        elif fits_smem(q.shape[-2], q.shape[-1]):
            out = biased_attention_cuda(q, k, v, bias)
        else:
            out = biased_attention_tiled_cuda(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out = ctx.saved_tensors
        if any(t.dtype != torch.float32 for t in (q, k, v, bias)):
            raise NotImplementedError("biased attention backward: bf16 training is not ported (float32 only)")
        dout = dout.contiguous()
        if q.device.type == "cpu":
            return plain_biased_attention_backward(q, k, v, bias, out, dout)
        return biased_attention_bwd_cuda(q, k, v, bias, out, dout)


def fused_biased_attention(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v with q, k, v (B, heads, n, d) and a
    (heads, n, n) bias shared across the batch; float32, or bf16 k, v, bias
    (module docstring), always returning float32. Differentiable (float32).
    CUDA tensors go through the hand-written kernels of their dtype (float32
    beyond the shared-memory kernel's n: the key-tiled kernel; bf16 there
    raises); CPU tensors take the plain versions."""
    return _BiasedAttention.apply(q, k, v, bias)
