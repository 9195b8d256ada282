"""Biased attention softmax(q k^T / sqrt(d) + bias) v: the CUDA kernels
(`csrc/biased_attention.cu`: one forward design instantiated for float32 and
for bf16, which holds a head's K, V and a tile's bias rows in shared
memory, and a key-tiled float32 forward for the n beyond that, as a
42-keypoint model's levels 0 and 1 have; `csrc/biased_attention_bwd.cu`: the
backward, one cluster launch where a (batch, head) problem fits in a
block's shared memory, as at training's level 2, in float32 and in bf16;
else, where a head's query rows split over a cluster's 8 ranks, one
row-split cluster launch, as at a 42-keypoint model's level 2, float32
only; else two passes, float32 only) and their plain PyTorch versions.

Counterpart of `sgtapose_tpu/ops/attention_kernel.py:fused_biased_attention`
(a Pallas TPU kernel) and of its custom VJP `_bwd_rule` (a recompute through
the XLA formulation). `fused_biased_attention` is a `torch.autograd.Function`:
on the card its forward and backward always run kernels; the plain versions
are what a CPU tensor gets, and what the kernels are held against. The
backward saves the forward's output beside q, k, v and the bias, and
recomputes the probabilities. Its dtype follows the forward's: float32, or
bf16 training's (below) on the cluster path; a bf16 backward at an (n, d)
beyond the cluster path raises on the card (ROADMAP.md Queue 1 item 10,
`--bf16 --depth`).

bf16: the port follows the JAX package's DEFAULT attention form
(`fused_attention=False`, `sgtapose_tpu/models/attention.py:175-180`), which
is what its detector and benchmark run, not the Pallas path. Under bf16
serving that form takes bf16 k, v and pos_embed, and a q that is bf16 on the
first of the tied layers and float32 on the others (their query comes from a
float32 LayerNorm). With a bf16 q the q.k logit is rounded to bf16; dividing
by the float32 sqrt(d) makes the logits float32, and the bias add, softmax
and p.v product run in float32, so the output is float32. (The Pallas path
casts the bias to q's dtype and returns q's dtype, bf16: another function.)
bf16 training differentiates that same default form, as XLA's autodiff
does under bf16 parameters (`plain_biased_attention_backward_bf16`): with a
bf16 q the logit's cotangent dS / sqrt(d) is rounded to bf16 before the dq
and dk products and dq, dk, dv come out bf16; with a float32 q, dq is
float32 and dk, dv are rounded once; dbias is the batch sum of float32 dS,
rounded once to bf16 (pos_embed is bf16, promoted in `energy + bias`).

No bias (`bias=None`): the plain MHA of the global-attention variant
(`sgtapose_tpu/models/variants.py:SGTAPoseGlobal`, `pos_embed=False`) at
(n, d) = (28, 4 ... 128). On the card the forward runs the no-bias
instantiations of the same kernels (`biased_attention_nobias`, `_bf16`: no
bias read, no bias span staged) and the backward those of the cluster path
(`biased_attention_bwd_nobias`, `_bf16`: no dbias formed or written); an
(n, d) beyond the cluster path raises. The gradient of the bias is None.
"""

from __future__ import annotations

import math

import torch

from sgtapose_tpu_torch.ops import build

KERNEL = "biased_attention"
KERNEL_BF16 = "biased_attention_bf16"
KERNEL_TILED = "biased_attention_tiled"
BWD_KERNEL = "biased_attention_bwd"
BWD_KERNEL_BF16 = "biased_attention_bwd_bf16"
BWD_KERNEL_ROWS = "biased_attention_bwd_rows"
KERNEL_NOBIAS = "biased_attention_nobias"
KERNEL_NOBIAS_BF16 = "biased_attention_nobias_bf16"
BWD_KERNEL_NOBIAS = "biased_attention_bwd_nobias"
BWD_KERNEL_NOBIAS_BF16 = "biased_attention_bwd_nobias_bf16"
SUPPORTED_HEAD_DIMS = (4, 8, 16, 32, 64, 128)
# 64 and 128 are the global variant's, which has no bias
BIASED_HEAD_DIM_MAX = 32
# the biased backward's head dims (the flagship's 4 ... 16 and 32); the
# no-bias cluster path takes every SUPPORTED_HEAD_DIMS
BWD_HEAD_DIMS = (4, 8, 16, 32)
# the kernel's layout (csrc/biased_attention.cu): blocks of 8 warps, one
# warp (ROW_LANES lanes) per query row, a 2-stage ring of bias spans
ROW_LANES, _ROWS, _STAGES = 32, 8, 2
_SMEM_LIMIT = 227 * 1024


def kernel_smem_bytes(n: int, d: int, elem_bytes: int = 4, bias: bool = True) -> int:
    """Shared memory the kernel needs: K and V of one head and (with a bias)
    the ring of 8-row bias spans, each copied in whole 16-byte lines from
    any element's start (up to 16 - elem_bytes bytes of line offset);
    elem_bytes is 4 for float32, 2 for bf16."""
    def span(elems):
        return 16 * ((elem_bytes * elems + 31 - elem_bytes) // 16)
    return 2 * span(n * d) + (_STAGES * span(_ROWS * n) if bias else 0)


def fits_smem(n: int, d: int, elem_bytes: int = 4) -> bool:
    """Whether the shared-memory kernel takes (n, d); beyond it float32 runs
    the key-tiled kernel."""
    return kernel_smem_bytes(n, d, elem_bytes) <= _SMEM_LIMIT


def _add_bias(energy, bias):
    return energy if bias is None else energy + bias


def sqrt_d(d: int) -> float:
    """sqrt(d) rounded to float32, the JAX form's divisor in every dtype
    (`jnp.sqrt(jnp.float32(d))`; in float32 the same as math.sqrt(d))."""
    return float(torch.tensor(float(d), dtype=torch.float32).sqrt())


def plain_biased_attention(q, k, v, bias):
    """q, k, v: (B, heads, n, d); bias: (heads, n, n) or None -> (B, heads,
    n, d)."""
    d = q.shape[-1]
    energy = torch.einsum("bhid,bhjd->bhij", q, k) / sqrt_d(d)
    p = torch.softmax(_add_bias(energy, bias), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v)


def plain_biased_attention_backward(q, k, v, bias, out, dout):
    """The backward's formulas step by step (float32): with S = q k^T / sqrt(d)
    + bias, P = softmax(S), D_i = dO_i . O_i and dS = P (dO v^T - D),
    returns dq = dS k / sqrt(d), dk = dS^T q / sqrt(d), dv = P^T dO and
    dbias = sum over the batch of dS (None without a bias)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(_add_bias(torch.einsum("bhid,bhjd->bhij", q, k) * scale, bias), dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, v) - delta)
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q) * scale
    dv = torch.einsum("bhij,bhid->bhjd", p, dout)
    return dq, dk, dv, None if bias is None else ds.sum(0)


def plain_biased_attention_bf16(q, k, v, bias):
    """The JAX default form under bf16 serving, step by step (module
    docstring): k, v, bias bf16; q bf16 (the q.k logit rounded to bf16) or
    float32 (not rounded) -> float32 (B, heads, n, d)."""
    f32 = torch.float32
    d = q.shape[-1]
    energy = torch.einsum("bhid,bhjd->bhij", q.to(f32), k.to(f32))
    if q.dtype == torch.bfloat16:
        energy = energy.to(torch.bfloat16).to(f32)
    p = torch.softmax(_add_bias(energy / math.sqrt(d), None if bias is None else bias.to(f32)), dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p, v.to(f32))


def plain_biased_attention_backward_bf16(q, k, v, bias, out, dout):
    """The autograd of `plain_biased_attention_bf16` written out (module
    docstring), given its float32 output and float32 dout: the float32
    formulas of `plain_biased_attention_backward` from the bf16 inputs
    widened, with dS / sqrt(d) rounded to bf16 when q is bf16, each output
    rounded once to its input's dtype (dq to q's, dk, dv and dbias to bf16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    d = q.shape[-1]
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    energy = torch.einsum("bhid,bhjd->bhij", qf, kf)
    if q.dtype == bf16:
        energy = energy.to(bf16).to(f32)
    p = torch.softmax(_add_bias(energy / math.sqrt(d), None if bias is None else bias.to(f32)), dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, vf) - delta)
    de = ds / math.sqrt(d)
    if q.dtype == bf16:
        de = de.to(bf16).to(f32)
    dq = torch.einsum("bhij,bhjd->bhid", de, kf)
    dk = torch.einsum("bhij,bhid->bhjd", de, qf)
    dv = torch.einsum("bhij,bhid->bhjd", p, dout)
    return dq.to(q.dtype), dk.to(bf16), dv.to(bf16), None if bias is None else ds.sum(0).to(bf16)


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
    shared-memory kernel's). bias may be None."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, heads, n, d) shape, got {q.shape}, {k.shape}, {v.shape}")
    B, h, n, d = q.shape
    if bias is not None and tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias must be (heads, n, n) = {(h, n, n)}, got {tuple(bias.shape)}")
    kv_dtype = torch.bfloat16 if bf16 else torch.float32
    q_dtypes = (torch.bfloat16, torch.float32) if bf16 else (torch.float32,)
    named = (("q", q), ("k", k), ("v", v)) + ((("bias", bias),) if bias is not None else ())
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in (q_dtypes if name == "q" else (kv_dtype,)):
            raise ValueError(f"{name} must be {q_dtypes if name == 'q' else kv_dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the CUDA kernel {SUPPORTED_HEAD_DIMS}")
    if bias is not None and d > BIASED_HEAD_DIM_MAX:
        raise ValueError(f"head dim {d}: the kernel takes a bias at head dims up to {BIASED_HEAD_DIM_MAX}")
    need = kernel_smem_bytes(n, d, 2 if bf16 else 4, bias is not None)
    if smem and need > _SMEM_LIMIT:
        raise ValueError(f"n={n}, d={d} needs {need} B of shared memory, more than the kernel's {_SMEM_LIMIT}")


def biased_attention_cuda(q, k, v, bias):
    """Launch the CUDA kernel on the current stream (CUDA tensors only);
    bias None launches the no-bias instantiation."""
    _check(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_cuda needs CUDA tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as float4)")
    B, h, n, d = q.shape
    out = torch.empty_like(q)
    name = KERNEL if bias is not None else KERNEL_NOBIAS
    fn = build.kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr()) + ((bias.data_ptr(),) if bias is not None else ())
        err = fn(*ptrs, out.data_ptr(), B, h, n, d, stream)
    build.check(name, err)
    build.count_launch(name)
    return out


def biased_attention_tiled_cuda(q, k, v, bias):
    """Launch the float32 key-tiled kernel on the current stream (CUDA
    tensors only): any n, K and V staged in chunks, the bias read straight
    from device memory."""
    _check(q, k, v, bias, smem=False)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_tiled_cuda needs CUDA tensors")
    if bias is None or q.shape[-1] > 32:
        raise ValueError(f"the key-tiled kernel takes a bias and d <= 32, got d={q.shape[-1]}")
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
    bf16 k, v, bias (or None: the no-bias instantiation); bf16 or float32 q;
    float32 out."""
    _check(q, k, v, bias, bf16=True)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_bf16_cuda needs CUDA tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as vectors)")
    B, h, n, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    name = KERNEL_BF16 if bias is not None else KERNEL_NOBIAS_BF16
    fn = build.kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr()) + ((bias.data_ptr(),) if bias is not None else ())
        err = fn(*ptrs, out.data_ptr(), B, h, n, d, int(q.dtype == torch.bfloat16), stream)
    build.check(name, err)
    build.count_launch(name)
    return out


def bwd_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the two-pass backward's row pass: 8 bias rows, their
    8 dbias rows, and K and V of one (batch, head)."""
    return 4 * (2 * _ROWS * n + 2 * n * d)


# the backward's cluster path (csrc/biased_attention_bwd.cu): one block per
# (batch element, head), up to 8 batch elements per cluster
BWD_CLUSTER = 8


def bwd_cluster_smem_bytes(n: int, d: int, bias: bool = True) -> int:
    """Shared memory of the backward's one-pass cluster path: K and V of one
    (batch, head) in rows padded to d + 4 floats, q, O and dO, P and dS
    (n x n each), with a bias the head's bias and the block's dbias sum
    (n x n each), and D (n)."""
    return 4 * (2 * n * (d + 4) + 3 * n * d + (4 if bias else 2) * n * n + n)


def bwd_uses_cluster(n: int, d: int, bias: bool = True) -> bool:
    """The backward's path: one cluster launch when a whole (batch, head)
    problem fits in one block's shared memory (level 2 of the flagship,
    (63, 16), and (100, 8); without a bias the global variant's (28, d), d
    up to 128); else `bwd_uses_rows` or the two-pass kernels (with a bias;
    without one, nothing)."""
    return bwd_cluster_smem_bytes(n, d, bias) <= _SMEM_LIMIT


# the row-split path (csrc/biased_attention_bwd.cu): a cluster of BWD_CLUSTER
# ranks per head, each at most 48 query rows (16 warps of 3 rows)
BWD_ROWS_MAX = 48


def bwd_rows_smem_bytes(n: int, d: int) -> int:
    """Shared memory of the row-split path's rank (R = ceil(n / 8) query
    rows): K and V in rows padded to d + 4 floats, the rank's q, O and dO
    rows, its R x n P / dS tile (which then holds the 2 x n x d dk and dv
    partials) and its R x n dbias rows."""
    R = -(-n // BWD_CLUSTER)
    return 4 * (2 * n * (d + 4) + 3 * R * d + n * max(R, 2 * d) + R * n)


def bwd_uses_rows(n: int, d: int) -> bool:
    """The row-split cluster path: for d <= 16 and an (n, d) beyond the
    one-block cluster path whose query rows split over 8 ranks of at most 48
    rows, each rank within a block's shared memory (a 42-keypoint model's level 2, (378,
    16), and (343, 8)); beyond it, the two-pass kernels (levels 0 and 1)."""
    return (d <= 16 and not bwd_uses_cluster(n, d) and -(-n // BWD_CLUSTER) <= BWD_ROWS_MAX
            and bwd_rows_smem_bytes(n, d) <= _SMEM_LIMIT)


def bwd_path(n: int, d: int, bias: bool = True) -> str:
    """The float32 backward's path at (n, d): "cluster", "rows" or
    "two_pass"; without a bias "cluster" or, beyond it, "none" (raises on
    the card)."""
    if bwd_uses_cluster(n, d, bias):
        return "cluster"
    if not bias:
        return "none"
    return "rows" if bwd_uses_rows(n, d) else "two_pass"


def rows_biased_attention_backward(q, k, v, bias, out, dout, ranks: int = BWD_CLUSTER):
    """The row-split path's order of summation in plain PyTorch: rank r owns
    the query rows [r R, r R + R), R = ceil(n / ranks); its dbias rows sum dS
    over b = 0, 1, ... in order; its dk and dv partials dS^T q and P^T dO
    over its rows are added in rank order, dk scaled after the sum. dq is
    that of `plain_biased_attention_backward`, and every output equals its
    up to the order of the float32 additions."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    n = q.shape[-2]
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * scale + bias, dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, v) - delta)
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * scale
    R = -(-n // ranks)
    dk = dv = None
    dbias = torch.zeros_like(bias)
    for r in range(ranks):
        rows = slice(r * R, min(n, (r + 1) * R))
        pk = torch.einsum("bhij,bhid->bhjd", ds[:, :, rows], q[:, :, rows])
        pv = torch.einsum("bhij,bhid->bhjd", p[:, :, rows], dout[:, :, rows])
        dk, dv = (pk, pv) if dk is None else (dk + pk, dv + pv)
        acc = torch.zeros_like(bias[:, rows])
        for b in range(q.shape[0]):
            acc = acc + ds[b, :, rows]
        dbias[:, rows] = acc
    return dq, dk * scale, dv, dbias


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


def biased_attention_bwd_cuda(q, k, v, bias, out, dout, path: str | None = None):
    """Launch the float32 backward on the current stream (CUDA tensors only):
    (dq, dk, dv, dbias) of `plain_biased_attention_backward`, dbias summed
    over the batch in a fixed order (no atomics). One call of one path,
    `bwd_path(n, d)` unless `path` names another that takes (n, d): the
    cluster path, the row-split path (its own kernel and launch count,
    `biased_attention_bwd_rows`) or the two-pass kernels (the row-split
    path's yardstick)."""
    _check(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_bwd_cuda needs CUDA tensors")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape)} tensor on {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("q, k, v, out, dout must start on a 16-byte boundary (rows are read as float4)")
    B, h, n, d = q.shape
    if bias is None or d not in BWD_HEAD_DIMS:
        raise ValueError(f"the biased backward takes a bias and head dims {BWD_HEAD_DIMS}, got d={d}")
    path = path or bwd_path(n, d)
    takes = {"cluster": bwd_uses_cluster(n, d), "rows": bwd_uses_rows(n, d),
             "two_pass": bwd_smem_bytes(n, d) <= _SMEM_LIMIT}
    if not takes.get(path):
        raise ValueError(f"n={n}, d={d}: the backward's {path!r} path does not take it ({takes})")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
    if path == "rows":
        fn = build.kernel_fn(BWD_KERNEL_ROWS)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                     B, h, n, d, stream)
        build.check(BWD_KERNEL_ROWS, err)
        build.count_launch(BWD_KERNEL_ROWS)
        return dq, dk, dv, dbias
    cluster = path == "cluster"
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


def biased_attention_bwd_bf16_cuda(q, k, v, bias, out, dout):
    """Launch bf16 training's backward on the current stream (CUDA tensors
    only): (dq, dk, dv, dbias) of `plain_biased_attention_backward_bf16`, bf16
    k, v, bias, a bf16 or float32 q, float32 out and dout; one cluster launch,
    dbias summed over the batch in a fixed order (no atomics). An (n, d)
    beyond the cluster path raises NotImplementedError: it needs the bf16
    instantiation of the row-split path, whose body is templated for it
    (ROADMAP.md Queue 1 item 10, `--bf16 --depth`)."""
    _check(q, k, v, bias, bf16=True, smem=False)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_bwd_bf16_cuda needs CUDA tensors")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape)} tensor on {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("q, k, v, out, dout must start on a 16-byte boundary (rows are read as vectors)")
    B, h, n, d = q.shape
    if bias is None or d not in BWD_HEAD_DIMS:
        raise ValueError(f"the biased backward takes a bias and head dims {BWD_HEAD_DIMS}, got d={d}")
    if not bwd_uses_cluster(n, d):
        raise NotImplementedError(
            f"biased attention backward in bf16 at (n, d) = {(n, d)}: beyond the one-pass cluster path "
            "(a 42-keypoint model's --bf16 --depth training needs the bf16 row-split backward, "
            "ROADMAP.md Queue 1 item 10)")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((h, n, n), dtype=torch.bfloat16, device=q.device)
    fn = build.kernel_fn(BWD_KERNEL_BF16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                 B, h, n, d, int(q.dtype == torch.bfloat16), stream)
    build.check(BWD_KERNEL_BF16, err)
    build.count_launch(BWD_KERNEL_BF16)
    return dq, dk, dv, dbias


def attention_bwd_nobias_cuda(q, k, v, out, dout):
    """Launch the no-bias backward on the current stream (CUDA tensors only):
    (dq, dk, dv) of `plain_biased_attention_backward` (or, for bf16 k and v,
    of `plain_biased_attention_backward_bf16`) with bias None; one cluster
    launch; an (n, d) beyond the cluster path raises NotImplementedError
    (no variant reaches one)."""
    bf16 = k.dtype == torch.bfloat16
    _check(q, k, v, None, bf16=bf16, smem=False)
    if q.device.type != "cuda":
        raise ValueError("attention_bwd_nobias_cuda needs CUDA tensors")
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape)} tensor on {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("q, k, v, out, dout must start on a 16-byte boundary (rows are read as vectors)")
    B, h, n, d = q.shape
    if not bwd_uses_cluster(n, d, bias=False):
        raise NotImplementedError(
            f"attention backward without a bias at (n, d) = {(n, d)}: beyond the one-pass cluster path "
            f"({bwd_cluster_smem_bytes(n, d, False)} B of shared memory); no ported model reaches it")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = BWD_KERNEL_NOBIAS_BF16 if bf16 else BWD_KERNEL_NOBIAS
    fn = build.kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, h, n, d]
        if bf16:
            args.append(int(q.dtype == torch.bfloat16))
        err = fn(*args, stream)
    build.check(name, err)
    build.count_launch(name)
    return dq, dk, dv


class _BiasedAttention(torch.autograd.Function):
    """Forward through the kernel of the inputs' dtype and size (plain on
    the CPU); backward through `biased_attention_bwd_cuda` or, for bf16
    inputs, `biased_attention_bwd_bf16_cuda` (plain on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        bf16 = k.dtype == torch.bfloat16
        if q.device.type == "cpu":
            out = plain_biased_attention_bf16(q, k, v, bias) if bf16 else plain_biased_attention(q, k, v, bias)
        elif bf16:
            out = biased_attention_bf16_cuda(q, k, v, bias)
        elif bias is None or fits_smem(q.shape[-2], q.shape[-1]):
            out = biased_attention_cuda(q, k, v, bias)
        else:
            out = biased_attention_tiled_cuda(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out = ctx.saved_tensors
        dout = dout.contiguous()
        if bias is None and q.device.type != "cpu":
            return attention_bwd_nobias_cuda(q, k, v, out, dout) + (None,)
        if k.dtype == torch.bfloat16:
            if q.device.type == "cpu":
                return plain_biased_attention_backward_bf16(q, k, v, bias, out, dout)
            return biased_attention_bwd_bf16_cuda(q, k, v, bias, out, dout)
        if q.device.type == "cpu":
            return plain_biased_attention_backward(q, k, v, bias, out, dout)
        return biased_attention_bwd_cuda(q, k, v, bias, out, dout)


def fused_biased_attention(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v with q, k, v (B, heads, n, d) and a
    (heads, n, n) bias shared across the batch, or bias None (no bias);
    float32, or bf16 k, v, bias (module docstring), always returning
    float32. Differentiable in both (bf16 on the card at the cluster path's
    (n, d); without a bias at the cluster path's (n, d) only). CUDA tensors
    go through the hand-written kernels of their dtype (float32 beyond the
    shared-memory kernel's n: the key-tiled kernel; bf16 there, and no bias
    there, raise); CPU tensors take the plain versions."""
    return _BiasedAttention.apply(q, k, v, bias)
