"""Biased attention softmax(q k^T / sqrt(d) + bias) v: the CUDA kernels
(`csrc/biased_attention.cu`: one forward design instantiated for float32 and
for bf16, which holds a head's K, V and a tile's bias rows in shared
memory, and a key-tiled forward, also float32 and bf16, for the n beyond
that (`fits_smem`): a 42-keypoint model's levels 0 and 1 in float32, its
level 0 in bf16, whose level 1 fits the bf16 shared-memory kernel;
`csrc/biased_attention_bwd.cu`: the backward, one cluster launch where a
(batch, head) problem fits in a block's shared memory, as at training's
level 2, in float32 and in bf16; else, where a head's query rows split over
a cluster's 8 ranks, one row-split cluster launch, as at a 42-keypoint
model's level 2, in float32 and in bf16; else two passes, float32 only) and
their plain PyTorch versions.

Counterpart of `sgtapose_tpu/ops/attention_kernel.py:fused_biased_attention`
(a Pallas TPU kernel) and of its custom VJP `_bwd_rule` (a recompute through
the XLA formulation). `fused_biased_attention` is a `torch.autograd.Function`:
on the card its forward and backward always run kernels; the plain versions
are what a CPU tensor gets, and what the kernels are held against. The
backward saves the forward's output beside q, k, v and the bias, and
recomputes the probabilities. Its dtype follows the forward's: float32, or
bf16 training's (below) on the cluster and row-split paths; a bf16 backward
beyond both raises on the card (levels 0 and 1 of a 42-keypoint model, which
feed no head, so autograd never differentiates them).

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
(n, d) = (28, 4 ... 128). On the card both directions run the latency-first
kernels of `csrc/attention_nobias.cu` (`biased_attention_nobias`, `_bf16`
forward; `biased_attention_bwd_nobias`, `_bf16` backward, three blocks per
(batch, head), no dbias), whose arithmetic order `latency_nobias_attention`
and `latency_nobias_attention_backward` render in plain PyTorch. The
forward takes n up to `NOBIAS_MAX_TOKENS` within its shared memory
(`nobias_fwd_smem_bytes`), the backward every (n, d) of
`bwd_uses_cluster(n, d, bias=False)`; beyond, they raise. The no-bias instantiations of the biased designs that preceded them
(`attention_nobias_rowtile_cuda`, `attention_bwd_nobias_cluster_cuda`) run
on no path: they are the new kernels' yardsticks on the card. The gradient
of the bias is None.
"""

from __future__ import annotations

import math

import torch

from sgtapose_tpu_torch.ops import build

KERNEL = "biased_attention"
KERNEL_BF16 = "biased_attention_bf16"
KERNEL_TILED = "biased_attention_tiled"
KERNEL_TILED_BF16 = "biased_attention_tiled_bf16"
BWD_KERNEL = "biased_attention_bwd"
BWD_KERNEL_BF16 = "biased_attention_bwd_bf16"
BWD_KERNEL_ROWS = "biased_attention_bwd_rows"
BWD_KERNEL_ROWS_BF16 = "biased_attention_bwd_rows_bf16"
KERNEL_NOBIAS = "biased_attention_nobias"
KERNEL_NOBIAS_BF16 = "biased_attention_nobias_bf16"
BWD_KERNEL_NOBIAS = "biased_attention_bwd_nobias"
BWD_KERNEL_NOBIAS_BF16 = "biased_attention_bwd_nobias_bf16"
# the yardsticks of the four no-bias kernels: the no-bias instantiations of
# the row-tiled forward and of the backward's cluster path (on no path)
KERNEL_NOBIAS_ROWTILE = "biased_attention_nobias_rowtile"
KERNEL_NOBIAS_ROWTILE_BF16 = "biased_attention_nobias_rowtile_bf16"
BWD_KERNEL_NOBIAS_CLUSTER = "biased_attention_bwd_nobias_cluster"
BWD_KERNEL_NOBIAS_CLUSTER_BF16 = "biased_attention_bwd_nobias_cluster_bf16"
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
    """Whether the shared-memory kernel takes (n, d) in float32 (elem_bytes
    4) or bf16 (2); beyond it the key-tiled kernel of the same precision
    runs."""
    return kernel_smem_bytes(n, d, elem_bytes) <= _SMEM_LIMIT


# the no-bias kernels (csrc/attention_nobias.cu): a lane takes up to 6 keys
NOBIAS_MAX_TOKENS = 32 * 6


def _line(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _nobias_key_pitch(d: int) -> int:
    return 4 if d == 4 else d + 4


def _nobias_fwd_splits(d: int) -> int:
    """Blocks per (batch, head) of the no-bias forward: its query rows split
    in 1, 2 or 4 at d <= 32, 64 and 128."""
    return 1 if d <= 32 else (2 if d == 64 else 4)


def nobias_fwd_smem_bytes(n: int, d: int, q_bytes: int = 4, kv_bytes: int = 4) -> int:
    """Shared memory of a no-bias forward block (`csrc/attention_nobias.cu`),
    each tensor in its own dtype (q_bytes, kv_bytes: 4 float32, 2 bf16): the
    block's ceil(n / splits) q rows, k in rows padded to d + 4 (d > 4), v."""
    rows = -(-n // _nobias_fwd_splits(d))
    return _line(rows * d * q_bytes) + _line(n * _nobias_key_pitch(d) * kv_bytes) + _line(n * d * kv_bytes)


def nobias_bwd_smem_bytes(n: int, d: int, q_bytes: int = 4, kv_bytes: int = 4) -> int:
    """Shared memory of the no-bias backward's block (`csrc/attention_nobias.cu`):
    an n x p float32 tile of dS or P (p = n rounded up to 4), q in its dtype,
    O and dO float32, k and v in their dtype in rows padded to d + 4 (d >
    4). In float32 never more than `bwd_cluster_smem_bytes(n, d,
    bias=False)` for n >= 2."""
    return (_line(4 * n * (-(-n // 4) * 4)) + _line(n * d * q_bytes) + 2 * _line(4 * n * d)
            + 2 * _line(n * _nobias_key_pitch(d) * kv_bytes))


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


def _split_keys(a, b, kg: int | None = None):
    """a @ b, a (..., r, n) and b (..., n, c), as the no-bias kernels form
    their d-wide outputs: the keys split over KG = 32 / (d / 4) lanes (lane
    g takes keys g, g + KG, ...; `kg` overrides KG), the lanes' partial sums
    added across the lane bits, highest first."""
    n = b.shape[-2]
    KG = kg or 32 // (b.shape[-1] // 4)
    pad = -n % KG
    a = torch.nn.functional.pad(a, (0, pad)).unflatten(-1, (-1, KG))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).unflatten(-2, (-1, KG))
    return _fold_lanes(torch.einsum("bhrmg,bhmgc->bhrcg", a, b))


def _fold_lanes(part):
    """Sum the last dim (one entry per lane) pairwise across the highest
    lane bit first, as the kernels' shuffles do."""
    while part.shape[-1] > 1:
        half = part.shape[-1] // 2
        part = part[..., :half] + part[..., half:]
    return part[..., 0]


def _latency_probs(q, k):
    """The no-bias kernels' logits, whole q.k dots of the widened q and k
    (rounded to bf16 for a bf16 q) divided by sqrt(d) rounded to float32,
    and p = 2^(s log2 e - max log2 e), not normalised."""
    f32 = torch.float32
    e = torch.einsum("bhid,bhjd->bhij", q.to(f32), k.to(f32))
    if q.dtype == torch.bfloat16:
        e = e.to(torch.bfloat16).to(f32)
    s = e / sqrt_d(q.shape[-1])
    log2e = 1.0 / math.log(2.0)
    return torch.exp2(s * log2e - s.amax(dim=-1, keepdim=True) * log2e)


def latency_nobias_attention(q, k, v):
    """The latency-first no-bias forward (`csrc/attention_nobias.cu`) in plain
    PyTorch, in its order of arithmetic: p from `_latency_probs`, then p v
    and the row sums of p with the keys split over lanes (`_split_keys`),
    the output times 1 / the sum. float32 q, k, v, or bf16 k, v with a bf16
    or float32 q (the rounding points of `plain_biased_attention_bf16`) ->
    float32. Same function as `plain_biased_attention(q, k, v, None)` (or
    its bf16 form)."""
    p = _latency_probs(q, k)
    kg = 32 // (q.shape[-1] // 4)
    l = _split_keys(p, torch.ones(p.shape[:-2] + (p.shape[-1], 1), dtype=p.dtype), kg)
    return _split_keys(p, v.to(torch.float32)) * (1.0 / l)


def latency_nobias_attention_backward(q, k, v, out, dout):
    """The latency-first no-bias backward (`csrc/attention_nobias.cu`) in
    plain PyTorch, in its order of arithmetic: p as the forward forms it, P
    = p times 1 / its row sum (one key a lane, summed across the warp),
    D_i = dO_i . O_i, dS / sqrt(d) = P (dO v^T - D) / sqrt(d) (rounded to
    bf16 for a bf16 q), then dq, dk and dv with the keys (or query rows)
    split over lanes (`_split_keys`), each rounded once to its input's
    dtype. Same function as `plain_biased_attention_backward` (or its bf16
    form) with bias None: returns (dq, dk, dv)."""
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    d = q.shape[-1]
    p = _latency_probs(q, k)
    n = p.shape[-1]
    lanes = torch.nn.functional.pad(p, (0, -n % 32)).unflatten(-1, (-1, 32)).sum(-2)
    P = p * (1.0 / _fold_lanes(lanes)[..., None])
    delta = (dout * out).sum(-1, keepdim=True)
    de = P * (torch.einsum("bhid,bhjd->bhij", dout, vf) - delta) / sqrt_d(d)
    if q.dtype == torch.bfloat16:
        de = de.to(torch.bfloat16).to(f32)
    dq = _split_keys(de, kf)
    dk = _split_keys(de.transpose(-1, -2), qf)
    dv = _split_keys(P.transpose(-1, -2), dout)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


TILE_KEYS = 256  # keys per chunk of the key-tiled kernel


def key_tiled_attention(q, k, v, bias, tile_keys: int = TILE_KEYS):
    """The key-tiled kernel's arithmetic in plain PyTorch: keys in chunks of
    `tile_keys`, lane t of a row taking keys t, t+32, ... of each chunk; per
    chunk each lane takes its own max, rescales its running sums of p and p v
    by 2^((old max - new max) log2 e) and adds the chunk's terms relative to
    the new max; the lanes' sums are merged relative to the row max. Same
    function as `plain_biased_attention`."""
    s = torch.einsum("bhid,bhjd->bhij", q, k) / math.sqrt(q.shape[-1]) + bias
    return _key_tiled_softmax_pv(s, v, tile_keys)


def key_tiled_attention_bf16(q, k, v, bias, tile_keys: int = TILE_KEYS):
    """The key-tiled kernel's bf16 instantiation in plain PyTorch: the
    logits of `plain_biased_attention_bf16` (k, v, bias bf16; with a bf16 q
    the q.k logit rounded to bf16), then `key_tiled_attention`'s chunked
    float32 softmax and p v -> float32. Same function as
    `plain_biased_attention_bf16`."""
    f32 = torch.float32
    energy = torch.einsum("bhid,bhjd->bhij", q.to(f32), k.to(f32))
    if q.dtype == torch.bfloat16:
        energy = energy.to(torch.bfloat16).to(f32)
    s = energy / math.sqrt(q.shape[-1]) + bias.to(f32)
    return _key_tiled_softmax_pv(s, v.to(f32), tile_keys)


def _key_tiled_softmax_pv(s, v, tile_keys):
    """softmax(s) v over keys in chunks (`key_tiled_attention`'s order)."""
    d, n = v.shape[-1], v.shape[-2]
    lanes = ROW_LANES
    log2e = 1.0 / math.log(2.0)
    lead = s.shape[:-1]
    m = torch.full(lead + (lanes,), -math.inf, dtype=s.dtype, device=s.device)
    l = torch.zeros(lead + (lanes,), dtype=s.dtype, device=s.device)
    acc = torch.zeros(lead + (lanes, d), dtype=s.dtype, device=s.device)
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
    if bias is not None:
        need = kernel_smem_bytes(n, d, 2 if bf16 else 4)
    else:
        need = nobias_fwd_smem_bytes(n, d, q.element_size(), k.element_size())
    if smem and need > _SMEM_LIMIT:
        raise ValueError(f"n={n}, d={d} needs {need} B of shared memory, more than the kernel's {_SMEM_LIMIT}")
    if smem and bias is None and n > NOBIAS_MAX_TOKENS:
        raise ValueError(f"n={n}: the no-bias kernel takes up to {NOBIAS_MAX_TOKENS} tokens")


def biased_attention_cuda(q, k, v, bias):
    """Launch the CUDA kernel on the current stream (CUDA tensors only);
    bias None launches the no-bias kernel (`csrc/attention_nobias.cu`)."""
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
    """Launch the key-tiled kernel on the current stream (CUDA tensors
    only): any n, K and V staged in chunks, the bias read straight from
    device memory. float32 q, k, v, bias (`biased_attention_tiled`), or bf16
    k, v, bias with a bf16 or float32 q (`biased_attention_tiled_bf16`, the
    arithmetic of `plain_biased_attention_bf16`); float32 out."""
    bf16 = k.dtype == torch.bfloat16
    _check(q, k, v, bias, bf16=bf16, smem=False)
    if q.device.type != "cuda":
        raise ValueError("biased_attention_tiled_cuda needs CUDA tensors")
    if bias is None or q.shape[-1] > 32:
        raise ValueError(f"the key-tiled kernel takes a bias and d <= 32, got d={q.shape[-1]}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as vectors)")
    B, h, n, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    name = KERNEL_TILED_BF16 if bf16 else KERNEL_TILED
    fn = build.kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), B, h, n, d]
        if bf16:
            args.append(int(q.dtype == torch.bfloat16))
        err = fn(*args, stream)
    build.check(name, err)
    build.count_launch(name)
    return out


def biased_attention_bf16_cuda(q, k, v, bias):
    """Launch the bf16 shared-memory kernel on the current stream (CUDA
    tensors only; `fits_smem(n, d, 2)`): bf16 k, v, bias (or None: the
    no-bias kernel's bf16 instantiation, `csrc/attention_nobias.cu`); bf16
    or float32 q; float32 out."""
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
    (63, 16), and (100, 8)); else `bwd_uses_rows` or the two-pass kernels.
    Without a bias the same test bounds the one plain launch of
    `csrc/attention_nobias.cu` (the global variant's (28, d), d up to 128),
    whose block needs no more (`nobias_bwd_smem_bytes`); beyond it,
    nothing."""
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
    "two_pass"; without a bias "cluster" (the one launch of
    `attention_bwd_nobias_cuda`) or, beyond it, "none" (raises on the
    card)."""
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
    p = torch.softmax(torch.einsum("bhid,bhjd->bhij", q, k) * scale + bias, dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, v) - delta)
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * scale
    dk, dv, dbias = _rank_ordered_sums(ds, ds, p, q, dout, ranks)
    return dq, dk * scale, dv, dbias


def rows_biased_attention_backward_bf16(q, k, v, bias, out, dout, ranks: int = BWD_CLUSTER):
    """The row-split path's bf16 instantiation in plain PyTorch: the order
    of summation of `rows_biased_attention_backward` with the rounding points
    of `plain_biased_attention_backward_bf16` (k, v, bias bf16, q bf16 or
    float32, out and dout float32): with a bf16 q, dS / sqrt(d) rounded to
    bf16 before the dq and dk products; the float32 dS summed into dbias over
    b = 0, 1, ... in order; each output rounded once to its input's dtype (dq
    to q's, dk, dv and dbias to bf16)."""
    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    energy = torch.einsum("bhid,bhjd->bhij", qf, kf)
    if q.dtype == bf16:
        energy = energy.to(bf16).to(f32)
    p = torch.softmax(energy * scale + bias.to(f32), dim=-1)
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhid,bhjd->bhij", dout, vf) - delta)
    if q.dtype == bf16:  # the bf16 logit's cotangent
        de = (ds * scale).to(bf16).to(f32)
        dq = torch.einsum("bhij,bhjd->bhid", de, kf)
        dk, dv, dbias = _rank_ordered_sums(de, ds, p, qf, dout, ranks)
    else:
        dq = torch.einsum("bhij,bhjd->bhid", ds, kf) * scale
        dk, dv, dbias = _rank_ordered_sums(ds, ds, p, qf, dout, ranks)
        dk = dk * scale
    return dq.to(q.dtype), dk.to(bf16), dv.to(bf16), dbias.to(bf16)


def _rank_ordered_sums(ds_k, ds, p, q, dout, ranks):
    """The row-split path's sums: rank r owns the query rows [r R, r R + R),
    R = ceil(n / ranks); dk = the ranks' partials ds_k^T q over their rows
    and dv those of P^T dO, added in rank order; dbias rows = dS summed over
    b = 0, 1, ... in order."""
    n = q.shape[-2]
    R = -(-n // ranks)
    dk = dv = None
    dbias = torch.zeros(ds.shape[1:], dtype=ds.dtype, device=ds.device)
    for r in range(ranks):
        rows = slice(r * R, min(n, (r + 1) * R))
        pk = torch.einsum("bhij,bhid->bhjd", ds_k[:, :, rows], q[:, :, rows])
        pv = torch.einsum("bhij,bhid->bhjd", p[:, :, rows], dout[:, :, rows])
        dk, dv = (pk, pv) if dk is None else (dk + pk, dv + pv)
        acc = torch.zeros_like(dbias[:, rows])
        for b in range(q.shape[0]):
            acc = acc + ds[b, :, rows]
        dbias[:, rows] = acc
    return dk, dv, dbias


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
    k, v, bias, a bf16 or float32 q, float32 out and dout; one launch of the
    cluster path (`biased_attention_bwd_bf16`) or, beyond it, of the
    row-split path (`biased_attention_bwd_rows_bf16`, where `bwd_uses_rows`,
    as at a 42-keypoint model's level 2 under `--bf16 --depth`), dbias
    summed over the batch in a fixed order (no atomics). An (n, d) beyond
    both raises NotImplementedError: no model differentiates one (levels 0
    and 1 feed no head)."""
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
    if bwd_uses_cluster(n, d):
        name = BWD_KERNEL_BF16
    elif bwd_uses_rows(n, d):
        name = BWD_KERNEL_ROWS_BF16
    else:
        raise NotImplementedError(
            f"biased attention backward in bf16 at (n, d) = {(n, d)}: beyond the cluster and row-split "
            "paths (the two-pass path is float32 only; no model differentiates such a level)")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty((h, n, n), dtype=torch.bfloat16, device=q.device)
    fn = build.kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
                 B, h, n, d, int(q.dtype == torch.bfloat16), stream)
    build.check(name, err)
    build.count_launch(name)
    return dq, dk, dv, dbias


def attention_bwd_nobias_cuda(q, k, v, out, dout):
    """Launch the no-bias backward on the current stream (CUDA tensors only):
    (dq, dk, dv) of `plain_biased_attention_backward` (or, for bf16 k and v,
    of `plain_biased_attention_backward_bf16`) with bias None; one plain
    launch of three blocks per (batch, head) (`csrc/attention_nobias.cu`);
    an (n, d) beyond `bwd_uses_cluster(n, d, bias=False)` raises
    NotImplementedError (no variant reaches one)."""
    return _bwd_nobias(q, k, v, out, dout, BWD_KERNEL_NOBIAS_BF16, BWD_KERNEL_NOBIAS)


def attention_bwd_nobias_cluster_cuda(q, k, v, out, dout):
    """The no-bias backward's yardstick: the same function through the
    no-bias instantiation of the backward's one-block cluster path
    (`biased_attention_bwd_nobias_cluster`, `_bf16`), on no path."""
    return _bwd_nobias(q, k, v, out, dout, BWD_KERNEL_NOBIAS_CLUSTER_BF16, BWD_KERNEL_NOBIAS_CLUSTER)


def _bwd_nobias(q, k, v, out, dout, name_bf16, name_f32):
    """Check and launch kernel `name_bf16` (bf16 k, v) or `name_f32`, both
    taking `biased_attention_bwd_nobias`'s arguments."""
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
            f"attention backward without a bias at (n, d) = {(n, d)}: beyond the one-launch path "
            f"({bwd_cluster_smem_bytes(n, d, False)} B of shared memory); no ported model reaches it")
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    name = name_bf16 if bf16 else name_f32
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


def attention_nobias_rowtile_cuda(q, k, v):
    """The no-bias forward's yardstick: softmax(q k^T / sqrt(d)) v through
    the no-bias instantiation of the shared-memory forward's row-tiled design
    (`biased_attention_nobias_rowtile`; bf16 k and v:
    `biased_attention_nobias_rowtile_bf16`), on no path; float32 out."""
    bf16 = k.dtype == torch.bfloat16
    _check(q, k, v, None, bf16=bf16, smem=False)
    if q.device.type != "cuda":
        raise ValueError("attention_nobias_rowtile_cuda needs CUDA tensors")
    B, h, n, d = q.shape
    if kernel_smem_bytes(n, d, 2 if bf16 else 4, bias=False) > _SMEM_LIMIT:
        raise ValueError(f"n={n}, d={d}: beyond the row-tiled kernel's shared memory")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (rows are read as vectors)")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    name = KERNEL_NOBIAS_ROWTILE_BF16 if bf16 else KERNEL_NOBIAS_ROWTILE
    fn = build.kernel_fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, h, n, d]
        if bf16:
            args.append(int(q.dtype == torch.bfloat16))
        err = fn(*args, stream)
    build.check(name, err)
    build.count_launch(name)
    return out


def forward_kernel(q, k, bias):
    """The wrapper whose kernel runs the forward on the card: beyond the
    shared-memory kernel's n in the inputs' precision (`fits_smem`), the
    key-tiled kernel; else the shared-memory kernel, float32 or bf16 (k, v
    and bias bf16)."""
    bf16 = k.dtype == torch.bfloat16
    if bias is not None and not fits_smem(q.shape[-2], q.shape[-1], 2 if bf16 else 4):
        return biased_attention_tiled_cuda
    return biased_attention_bf16_cuda if bf16 else biased_attention_cuda


class _BiasedAttention(torch.autograd.Function):
    """Forward through the kernel of the inputs' dtype and size (plain on
    the CPU); backward through `biased_attention_bwd_cuda` or, for bf16
    inputs, `biased_attention_bwd_bf16_cuda` (plain on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        if q.device.type == "cpu":
            bf16 = k.dtype == torch.bfloat16
            out = plain_biased_attention_bf16(q, k, v, bias) if bf16 else plain_biased_attention(q, k, v, bias)
        else:
            out = forward_kernel(q, k, bias)(q, k, v, bias)
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
    float32. Differentiable in both (on the card: with a bias, float32 at
    any (n, d), bf16 on the cluster and row-split paths' (n, d); without a
    bias at the cluster path's (n, d) only). CUDA tensors go through the
    hand-written kernels of their dtype (beyond the shared-memory kernel's n
    the key-tiled kernel of that dtype; without a bias the kernels of
    `csrc/attention_nobias.cu`, and beyond their shared memory it raises);
    CPU tensors take the plain versions."""
    return _BiasedAttention.apply(q, k, v, bias)
