"""The latency-first no-bias attention kernels (`csrc/attention_nobias.cu`)
on the CPU: their order of arithmetic, rendered in plain PyTorch by
`ops/attention_kernel.py:latency_nobias_attention` and
`latency_nobias_attention_backward`, against the JAX package's default
attention form with bias None (`sgtapose_tpu/models/attention.py:174-180`)
and its autodiff, at the global variant's (28, d) for every head dim, in
float32 and in bf16 with a bf16 or a float32 q; and the kernels' domain
(their shared memory) against the designs they replaced. The kernels
themselves run only on the card (`tests/test_torch_port_cuda.py`).

Bars, as `tests/test_torch_port_variants.py` holds the plain no-bias
attention: float32 forward 2e-4 (the JAX package's Pallas-vs-XLA bar),
backward 1e-5 of max(1, max|ref|); bf16 forward within 1e-5 of JAX's bf16
or half its gap to JAX float32 (a bf16 logit summed in another order can
round the other way), each gradient within 0.3x the gap between JAX bf16
and JAX float32 or one bf16 rounding (2^-8 of the largest); where a bf16
logit rounds the other way (by one bf16 unit, in under 1 % of logits,
checked), within twice JAX bf16's gap of JAX float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu_torch.ops import attention_kernel as tak

DIMS = (4, 8, 16, 32, 64, 128)  # SGTAPoseGlobal's head dim per level
MODES = ("f32", "bf16_q_bf16", "bf16_q_f32")
N_TOKENS = 28


def _jax_mha(q, k, v):
    """The JAX default attention without a position bias."""
    energy = jnp.einsum("bhid,bhjd->bhij", q, k) / jnp.sqrt(jnp.float32(q.shape[-1]))
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(energy, axis=-1), v)


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@functools.lru_cache(maxsize=None)
def _case(d, mode, n=N_TOKENS):
    """Seeded inputs, JAX's output and VJP in the case's dtypes and in
    float32, and the port's inputs (the same values)."""
    rs = np.random.RandomState(7 * d + MODES.index(mode))
    q, k, v, g = (rs.randn(2, 8, n, d).astype(np.float32) for _ in range(4))
    bf16 = mode != "f32"
    qj = jnp.asarray(q).astype(jnp.bfloat16 if mode == "bf16_q_bf16" else jnp.float32)
    kj, vj = (jnp.asarray(a).astype(jnp.bfloat16 if bf16 else jnp.float32) for a in (k, v))
    out, vjp = jax.vjp(_jax_mha, qj, kj, vj)
    out32, vjp32 = jax.vjp(_jax_mha, *(jnp.asarray(a) for a in (q, k, v)))
    tq = torch.from_numpy(_np32(qj).copy()).to(torch.bfloat16 if mode == "bf16_q_bf16" else torch.float32)
    tk, tv = (torch.from_numpy(_np32(a).copy()).to(torch.bfloat16 if bf16 else torch.float32) for a in (kj, vj))
    return dict(q=tq, k=tk, v=tv, g=torch.from_numpy(g), out=out, out32=out32,
                grads=vjp(jnp.asarray(g)), grads32=vjp32(jnp.asarray(g)), qj=qj, kj=kj)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", DIMS)
def test_latency_forward_matches_jax(d, mode):
    c = _case(d, mode)
    o = tak.latency_nobias_attention(c["q"], c["k"], c["v"])
    assert o.dtype == torch.float32 and o.shape == (2, 8, N_TOKENS, d)
    if mode == "f32":
        np.testing.assert_allclose(o.numpy(), np.asarray(c["out"]), atol=2e-4)
        return
    gap_fwd = _gap(_np32(c["out"]), np.asarray(c["out32"]))
    assert _gap(o.numpy(), _np32(c["out"])) <= max(1e-5, 0.5 * gap_fwd)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", DIMS)
def test_latency_backward_matches_jax(d, mode):
    c = _case(d, mode)
    o = tak.latency_nobias_attention(c["q"], c["k"], c["v"])
    got = tak.latency_nobias_attention_backward(c["q"], c["k"], c["v"], o, c["g"])
    for name, a, t in zip(("dq", "dk", "dv"), got, (c["q"], c["k"], c["v"])):
        assert a.dtype == t.dtype and a.shape == t.shape, name
    if mode == "f32":
        for name, a, r in zip(("dq", "dk", "dv"), got, c["grads"]):
            r = np.asarray(r)
            assert np.abs(a.numpy() - r).max() <= 1e-5 * max(1.0, np.abs(r).max()), name
        return
    flipped = False
    if mode == "bf16_q_bf16":
        # the kernel's bf16 logits against JAX's: the same but where float32
        # sums in another order round the other way, by one bf16 unit
        lj = _np32(jnp.einsum("bhid,bhjd->bhij", c["qj"], c["kj"]))
        lt = torch.einsum("bhid,bhjd->bhij", c["q"].float(), c["k"].float()).to(torch.bfloat16).float().numpy()
        diff = lj != lt
        assert diff.mean() < 0.01
        assert (np.abs(lj - lt)[diff] <= 2.0 ** -7 * np.abs(lj)[diff]).all()
        flipped = bool(diff.any())
    for name, a, r, r32 in zip(("dq", "dk", "dv"), got, c["grads"], c["grads32"]):
        gap = _gap(_np32(r), np.asarray(r32))
        assert gap > 1e-3, name  # bf16 did round
        if flipped:
            assert _gap(a.float().numpy(), np.asarray(r32)) <= 2 * gap, name
            continue
        bar = max(0.3 * gap, 2.0 ** -8)
        assert _gap(a.float().numpy(), _np32(r)) <= bar, (name, _gap(a.float().numpy(), _np32(r)), gap)


@pytest.mark.parametrize("n", [1, 5, 33, 70])
def test_latency_rendering_at_other_n(n):
    """n off the global variant's 28: one key, fewer keys than a key group,
    more than a warp's lanes (the kernel's rows and keys loop): the
    rendering (float32) against the plain formulas in float64, to float32
    rounding."""
    rs = np.random.RandomState(n)
    for d in (4, 32, 128):
        q, k, v, g = (torch.from_numpy(rs.randn(3, 2, n, d)) for _ in range(4))
        o = tak.latency_nobias_attention(q, k, v).double()
        ref = tak.plain_biased_attention(q, k, v, None)
        assert (o - ref).abs().max().item() <= 1e-5
        got = tak.latency_nobias_attention_backward(q.float(), k.float(), v.float(), ref.float(), g.float())
        want = tak.plain_biased_attention_backward(q, k, v, None, ref, g)
        for a, b in zip(got, want):
            assert (a.double() - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max().item())


def test_split_orders_are_the_kernels_folds():
    """`_split_keys` adds the lanes' partial sums pairwise across the highest
    lane bit first, as the kernels' shuffles do: on integers (exact in
    float32) it equals the straight product, and on values where float32
    addition is not associative it follows the fold's tree, not a
    sequential sum."""
    rs = np.random.RandomState(3)
    for d in DIMS:
        b = torch.from_numpy(rs.randint(-8, 8, (1, 2, 28, d)).astype(np.float32))
        p = torch.from_numpy(rs.randint(-8, 8, (1, 2, 28, 28)).astype(np.float32))
        assert torch.equal(tak._split_keys(p, b), torch.einsum("bhij,bhjd->bhid", p, b))
    # d = 32: 4 lanes a chunk, lane g takes keys g, g + 4, ...; key 0 (lane
    # 0) weighs 2^24, keys 2 and 6 (lane 2) 1.0 each: the fold adds lanes 0
    # and 2 first (2^24 + 2, exact); a sum in key order would lose both ones
    p = torch.zeros(1, 1, 1, 28)
    p[..., 0], p[..., 2], p[..., 6] = 2.0 ** 24, 1.0, 1.0
    b = torch.ones(1, 1, 28, 32)
    assert (tak._split_keys(p, b) == 2.0 ** 24 + 2).all()
    acc = np.float32(0.0)
    for x in p.flatten().numpy():  # float32 additions in key order
        acc = np.float32(acc + x)
    assert acc == 2.0 ** 24


@pytest.mark.parametrize("d", DIMS)
def test_backward_takes_every_n_of_the_design_it_replaced(d):
    """The new backward's block never needs more shared memory than the
    no-bias cluster design's (n >= 2), so `bwd_path(n, d, bias=False)`
    answers as before and every n it calls "cluster" fits the new kernel;
    the forward takes the global variant's n = 28 at every d."""
    for n in range(1, 400):
        if tak.bwd_uses_cluster(n, d, bias=False):
            assert tak.bwd_path(n, d, bias=False) == "cluster"
            assert n <= tak.NOBIAS_MAX_TOKENS and tak.nobias_bwd_smem_bytes(n, d) <= 227 * 1024
            if n >= 2:
                assert tak.nobias_bwd_smem_bytes(n, d) <= tak.bwd_cluster_smem_bytes(n, d, bias=False)
        else:
            assert tak.bwd_path(n, d, bias=False) == "none"
    assert tak.nobias_fwd_smem_bytes(N_TOKENS, d) <= 227 * 1024
    q = torch.zeros(1, 8, N_TOKENS, d)
    tak._check(q, q, q, None)
    tak._check(q, q.bfloat16(), q.bfloat16(), None, bf16=True)


def test_nobias_wrappers_need_cuda_tensors():
    """On the CPU the new kernels' wrappers and their yardsticks' raise
    (CPU tensors take the plain versions, through fused_biased_attention)."""
    q = torch.zeros(1, 8, N_TOKENS, 16)
    for call in (lambda: tak.biased_attention_cuda(q, q, q, None),
                 lambda: tak.attention_nobias_rowtile_cuda(q, q, q),
                 lambda: tak.attention_bwd_nobias_cuda(q, q, q, q, q),
                 lambda: tak.attention_bwd_nobias_cluster_cuda(q, q, q, q, q)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    big = torch.zeros(1, 1, 200, 128)
    with pytest.raises(ValueError, match="shared memory"):
        tak._check(big, big, big, None)
    many = torch.zeros(1, 1, tak.NOBIAS_MAX_TOKENS + 1, 4)
    with pytest.raises(ValueError, match="tokens"):
        tak._check(many, many, many, None)
