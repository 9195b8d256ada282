"""Port parity of the two training backward kernels' plain versions and of
their designs' arithmetic, on the CPU (the kernels themselves run on the card:
tests/test_torch_port_cuda.py and chip_smoke.py).

- `plain_deform_conv_dgrad` (what `deform_conv_dgrad` is held against)
  against `jax.vjp` of the JAX DCN (deform_sample_batch with its custom VJP,
  then the 9C -> O contraction), for dx and the raw offset/mask gradient,
  within 1e-5 of max(1, max|ref|): float32 sums in another order.
- `tiled_deform_scatter`, the kernel's halo-tile split of the feature
  gradient, against the direct scatter within 1e-6 of max(1, max|ref|): the
  same products added in another order.
- `cluster_biased_attention_backward`, the cluster path's rank-ordered dbias
  sum, against `plain_biased_attention_backward` and JAX's vjp of
  `_xla_attention` within 1e-5 of max(1, max|ref|).
- `rows_biased_attention_backward`, the row-split path's order of summation
  (rank-ordered dk and dv partials, b-ordered dbias rows), against JAX's vjp
  of `_xla_attention` within 2e-4 of max(1, max|ref|) (the JAX package's
  Pallas-vs-XLA bar) and against `plain_biased_attention_backward` within
  1e-5 (float32 sums in another order).
- The attention backward's choice of path by shared-memory size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.deform_conv import deform_sample_batch
from sgtapose_tpu.ops.attention_kernel import _xla_attention
from sgtapose_tpu_torch.models import deform_conv as tdcn
from sgtapose_tpu_torch.ops import attention_kernel as tak


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(port, ref, rel, name=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(port) - ref).max()
    bar = rel * max(1.0, np.abs(ref).max())
    assert err <= bar, f"{name}: max abs err {err} > {bar}"


def _jax_dcn(x, om, w, b):
    """The JAX module's arithmetic: sampling with sigmoid masks, then the
    1x1 contraction with kernel W^T (input index k*C + c)."""
    flat = deform_sample_batch(x, om[..., :18], jax.nn.sigmoid(om[..., 18:]))
    return flat @ w.T + b


# (B, H, W, C, O, offset range); 0 means flax's zero-initialised offsets
DGRAD_CASES = {
    "zero_offsets": (2, 10, 12, 8, 12, 0.0),
    "offsets_3": (2, 10, 12, 8, 12, 3.0),
    "offsets_12": (1, 14, 13, 8, 12, 12.0),  # beyond any halo, many samples off the map
    "ragged": (1, 9, 11, 6, 5, 3.0),
}


@pytest.mark.parametrize("case", sorted(DGRAD_CASES))
def test_deform_conv_dgrad_matches_jax_vjp(case):
    B, H, W, C, O, span = DGRAD_CASES[case]
    rs = np.random.RandomState(len(case) + C)
    x = rs.randn(B, H, W, C).astype(np.float32)
    off = rs.uniform(-span, span, (B, H, W, 18)) if span else np.zeros((B, H, W, 18))
    om = np.concatenate([off, 2 * rs.randn(B, H, W, 9)], -1).astype(np.float32)
    w = (rs.randn(O, 9 * C) / np.sqrt(9 * C)).astype(np.float32)
    b = rs.randn(O).astype(np.float32)
    dy = rs.randn(B, H, W, O).astype(np.float32)
    _, vjp = jax.vjp(_jax_dcn, *(jnp.asarray(a) for a in (x, om, w, b)))
    ref_dx, ref_dom, _, _ = vjp(jnp.asarray(dy))
    dx, dom = tdcn.plain_deform_conv_dgrad(_t(x), _t(om), _t(w), _t(dy))
    assert dx.shape == (B, H, W, C) and dom.shape == (B, H, W, 27)
    _close(dx.numpy(), ref_dx, 1e-5, "dx")
    _close(dom.numpy(), ref_dom, 1e-5, "dom")


@pytest.mark.parametrize("tile,halo,span",
                         [(8, 3, 4.0), (8, 3, 12.0), (8, 2, 3.0), (4, 0, 3.0), (5, 1, 2.0)])
def test_tiled_scatter_matches_direct_scatter(tile, halo, span):
    """Offsets past the halo leave some corners to the direct path."""
    rs = np.random.RandomState(tile * 10 + halo)
    B, H, W, C = 2, 13, 17, 5
    feat = rs.randn(B, H, W, C).astype(np.float32)
    offsets = rs.uniform(-span, span, (B, H, W, 18)).astype(np.float32)
    masks = rs.rand(B, H, W, 9).astype(np.float32)
    g = rs.randn(B, H, W, 9 * C).astype(np.float32)
    args = [_t(a) for a in (feat, offsets, masks, g)]
    ref = tdcn.plain_deform_sample_backward(*args)[0]
    got, share = tdcn.tiled_deform_scatter(*args, tile=tile, halo=halo)
    assert 0.0 < share < 1.0  # both routes taken
    _close(got.numpy(), ref.numpy(), 1e-6, "dfeat")


@pytest.mark.parametrize("B", [1, 2, 8, 9])
@pytest.mark.parametrize("n,d", [(63, 16), (100, 8)])
def test_cluster_dbias_order_matches_plain_and_jax(n, d, B):
    """B = 9: rank 0 of the 8-block cluster sums b = 0 and 8."""
    rs = np.random.RandomState(n + d + B)
    q, k, v, g = (rs.randn(B, 8, n, d).astype(np.float32) for _ in range(4))
    bias = (0.3 * rs.randn(8, n, n)).astype(np.float32)
    out_ref, vjp = jax.vjp(_xla_attention, *(jnp.asarray(a) for a in (q, k, v, bias)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv, tb = (_t(a) for a in (q, k, v, bias))
    out = tak.plain_biased_attention(tq, tk, tv, tb)
    port = tak.cluster_biased_attention_backward(tq, tk, tv, tb, out, _t(g))
    plain = tak.plain_biased_attention_backward(tq, tk, tv, tb, out, _t(g))
    for name, p, r, pl in zip(("dq", "dk", "dv", "dbias"), port, ref, plain):
        assert p.shape == r.shape
        _close(p.numpy(), r, 1e-5, name)
        _close(p.numpy(), pl.numpy(), 1e-5, name)


@pytest.mark.parametrize("n,d,B", [(378, 16, 1), (378, 16, 2), (378, 16, 3), (200, 8, 2)])
def test_row_split_order_matches_plain_and_jax(n, d, B):
    """A 42-keypoint model's level 2 at B = 1, 2, 3 (its last rank owns 42
    rows of 48) and a ragged (200, 8), 25 rows a rank."""
    rs = np.random.RandomState(n + d + 10 * B)
    q, k, v, g = (rs.randn(B, 8, n, d).astype(np.float32) for _ in range(4))
    bias = (0.3 * rs.randn(8, n, n)).astype(np.float32)
    _, vjp = jax.vjp(_xla_attention, *(jnp.asarray(a) for a in (q, k, v, bias)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv, tb = (_t(a) for a in (q, k, v, bias))
    out = tak.plain_biased_attention(tq, tk, tv, tb)
    port = tak.rows_biased_attention_backward(tq, tk, tv, tb, out, _t(g))
    plain = tak.plain_biased_attention_backward(tq, tk, tv, tb, out, _t(g))
    for name, p, r, pl in zip(("dq", "dk", "dv", "dbias"), port, ref, plain):
        assert p.shape == r.shape
        _close(p.numpy(), r, 2e-4, name)
        _close(p.numpy(), pl.numpy(), 1e-5, name)


@pytest.mark.parametrize("n,d,path", [(63, 16, "cluster"), (100, 8, "cluster"), (343, 8, "rows"),
                                      (1183, 4, "two_pass"), (378, 16, "rows"), (200, 8, "rows"),
                                      (385, 16, "two_pass"), (378, 32, "two_pass")])
def test_attention_backward_path_choice(n, d, path):
    """Level 2 and the ragged (100, 8) fit a block's shared memory; a
    42-keypoint model's level 2, (378, 16), and the flagship's level 1,
    (343, 8), split their query rows over a cluster's 8 ranks (each within
    48 rows and a block's shared memory); level 0, (1183, 4), n = 385 (49
    rows a rank) and d = 32 take the two-pass kernels, whose row pass still
    fits."""
    assert tak.bwd_path(n, d) == path
    assert tak.bwd_uses_cluster(n, d) is (path == "cluster")
    assert tak.bwd_uses_rows(n, d) is (path == "rows")
    assert (tak.bwd_cluster_smem_bytes(n, d) <= 227 * 1024) is (path == "cluster")
    if path == "rows":
        assert tak.bwd_rows_smem_bytes(n, d) <= 227 * 1024 and -(-n // 8) <= 48
    if path == "two_pass":
        assert tak.bwd_smem_bytes(n, d) <= 227 * 1024
