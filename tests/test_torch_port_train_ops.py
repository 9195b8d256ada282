"""Port parity of the training operators on the CPU: the backward of
the biased attention and of the DCN sampling (the plain versions the CPU
path of their autograd Functions runs, and what the CUDA backward kernels are
held against on the card), the window scatter's gradient, and flax's
train-mode BatchNorm.

Bars: the attention backward within 1e-5 of max(1, max|jax grad|) per tensor
(the same float32 formulas, summed in another order); the DCN sampling
backward within 1e-5 (dfeat: a scatter-add in another order) of the JAX
custom VJP; each autograd Function within 1e-5 of torch autograd through its
plain forward; the scatter gradients within 1e-6 of `jax.grad` (they are
copies, no arithmetic); BatchNorm within 1e-5 of flax (fast vs two-pass
variance).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.attention import scatter_window_features as jax_scatter
from sgtapose_tpu.models.attention import window_feat_ids as jax_window_ids
from sgtapose_tpu.models.deform_conv import deform_sample_batch
from sgtapose_tpu.ops.attention_kernel import _xla_attention
from sgtapose_tpu_torch.models import attention as tattn
from sgtapose_tpu_torch.models import deform_conv as tdcn
from sgtapose_tpu_torch.models.dla import BatchNorm
from sgtapose_tpu_torch.ops import attention_kernel as tak


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
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


@pytest.mark.parametrize("n,d", [(1183, 4), (343, 8), (63, 16)])
def test_attention_backward_matches_jax_vjp(n, d):
    rs = np.random.RandomState(n + d)
    q, k, v, g = (rs.randn(2, 8, n, d).astype(np.float32) for _ in range(4))
    bias = (0.3 * rs.randn(8, n, n)).astype(np.float32)
    out_ref, vjp = jax.vjp(_xla_attention, *(jnp.asarray(a) for a in (q, k, v, bias)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv, tb = (_t(a) for a in (q, k, v, bias))
    out = tak.plain_biased_attention(tq, tk, tv, tb)
    _close(out.numpy(), out_ref, 1e-5, "out")
    port = tak.plain_biased_attention_backward(tq, tk, tv, tb, out, _t(g))
    for name, p, r in zip(("dq", "dk", "dv", "dbias"), port, ref):
        assert p.shape == r.shape
        _close(p.numpy(), r, 1e-5, name)


def test_attention_function_matches_autograd_of_plain():
    """`fused_biased_attention` (an autograd Function; plain on the CPU)
    against torch autograd through the plain forward."""
    rs = np.random.RandomState(3)
    args = [_t(rs.randn(2, 8, 33, 8).astype(np.float32)) for _ in range(3)]
    args.append(_t((0.3 * rs.randn(8, 33, 33)).astype(np.float32)))
    g = _t(rs.randn(2, 8, 33, 8).astype(np.float32))
    a = [x.clone().requires_grad_() for x in args]
    b = [x.clone().requires_grad_() for x in args]
    out = tak.fused_biased_attention(*a)
    assert out.grad_fn is not None
    out.backward(g)
    tak.plain_biased_attention(*b).backward(g)
    for x, y in zip(a, b):
        _close(x.grad.numpy(), y.grad.numpy(), 1e-5)


def _dcn_inputs(B, H, W, C, seed):
    rs = np.random.RandomState(seed)
    feat = rs.randn(B, H, W, C).astype(np.float32)
    offsets = rs.uniform(-3, 3, (B, H, W, 18)).astype(np.float32)  # samples leave the map
    offsets[0, 0, 0, :2] = [-1.0, -1.0]  # integer offsets: corners exactly on pixels
    masks = rs.rand(B, H, W, 9).astype(np.float32)
    g = rs.randn(B, H, W, 9 * C).astype(np.float32)
    return feat, offsets, masks, g


@pytest.mark.parametrize("B,H,W,C", [(1, 15, 15, 8), (2, 12, 20, 5)])
def test_deform_sample_backward_matches_jax_vjp(B, H, W, C):
    feat, offsets, masks, g = _dcn_inputs(B, H, W, C, H * W + C)
    _, vjp = jax.vjp(deform_sample_batch, *(jnp.asarray(a) for a in (feat, offsets, masks)))
    ref = vjp(jnp.asarray(g))  # through the custom VJP _dsb_bwd
    port = tdcn.plain_deform_sample_backward(_t(feat), _t(offsets), _t(masks), _t(g))
    for name, p, r in zip(("dfeat", "doffsets", "dmask"), port, ref):
        assert p.shape == r.shape
        _close(p.numpy(), r, 1e-5, name)


@pytest.mark.parametrize("B,H,W,C,O", [(1, 9, 11, 6, 5), (2, 8, 8, 16, 24)])
def test_deform_conv_function_matches_autograd_of_plain(B, H, W, C, O):
    """`deform_conv` (an autograd Function: recomputed columns, products,
    plain sampling backward on the CPU) against torch autograd through
    `plain_deform_conv`, for x, the raw offset/mask output, weight and bias."""
    rs = np.random.RandomState(B + C)
    x = rs.randn(B, H, W, C).astype(np.float32)
    om = np.concatenate([rs.uniform(-3, 3, (B, H, W, 18)), 2 * rs.randn(B, H, W, 9)], -1).astype(np.float32)
    w = (rs.randn(O, 9 * C) / np.sqrt(9 * C)).astype(np.float32)
    bias = rs.randn(O).astype(np.float32)
    g = _t(rs.randn(B, H, W, O).astype(np.float32))
    a = [_t(t).requires_grad_() for t in (x, om, w, bias)]
    b = [_t(t).requires_grad_() for t in (x, om, w, bias)]
    out = tdcn.deform_conv(*a)
    assert out.grad_fn is not None
    out.backward(g)
    tdcn.plain_deform_conv(*b).backward(g)
    for name, p, r in zip(("dx", "dom", "dweight", "dbias"), a, b):
        _close(p.grad.numpy(), r.grad.numpy(), 1e-5, name)


def _scatter_grads_jax(feats, ids, values, weights):
    def loss(f, v):
        return jnp.sum(jax_scatter(f, ids, v) * weights)

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(values))


def _scatter_grads_port(feats, ids, values, weights):
    f = _t(feats).requires_grad_()
    v = _t(values).requires_grad_()
    out = tattn.scatter_window_features(f, _t(ids).to(torch.int64), v)
    (out * _t(weights)).sum().backward()
    return out.detach(), f.grad, v.grad


def test_scatter_gradient_goes_to_the_winner_once():
    """ids [1, 3, 1, 1] into 5 zeros, loss = sum(out * [1..5]): position 3 wins
    pixel 1 and position 1 pixel 3, so d loss / d values = [0, 4, 0, 2]."""
    feats = np.zeros((1, 1, 5, 1), np.float32)
    ids = np.array([[1, 3, 1, 1]], np.int32)
    values = np.array([[[10.0], [20.0], [30.0], [40.0]]], np.float32)
    weights = np.arange(1, 6, dtype=np.float32).reshape(1, 1, 5, 1)
    ref_f, ref_v = _scatter_grads_jax(feats, ids, values, weights)
    out, gf, gv = _scatter_grads_port(feats, ids, values, weights)
    np.testing.assert_array_equal(out.numpy().ravel(), [0, 40, 0, 20, 0])
    np.testing.assert_array_equal(gv.numpy().ravel(), [0, 4, 0, 2])
    np.testing.assert_allclose(gv.numpy(), np.asarray(ref_v), atol=1e-6)
    np.testing.assert_allclose(gf.numpy(), np.asarray(ref_f), atol=1e-6)


def test_scatter_gradient_matches_jax_on_overlapping_windows():
    """13x13 windows (the flagship level-0 kernel) of 7 classes around
    clustered, partly clamped centers on a 40x40 map: most ids repeat."""
    rs = np.random.RandomState(0)
    H = W = 40
    C = 16
    centers = np.concatenate([rs.uniform(0, 10, (2, 5, 2)), rs.uniform(8, 12, (2, 2, 2))], 1)
    ids = np.asarray(jax_window_ids(jnp.asarray(centers, jnp.float32), 1.0, 12, H, W))
    assert ids.shape == (2, 7 * 169) and len(np.unique(ids[0])) < ids.shape[1] // 2
    port_ids = tattn.window_feat_ids(_t(centers.astype(np.float32)), 1.0, 12, H, W)
    np.testing.assert_array_equal(port_ids.numpy(), ids)
    feats = rs.randn(2, H, W, C).astype(np.float32)
    values = rs.randn(2, ids.shape[1], C).astype(np.float32)
    weights = rs.randn(2, H, W, C).astype(np.float32)
    ref_out = np.asarray(jax_scatter(jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(values)))
    ref_f, ref_v = _scatter_grads_jax(feats, ids, values, weights)
    out, gf, gv = _scatter_grads_port(feats, ids, values, weights)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(ref_v), atol=1e-6)
    np.testing.assert_allclose(gf.numpy(), np.asarray(ref_f), atol=1e-6)


def test_batchnorm_train_mode_matches_flax():
    """Output and updated statistics after two train-mode calls (a batch of
    2 at 2x2: 8 values a channel, where the unbiased variance would differ by
    8/7), then eval mode on the updated statistics."""
    rs = np.random.RandomState(4)
    C = 6
    xs = [(2.0 * rs.randn(2, 2, 2, C) + 1.0).astype(np.float32) for _ in range(2)]
    scale = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    bias = (0.1 * rs.randn(C)).astype(np.float32)
    mean0 = (0.1 * rs.randn(C)).astype(np.float32)
    var0 = np.exp(0.3 * rs.randn(C)).astype(np.float32)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0))
        bn.running_var.copy_(_t(var0))
    bn.train()
    for x in xs:
        ref, mutated = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
        out = bn(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), rtol=1e-5)
    bn.eval()
    ref = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(variables, jnp.asarray(xs[0]))
    with torch.no_grad():
        out = bn(_t(xs[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
