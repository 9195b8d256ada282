"""Port parity of bf16 mixed-precision training on the CPU: the attention's
and the DCN's bf16 VJPs and the plain bf16 attention backward against the
JAX package's bf16 path (`train_step(bf16=True)`: parameters cast to bf16
for the forward, float32 masters, loss and gradients), same numpy weights
and inputs; the bf16 forward view of the masters; both training CLIs with
--bf16 end to end. One whole bf16 train step against JAX's is
tests/test_torch_port_train_bf16_step.py (its two JAX compiles would take
this file past its time).

The JAX package runs as its own tests run it: the default einsum attention,
the DCN through its custom VJP `_dsb_bwd`. Both frameworks round to bf16 at
their own points, so every bar is a multiple of the gap between JAX bf16
and JAX float32 on the same inputs, measured in the same test (as
tests/test_torch_port_bf16.py does for serving):
  * the plain bf16 attention backward against `jax.vjp` of the einsum form
    (the rounding points: dS / sqrt(d) rounded to bf16 when q is bf16; dq
    in q's dtype; dk, dv, dbias rounded once): <= 0.3x the gap per
    gradient (measured 0.00-0.20x), the dtypes equal;
  * `MultiHeadCrossAttention` in bf16 at the 3 flagship (n, d), q bf16 (the
    first tied layer) and float32 (the later ones), the gradients of the
    query, key and value inputs and the float32 master of pos_embed:
    <= 0.5x the gap (measured 0.00-0.26x);
  * `DeformConv2d` in bf16 at two decoder shapes with offsets leaving the
    map, the input's gradient and the four float32 masters: the port rounds
    once where JAX's `_bwd_core` rounds every product and sum, <= 1.5x the
    gap per tensor (measured 0.38-1.07x), and port bf16 against JAX float32
    <= 2x the gap (measured 0.05-1.01x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models import attention as jattn
from sgtapose_tpu.models.deform_conv import DeformConv2d as JaxDeformConv2d
from sgtapose_tpu.utils.precision import cast_floating
from sgtapose_tpu_torch.models import attention as tattn
from sgtapose_tpu_torch.models.deform_conv import DeformConv2d
from sgtapose_tpu_torch.ops import attention_kernel as tak
from sgtapose_tpu_torch.utils import weights as tweights
from sgtapose_tpu_torch.utils.precision import bf16_forward
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import perturb

BF16 = torch.bfloat16
SHAPES = [(0, 1183, 4), (1, 343, 8), (2, 63, 16)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t if dtype is None else t.to(dtype)


def _gap(a, b):
    """max|a - b| / max|b| (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_einsum_attention(q, k, v, bias):
    """The JAX default attention (`sgtapose_tpu/models/attention.py:174-180`)."""
    scale = jnp.sqrt(jnp.float32(q.shape[-1]))
    energy = jnp.einsum("bhid,bhjd->bhij", q, k) / scale + bias
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(energy, axis=-1), v)


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("level,n,d", SHAPES)
def test_plain_bf16_attention_backward_matches_jax_vjp(level, n, d, q_bf16):
    rs = np.random.RandomState(10 + level)
    q, k, v, g = (rs.randn(2 if level else 1, 8, n, d).astype(np.float32) for _ in range(4))
    bias = (0.3 * rs.randn(8, n, n)).astype(np.float32)
    qj = jnp.asarray(q).astype(jnp.bfloat16 if q_bf16 else jnp.float32)
    kj, vj, bj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v, bias))
    out, vjp = jax.vjp(_jax_einsum_attention, qj, kj, vj, bj)
    ref = vjp(jnp.asarray(g))
    ref32 = jax.vjp(_jax_einsum_attention, *(jnp.asarray(a) for a in (q, k, v, bias)))[1](jnp.asarray(g))
    tq = _t(_np(qj), BF16 if q_bf16 else torch.float32)
    tk, tv, tb = (_t(_np(a), BF16) for a in (kj, vj, bj))
    o = tak.plain_biased_attention_bf16(tq, tk, tv, tb)
    assert o.dtype == torch.float32 and _gap(o.numpy(), _np(out)) <= 1e-5
    got = tak.plain_biased_attention_backward_bf16(tq, tk, tv, tb, o, _t(g))
    for name, a, r, r32 in zip(("dq", "dk", "dv", "dbias"), got, ref, ref32):
        assert str(a.dtype).replace("torch.", "") == str(r.dtype), (name, a.dtype, r.dtype)
        gap = _gap(_np(r), np.asarray(r32))
        assert gap > 1e-3, name  # bf16 did round
        assert _gap(a.float().numpy(), _np(r)) <= 0.3 * gap, (name, _gap(a.float().numpy(), _np(r)), gap)
    # autograd through the forward's plain version has the same rounding points
    leaves = [t.detach().clone().requires_grad_() for t in (tq, tk, tv, tb)]
    auto = torch.autograd.grad(tak.plain_biased_attention_bf16(*leaves), leaves, _t(g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, auto):
        assert a.dtype == b.dtype and _gap(a.float().numpy(), b.float().numpy()) <= 2.0 ** -7, name


def _attention_vjp(flax_mod, params, q, kv, g, bf16):
    """JAX: the module's outputs' VJP with respect to the float32 params
    (cast to bf16 inside when bf16, as train_step does) and the inputs."""
    def f(p, q_, k_, v_):
        return flax_mod.apply({"params": cast_floating(p, jnp.bfloat16) if bf16 else p}, q_, k_, v_)

    return jax.jit(lambda *a: jax.vjp(f, *a)[1](g))(params, q, kv, kv)


@pytest.mark.parametrize("q_bf16", [True, False], ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("level,n,d", SHAPES)
def test_bf16_attention_vjp_matches_jax(level, n, d, q_bf16):
    d_inp = 16 * 2 ** level
    rs = np.random.RandomState(20 + level)
    q = rs.randn(1, n, d_inp).astype(np.float32)
    kv = rs.randn(1, n, d_inp).astype(np.float32)
    g = rs.randn(1, n, d_inp).astype(np.float32)
    flax_mod = jattn.MultiHeadCrossAttention(8, d_inp, 8 * d, n, True)
    variables = perturb(flax_mod.init(jax.random.PRNGKey(0), q, kv, kv), level)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    qj = jnp.asarray(q).astype(jnp.bfloat16 if q_bf16 else jnp.float32)
    kvj = jnp.asarray(kv).astype(jnp.bfloat16)
    # the module's input kv feeds both key and value: their cotangents add
    dp, dq, dk, dv = _attention_vjp(flax_mod, params, qj, kvj, jnp.asarray(g), True)
    dp32, dq32, dk32, dv32 = _attention_vjp(flax_mod, params, jnp.asarray(q), jnp.asarray(kv),
                                            jnp.asarray(g), False)
    port = tattn.MultiHeadCrossAttention(8, d_inp, 8 * d, n, True)
    load_flax_variables(port, variables)
    tq = _t(_np(qj), BF16 if q_bf16 else torch.float32).requires_grad_()
    tk, tv = (_t(_np(kvj), BF16).requires_grad_() for _ in range(2))
    out = bf16_forward(port, [tq, tk, tv])
    assert out.dtype == torch.float32
    out.backward(_t(g))
    pos = port.pos_embed.grad
    assert tq.grad.dtype == tq.dtype and tk.grad.dtype == BF16 and pos.dtype == torch.float32
    cases = [("query", tq.grad, dq, dq32), ("key", tk.grad, dk, dk32), ("value", tv.grad, dv, dv32),
             ("pos_embed", pos, dp["pos_embed"], dp32["pos_embed"])]
    for name, a, r, r32 in cases:
        gap = _gap(_np(r), np.asarray(r32))
        assert gap > 1e-3, name
        assert _gap(a.float().numpy(), _np(r)) <= 0.5 * gap, (name, _gap(a.float().numpy(), _np(r)), gap)


@pytest.mark.parametrize("H,C,O", [(15, 64, 32), (30, 32, 16)])
def test_bf16_dcn_vjp_matches_jax(H, C, O):
    """Offsets of up to 4 px from the offset conv's bias: many samples leave
    the map, and their corners get zero weight in both VJPs."""
    rs = np.random.RandomState(30 + H)
    x = rs.randn(1, H, H, C).astype(np.float32)
    g = rs.randn(1, H, H, O).astype(np.float32)
    flax_mod = JaxDeformConv2d(O)
    variables = jax.tree_util.tree_map(np.asarray, perturb(flax_mod.init(jax.random.PRNGKey(0), x), H))
    variables["params"]["conv_offset_mask"]["bias"][:18] = (rs.rand(18) * 8 - 4).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def f(p, x_, bf16):
        return flax_mod.apply({"params": cast_floating(p, jnp.bfloat16) if bf16 else p}, x_)

    def vjp(p, x_, g_, bf16):
        return jax.vjp(lambda p_, xx: f(p_, xx, bf16), p, x_)[1](g_)

    xj = jnp.asarray(x).astype(jnp.bfloat16)
    dp, dx = jax.jit(vjp, static_argnums=3)(params, xj, jnp.asarray(g).astype(jnp.bfloat16), True)
    dp32, dx32 = jax.jit(vjp, static_argnums=3)(params, jnp.asarray(x), jnp.asarray(g), False)

    port = DeformConv2d(C, O)
    load_flax_variables(port, variables)
    tx = _t(_np(xj), BF16).permute(0, 3, 1, 2).requires_grad_()
    out = bf16_forward(port, [tx])
    assert out.dtype == BF16
    out.backward(_t(g, BF16).permute(0, 3, 1, 2))
    named = dict(port.named_parameters())
    ref = tweights._convert(port, {"params": dp}, named)
    ref32 = tweights._convert(port, {"params": dp32}, named)
    cases = [("x", tx.grad.permute(0, 2, 3, 1), _np(dx), np.asarray(dx32))]
    cases += [(k, named[k].grad, ref[k], ref32[k]) for k in ref]
    assert tx.grad.dtype == BF16 and all(p.grad.dtype == torch.float32 for p in named.values())
    for name, a, r, r32 in cases:
        gap = _gap(r, r32)
        assert gap > 1e-3, name
        a = a.float().numpy()
        assert _gap(a, r) <= 1.5 * gap, (name, _gap(a, r), gap)
        assert _gap(a, r32) <= 2.0 * gap, (name, _gap(a, r32), gap)


def test_bf16_forward_view_leaves_the_masters():
    """`bf16_forward` casts for one call only: the module's parameters stay
    float32 leaves, its buffers float32, and a BatchNorm in train mode
    updates its float32 running statistics in place."""
    from sgtapose_tpu_torch.models.dla import BatchNorm

    bn = BatchNorm(4).train()
    x = torch.randn(2, 4, 5, 5).to(BF16)
    out = bf16_forward(bn, [x])
    assert out.dtype == BF16
    assert bn.weight.dtype == bn.running_mean.dtype == torch.float32
    xf = x.float()
    assert torch.allclose(bn.running_mean, 0.1 * xf.mean((0, 2, 3)), atol=1e-6)
    assert torch.allclose(bn.running_var, 0.9 + 0.1 * xf.var((0, 2, 3), unbiased=False), atol=1e-6)
    out.float().sum().backward()
    assert bn.weight.grad.dtype == torch.float32


def test_train_demo_bf16_on_the_cpu():
    """`train_demo --bf16` end to end at 64x64 (2 steps, batch 2, no eval):
    finite losses, float32 masters, statistics and Adam moments after it."""
    from sgtapose_tpu_torch.cli import train_demo

    res = train_demo.main(["--device", "cpu", "--bf16", "--steps", "2", "--batch", "2", "--input_res", "64",
                           "--eval_videos", "0", "--log_every", "1"])
    assert [e["step"] for e in res["logged"]] == [0, 1]
    assert all(np.isfinite(e[k]) for e in res["logged"] for k in ("tot", "hm", "reg", "tracking"))
    state = res["state"]
    assert state.step == 2
    assert all(t.dtype == torch.float32 for t in state.model.state_dict().values() if t.is_floating_point())
    assert all(v.dtype == torch.float32 for p in state.model.parameters()
               for k, v in state.optimizer.state[p].items() if k != "step")


def test_train_cli_bf16_on_the_cpu(tmp_path):
    """`cli/train --bf16` end to end at 64x64 on a set the port's writer
    makes, 1 epoch with validation and a mosaic: the train step runs bf16
    (the bf16 forward view is taken once per step), validation and the
    mosaic run the float32 parameters (no bf16 view), and the records are
    finite."""
    import json
    import os

    from sgtapose_tpu_torch.cli import train as tcli
    from sgtapose_tpu_torch.data import synthetic as tsyn
    from sgtapose_tpu_torch.train import trainer as ttrainer

    tsyn.write_synthetic_dataset(str(tmp_path / "syn"), n_videos=1, n_frames=3, seed=0, device="cpu")
    tsyn.write_synthetic_dataset(str(tmp_path / "val"), n_videos=1, n_frames=3, seed=1, device="cpu")
    views = []
    real = ttrainer.bf16_forward

    def counted(model, inputs):
        views.append(tuple(x.dtype for x in inputs))
        return real(model, inputs)

    ttrainer.bf16_forward = counted
    try:
        res = tcli.main(["--dataset", str(tmp_path / "syn"), "--val_dataset", str(tmp_path / "val"),
                         "--output_dir", str(tmp_path / "out"), "--num_epochs", "1", "--batch_size", "2",
                         "--log_every", "1", "--image_log_every", "1", "--num_workers", "1", "--bf16",
                         "--input_res", "64", "--kernel_list", "3,3,3,1,1,1", "--device", "cpu"])
    finally:
        ttrainer.bf16_forward = real
    assert res["state"].step == 1 and views == [(BF16,) * 6]
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["prefix"] for r in recs] == ["train", "val"]
    assert all(np.isfinite(r[k]) for r in recs for k in ("tot", "hm", "reg", "tracking"))
    assert os.listdir(tmp_path / "out" / "viz") == ["train_mosaic_0000001.png"]
    assert all(p.dtype == torch.float32 for p in res["state"].model.parameters())


def test_bf16_batchnorm_matches_its_float32_formula():
    """bf16 training's BatchNorm (`models/dla.py:BatchNorm` with a bf16 x,
    bf16 views of its float32 masters and float32 running statistics, as
    `bf16_forward` runs it; x and dy channels-last, as in the model) against
    flax's formula in float32 on the same bf16 x (fast variance, the output
    rounded once to bf16), with autograd. Train mode: the output within one
    bf16 unit in the last place (the two variances differ in float32's last
    bits), the running statistics float32 within float32 rounding, dx within
    one bf16 unit in the last place at its largest value, the masters' dw
    and db float32 but rounded to bf16 (the cotangents of their bf16 views,
    as JAX's bf16 scale and bias receive them), each within one bf16 unit
    in the last place. Eval mode: the output of the
    running statistics, bit for bit."""
    from sgtapose_tpu_torch.models.dla import BN_MOMENTUM, BatchNorm

    g = torch.Generator().manual_seed(3)
    cl = torch.channels_last
    x = (3 * torch.randn(2, 8, 6, 6, generator=g) + 1).to(BF16).contiguous(memory_format=cl)
    dy = torch.randn(2, 8, 6, 6, generator=g).to(BF16).contiguous(memory_format=cl)
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(8, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(8, generator=g))
        bn.running_mean.copy_(torch.randn(8, generator=g))
        bn.running_var.copy_(torch.rand(8, generator=g) + 0.5)
    stats0 = (bn.running_mean.clone(), bn.running_var.clone())
    xl = x.clone().requires_grad_()
    out = torch.func.functional_call(bn, {n: p.to(BF16) for n, p in bn.named_parameters()}, (xl,))
    got = torch.autograd.grad(out, [xl, bn.weight, bn.bias], dy)

    leaves = [x.float().requires_grad_(), bn.weight.detach().clone().requires_grad_(),
              bn.bias.detach().clone().requires_grad_()]
    c = (None, slice(None), None, None)
    mean = leaves[0].mean(dim=(0, 2, 3))
    var = torch.clamp((leaves[0] * leaves[0]).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
    ref = ((leaves[0] - mean[c]) * (leaves[1] * torch.rsqrt(var + 1e-5))[c] + leaves[2][c]).to(BF16)
    want = torch.autograd.grad(ref, leaves, dy)
    assert out.dtype == BF16 and got[0].dtype == BF16
    assert (out.float() - ref.float()).abs().max() <= 2.0 ** -7 * ref.float().abs().max()
    for run, s0, s in zip((bn.running_mean, bn.running_var), stats0, (mean, var)):
        assert run.dtype == torch.float32
        assert torch.allclose(run, BN_MOMENTUM * s0 + (1 - BN_MOMENTUM) * s.detach(), rtol=1e-5, atol=1e-6)
    assert (got[0].float() - want[0].float()).abs().max() <= 2.0 ** -7 * want[0].float().abs().max()
    for a, r in zip(got[1:], want[1:]):  # float32 masters of bf16 cotangents
        assert a.dtype == torch.float32 and torch.equal(a, a.to(BF16).float())
        assert torch.allclose(a, r, rtol=2.0 ** -7, atol=0.0)

    bn.eval()
    out = torch.func.functional_call(bn, {n: p.to(BF16) for n, p in bn.named_parameters()}, (x,))
    rstd = torch.rsqrt(bn.running_var + 1e-5)
    ref = ((x.float() - bn.running_mean[c]) * (bn.weight * rstd)[c] + bn.bias[c]).to(BF16)
    assert out.dtype == BF16 and (out.float() - ref.float()).abs().max() <= 2.0 ** -7 * ref.float().abs().max()
