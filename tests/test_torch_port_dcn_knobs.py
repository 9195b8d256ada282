"""Port: the DCN memory knobs `dcn_chunks` and `dcn_remat`
(`models/deform_conv.py`, `models/dla.py:DeformNode`) on the CPU, and the
quantizable conv's parameter names.

* chunks in {1, 2, 4, 7} (7 does not divide the map's 12 rows: the largest
  divisor below it, 6, is taken, as JAX's `_pick_chunks` does) and remat
  change no number: the plain sampler and its backward, the DCN module's
  output and gradients, the int8 modes' columns, and a whole tiny train
  step's loss and gradients, bit for bit against chunks 1 without remat.
* The port's chunked sampler and its backward against JAX's
  `deform_sample_batch_chunked` and its VJP (the unchunked bars of
  tests/test_torch_port_dcn.py and test_torch_port_bwd_kernels.py: 1e-5 and
  1e-4).
* `models/layers.Conv2d` keeps nn.Conv2d's state_dict keys, so the model's
  keys are those of the same model with plain nn.Conv2d sites, and the
  converter's round trip is unchanged.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.deform_conv import deform_sample_batch_chunked
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.models import deform_conv as tdcn, dla as tdla, layers as tlayers, sgta as tsgta
from sgtapose_tpu_torch.models.attention import set_dropout_rate
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.utils import torch_convert as ttc
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import port_cfg, random_train_batch, train_variables

CHUNKS = [2, 4, 7]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _sample_case(seed=0, B=2, H=12, W=10, C=6):
    rs = np.random.RandomState(seed)
    feat = rs.randn(B, H, W, C).astype(np.float32)
    offsets = rs.uniform(-3, 3, (B, H, W, 18)).astype(np.float32)  # samples leave the map
    masks = rs.rand(B, H, W, 9).astype(np.float32)
    grad = rs.randn(B, H, W, 9 * C).astype(np.float32)
    return feat, offsets, masks, grad


def test_pick_chunks_is_jax_rule():
    from sgtapose_tpu.models.deform_conv import _pick_chunks

    for H in (1, 7, 12, 15, 30, 120):
        for chunks in (1, 2, 3, 4, 7, 8, 200):
            assert tdcn.pick_chunks(H, chunks) == _pick_chunks(H, chunks)


@pytest.mark.parametrize("chunks", CHUNKS)
def test_plain_sampler_chunks_bit_for_bit_and_against_jax(chunks):
    feat, offsets, masks, grad = _sample_case(chunks)
    args = [_t(a) for a in (feat, offsets, masks)]
    one = tdcn.plain_deform_sample(*args)
    np.testing.assert_array_equal(tdcn.plain_deform_sample(*args, chunks=chunks).numpy(), one.numpy())
    bwd_one = tdcn.plain_deform_sample_backward(*args, _t(grad))
    bwd = tdcn.plain_deform_sample_backward(*args, _t(grad), chunks=chunks)
    for a, b in zip(bwd, bwd_one):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    ref, vjp = jax.vjp(lambda f, o, m: deform_sample_batch_chunked(chunks, f, o, m), *map(jnp.asarray, (feat, offsets, masks)))
    np.testing.assert_allclose(one.numpy(), np.asarray(ref), atol=1e-5)
    for a, r in zip(bwd, vjp(jnp.asarray(grad))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-5)


def _dcn_module(chunks, seed=3, C=8, O=12):
    torch.manual_seed(seed)
    mod = tdcn.DeformConv2d(C, O, chunks=chunks)
    with torch.no_grad():  # offsets of a few pixels, masks away from 0.5
        mod.conv_offset_mask.weight.normal_(0, 0.3)
        mod.conv_offset_mask.bias.uniform_(-2, 2)
    return mod


@pytest.mark.parametrize("mode", [None, "int8_train"], ids=["float", "int8_train"])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_dcn_module_chunks_bit_for_bit(chunks, mode):
    x = _t(np.random.RandomState(1).randn(2, 8, 12, 10).astype(np.float32))  # NCHW, H = 12
    outs = []
    for c in (1, chunks):
        mod = _dcn_module(c)
        xi = x.clone().requires_grad_(True)
        with tlayers.quantized(mode) if mode else contextlib.nullcontext():
            y = mod(xi)
            (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        outs.append([y.detach(), xi.grad] + [p.grad for p in mod.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_dcn_columns_chunks_bit_for_bit_under_int8():
    x = _t(np.random.RandomState(2).randn(1, 8, 12, 10).astype(np.float32))
    outs = []
    for c in (1, 4):
        mod = _dcn_module(c)
        with torch.no_grad(), tlayers.quantized("int8"):
            outs.append(mod(x))
    assert torch.equal(*outs)


def test_deform_node_remat_bit_for_bit():
    x = _t(np.random.RandomState(4).randn(2, 8, 12, 10).astype(np.float32))
    outs = []
    for remat in (False, True):
        torch.manual_seed(5)
        node = tdla.DeformNode(8, 12, dcn_remat=remat, dcn_chunks=3 if remat else 1).train()
        with torch.no_grad():
            node.conv.conv_offset_mask.weight.normal_(0, 0.3)
        calls = []
        for tag, mod in ((1, node.conv), (2, node.BatchNorm_0)):
            mod.forward = (lambda f, tag: lambda *a: calls.append(tag) or f(*a))(mod.forward, tag)
        xi = x.clone().requires_grad_(True)
        y = node(xi)
        (y * y).sum().backward()
        # remat recomputes the DCN, and only the DCN, in the backward
        assert calls == ([1, 2, 1] if remat else [1, 2])
        outs.append([y.detach(), xi.grad] + [p.grad for p in node.parameters()] + [node.BatchNorm_0.running_mean])
    assert len(outs[0]) == 9
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _step(chunks: int, remat: bool):
    _, variables = train_variables()
    cfg = PortConfig(model=dataclasses.replace(port_cfg("dcn"), dcn_chunks=chunks, dcn_remat=remat))
    state = ttrainer.create_train_state(cfg, seed=0, max_iters=20, device="cpu")
    load_flax_variables(state.model, variables)
    set_dropout_rate(state.model, 0.0)
    stats = ttrainer.train_step(state, {k: _t(v) for k, v in random_train_batch(5).items()})
    return stats, {k: p.detach().clone() for k, p in state.model.state_dict().items()}


def test_train_step_knobs_bit_for_bit():
    """One whole train step of the tiny model: loss terms and the updated
    parameters and BatchNorm statistics, chunks 4 (the 16x16 map takes 4
    slabs, the 4x4 and 8x8 maps theirs), and remat with chunks 7 (the
    divisor rule at 16, 8 and 4 rows), against the plain configuration."""
    ref_stats, ref_sd = _step(1, False)
    for chunks, remat in ((4, False), (7, True)):
        stats, sd = _step(chunks, remat)
        assert all(torch.equal(stats[k], ref_stats[k]) for k in ref_stats), (chunks, remat)
        assert all(torch.equal(sd[k], ref_sd[k]) for k in ref_sd), (chunks, remat)


def test_quantizable_conv_keeps_state_dict_keys_and_the_converter_round_trip(monkeypatch):
    cfg = dataclasses.replace(port_cfg("dcn"), dcn_chunks=2, dcn_remat=True)
    model = tsgta.create_model(cfg, device="cpu")
    sites = [m for m in model.modules() if isinstance(m, tlayers.Conv2d)]
    assert len(sites) == 41  # 38 trunk convs and the 3 heads' 3x3s; the 16 DCN contractions are nn.Linear
    for m in sites:
        plain = torch.nn.Conv2d(m.in_channels, m.out_channels, m.kernel_size, bias=m.bias is not None)
        assert list(m.state_dict()) == list(plain.state_dict())
    for module in (tdla, tsgta):
        monkeypatch.setattr(module, "Conv2d", torch.nn.Conv2d)
    plain_model = tsgta.build_model(port_cfg("dcn"))
    assert not any(isinstance(m, tlayers.Conv2d) for m in plain_model.modules())
    assert list(model.state_dict()) == list(plain_model.state_dict())
    sd = ttc.export_state_dict(model)
    back = tsgta.create_model(port_cfg("dcn"), device="cpu", seed=1)
    report = ttc.convert_state_dict({"module." + k: v for k, v in sd.items()}, back)
    assert not report["missing"] and not report["mismatched"] and not report["unused_ref_keys"]
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
