"""Port parity for bf16 serving: `utils/precision.py`, the bf16 plain
attention and DCN, and the bf16 forward, against the JAX package's own bf16
path (`bf16_inference_variables`, `make_bf16_apply`) on the CPU, same numpy
weights and inputs.

Bars, each measured against the deviation of JAX bf16 from JAX float32 on the
same inputs (measured in the same test), since both frameworks round to bf16
at their own points:
  * weights: the bf16 port model equals `bf16_inference_variables` of the
    same flax tree, tensor by tensor (BatchNorm statistics included);
  * attention (MultiHeadCrossAttention, bf16 weights, q bf16 as on the first
    tied layer or float32 as on the later ones) at the 3 flagship (n, d):
    <= 1e-3 abs against JAX bf16 (measured 5e-7 .. 6e-5; JAX bf16 vs float32
    5e-3 .. 1e-2);
  * DCN (offsets leaving the map): the port forms each sampled element in
    float32 and rounds it once, where JAX rounds every corner product and sum
    and adds a bf16 bias to a bf16 product, so port bf16 vs JAX bf16 <= 2x
    JAX bf16 vs float32 (measured 1.2-1.3x), and port bf16 vs JAX float32 <=
    1.5x JAX bf16 vs float32 (measured 0.95-1.05x);
  * the full tiny forward (64x64, full widths) against `make_bf16_apply`:
    <= 1.5x JAX bf16 vs float32 per head (measured 0.95-1.2x).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.eval.synthetic_eval import make_bf16_apply as jax_bf16_apply
from sgtapose_tpu.models import attention as jattn
from sgtapose_tpu.models.deform_conv import DeformConv2d as JaxDeformConv2d
from sgtapose_tpu.utils.precision import bf16_inference_variables
from sgtapose_tpu_torch.eval.synthetic_eval import make_bf16_apply
from sgtapose_tpu_torch.models import attention as tattn
from sgtapose_tpu_torch.models.deform_conv import DeformConv2d
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.utils import precision
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, model_inputs, perturb, port_cfg

BF16 = torch.bfloat16


def _jax_bf16(variables):
    return bf16_inference_variables(jax.tree_util.tree_map(jnp.asarray, variables))


def _port_model(variables):
    model = SGTAPose(port_cfg("dcn")).eval()
    load_flax_variables(model, variables)
    return model


def test_bf16_model_equals_bf16_inference_variables():
    _, variables = flax_model_and_variables("dcn")
    f32_model = _port_model(variables)
    model = precision.bf16_inference_model(f32_model)
    assert precision.param_dtype(f32_model) == torch.float32  # the original is left as it is
    ref = SGTAPose(port_cfg("dcn")).eval().to(BF16)
    load_flax_variables(ref, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), _jax_bf16(variables)))
    state, ref_state = model.state_dict(), ref.state_dict()
    assert state.keys() == ref_state.keys()
    for key, t in state.items():
        if key.endswith("num_batches_tracked"):
            assert t.dtype == torch.int64
            continue
        assert t.dtype == BF16, key
        assert torch.equal(t, ref_state[key]), key
    assert any(k.endswith("running_var") for k in state)


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("level,n,d", [(0, 1183, 4), (1, 343, 8), (2, 63, 16)])
def test_bf16_attention_matches_jax(level, n, d, q_dtype):
    d_inp = 16 * 2 ** level
    rs = np.random.RandomState(level)
    q = rs.randn(1, n, d_inp).astype(np.float32)
    kv = rs.randn(1, n, d_inp).astype(np.float32)
    flax_mod = jattn.MultiHeadCrossAttention(8, d_inp, 8 * d, n, True)
    variables = perturb(flax_mod.init(jax.random.PRNGKey(0), q, kv, kv), level)
    qj = jnp.asarray(q).astype(q_dtype)
    kvj = jnp.asarray(kv).astype(jnp.bfloat16)
    ref = np.asarray(flax_mod.apply(_jax_bf16(variables), qj, kvj, kvj))
    ref32 = np.asarray(flax_mod.apply(variables, q, kv, kv))
    port_mod = tattn.MultiHeadCrossAttention(8, d_inp, 8 * d, n, True)
    load_flax_variables(port_mod, variables)
    port_mod = precision.bf16_inference_model(port_mod)
    with torch.no_grad():
        out = port_mod(torch.from_numpy(np.asarray(qj, np.float32)).to(getattr(torch, q_dtype)),
                       torch.from_numpy(kv).to(BF16), torch.from_numpy(kv).to(BF16))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-3
    assert np.abs(ref - ref32).max() > 1e-3  # bf16 did round


@pytest.mark.parametrize("H,C,O", [(15, 64, 32), (30, 32, 16)])
def test_bf16_dcn_matches_jax(H, C, O):
    """Offsets of up to 4 px from the offset conv's bias: many samples leave
    the map."""
    rs = np.random.RandomState(H)
    x = rs.randn(1, H, H, C).astype(np.float32)
    flax_mod = JaxDeformConv2d(O)
    variables = jax.tree_util.tree_map(np.asarray, perturb(flax_mod.init(jax.random.PRNGKey(0), x), H))
    variables["params"]["conv_offset_mask"]["bias"][:18] = (rs.rand(18) * 8 - 4).astype(np.float32)
    ref = np.asarray(flax_mod.apply(_jax_bf16(variables), jnp.asarray(x).astype(jnp.bfloat16)),
                     np.float32)
    ref32 = np.asarray(flax_mod.apply(variables, x))
    port_mod = DeformConv2d(C, O)
    load_flax_variables(port_mod, variables)
    port_mod = precision.bf16_inference_model(port_mod)
    with torch.no_grad():
        out = port_mod(torch.from_numpy(x).to(BF16).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == BF16
    out = out.float().numpy()
    jax_dev = np.abs(ref - ref32).max()
    assert np.abs(out - ref).max() <= 2.0 * jax_dev
    assert np.abs(out - ref32).max() <= 1.5 * jax_dev


@pytest.mark.parametrize("zero_priors", [False, True], ids=["priors", "cold_start"])
def test_bf16_forward_matches_make_bf16_apply(zero_priors):
    flax_model, variables = flax_model_and_variables("dcn")
    inputs = model_inputs(seed=2, zero_priors=zero_priors)
    ref = jax.jit(jax_bf16_apply(flax_model))(_jax_bf16(variables), *[jnp.asarray(a) for a in inputs])
    ref32 = jax.jit(flax_model.apply)(variables, *[jnp.asarray(a) for a in inputs])
    apply = make_bf16_apply(precision.bf16_inference_model(_port_model(variables)))
    out = apply(*[torch.from_numpy(a) for a in inputs])
    for key in ("hm", "reg", "tracking"):
        assert out[key].dtype == torch.float32 and out[key].shape == ref[key].shape
        jax_dev = np.abs(np.asarray(ref[key]) - np.asarray(ref32[key])).max()
        assert jax_dev > 0
        err = np.abs(out[key].numpy() - np.asarray(ref[key])).max()
        assert err <= 1.5 * jax_dev, (key, err, jax_dev)


def test_cast_floating_leaves_integers():
    tree = (torch.ones(2), [torch.arange(3), (torch.zeros(1, dtype=torch.float64), 5)])
    out = precision.cast_floating(tree, BF16)
    assert out[0].dtype == BF16 and out[1][0].dtype == torch.int64
    assert out[1][1][0].dtype == BF16 and out[1][1][1] == 5
