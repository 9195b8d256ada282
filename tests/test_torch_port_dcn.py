"""Port parity: models/deform_conv.py (plain sampling on the CPU, and the
DeformConv2d module) against the JAX package on the same numpy inputs.

Bars: the sampling <= 1e-5 (the same float32 arithmetic per output; only
FMA contraction may differ); DeformConv2d and plain_deform_conv <= 1e-4
against flax (adds a 3x3 and a 9C-wide contraction summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.deform_conv import DeformConv2d as JaxDeformConv2d
from flax import linen as fnn

from sgtapose_tpu.models.deform_conv import deform_sample_batch
from sgtapose_tpu_torch.models import deform_conv as tdcn
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import perturb


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("B,H,W,C", [(1, 15, 15, 8), (2, 12, 20, 5)])
def test_plain_deform_sample_matches_jax(B, H, W, C):
    rs = np.random.RandomState(H * W + C)
    feat = rs.randn(B, H, W, C).astype(np.float32)
    offsets = rs.uniform(-3, 3, (B, H, W, 18)).astype(np.float32)  # samples leave the map
    offsets[0, 0, 0, :2] = [-1.0, -1.0]  # integer offsets: corners exactly on pixels
    masks = rs.rand(B, H, W, 9).astype(np.float32)
    ref = np.asarray(deform_sample_batch(feat, offsets, masks))
    port = tdcn.deform_sample(_t(feat), _t(offsets), _t(masks)).numpy()
    assert port.shape == (B, H, W, 9 * C)
    np.testing.assert_allclose(port, ref, atol=1e-5)


def test_deform_sample_cuda_rejects_cpu_tensors():
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError):
        tdcn.deform_sample_cuda(x, torch.zeros(1, 4, 4, 18), torch.zeros(1, 4, 4, 9))


def test_deform_conv2d_matches_flax():
    rs = np.random.RandomState(7)
    x = rs.randn(1, 10, 12, 16).astype(np.float32)
    flax_mod = JaxDeformConv2d(24)
    variables = perturb(flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    ref = np.asarray(flax_mod.apply(variables, jnp.asarray(x)))
    port_mod = tdcn.DeformConv2d(16, 24)
    load_flax_variables(port_mod, variables)
    with torch.no_grad():
        port = port_mod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-4)


def _wide_offset_variables(flax_mod, x, seed):
    """Flax DeformConv2d variables whose offsets reach ~3 px (samples leave
    the map) and whose mask logits are far from 0."""
    variables = perturb(flax_mod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed=seed)
    rs = np.random.RandomState(seed)
    om = dict(variables["params"]["conv_offset_mask"])
    om["kernel"] = 3.0 * om["kernel"]
    om["bias"] = rs.uniform(-3, 3, om["bias"].shape).astype(np.float32)
    params = dict(variables["params"], conv_offset_mask=om)
    return dict(variables, params=params)


@pytest.mark.parametrize("B,H,W,C,O", [(1, 9, 11, 6, 5), (2, 8, 8, 16, 24)])
def test_plain_deform_conv_and_module_match_flax(B, H, W, C, O):
    """plain_deform_conv (the fused kernel's plain version) from the raw
    offset/mask conv output, and the CPU DeformConv2d, against flax
    DeformConv2d.apply on the same numpy weights and inputs."""
    rs = np.random.RandomState(B * 100 + C)
    x = rs.randn(B, H, W, C).astype(np.float32)
    flax_mod = JaxDeformConv2d(O)
    variables = _wide_offset_variables(flax_mod, x, seed=B + C)
    ref = np.asarray(flax_mod.apply(variables, jnp.asarray(x)))

    p = variables["params"]
    om = np.asarray(fnn.Conv(27, (3, 3), padding=1).apply({"params": p["conv_offset_mask"]}, jnp.asarray(x)))
    off = om[..., :18]
    assert np.abs(off).max() > 2.0 and np.abs(om[..., 18:]).min() < np.abs(om[..., 18:]).max()
    weight = np.asarray(p["kernel"]["kernel"])[0, 0].T  # (O, 9C)
    plain = tdcn.plain_deform_conv(_t(x), _t(om), _t(weight), _t(p["kernel"]["bias"])).numpy()
    assert plain.shape == (B, H, W, O)
    np.testing.assert_allclose(plain, ref, atol=1e-4)

    port_mod = tdcn.DeformConv2d(C, O)
    load_flax_variables(port_mod, variables)
    with torch.no_grad():
        port = port_mod(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-4)


def test_deform_conv_cuda_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 8)
    om = torch.zeros(1, 4, 4, 27)
    with pytest.raises(ValueError):  # CPU tensors
        tdcn.deform_conv_cuda(x, om, torch.zeros(5, 72), torch.zeros(5))
    with pytest.raises(ValueError):  # weight is not (O, 9C)
        tdcn.deform_conv_cuda(x, om, torch.zeros(5, 64), torch.zeros(5))
    with pytest.raises(ValueError):  # om is not (B,H,W,27)
        tdcn.deform_conv_cuda(x, om[..., :18], torch.zeros(5, 72), torch.zeros(5))
    with pytest.raises(ValueError):  # bf16 x with float32 weights: no mixed kernel
        tdcn.deform_conv_cuda(x.to(torch.bfloat16), om.to(torch.bfloat16), torch.zeros(5, 72),
                              torch.zeros(5))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_deform_conv_refuses_other_dtypes(dtype):
    """float32 goes to the float32 kernel, bf16 to the bf16 one; any other
    dtype raises on every device, the CPU included."""
    mod = tdcn.DeformConv2d(8, 5).to(dtype)
    with pytest.raises(ValueError, match="float32 or bf16"):
        mod(torch.zeros(1, 8, 4, 4, dtype=dtype))


def test_plain_deform_conv_bf16_rounds_once():
    """The bf16 plain version (the bf16 kernel's reference): the sampled
    columns formed in float32 from the bf16 inputs and rounded once, the
    product in float32, the output rounded once to bf16."""
    rs = np.random.RandomState(5)
    x = _t(rs.randn(1, 9, 11, 6).astype(np.float32)).to(torch.bfloat16)
    om = _t(np.concatenate([rs.rand(1, 9, 11, 18) * 6 - 3, 2 * rs.randn(1, 9, 11, 9)], -1)
            .astype(np.float32)).to(torch.bfloat16)
    w = _t((rs.randn(5, 54) / 8).astype(np.float32)).to(torch.bfloat16)
    b = _t(rs.randn(5).astype(np.float32)).to(torch.bfloat16)
    out = tdcn.plain_deform_conv(x, om, w, b)
    assert out.dtype == torch.bfloat16
    f = torch.float32
    cols = tdcn.plain_deform_sample(x.to(f), om[..., :18].to(f), torch.sigmoid(om[..., 18:].to(f)))
    ref = torch.nn.functional.linear(cols.to(torch.bfloat16).to(f), w.to(f), b.to(f))
    assert torch.equal(out, ref.to(torch.bfloat16))
    exact = torch.nn.functional.linear(cols, w.to(f), b.to(f))
    assert (out.to(f) - exact).abs().max() <= 0.05 * exact.abs().max()
