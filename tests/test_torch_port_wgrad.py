"""Port parity of the DCN weight gradient's plain version on the CPU (the
kernel, `deform_conv_wgrad` and its bf16 instantiation, runs on the card:
tests/test_torch_port_cuda.py and chip_smoke.py phase 4c).

- `plain_deform_conv_wgrad` (what the kernel is held against) against
  `jax.vjp` of the flax `DeformConv2d`'s `kernel` parameter, on maps of the
  64x64 model's decoder with offsets of up to 4 px from the offset conv's
  bias (many samples leave the map), same numpy inputs and weights:
  float32 within 1e-5 of max(1, max|ref|) (the same products summed in
  another order). bf16 (bf16 parameters and input, as bf16 training runs the
  module): the port forms each column element in float32 and rounds it once
  and sums in float32, where JAX rounds after every product and sum, so the
  bars are multiples of the gap between JAX bf16 and JAX float32 measured in
  the same test: port bf16 vs JAX bf16 <= 0.75x the gap (measured
  0.32-0.41x), port bf16 vs JAX float32 <= 1.5x (measured 0.98-1.00x);
  controls that sample half a pixel off, or at zero offsets, fail both bars
  (47-118x).
- The kernel's split of the pixels: the split-order sum equals the direct
  product up to the order of summation, and `deform_conv`'s autograd on the
  CPU takes the plain version.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.deform_conv import DeformConv2d as JaxDeformConv2d
from sgtapose_tpu.utils.precision import cast_floating
from sgtapose_tpu_torch.models import deform_conv as tdcn
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import perturb

# (B, H, W, C, O): decoder maps of the 64x64 model (16x16 at C = 32, a
# ragged 8x12 at C = 64)
CASES = [(2, 16, 16, 32, 16), (1, 8, 12, 64, 24)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _gap(a, b):
    """max|a - b| / max|b| (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _jax_case(B, H, W, C, O, bf16):
    """x, dy, the flax module's raw offset/mask conv output and the gradient
    of its `kernel` parameter in the port's (O, 9C) layout, as float32 numpy
    (bf16: parameters, input and cotangent cast to bf16, as bf16 training
    runs the module); and the flax variables."""
    rs = np.random.RandomState(H + C)
    x = rs.randn(B, H, W, C).astype(np.float32)
    g = rs.randn(B, H, W, O).astype(np.float32)
    mod = JaxDeformConv2d(O)
    variables = jax.tree_util.tree_map(np.asarray, perturb(mod.init(jax.random.PRNGKey(0), x), H))
    variables["params"]["conv_offset_mask"]["bias"][:18] = (rs.rand(18) * 8 - 4).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    dt = jnp.bfloat16 if bf16 else jnp.float32
    p = cast_floating(params, dt) if bf16 else params
    xj, gj = jnp.asarray(x).astype(dt), jnp.asarray(g).astype(dt)
    dp = jax.vjp(lambda pp: mod.apply({"params": pp}, xj), p)[1](gj)[0]
    dw = np.asarray(dp["kernel"]["kernel"][0, 0].astype(jnp.float32)).T
    om = fnn.Conv(27, (3, 3), padding=1).apply({"params": p["conv_offset_mask"]}, xj)
    return x, g, np.asarray(om.astype(jnp.float32)), dw, variables


@pytest.mark.parametrize("B,H,W,C,O", CASES)
def test_plain_wgrad_matches_flax_kernel_gradient(B, H, W, C, O):
    x, g, om, ref, _ = _jax_case(B, H, W, C, O, bf16=False)
    om_t = _t(om)
    dw = tdcn.plain_deform_conv_wgrad(_t(x), om_t[..., :18].contiguous(), torch.sigmoid(om_t[..., 18:]), _t(g))
    assert dw.shape == (O, 9 * C) and dw.dtype == torch.float32
    err = np.abs(dw.numpy() - ref).max()
    assert err <= 1e-5 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("B,H,W,C,O", CASES)
def test_plain_wgrad_bf16_within_jax_gap(B, H, W, C, O):
    """The port's bf16 path takes the bf16 offset conv's output widened to
    float32, the mask sigmoid in float32 (`deform_conv_backward`)."""
    x, g, om16, ref16, _ = _jax_case(B, H, W, C, O, bf16=True)
    _, _, _, ref32, _ = _jax_case(B, H, W, C, O, bf16=False)
    gap = _gap(ref16, ref32)
    assert gap > 1e-3  # bf16 did round
    xb, gb, om_t = _t(x).to(torch.bfloat16), _t(g).to(torch.bfloat16), _t(om16)
    offsets, masks = om_t[..., :18].contiguous(), torch.sigmoid(om_t[..., 18:])

    def bars(dw):
        return _gap(dw.float().numpy(), ref16) <= 0.75 * gap and _gap(dw.float().numpy(), ref32) <= 1.5 * gap

    dw = tdcn.plain_deform_conv_wgrad(xb, offsets, masks, gb)
    assert dw.dtype == torch.bfloat16 and dw.shape == (O, 9 * C)
    assert bars(dw), (_gap(dw.float().numpy(), ref16) / gap, _gap(dw.float().numpy(), ref32) / gap)
    # controls: sampling half a pixel off, or at the taps without offsets
    assert not bars(tdcn.plain_deform_conv_wgrad(xb, offsets + 0.5, masks, gb))
    assert not bars(tdcn.plain_deform_conv_wgrad(xb, torch.zeros_like(offsets), masks, gb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("splits", [2, 5, 7])
def test_split_order_matches_direct_product(splits, dtype):
    """The pixels cut into whole K steps (32 float32 or 64 bf16 pixels; the
    last split ragged): the ranges' float32 products added in order equal
    the direct product within 1e-6 of max(1, max|ref|) (float32 sums in
    another order); in bf16, after the one rounding, within one bf16 unit
    in the last place at the top of the range (2^-7 of max|ref|)."""
    rs = np.random.RandomState(splits)
    B, H, W, C, O = 2, 13, 17, 10, 6
    x = _t(rs.randn(B, H, W, C)).to(dtype)
    offsets = _t(rs.uniform(-3, 3, (B, H, W, 18)))
    masks = _t(rs.rand(B, H, W, 9))
    dy = _t(rs.randn(B, H, W, O)).to(dtype)
    cols = tdcn.plain_deform_sample(x, offsets, masks).reshape(-1, 9 * C).float()
    direct = dy.reshape(-1, O).float().t() @ cols
    got = tdcn.plain_deform_conv_wgrad(x, offsets, masks, dy, splits).float()
    bar = 1e-6 * max(1.0, direct.abs().max().item()) if dtype == torch.float32 else 2.0 ** -7 * direct.abs().max().item()
    assert (got - direct).abs().max().item() <= bar
    assert splits <= -(-B * H * W // tdcn.wgrad_step_pixels(dtype))  # every split holds pixels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_deform_conv_autograd_takes_the_plain_wgrad(monkeypatch, dtype):
    """`DeformConv2d`'s backward on the CPU computes its kernel gradient with
    `plain_deform_conv_wgrad`, once, from the offsets and sigmoided masks of
    the offset conv's output (float32 in bf16)."""
    calls = []
    real = tdcn.plain_deform_conv_wgrad

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(tdcn, "plain_deform_conv_wgrad", counted)
    torch.manual_seed(3)
    mod = tdcn.DeformConv2d(12, 10).to(dtype)
    with torch.no_grad():
        mod.conv_offset_mask.weight.normal_(0.0, 0.3)
        mod.conv_offset_mask.bias.uniform_(-2.0, 2.0)
    x = torch.randn(2, 12, 9, 11).to(dtype)
    g = torch.randn(2, 10, 9, 11).to(dtype)
    mod(x).backward(g)
    assert len(calls) == 1
    feat, offsets, masks, dy = calls[0]
    assert offsets.dtype == masks.dtype == torch.float32 and feat.dtype == dy.dtype == dtype
    om = mod.conv_offset_mask(x).permute(0, 2, 3, 1).contiguous()
    f32 = torch.float32
    assert torch.equal(offsets, om[..., :18].to(f32))
    assert torch.equal(masks, torch.sigmoid(om[..., 18:27].to(f32)).contiguous())
    assert torch.equal(mod.kernel.weight.grad, real(*calls[0]))


def test_wgrad_splits_fill_the_card():
    """The split counts at the training batch of 8 on a 132-SM H100, float32
    and bf16: the 120x120 nodes (9 tiles) split 28 ways, 252 blocks at two
    an SM; every split at least 8 K steps."""
    nodes = [(15, 512, 256), (30, 256, 256), (30, 256, 128), (30, 256, 64), (60, 128, 128), (60, 128, 64),
             (120, 64, 64)]
    expect = {torch.float32: [5, 7, 7, 7, 7, 14, 28], torch.bfloat16: [3, 7, 7, 7, 7, 14, 28]}
    for dtype, want in expect.items():
        got = [tdcn.wgrad_splits(8 * H * H, C, O, dtype, 132) for H, C, O in nodes]
        assert got == want, (dtype, got)
        for (H, C, O), s in zip(nodes, got):
            assert s * 8 <= -(-8 * H * H // tdcn.wgrad_step_pixels(dtype))
    assert tdcn.wgrad_splits(2 * 9 * 11, 6, 5, torch.float32, 132) == 1


def test_wgrad_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tdcn.deform_conv_wgrad_cuda(x, torch.zeros(1, 4, 4, 18), torch.zeros(1, 4, 4, 9), torch.zeros(1, 4, 4, 3))


def test_flax_kernel_gradient_lands_on_the_port_weight():
    """The port's `kernel.weight` gradient from its CPU autograd equals the
    flax `kernel` parameter's gradient, loaded through the weight map, within
    1e-5 of max(1, max|ref|)."""
    B, H, W, C, O = CASES[0]
    x, g, _, ref, variables = _jax_case(B, H, W, C, O, bf16=False)
    port = tdcn.DeformConv2d(C, O)
    load_flax_variables(port, variables)
    port(_t(x).permute(0, 3, 1, 2)).backward(_t(g).permute(0, 3, 1, 2))
    err = np.abs(port.kernel.weight.grad.numpy() - ref).max()
    assert err <= 1e-5 * max(1.0, np.abs(ref).max()), err
