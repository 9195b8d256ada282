"""Port parity of bf16 training's DCN data gradient on the CPU (the kernel,
`deform_conv_dgrad_bf16`, runs on the card: tests/test_torch_port_cuda.py
and chip_smoke.py hold it against the plain version checked here).

- `plain_deform_conv_dgrad` on bf16 inputs (the float32 formulas on the
  widened inputs, dx and dom each rounded once to bf16: the kernel's
  semantics) against `jax.vjp` of the JAX DCN (deform_sample_batch with its
  custom VJP, then the 9C -> O contraction) computed in bf16, at the
  float32 test's four shapes (zero offsets, +-3 px, +-12 px beyond any
  tile, a ragged C and O). JAX rounds to bf16 after every product and sum
  of `_bwd_core`, the port once per output, so the bar is a multiple of
  JAX's own bf16-vs-float32 gap: within 1.5x that gap per output, the gap
  itself above 1e-3 (bf16 did round); a control shows the bar fails a
  wrong answer.
- The wrappers of the kernel and of its yardstick raise on CPU tensors and
  on dtypes they do not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.deform_conv import deform_sample_batch
from sgtapose_tpu_torch.models import deform_conv as tdcn

BF16 = torch.bfloat16

# (B, H, W, C, O, offset range), as tests/test_torch_port_bwd_kernels.py:
# DGRAD_CASES; 0 means flax's zero-initialised offsets
DGRAD_CASES = {
    "zero_offsets": (2, 10, 12, 8, 12, 0.0),
    "offsets_3": (2, 10, 12, 8, 12, 3.0),
    "offsets_12": (1, 14, 13, 8, 12, 12.0),
    "ragged": (1, 9, 11, 6, 5, 3.0),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_dcn(x, om, w, b):
    """The JAX module's arithmetic: sampling with sigmoid masks, then the
    1x1 contraction with kernel W^T (input index k*C + c)."""
    flat = deform_sample_batch(x, om[..., :18], jax.nn.sigmoid(om[..., 18:]))
    return flat @ w.T + b


@jax.jit
def _jax_data_grads(x, om, w, b, dy):
    """(dx, dom) of `_jax_dcn` by `jax.vjp`, in the inputs' dtype."""
    return jax.vjp(_jax_dcn, x, om, w, b)[1](dy)[:2]


def _gap(a, b):
    """max|a - b| / max|b| (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _case(case):
    B, H, W, C, O, span = DGRAD_CASES[case]
    rs = np.random.RandomState(len(case) + C)
    x = rs.randn(B, H, W, C).astype(np.float32)
    off = rs.uniform(-span, span, (B, H, W, 18)) if span else np.zeros((B, H, W, 18))
    om = np.concatenate([off, 2 * rs.randn(B, H, W, 9)], -1).astype(np.float32)
    w = (rs.randn(O, 9 * C) / np.sqrt(9 * C)).astype(np.float32)
    b = rs.randn(O).astype(np.float32)
    dy = rs.randn(B, H, W, O).astype(np.float32)
    return x, om, w, b, dy


@pytest.mark.parametrize("case", sorted(DGRAD_CASES))
def test_bf16_plain_dgrad_matches_jax_vjp(case):
    arrays = _case(case)
    B, H, W, C, O, _ = DGRAD_CASES[case]
    ref = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        dx, dom = _jax_data_grads(*(jnp.asarray(a).astype(dtype) for a in arrays))
        assert dx.dtype == dom.dtype == dtype
        ref[dtype] = (np.asarray(dx.astype(jnp.float32)), np.asarray(dom.astype(jnp.float32)))
    # the port on the very bf16 values JAX's bf16 run took
    x, om, w, _, dy = (torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)))
                       .to(BF16) for a in arrays)
    got = tdcn.plain_deform_conv_dgrad(x, om, w, dy)
    assert got[0].shape == (B, H, W, C) and got[1].shape == (B, H, W, 27)
    assert got[0].dtype == got[1].dtype == BF16
    for name, a, r16, r32 in zip(("dx", "dom"), got, ref[jnp.bfloat16], ref[jnp.float32]):
        gap = _gap(r16, r32)
        assert gap > 1e-3, (name, gap)
        a = a.float().numpy()
        assert _gap(a, r16) <= 1.5 * gap, (name, _gap(a, r16), gap)
        # control: a wrong answer (dx or dom scaled by 1 + 4 gaps) fails the bar
        assert _gap(a * (1 + 4 * gap), r16) > 1.5 * gap, name


def test_bf16_dgrad_wrappers_raise_off_the_card():
    x, om, w, _, dy = (torch.from_numpy(a).to(BF16) for a in _case("ragged"))
    with pytest.raises(ValueError, match="CUDA"):
        tdcn.deform_conv_dgrad_cuda(x, om, w, dy)
    with pytest.raises(ValueError, match="CUDA"):
        tdcn.deform_conv_dgrad_halo_cuda(x, om, w, dy)
    with pytest.raises(ValueError, match="bf16"):
        tdcn.deform_conv_dgrad_halo_cuda(x.float(), om.float(), w.float(), dy.float())
    with pytest.raises(ValueError, match="float32 or bf16"):
        tdcn.deform_conv_dgrad_cuda(x.half(), om.half(), w.half(), dy.half())
