"""Port parity of the DCN column kernels of the int8 and QAT paths, and of
int8 serving's per-video dynamic scales beyond 64 videos, against the JAX
package on the CPU, same numpy inputs.

1. The bf16 sampling backward in the kernels' form
   (`models/deform_conv.py:plain_deform_sample_bwd`: bf16 x and cotangent,
   float32 offsets and masks widened from the bf16 offset/mask output, every
   product and sum in float32, dx and dom rounded once) against `jax.vjp`
   of `deform_sample_batch` (through the mask sigmoid) in float32, within
   1.5x the gap between JAX's own bf16 and float32 VJPs on the same inputs,
   at two decoder-like shapes with offsets leaving the map.
2. The sampling backward's float32 form (`plain_deform_sample_bwd`, which
   the card tests hold both backward kernels to) against `jax.vjp` in
   float32, at offsets 0, +-3 and +-12, at three channel widths and a
   ragged shape (C % 4 != 0, H != W: the kernels' one-channel-a-lane
   variant).
3. `_DeformSample` (the QAT columns) in bf16 gives the kernels' form.
4. A dynamic-scale int8 site at `groups` 65 (130 samples, 8x8x16): the
   plain site bit for bit against JAX vmapping its quantized conv over the
   videos, and the kernel's new scale prologue (each 64-pixel block reads
   only the slot maxima of its own images' videos) rendered in numpy, equal
   to the per-sample scales at 1, 2, 65 and 130 videos over maps of 1, 16
   and 64 pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models import layers as jlayers
from sgtapose_tpu.models.deform_conv import deform_sample_batch
from sgtapose_tpu_torch.models import deform_conv as tdc
from sgtapose_tpu_torch.models import layers as tlayers
from sgtapose_tpu_torch.ops import int8_conv as tint8

BF16 = torch.bfloat16


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


def _inputs(rs, B, H, W, C, span):
    """feat, offsets (in [-span, span]), mask logits and the cotangent, all
    rounded to bf16 values (held as float32)."""
    def r16(a):
        return _np(jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16))
    feat = r16(rs.randn(B, H, W, C))
    off = r16((rs.rand(B, H, W, 18) * 2 - 1) * span)
    logit = r16(2 * rs.randn(B, H, W, 9))
    g = r16(rs.randn(B, H, W, 9 * C))
    return feat, off, logit, g


def _jax_vjp(feat, off, logit, g, dtype):
    """(dfeat, doffsets, dlogit) of deform_sample_batch(feat, off,
    sigmoid(logit)) in `dtype`, as float32 numpy."""
    def f(x, o, lg):
        return deform_sample_batch(x, o, jax.nn.sigmoid(lg))
    args = [jnp.asarray(a).astype(dtype) for a in (feat, off, logit)]
    _, pull = jax.vjp(f, *args)
    return [_np(d) for d in pull(jnp.asarray(g).astype(dtype))]


@pytest.mark.parametrize("H,W,C", [(15, 15, 64), (12, 10, 32)])
def test_bf16_sampling_backward_matches_jax_vjp(H, W, C):
    """Offsets of up to 4 px: many samples leave the map; the port's bf16
    form against JAX float32 within 1.5x JAX's own bf16 gap per output."""
    rs = np.random.RandomState(H + C)
    feat, off, logit, g = _inputs(rs, 2, H, W, C, 4.0)
    r32 = _jax_vjp(feat, off, logit, g, jnp.float32)
    r16 = _jax_vjp(feat, off, logit, g, jnp.bfloat16)
    offsets, masks = tdc.sample_inputs(torch.cat([_t(off), _t(logit)], dim=-1).to(BF16))
    dx, dom = tdc.plain_deform_sample_bwd(_t(feat, BF16), offsets, masks, _t(g, BF16))
    assert dx.dtype == BF16 and dom.dtype == BF16 and dom.shape == (2, H, W, 27)
    ports = [dx.float().numpy(), dom[..., :18].float().numpy(), dom[..., 18:].float().numpy()]
    for name, a, ref, ref16 in zip(("dfeat", "doffsets", "dlogit"), ports, r32, r16):
        gap = _gap(ref16, ref)
        assert gap > 1e-3, name  # bf16 did round
        assert _gap(a, ref) <= 1.5 * gap, (name, _gap(a, ref), gap)


# (B, H, W, C): the backward kernels take 16 lanes of 4 channels per (pixel,
# tap) at C = 64, 8 at C = 32, a whole warp stepping twice at C = 256, and
# one channel a lane at the ragged shape
BWD_SHAPES = [(2, 8, 8, 64), (1, 7, 9, 32), (1, 5, 6, 256), (2, 9, 11, 6)]


@pytest.mark.parametrize("span", [0.0, 3.0, 12.0])
@pytest.mark.parametrize("B,H,W,C", BWD_SHAPES, ids=["c64", "c32", "c256", "ragged"])
def test_sampling_backward_matches_jax_vjp_at_offset_spans(B, H, W, C, span):
    """Float32 throughout: dx and dom (the offsets' gradient and the mask
    logits', dmask s (1 - s)) against JAX's VJP through the sigmoid."""
    rs = np.random.RandomState(int(span) + C)
    feat, off, logit, g = _inputs(rs, B, H, W, C, span)
    if span == 0.0:
        off = np.zeros_like(off)
    masks = torch.sigmoid(_t(logit))
    dx, dom = tdc.plain_deform_sample_bwd(_t(feat), _t(off), masks, _t(g))
    assert dx.dtype == dom.dtype == torch.float32 and dom.shape == (B, H, W, 27)
    scale_x, scale_o = max(1.0, dx.abs().max().item()), max(1.0, dom.abs().max().item())
    jdx, jdoff, jdlogit = _jax_vjp(feat, off, logit, g, jnp.float32)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=0, atol=1e-5 * scale_x)
    np.testing.assert_allclose(dom[..., :18].numpy(), jdoff, rtol=0, atol=1e-5 * scale_o)
    np.testing.assert_allclose(dom[..., 18:].numpy(), jdlogit, rtol=0, atol=1e-5 * scale_o)
    if span == 12.0:  # samples leave the map: their corners carry zero weight
        corners = tdc._corners(*tdc._tap_grid(B, 0, H, W, _t(off)), H, W)
        assert any((wv == 0).any() for _, wv, _, _, _ in corners)


def test_qat_columns_bf16_backward_is_the_kernels_form():
    """`deform_columns` under autograd in bf16: the cotangent of x and of the
    offset/mask output equal `plain_deform_sample_bwd`'s, in bf16."""
    rs = np.random.RandomState(5)
    feat, off, logit, g = _inputs(rs, 1, 6, 7, 16, 3.0)
    x = _t(feat, BF16).requires_grad_()
    om = torch.cat([_t(off), _t(logit)], dim=-1).to(BF16).requires_grad_()
    cols = tdc.deform_columns(x, om)
    assert cols.dtype == BF16
    cols.backward(_t(g, BF16))
    offsets, masks = tdc.sample_inputs(om.detach())
    dx, dom = tdc.plain_deform_sample_bwd(x.detach(), offsets, masks, _t(g, BF16))
    assert x.grad.dtype == BF16 and om.grad.dtype == BF16
    assert torch.equal(x.grad, dx) and torch.equal(om.grad, dom)


def _kernel_row_scales(partial, groups, hw, tile=64):
    """int8_conv_fused's scale prologue in numpy (flat modes): the block of
    output pixels m0 .. m0 + tile - 1 spans images n0 .. n1; its slot j
    holds the max over the slot maxima of video (n0 + j) % groups (images
    v, v + groups, ...), taken on the float bits; pixel m's image n takes
    slot (n - n0) % groups. Returns each pixel's scale."""
    N, slots = partial.shape
    bits = partial.view(np.uint32)
    M = N * hw
    out = np.empty(M, np.float32)
    for m0 in range(0, M, tile):
        n0, n1 = m0 // hw, (min(m0 + tile, M) - 1) // hw
        nv = min(n1 - n0 + 1, groups)
        vmax = np.zeros(nv, np.uint32)
        for j in range(nv):
            v = (n0 + j) % groups
            vmax[j] = bits[v::groups].max()
        scale = np.maximum(vmax.view(np.float32), np.float32(1e-12)) / np.float32(127)
        for m in range(m0, min(m0 + tile, M)):
            out[m] = scale[(m // hw - n0) % groups]
    return out


@pytest.mark.parametrize("hw", [1, 16, 64])
def test_kernel_scale_prologue_at_any_number_of_videos(hw):
    rs = np.random.RandomState(hw)
    N = 130
    x = _t(rs.randn(N, hw, 1, 3).astype(np.float32) * rs.rand(N, 1, 1, 1).astype(np.float32) * 4)
    part = tint8.plain_int8_absmax(x, 2).numpy()
    for groups in (1, 2, 65, 130):
        ref = tlayers.activation_scale(x, groups=groups).numpy()
        np.testing.assert_array_equal(_kernel_row_scales(part, groups, hw), np.repeat(ref, hw))


def test_plain_site_at_65_videos_matches_jax_vmap():
    """A dynamic 3x3 site over 130 samples in 65 videos (sample n is video n
    % 65), float32 and bf16: the port's plain site bit for bit against JAX
    vmapping the quantized conv over the videos (one scale each), as JAX's
    batched runner does."""
    rs = np.random.RandomState(65)
    N, V, C, O = 130, 65, 16, 16
    x = rs.randn(N, 8, 8, C).astype(np.float32) * (1 + 3 * rs.rand(N, 1, 1, 1)).astype(np.float32)
    w = (rs.randn(3, 3, C, O) / np.sqrt(9 * C)).astype(np.float32)
    b = (0.1 * rs.randn(O)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        mod = jlayers.Conv(O, kernel_size=(3, 3), strides=(1, 1), padding=1, use_bias=True, dtype=jdt,
                           param_dtype=jdt)
        params = {"kernel": jnp.asarray(w).astype(jdt), "bias": jnp.asarray(b).astype(jdt)}

        def video(xv):
            with jlayers.quantized("int8"):
                return mod.apply({"params": params}, xv)

        xj = jnp.asarray(x).astype(jdt).reshape(N // V, V, 8, 8, C).transpose(1, 0, 2, 3, 4)
        ref = _np(jax.vmap(video)(xj)).transpose(1, 0, 2, 3, 4).reshape(N, 8, 8, O)
        tw = _t(w).permute(3, 2, 0, 1).contiguous().to(tdt)
        qw = tlayers._cached_weight(torch.nn.Module(), tw, 3, 3)
        got = tint8.int8_site(_t(x).to(tdt), qw, None, V, _t(b).to(tdt), 1, 1)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref)
        whole = tint8.int8_site(_t(x).to(tdt), qw, None, 1, _t(b).to(tdt), 1, 1)
        assert not torch.equal(got, whole)  # the per-video scales differ from one scale
