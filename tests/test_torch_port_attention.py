"""Port parity: the biased-attention op (plain version on the CPU) and
models/attention.py against the JAX package on the same numpy inputs.

Bars: the attention op <= 2e-4 against the Pallas kernel in interpret mode
(the JAX package's own kernel-vs-XLA bar); MultiHeadCrossAttention and the
weight-tied TransformerEncoder <= 5e-4 against flax (the JAX module bar);
top-k indices, window ids and scatters equal (integer/copy semantics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models import attention as jattn
from sgtapose_tpu.ops.attention_kernel import _xla_attention
from sgtapose_tpu.ops.attention_kernel import fused_biased_attention as jax_fused
from sgtapose_tpu_torch.models import attention as tattn
from sgtapose_tpu_torch.ops import attention_kernel as tkern
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import perturb


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("n,d", [(63, 16), (343, 8)])
def test_plain_attention_matches_pallas_interpret(n, d):
    rs = np.random.RandomState(n)
    q, k, v = (rs.randn(1, 8, n, d).astype(np.float32) for _ in range(3))
    bias = (0.1 * rs.randn(8, n, n)).astype(np.float32)
    ref = np.asarray(jax_fused(q, k, v, bias, True))
    port = tkern.fused_biased_attention(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(port.numpy(), ref, atol=2e-4)


@pytest.mark.parametrize("n,d", [(1, 4), (33, 8), (100, 16), (343, 4)])
def test_kernel_split_and_merge_matches_jax(n, d):
    """The CUDA kernel's arithmetic (log2-unit logits, row max, keys split
    over the 32 lanes of a warp and the lanes' sums added) against the Pallas
    kernel in interpret mode and the XLA formulation, at ragged n (fewer keys
    than lanes, and not a multiple of 32)."""
    rs = np.random.RandomState(100 + n)
    q, k, v = (rs.randn(2, 8, n, d).astype(np.float32) for _ in range(3))
    bias = (0.1 * rs.randn(8, n, n)).astype(np.float32)
    port = tkern.split_lane_attention(_t(q), _t(k), _t(v), _t(bias)).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_fused(q, k, v, bias, True)), atol=2e-4)
    np.testing.assert_allclose(port, np.asarray(_xla_attention(q, k, v, bias)), atol=2e-4)


@pytest.mark.parametrize("n,d,tile_keys", [(600, 4, 256), (70, 8, 32), (5, 16, 256), (378, 16, 64)])
def test_key_tiled_arithmetic_matches_jax(n, d, tile_keys):
    """The key-tiled kernel's arithmetic (per-lane online softmax over key
    chunks, lanes merged at the row max) against the Pallas kernel in
    interpret mode and the XLA formulation, at ragged chunks and n below 32;
    a bias of scale 3 makes a lane's max grow from chunk to chunk."""
    rs = np.random.RandomState(200 + n)
    q, k, v = (rs.randn(2, 8, n, d).astype(np.float32) for _ in range(3))
    bias = (3.0 * rs.randn(8, n, n)).astype(np.float32)
    port = tkern.key_tiled_attention(_t(q), _t(k), _t(v), _t(bias), tile_keys).numpy()
    np.testing.assert_allclose(port, np.asarray(jax_fused(q, k, v, bias, True)), atol=2e-4)
    np.testing.assert_allclose(port, np.asarray(_xla_attention(q, k, v, bias)), atol=2e-4)


def test_large_n_goes_to_the_key_tiled_kernel():
    """A 42-keypoint model's levels 0 and 1 at the flagship windows,
    (42 x 13^2, 4) and (42 x 7^2, 8), exceed the shared-memory kernel; the
    7-keypoint flagship's shapes and level 2 of the 42-keypoint model fit."""
    for n, d in ((1183, 4), (343, 8), (63, 16), (378, 16)):
        assert tkern.fits_smem(n, d)
    for n, d in ((7098, 4), (2058, 8)):
        assert not tkern.fits_smem(n, d)
    q = torch.zeros(1, 8, 2058, 8)
    with pytest.raises(ValueError):  # CPU tensors; the size itself is no error here
        tkern.biased_attention_tiled_cuda(q, q, q, torch.zeros(8, 2058, 2058))


def test_kernel_layout_fits_the_flagship_shapes():
    for n, d in ((1183, 4), (343, 8), (63, 16)):
        assert tkern.kernel_smem_bytes(n, d) <= 227 * 1024
        # bf16: half the bytes of K, V and the bias ring
        assert tkern.kernel_smem_bytes(n, d, 2) <= tkern.kernel_smem_bytes(n, d) // 2 + 64
    with pytest.raises(ValueError):  # K/V of one head no longer fit
        q = torch.zeros(1, 8, 1183, 32)
        tkern.biased_attention_cuda(q, q, q, torch.zeros(8, 1183, 1183))


def test_attention_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 10, 4)
    with pytest.raises(ValueError):
        tkern.biased_attention_cuda(q, q, q, torch.zeros(8, 10, 10))  # CPU tensors
    with pytest.raises(ValueError):
        tkern.biased_attention_cuda(q, q, q, torch.zeros(8, 10, 9))  # bias shape
    kb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        tkern.biased_attention_bf16_cuda(kb, kb, kb, torch.zeros(8, 10, 10, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # float32 k/v are not the bf16 kernel's
        tkern.biased_attention_bf16_cuda(kb, q, q, torch.zeros(8, 10, 10, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # a float32 bias is not the bf16 kernel's
        tkern.biased_attention_bf16_cuda(kb, kb, kb, torch.zeros(8, 10, 10))


def _flax_module_pair(flax_mod, port_mod, inputs, seed):
    variables = flax_mod.init(jax.random.PRNGKey(seed), *inputs)
    variables = perturb(variables, seed)
    load_flax_variables(port_mod, variables)
    ref = np.asarray(flax_mod.apply(variables, *inputs))
    with torch.no_grad():
        port = port_mod(*[_t(a) for a in inputs]).numpy()
    return port, ref


def test_multihead_cross_attention_matches_flax():
    rs = np.random.RandomState(0)
    n, d_inp = 63, 16
    q = rs.randn(2, n, d_inp).astype(np.float32)
    kv = rs.randn(2, n, d_inp).astype(np.float32)
    port, ref = _flax_module_pair(
        jattn.MultiHeadCrossAttention(8, d_inp, 32, n, True),
        tattn.MultiHeadCrossAttention(8, d_inp, 32, n, True), (q, kv, kv), 1)
    np.testing.assert_allclose(port, ref, atol=5e-4)


def test_tied_transformer_encoder_matches_flax():
    rs = np.random.RandomState(1)
    n, d_inp, d_model = 63, 32, 8
    q = rs.randn(1, n, d_inp).astype(np.float32)
    kv = rs.randn(1, n, d_inp).astype(np.float32)
    port_mod = tattn.TransformerEncoder(d_inp, d_model, n, num_layers=3).eval()
    port, ref = _flax_module_pair(jattn.TransformerEncoder(d_inp, d_model, n, num_layers=3),
                                  port_mod, (q, kv, kv), 2)
    np.testing.assert_allclose(port, ref, atol=5e-4)
    # one shared layer applied three times
    assert sum(1 for _ in port_mod.modules() if isinstance(_, tattn.TransformerEncoderLayer)) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", ["zeros", "ties", "random", "gaussian"])
def test_topk_class_indices_tie_order(k, kind, dtype):
    """bfloat16: bf16 serving ranks the class priors after make_bf16_apply
    rounds them to 8 significant bits, so far more pixels tie (the gaussian
    tails of a rendered prior, random maps); the tie order must still be
    lax.top_k's."""
    rs = np.random.RandomState(2)
    hm = np.zeros((2, 12, 12, 7), np.float32)
    if kind == "ties":  # plateaus of equal maxima, as rendered priors have
        hm[:, 3:6, 4:7] = 1.0
        hm[:, 9, 1] = 1.0
    elif kind == "random":
        hm = rs.rand(2, 12, 12, 7).astype(np.float32)
    elif kind == "gaussian":  # rendered priors: peaks with sigma-2 tails
        yy, xx = np.mgrid[:12, :12]
        c = rs.rand(2, 7, 2) * 11
        hm = np.exp(-((xx - c[..., 0, None, None]) ** 2 + (yy - c[..., 1, None, None]) ** 2) / 8.0)
        hm = hm.transpose(0, 2, 3, 1).astype(np.float32)
    x = jnp.asarray(hm).astype(dtype)
    if dtype == "bfloat16" and kind in ("random", "gaussian"):
        assert len(np.unique(np.asarray(x, np.float32))) < len(np.unique(hm))
    ref = np.asarray(jattn.topk_class_indices(x, k))
    port = tattn.topk_class_indices(_t(np.asarray(x, np.float32)).to(getattr(torch, dtype)), k)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("scale,kernel", [(4.0, 12), (1.0, 3), (0.5, 1), (0.125, 1)])
def test_window_feat_ids_match(scale, kernel):
    rs = np.random.RandomState(3)
    xy = np.floor(rs.rand(1, 7, 2) * 120).astype(np.float32)
    xy[0, 0] = [0.0, 0.0]
    xy[0, 1] = [119.0, 119.0]
    H = W = int(120 * scale)
    ref = np.asarray(jattn.window_feat_ids(jnp.asarray(xy), scale, kernel, H, W))
    np.testing.assert_array_equal(tattn.window_feat_ids(_t(xy), scale, kernel, H, W).numpy(), ref)


def test_gather_and_scatter_with_duplicate_ids_match():
    """Clamped windows and cold-start (all-origin) windows repeat ids: XLA on
    the CPU keeps the last write, and so must the port."""
    rs = np.random.RandomState(4)
    feats = rs.randn(2, 8, 8, 5).astype(np.float32)
    xy = np.zeros((2, 7, 2), np.float32)  # frame 0: every class at the origin
    xy[1] = np.floor(rs.rand(7, 2) * 8)
    ids = np.asarray(jattn.window_feat_ids(jnp.asarray(xy), 1.0, 3, 8, 8))
    assert len(np.unique(ids[0])) < ids.shape[1]  # duplicates present
    vals = rs.randn(2, ids.shape[1], 5).astype(np.float32)
    np.testing.assert_array_equal(
        tattn.gather_window_features(_t(feats), _t(ids).long()).numpy(),
        np.asarray(jattn.gather_window_features(jnp.asarray(feats), jnp.asarray(ids))))
    ref = np.asarray(jattn.scatter_window_features(jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(vals)))
    port = tattn.scatter_window_features(_t(feats), _t(ids).long(), _t(vals)).numpy()
    np.testing.assert_array_equal(port, ref)
