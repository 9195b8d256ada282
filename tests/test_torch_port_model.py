"""Port parity: the tiny SGTAPose (full channel widths, 64x64 input) against
flax for both decoder node types, through `utils/weights.load_flax_variables`.

Bars: heads <= 1e-3 abs on the logits in float32 (34 conv layers summed in
another order; measured ~5e-7) and trunk features <= 1e-4. The loader is
strict: a leaf removed from (or added to) the flax tree raises.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models.sgta import SGTAPose as JaxSGTAPose
from sgtapose_tpu_torch.models.sgta import SGTAPose, create_model
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, model_inputs, port_cfg

HEAD_ATOL = 1e-3
TRUNK_ATOL = 1e-4


def _port_model(dla_node):
    _, variables = flax_model_and_variables(dla_node)
    model = SGTAPose(port_cfg(dla_node)).eval()
    load_flax_variables(model, variables)
    return model


@pytest.mark.parametrize("dla_node", ["dcn", "conv"])
def test_loader_sets_every_tensor_and_is_strict(dla_node):
    _, variables = flax_model_and_variables(dla_node)
    model = SGTAPose(port_cfg(dla_node)).eval()
    load_flax_variables(model, variables)  # raises on any unused leaf / unset tensor
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_tensors = sum(1 for k in model.state_dict() if not k.endswith("num_batches_tracked"))
    assert n_leaves == n_tensors
    short = copy.deepcopy(variables)
    del short["params"]["transformer_1"]["layer"]["cross_attn"]["pos_embed"]
    with pytest.raises(KeyError, match="not set"):
        load_flax_variables(SGTAPose(port_cfg(dla_node)), short)
    extra = copy.deepcopy(variables)
    extra["params"]["hm"]["Conv_2"] = {"kernel": np.zeros((1, 1, 256, 7), np.float32)}
    with pytest.raises(KeyError, match="no port tensor"):
        load_flax_variables(SGTAPose(port_cfg(dla_node)), extra)


@pytest.mark.parametrize("dla_node,zero_priors", [("dcn", False), ("dcn", True), ("conv", False)])
def test_forward_matches_flax(dla_node, zero_priors):
    """zero_priors: the cold-start frame, where every window collapses to
    the origin (ties in top-k, duplicate scatter ids)."""
    flax_model, variables = flax_model_and_variables(dla_node)
    inputs = model_inputs(seed=2, zero_priors=zero_priors)
    ref = jax.jit(flax_model.apply)(variables, *[jnp.asarray(a) for a in inputs])
    with torch.no_grad():
        out = _port_model(dla_node)(*[torch.from_numpy(a) for a in inputs])
    for key in ("hm", "reg", "tracking"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=HEAD_ATOL, err_msg=key)


def test_trunk_matches_flax():
    flax_model, variables = flax_model_and_variables("dcn")
    cur, pre, pre_hm, repro_hm = model_inputs(seed=3)[:4]
    imgs = np.concatenate([pre, cur])
    hms = np.concatenate([pre_hm, repro_hm])
    ref = jax.jit(lambda v, a, b: flax_model.apply(v, a, b, method=JaxSGTAPose.trunk))(
        variables, jnp.asarray(imgs), jnp.asarray(hms))
    with torch.no_grad():
        feats = _port_model("dcn").trunk(torch.from_numpy(imgs), torch.from_numpy(hms))
    assert len(feats) == len(ref) == 6
    for f, r in zip(feats, ref):
        np.testing.assert_allclose(f.numpy(), np.asarray(r), atol=TRUNK_ATOL)


def test_create_model_flagship_only_and_device_explicit():
    cfg = port_cfg("dcn")
    model = create_model(cfg, device="cpu", seed=0)
    assert not model.training and next(model.parameters()).device.type == "cpu"
    assert torch.all(model.hm.Conv_1.bias == cfg.prior_bias)
    with pytest.raises(ValueError):
        create_model(cfg.__class__(arch="dlapawglobal_34"), device="cpu")  # no such arch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            create_model(cfg)  # the default device is the card; no CPU fallback
