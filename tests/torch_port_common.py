"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py):
the tiny model config of both packages, seeded numpy perturbation of flax
variable trees (so zero-initialised parameters and BN statistics matter),
a cache of flax SGTAPose variables per decoder node type, and the pieces of
the train-step tests (a random batch, their variables, a seeded Adam state,
flax dropout turned off)."""

from __future__ import annotations

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np

from sgtapose_tpu.config import ModelConfig as JaxModelConfig
from sgtapose_tpu.models.sgta import SGTAPose as JaxSGTAPose
from sgtapose_tpu_torch.config import ModelConfig as PortModelConfig

# the existing tiny test config (tests/test_model.py): 64x64 input, 16x16
# heatmaps, 3x3 windows at levels 0-2; channel widths stay at full size
TINY = dict(input_res=(64, 64), kernel_list=(3, 3, 3, 1, 1, 1))


def jax_cfg(dla_node: str = "dcn", num_classes: int = 7) -> JaxModelConfig:
    return JaxModelConfig(dla_node=dla_node, num_classes=num_classes, **TINY)


def port_cfg(dla_node: str = "dcn", num_classes: int = 7) -> PortModelConfig:
    return PortModelConfig(dla_node=dla_node, num_classes=num_classes, **TINY)


def perturb(variables, seed: int = 0):
    """Seeded noise on a flax variable tree: BN statistics, scales and biases,
    the zero-initialised DCN offset/mask convs (offsets of order 1 px, some
    samples out of bounds), pos_embed and the symmetric bilinear up-convs.
    Returns a tree of float32 numpy arrays."""
    rs = np.random.RandomState(seed)

    def noise(shape, s):
        return (s * rs.randn(*shape)).astype(np.float32)

    def one(path, x):
        x = np.asarray(x, np.float32)
        names = [getattr(p, "key", str(p)) for p in path]
        name = names[-1]
        if names[0] == "batch_stats":
            if name == "var":
                return x * np.exp(noise(x.shape, 0.3))
            return x + noise(x.shape, 0.1)
        if "conv_offset_mask" in names:
            return x + noise(x.shape, 1.0 / np.sqrt(x[..., 0].size) if name == "kernel" else 1.0)
        if name == "pos_embed" or names[-2].startswith("up_"):
            return x + noise(x.shape, 0.1)
        if name == "scale":
            return x * (1.0 + noise(x.shape, 0.1))
        if name == "bias":
            return x + noise(x.shape, 0.05)
        return x

    return jax.tree_util.tree_map_with_path(one, variables)


def model_inputs(seed: int = 0, zero_priors: bool = False, num_classes: int = 7):
    """Six NHWC numpy inputs of the tiny SGTAPose (batch 1)."""
    rs = np.random.RandomState(seed)
    H, W = TINY["input_res"]
    Ho, Wo = H // 4, W // 4
    f = np.float32
    cls = (np.zeros if zero_priors else lambda s: rs.rand(*s))
    return [
        rs.randn(1, H, W, 3).astype(f),
        rs.randn(1, H, W, 3).astype(f),
        rs.rand(1, H, W, 1).astype(f),
        rs.rand(1, H, W, 1).astype(f),
        np.asarray(cls((1, Ho, Wo, num_classes)), f),
        np.asarray(cls((1, Ho, Wo, num_classes)), f),
    ]


@functools.lru_cache(maxsize=None)
def flax_model_and_variables(dla_node: str = "dcn", num_classes: int = 7):
    """(flax module, numpy variables) of the tiny SGTAPose: the tree's
    structure from `jax.eval_shape` of flax's init (no compile), its values
    seeded numpy draws (kernels ~ N(0, 1/fan_in), so the up-conv kernels are
    asymmetric), then `perturb`ed."""
    model = JaxSGTAPose(jax_cfg(dla_node, num_classes))
    inputs = [jnp.asarray(a) for a in model_inputs(num_classes=num_classes)]
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *inputs))
    rs = np.random.RandomState(0)

    def one(path, s):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return model, perturb(jax.tree_util.tree_map_with_path(one, shapes), seed=1)


def random_train_batch(seed: int = 0, res: int = 64, B: int = 2):
    """A training batch of random numpy tensors for the tiny model."""
    rs = np.random.RandomState(seed)
    Ho = res // 4
    f = np.float32
    return {
        "cur_img": rs.randn(B, res, res, 3).astype(f), "pre_img": rs.randn(B, res, res, 3).astype(f),
        "pre_hm": rs.rand(B, res, res, 1).astype(f), "repro_hm": rs.rand(B, res, res, 1).astype(f),
        "pre_hm_cls": rs.rand(B, Ho, Ho, 7).astype(f), "repro_hm_cls": rs.rand(B, Ho, Ho, 7).astype(f),
        "gt_belief_maps": rs.rand(B, Ho, Ho, 7).astype(f),
        "kp_int": rs.randint(0, Ho, (B, 7, 2)).astype(np.int32),
        "reg_target": rs.rand(B, 7, 2).astype(f), "tracking_target": rs.randn(B, 7, 2).astype(f),
    }


def train_variables():
    """The tiny model's perturbed variables with the DCN offset/mask convs
    scaled by 0.3 (offsets of a fraction of a pixel). In train mode
    BatchNorm normalises by the batch statistics of 2x2-16x16 maps, which
    amplifies float32 rounding layer by layer through the decoder, the more
    the larger the offsets (tests/test_torch_port_train_f64.py holds the same
    step in float64)."""
    flax_model, variables = flax_model_and_variables("dcn")

    def one(path, x):
        names = [getattr(p, "key", str(p)) for p in path]
        return (0.3 * x).astype(np.float32) if "conv_offset_mask" in names else x

    return flax_model, jax.tree_util.tree_map_with_path(one, variables)


def adam_state(params, seed: int = 9):
    """Seeded Adam moments (mu, nu) of the size a few steps leave."""
    rs = np.random.RandomState(seed)
    mu = jax.tree_util.tree_map(lambda p: (1e-3 * rs.randn(*p.shape)).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda p: (1e-6 * (1 + rs.rand(*p.shape))).astype(np.float32), params)
    return mu, nu


def no_dropout(next_fun, args, kwargs, context):
    """flax.linen.intercept_methods interceptor: nn.Dropout as the identity."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)
