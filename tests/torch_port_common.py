"""Shared pieces of the port's parity tests (tests/test_torch_port_*.py):
the tiny model config of both packages, seeded numpy perturbation of flax
variable trees (so zero-initialised parameters and BN statistics matter),
a cache of flax SGTAPose variables per decoder node type, and the pieces of
the train-step tests (a random batch, their variables, a seeded Adam state,
flax dropout turned off)."""

from __future__ import annotations

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax

import torch

from sgtapose_tpu.config import ModelConfig as JaxModelConfig
from sgtapose_tpu.data import pipeline as jpipe
from sgtapose_tpu.models.sgta import SGTAPose as JaxSGTAPose, create_model as jax_create_model
from sgtapose_tpu.train import loss as jloss, schedule as jsched, trainer as jtrainer
from sgtapose_tpu.train.phases import input_names as jax_input_names, loss_weights as jax_loss_weights
from sgtapose_tpu_torch.config import ModelConfig as PortModelConfig
from sgtapose_tpu_torch.data import pipeline as tpipe
from sgtapose_tpu_torch.train.phases import model_wiring

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


def random_train_batch(seed: int = 0, res: int = 64, B: int = 2, num_classes: int = 7):
    """A training batch of random numpy tensors for the tiny model."""
    rs = np.random.RandomState(seed)
    Ho = res // 4
    f = np.float32
    K = num_classes
    return {
        "cur_img": rs.randn(B, res, res, 3).astype(f), "pre_img": rs.randn(B, res, res, 3).astype(f),
        "pre_hm": rs.rand(B, res, res, 1).astype(f), "repro_hm": rs.rand(B, res, res, 1).astype(f),
        "pre_hm_cls": rs.rand(B, Ho, Ho, K).astype(f), "repro_hm_cls": rs.rand(B, Ho, Ho, K).astype(f),
        "gt_belief_maps": rs.rand(B, Ho, Ho, K).astype(f),
        "kp_int": rs.randint(0, Ho, (B, K, 2)).astype(np.int32),
        "reg_target": rs.rand(B, K, 2).astype(f), "tracking_target": rs.randn(B, K, 2).astype(f),
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


def seeded_flax_variables(model, inputs, seed: int = 0, **apply_kwargs):
    """Numpy variables of any flax module for `inputs`, made as
    `flax_model_and_variables` makes the flagship's: the tree from
    `jax.eval_shape` of init (no compile), kernels ~ N(0, 1/fan_in), scales
    and variances 1, the rest 0, then `perturb`ed."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in inputs],
                                               **apply_kwargs))
    rs = np.random.RandomState(seed)

    def one(path, s):
        name = getattr(path[-1], "key", None)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(s.shape, np.float32)
        return np.zeros(s.shape, np.float32)

    return perturb(jax.tree_util.tree_map_with_path(one, shapes), seed=seed + 1)


def phase_batch(seed: int = 0, B: int = 1, res: int = 64, num_classes: int = 7, zero_priors: bool = False):
    """Every model input of every phase (numpy, NHWC), batch B."""
    rs = np.random.RandomState(seed)
    Ho = res // 4
    f = np.float32
    prior = (lambda *s: np.zeros(s, f)) if zero_priors else (lambda *s: rs.rand(*s).astype(f))
    out = {}
    for name in ("cur_img", "pre_img", "ppre_img"):
        out[name] = rs.randn(B, res, res, 3).astype(f)
    for name in ("pre_hm", "repro_hm", "ppre_hm", "pre_origin_hm"):
        out[name] = prior(B, res, res, 1)
    for name in ("pre_hm_cls", "repro_hm_cls", "ppre_hm_cls"):
        out[name] = prior(B, Ho, Ho, num_classes)
    return out


def replay_draws(rng, n_kp, H_raw, W_raw):
    """The random numbers augment_and_render draws from `rng`, by the JAX
    package's key splits (`_derive_affine`, `noised_pnp_prior`,
    `render_noised_prior_heatmap`)."""
    k_aug_s, k_aug_c, k_prior, k_prevhm = jax.random.split(rng, 4)
    aug_s = jax.random.choice(k_aug_s, jnp.arange(0.6, 1.4, 0.1, dtype=jnp.float32))
    wb, hb = jpipe._border(128, W_raw), jpipe._border(128, H_raw)
    cx = jax.random.randint(k_aug_c, (), wb, W_raw - wb)
    cy = jax.random.randint(jax.random.fold_in(k_aug_c, 1), (), hb, H_raw - hb)
    k_jit, k_drop = jax.random.split(k_prior)
    o_jit, o_drop, o_fp, o_fpjit = jax.random.split(k_prevhm, 4)
    draws = tpipe.Draws(
        aug_s=aug_s, center=jnp.stack([cx, cy]).astype(jnp.float32),
        prior_noise=jax.random.normal(k_jit, (n_kp, 2)), prior_keep_u=jax.random.uniform(k_drop, (n_kp,)),
        origin_noise=jax.random.normal(o_jit, (n_kp, 2)), origin_keep_u=jax.random.uniform(o_drop, (n_kp,)),
        origin_fp_u=jax.random.uniform(o_fp, (n_kp,)), origin_fp_noise=jax.random.normal(o_fpjit, (n_kp, 2)))
    return tpipe.Draws(*(torch.from_numpy(np.array(a, copy=True)) for a in draws))


# ---- one float64 train step per phase (tests/test_torch_port_phases*.py) ----

LR, MAX_ITERS, WARMUP = 1e-3, 20, 4
ADAM_COUNT, SCHED_COUNT = 5, 7
# phase -> arch of its model
PHASE_ARCH = {"PlanA": "dlapa_34", "PlanA_three": "dlapawd3_34", "PlanACAT": "dlapacat_34",
              "ablation_shared_repro": "dlaabla_34", "ablation_shared": "dlaabla_34",
              "ablation_wo_shared": "dlaabla_34", "CenterTrack": "dlaseg_34", "CenterNet": "dlaseg_34",
              "Dream": "dreamhourglass"}


def _rel_err(a, b, floor=1.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(floor, np.abs(b).max())


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def phase_train_batch(seed=5):
    """A random float64 training batch with every phase's model inputs (B = 2)."""
    batch = random_train_batch(seed)
    batch.update(phase_batch(seed=seed + 1, B=2))
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def phase_cfgs(arch: str, phase: str, **kw):
    """(JAX model config, port model config, tracking) of `arch` wired for
    `phase` by the port's `phases.model_wiring`; the JAX config takes the
    ablation mode the wiring picks, as the JAX CLIs set it."""
    pcfg, tracking = model_wiring(dataclasses.replace(port_cfg(), arch=arch, **kw), phase)
    return dataclasses.replace(jax_cfg(), arch=arch, ablation_mode=pcfg.ablation_mode, **kw), pcfg, tracking


@functools.lru_cache(maxsize=None)
def _jax_phase_step(phase):
    """One float64 JAX train step (train_step's body, dropout intercepted to
    the identity) of the phase's tiny model from seeded variables and a
    seeded Adam state: (flax state, (stats, grads, new params, new
    batch_stats))."""
    jcfg, _, _ = phase_cfgs(PHASE_ARCH[phase], phase)
    module = jax_create_model(jcfg)
    batch = phase_train_batch()
    variables = seeded_flax_variables(module, [batch[k][:1].astype(np.float32) for k in jax_input_names(phase)],
                                      seed=len(phase), train=False)

    def smaller_offsets(path, x):
        names = [getattr(p, "key", str(p)) for p in path]
        return 0.3 * x if "conv_offset_mask" in names else x

    variables = _f64(jax.tree_util.tree_map_with_path(smaller_offsets, variables))
    mu, nu = _f64(adam_state(variables["params"]))
    with jax.enable_x64(True):
        return variables, mu, nu, _jax_phase_step_x64(module, variables, mu, nu, phase, batch)


def _jax_phase_step_x64(module, variables, mu, nu, phase, batch):
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = optax.adam(jsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
    adam, sched = tx.init(variables["params"])
    opt_state = (adam._replace(count=jnp.int32(ADAM_COUNT), mu=mu, nu=nu),
                 sched._replace(count=jnp.int32(SCHED_COUNT)))
    state = jtrainer.TrainState(step=jnp.int32(SCHED_COUNT), params=variables["params"],
                                batch_stats=variables.get("batch_stats", {}), opt_state=opt_state,
                                apply_fn=module.apply, tx=tx)

    def step(state, batch):
        def loss_fn(params):
            out, new_stats = jtrainer.model_forward(state, params, batch, train=True,
                                                    rngs={"dropout": jax.random.PRNGKey(0)}, phase=phase)
            out = {k: v.astype(jnp.float32) for k, v in out.items()}
            total, stats = jloss.sgta_loss(out, batch, **jax_loss_weights(phase))
            return total, (stats, new_stats)

        (_, (stats, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        return stats, grads, state.apply_gradients(grads, new_stats)

    with fnn.intercept_methods(no_dropout):
        stats, grads, new_state = jax.jit(step)(state, batch)
    return jax.tree_util.tree_map(np.asarray, (stats, grads, new_state.params, new_state.batch_stats))


def check_phase_train_step(phase, monkeypatch):
    """The float64 train step of `phase`'s tiny model, port against JAX
    (tests/test_torch_port_phases.py states the bars)."""
    from sgtapose_tpu_torch.models import attention as tattn, deform_conv as tdcn
    from sgtapose_tpu_torch.models.attention import set_dropout_rate
    from sgtapose_tpu_torch.ops import attention_kernel as tak
    from sgtapose_tpu_torch.train import schedule as tsched, trainer as ttrainer
    from sgtapose_tpu_torch.config import Config as PortConfig
    from sgtapose_tpu_torch.utils import weights as tweights

    monkeypatch.setattr(tdcn, "deform_conv", tdcn.plain_deform_conv)
    monkeypatch.setattr(tattn, "fused_biased_attention", tak.plain_biased_attention)
    variables, mu, nu, (stats, grads, params, batch_stats) = _jax_phase_step(phase)
    _, pcfg, _ = phase_cfgs(PHASE_ARCH[phase], phase)
    # the phase sets the ablation's wiring whatever the config says
    state = ttrainer.create_train_state(PortConfig(model=dataclasses.replace(pcfg, ablation_mode="shared_repro")),
                                        0, max_iters=MAX_ITERS, device="cpu", phase=phase,
                                        schedule=tsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
    assert getattr(state.model, "mode", None) == (pcfg.ablation_mode if PHASE_ARCH[phase] == "dlaabla_34" else None)
    state.model.double()
    tweights.load_flax_train_state(state, {
        "params": variables["params"], "batch_stats": variables.get("batch_stats", {}), "mu": mu, "nu": nu,
        "adam_count": ADAM_COUNT, "schedule_count": SCHED_COUNT, "step": SCHED_COUNT})
    set_dropout_rate(state.model, 0.0)
    model = state.model
    port_stats = ttrainer.train_step(state, {k: _t(v) for k, v in phase_train_batch().items()}, phase=phase)
    assert state.step == SCHED_COUNT + 1
    for k in ("tot", "hm", "reg", "tracking"):
        assert _rel_err(port_stats[k].numpy(), stats[k], floor=1e-30) <= 1e-6, k

    named = dict(model.named_parameters())
    ref_grads = tweights._convert(model, {"params": grads}, named)
    port_grads = {k: named[k].grad.numpy() for k in ref_grads}
    unused = [k for k, g in ref_grads.items() if np.abs(g).max() == 0]
    assert all(np.abs(port_grads[k]).max() == 0 for k in unused), unused
    live = [k for k, g in ref_grads.items() if np.abs(g).max() > 1e-9]
    assert len(live) > 100 or len(live) == len(ref_grads)  # the DREAM hourglass has 46 tensors, all live
    worst = max((_rel_err(port_grads[k], ref_grads[k], floor=1e-30), k) for k in live)
    assert worst[0] <= 1e-6, worst

    buffers = model.state_dict()
    ref_stats = tweights._convert(model, {"batch_stats": batch_stats}, {
        k: v for k, v in buffers.items() if k.endswith(("running_mean", "running_var"))})
    for k, r in ref_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), r, rtol=1e-10, atol=1e-12, err_msg=k)
    for k, r in tweights._convert(model, {"params": params}, named).items():
        np.testing.assert_allclose(named[k].detach().numpy(), r, rtol=0, atol=1e-9, err_msg=k)
