"""Port parity of one whole bf16 mixed-precision train step on the CPU
(`trainer.train_step(bf16=True)`) against the JAX package's
(`sgtapose_tpu/train/trainer.py:train_step(bf16=True)`: parameters and the
phase's model inputs cast to bf16 for the forward, the heads cast to
float32 for the loss, float32 masters, loss and gradients, batch statistics
never cast), from the same variables, Adam state and batch: the tiny model
at batch 2, dropout off.

Both frameworks round to bf16 at their own points, so every bar is a
multiple of the gap between JAX bf16 and JAX float32 on the same step,
measured here, and each test shows that a wrong answer fails its bar.

BatchNorm in train mode (the step as training runs it): the forward is not
chaotic, so the loss terms <= 2x the gap (measured 0.30-1.19x) and each
BatchNorm running statistic <= 3x its own gap (measured <= 2.1x; relative
to max(1, max|ref|)), where statistics left as they were before the step
read >= 4.3x in every one; after the step the masters, the statistics and
the Adam moments are float32. Its backward is: batch statistics of 2x2 to
16x16 maps divide rounding by small spreads, and JAX's own bf16 gradient is
1.3x the gradients' norm away from its float32 one, a gap no comparison can
be held to. So the gradients are compared on the same step with BatchNorm
in eval mode (running statistics; as chip_smoke.py does on the card), where
JAX's gap is 0.024 of the norm: the master gradients in L2 <= 0.8x the gap
(measured 0.70x), which zero gradients (42x) and the port's own float32 step
(1.0x: it lacks bf16's roundings) both fail; the loss terms <= 1.5x the gap
(measured 0.40-1.07x).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sgtapose_tpu.train import loss as jloss, trainer as jtrainer
from sgtapose_tpu.train.phases import loss_weights as jax_loss_weights
from sgtapose_tpu.utils.precision import cast_floating
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.models import dla as tdla
from sgtapose_tpu_torch.models.attention import set_dropout_rate
from sgtapose_tpu_torch.train import schedule as tsched, trainer as ttrainer
from sgtapose_tpu_torch.utils import weights as tweights

from torch_port_common import adam_state, no_dropout, port_cfg, random_train_batch, train_variables

LR, MAX_ITERS, WARMUP = 1e-3, 20, 4
ADAM_COUNT, SCHED_COUNT = 5, 7
TERMS = ("tot", "hm", "reg", "tracking")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX step's pieces, in bf16 and in float32 (the gap), dropout
    intercepted to the identity: {"train": {bf16: (loss terms, batch
    statistics)}} from the train-mode forward, {"eval": {bf16: (loss terms,
    gradients)}} from train_step's loss and gradients with BatchNorm in eval
    mode."""
    import flax.linen as fnn
    import optax

    from sgtapose_tpu.train import schedule as jsched

    flax_model, variables = train_variables()
    tx = optax.adam(jsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
    mu, nu = adam_state(variables["params"])
    adam, sched = tx.init(variables["params"])
    opt_state = (adam._replace(count=jnp.int32(ADAM_COUNT), mu=mu, nu=nu),
                 sched._replace(count=jnp.int32(SCHED_COUNT)))
    state = jtrainer.TrainState(step=jnp.int32(SCHED_COUNT), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=opt_state,
                                apply_fn=flax_model.apply, tx=tx)
    batch = {k: jnp.asarray(v) for k, v in random_train_batch(5).items()}
    names = ("cur_img", "pre_img", "pre_hm", "repro_hm", "pre_hm_cls", "repro_hm_cls")

    def loss_fn(params, batch, bf16, train):
        fwd_params, fwd_batch = params, dict(batch)
        if bf16:  # as sgtapose_tpu/train/trainer.py:166-180
            fwd_params = cast_floating(params, jnp.bfloat16)
            for k in names:
                fwd_batch[k] = batch[k].astype(jnp.bfloat16)
        out, new_stats = jtrainer.model_forward(state, fwd_params, fwd_batch, train=train,
                                                rngs={"dropout": jax.random.PRNGKey(0)})
        out = {k: v.astype(jnp.float32) for k, v in out.items()}
        total, stats = jloss.sgta_loss(out, batch, **jax_loss_weights("PlanA_win"))
        return total, (stats, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), new_stats))

    def train_forward(params, batch, bf16):
        _, (stats, new_stats) = loss_fn(params, batch, bf16, True)
        return stats, new_stats

    def eval_grads(params, batch, bf16):
        (_, (stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, bf16, False)
        return stats, grads

    out = {"train": {}, "eval": {}}
    with fnn.intercept_methods(no_dropout):
        for mode, fn in (("train", train_forward), ("eval", eval_grads)):
            for bf16 in (True, False):
                res = jax.jit(fn, static_argnums=2)(state.params, batch, bf16)
                out[mode][bf16] = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), res)
    flax_state = {"params": variables["params"], "batch_stats": variables["batch_stats"], "mu": mu,
                  "nu": nu, "adam_count": ADAM_COUNT, "schedule_count": SCHED_COUNT, "step": SCHED_COUNT}
    return flax_state, out


def _port_step(flax_state, bf16: bool, bn_eval: bool = False):
    """The port's train_step from the same variables, Adam state and batch;
    bn_eval holds every BatchNorm in eval mode through the step's
    `model.train()`."""
    cfg = PortConfig(model=port_cfg("dcn"))
    state = ttrainer.create_train_state(cfg, seed=0, max_iters=MAX_ITERS, device="cpu",
                                        schedule=tsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
    tweights.load_flax_train_state(state, flax_state)
    set_dropout_rate(state.model, 0.0)
    with pytest.MonkeyPatch.context() if bn_eval else contextlib.nullcontext() as mp:
        if bn_eval:
            mp.setattr(tdla.BatchNorm, "train", lambda self, mode=True: nn.Module.train(self, False))
        stats = ttrainer.train_step(state, {k: _t(v) for k, v in random_train_batch(5).items()}, bf16=bf16)
    return state, stats


@pytest.fixture(scope="module")
def port_step(jax_runs):
    """The port's bf16 step as training runs it (BatchNorm in train mode)."""
    return _port_step(jax_runs[0], bf16=True)


@pytest.fixture(scope="module")
def port_eval_steps(jax_runs):
    """The port's step with BatchNorm in eval mode, in bf16 and (the
    control) in float32: {bf16: (state, loss terms)}."""
    return {bf16: _port_step(jax_runs[0], bf16=bf16, bn_eval=True) for bf16 in (True, False)}


def _rel_terms(got, ref):
    return {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) for k in TERMS}


def test_bf16_step_loss_terms(jax_runs, port_step):
    runs = jax_runs[1]["train"]
    state, port_stats = port_step
    assert state.step == SCHED_COUNT + 1 and state.schedule_count == SCHED_COUNT + 1
    assert all(port_stats[k].dtype == torch.float32 for k in TERMS)
    gap = _rel_terms(runs[True][0], runs[False][0])
    err = _rel_terms({k: port_stats[k].item() for k in TERMS}, runs[True][0])
    assert all(err[k] <= 2.0 * gap[k] for k in TERMS), (err, gap)


def test_bf16_step_batch_statistics(jax_runs, port_step):
    runs = jax_runs[1]["train"]
    model = port_step[0].model
    buffers = model.state_dict()
    keys = [k for k in buffers if k.endswith(("running_mean", "running_var"))]
    like = {k: buffers[k] for k in keys}
    ref, ref32, before = (tweights._convert(model, {"batch_stats": s}, like)
                          for s in (runs[True][1], runs[False][1], jax_runs[0]["batch_stats"]))

    def rel(a, b, k):
        return np.abs(a[k] - b[k]).max() / max(1.0, np.abs(b[k]).max())

    port = {k: buffers[k].numpy() for k in keys}
    for k in keys:
        gap = rel(ref, ref32, k)
        assert rel(port, ref, k) <= 3.0 * gap, (k, rel(port, ref, k), gap)
        assert rel(before, ref, k) > 3.0 * gap, k  # the control: statistics the step did not update


def test_bf16_step_master_gradients(jax_runs, port_eval_steps):
    """The master gradients in L2 with BatchNorm in eval mode; the zero
    gradients and the float32 step fail the bar."""
    runs = jax_runs[1]["eval"]
    model = port_eval_steps[True][0].model
    named = dict(model.named_parameters())
    ref, ref32 = (tweights._convert(model, {"params": runs[b][1]}, named) for b in (True, False))
    port = {b: {k: p.grad.numpy() for k, p in port_eval_steps[b][0].model.named_parameters()} for b in (True, False)}
    assert all(named[k].grad.dtype == torch.float32 for k in ref)
    live = [k for k, g in ref32.items() if np.abs(g).max() > 1e-7]

    def l2(a, b):
        num = sum(((a[k] - b[k]).astype(np.float64) ** 2).sum() for k in live)
        return np.sqrt(num / sum((b[k].astype(np.float64) ** 2).sum() for k in live))

    gap = l2(ref, ref32)
    assert 1e-3 < gap < 0.1
    assert l2(port[True], ref) <= 0.8 * gap, (l2(port[True], ref), gap)
    assert l2({k: 0 * g for k, g in ref.items()}, ref) > 0.8 * gap
    assert l2(port[False], ref) > 0.8 * gap, (l2(port[False], ref), gap)
    # no leaf lost: every gradient that reaches JAX's masters reaches the port's
    assert all(np.abs(port[True][k]).max() > 0 for k in live)
    # levels 0 and 1 feed no head: zero gradients, as optax gives them
    dead = [k for k in port[True] if k.startswith(("transformer_0.", "transformer_1."))]
    assert dead and all(np.abs(port[True][k]).max() == 0 for k in dead)


def test_bf16_step_loss_terms_batchnorm_eval(jax_runs, port_eval_steps):
    runs = jax_runs[1]["eval"]
    port_stats = port_eval_steps[True][1]
    gap = _rel_terms(runs[True][0], runs[False][0])
    err = _rel_terms({k: port_stats[k].item() for k in TERMS}, runs[True][0])
    assert all(err[k] <= 1.5 * gap[k] for k in TERMS), (err, gap)


def test_bf16_step_keeps_float32_state(port_step):
    """Masters, BatchNorm statistics and Adam moments are float32 after the
    step, as the JAX step keeps them (its batch statistics cast back)."""
    state = port_step[0]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(t.dtype == torch.float32 for k, t in state.model.state_dict().items()
               if k.endswith(("running_mean", "running_var")))
    moments = [v for p in state.model.parameters() for k, v in state.optimizer.state[p].items() if k != "step"]
    assert len(moments) == 2 * len(list(state.model.parameters()))
    assert all(v.dtype == torch.float32 for v in moments)
