"""The tiny model's whole train step in float64, port against JAX, from the
same variables and Adam state as `test_torch_port_train.py`'s float32 step:
the loss terms, every parameter gradient, the updated BatchNorm statistics
and the parameters after the Adam update.

In float32 train-mode BatchNorm amplifies rounding through the decoder, so
the float32 comparison can only hold loose bars; in float64 the two packages
must agree closely, which shows the step is the same function. Both cast the
heads to float32 before the loss (the JAX train step does, `.astype(float32)`),
so the loss and its first cotangent carry float32 rounding. Measured: the
loss terms within 2.1e-10 relative, every gradient within 1.2e-7 of its
tensor's largest, the parameters after the update within 3e-11. Bars: 1e-6
relative for the loss terms, 1e-6 for each gradient tensor (those above
1e-9: the DCN biases before a BatchNorm have no gradient in exact
arithmetic), 1e-10 relative for the BN statistics, 1e-9 for the parameters.

The port's DCN and attention autograd Functions (and kernels) run float32
only; here both are routed through torch autograd of their plain versions,
which `test_torch_port_train_ops.py` holds against the Functions.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgtapose_tpu.train import loss as jloss, schedule as jsched, trainer as jtrainer
from sgtapose_tpu.train.phases import loss_weights as jax_loss_weights
from sgtapose_tpu_torch.models import attention as tattn, deform_conv as tdcn
from sgtapose_tpu_torch.models.attention import set_dropout_generator, set_dropout_rate
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.ops import attention_kernel as tak
from sgtapose_tpu_torch.train import schedule as tsched, trainer as ttrainer
from sgtapose_tpu_torch.utils import weights as tweights

from torch_port_common import adam_state, no_dropout, port_cfg, random_train_batch, train_variables

LR, MAX_ITERS, WARMUP = 1e-3, 20, 4
ADAM_COUNT, SCHED_COUNT = 5, 7


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _jax_step(flax_model, variables, mu, nu, batch):
    with jax.enable_x64(True):
        tx = optax.adam(jsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
        adam, sched = tx.init(variables["params"])
        opt_state = (adam._replace(count=jnp.int32(ADAM_COUNT), mu=mu, nu=nu),
                     sched._replace(count=jnp.int32(SCHED_COUNT)))
        state = jtrainer.TrainState(step=jnp.int32(SCHED_COUNT), params=variables["params"],
                                    batch_stats=variables["batch_stats"], opt_state=opt_state,
                                    apply_fn=flax_model.apply, tx=tx)

        def step(state, batch):
            def loss_fn(params):
                out, new_stats = jtrainer.model_forward(state, params, batch, train=True,
                                                        rngs={"dropout": jax.random.PRNGKey(0)})
                out = {k: v.astype(jnp.float32) for k, v in out.items()}
                total, stats = jloss.sgta_loss(out, batch, **jax_loss_weights("PlanA_win"))
                return total, (stats, new_stats)

            (_, (stats, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
            return stats, grads, state.apply_gradients(grads, new_stats)

        with fnn.intercept_methods(no_dropout):
            out = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
        stats, grads, new_state = out
        return jax.tree_util.tree_map(np.asarray, (stats, grads, new_state.params, new_state.batch_stats))


def test_train_step_matches_jax_in_float64(monkeypatch):
    monkeypatch.setattr(tdcn, "deform_conv", tdcn.plain_deform_conv)
    monkeypatch.setattr(tattn, "fused_biased_attention", tak.plain_biased_attention)
    flax_model, variables = train_variables()
    variables = _f64(variables)
    mu, nu = _f64(adam_state(variables["params"]))
    batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in random_train_batch(5).items()}
    stats, grads, params, batch_stats = _jax_step(flax_model, variables, mu, nu, batch)

    model = SGTAPose(port_cfg("dcn")).double()
    generator = torch.Generator()
    set_dropout_generator(model, generator)
    set_dropout_rate(model, 0.0)
    state = ttrainer.TrainState(
        model=model, optimizer=torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8),
        schedule=tsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP), dropout_generator=generator, seed=0)
    tweights.load_flax_train_state(state, {
        "params": variables["params"], "batch_stats": variables["batch_stats"], "mu": mu, "nu": nu,
        "adam_count": ADAM_COUNT, "schedule_count": SCHED_COUNT, "step": SCHED_COUNT})
    assert next(model.parameters()).dtype == torch.float64
    port_stats = ttrainer.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})

    for k in ("tot", "hm", "reg", "tracking"):
        r = float(stats[k])
        assert abs(port_stats[k].item() - r) <= 1e-6 * abs(r), k
    named = dict(model.named_parameters())
    ref_grads = tweights._convert(model, {"params": grads}, named)
    live = [k for k, g in ref_grads.items() if np.abs(g).max() > 1e-9]
    assert len(live) > 200
    worst = max((np.abs(named[k].grad.numpy() - ref_grads[k]).max() / np.abs(ref_grads[k]).max(), k)
                for k in live)
    assert worst[0] <= 1e-6, worst
    buffers = model.state_dict()
    ref_stats = tweights._convert(model, {"batch_stats": batch_stats}, {
        k: v for k, v in buffers.items() if k.endswith(("running_mean", "running_var"))})
    for k, r in ref_stats.items():
        np.testing.assert_allclose(buffers[k].numpy(), r, rtol=1e-10, atol=1e-12, err_msg=k)
    for k, r in tweights._convert(model, {"params": params}, named).items():
        np.testing.assert_allclose(named[k].detach().numpy(), r, rtol=0, atol=1e-9, err_msg=k)
