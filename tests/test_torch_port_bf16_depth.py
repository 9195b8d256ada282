"""Port parity of `--bf16 --depth` on the CPU: one bf16 mixed-precision
train step of a 42-keypoint model, the step `cli/train.py --bf16 --depth`
runs (`trainer.train_step(bf16=True)` on a 42-class model), against the JAX
package's own step (`sgtapose_tpu/cli/train.py --bf16 --depth` runs
`make_parallel_train_step(mesh, bf16=True)`, which casts the parameters and
the model inputs to bf16 for the forward and the heads to float32 for the
loss), from the same variables and batch: the tiny model (64x64, full widths, the
CLI tests' `--kernel_list 3,3,3,1,1,1`) at batch 2, dropout off. Its levels
0-2 attend over 42 x 3^2 = 378 tokens: level 2, (378, 16), is the (n, d)
whose backward takes the bf16 row-split kernel on the card (its plain
version, the autograd of the bf16 default form, runs here).

Both frameworks round to bf16 at their own points, so each bar is a
multiple of the gap between JAX bf16 and JAX float32 on the same step,
measured here. As tests/test_torch_port_train_bf16_step.py explains, bf16's
backward through train-mode BatchNorm on 2x2-16x16 maps is chaotic, so the
step runs with BatchNorm held in eval mode (JAX: its step with a model
applied in eval mode, which also drops dropout; the port: dropout at rate
0): the master gradients in L2 <=
0.8x the gap (the 7-keypoint step's bar), which zero gradients and the
port's own float32 step both fail; the loss terms <= 1.5x the gap. The
attention parameters of levels 0 and 1, which feed no head, get zero
gradients, as optax gives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from sgtapose_tpu.train import trainer as jtrainer
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.models import dla as tdla
from sgtapose_tpu_torch.models.attention import set_dropout_rate
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.utils import weights as tweights

from torch_port_common import flax_model_and_variables, port_cfg, random_train_batch

N_KP = 42
TERMS = ("tot", "hm", "reg", "tracking")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    return random_train_batch(7, num_classes=N_KP)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's own `--bf16 --depth` step, `make_parallel_train_step(mesh,
    bf16=True)` on a one-device mesh, and its float32 step (the gap), the
    model in eval mode (the state's apply_fn calls the model with
    train=False: BatchNorm's running statistics, no dropout) and an optimizer
    that keeps the gradients as its state and updates nothing:
    ({bf16: (loss terms, gradients)}, variables)."""
    import optax

    from sgtapose_tpu.parallel import mesh as jmesh

    flax_model, variables = flax_model_and_variables("dcn", N_KP)

    def eval_apply(variables, *inputs, mutable=None, rngs=None, train=False):
        out = flax_model.apply(variables, *inputs, train=False)
        return (out, {"batch_stats": variables["batch_stats"]}) if mutable else out

    zeros = lambda tree: jax.tree_util.tree_map(jnp.zeros_like, tree)  # noqa: E731
    keep_grads = optax.GradientTransformation(zeros, lambda grads, state, params=None: (zeros(grads), grads))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {}
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731
    for bf16 in (True, False):  # a fresh state each time: the step donates it
        state = jtrainer.TrainState(step=jnp.int32(0), params=copy(variables["params"]),
                                    batch_stats=copy(variables["batch_stats"]),
                                    opt_state=zeros(variables["params"]), apply_fn=eval_apply, tx=keep_grads)
        new_state, stats = jtrainer.make_parallel_train_step(jmesh.make_mesh(1), bf16=bf16)(
            state, batch, jax.random.PRNGKey(0))
        out[bf16] = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), (stats, new_state.opt_state))
    return out, variables


def _port_step(variables, bf16: bool):
    """The port's train_step on the 42-class model from the same variables
    and batch, every BatchNorm held in eval mode: (model, loss terms)."""
    cfg = PortConfig(model=port_cfg("dcn", N_KP))
    state = ttrainer.create_train_state(cfg, seed=0, device="cpu")
    tweights.load_flax_variables(state.model, variables)
    set_dropout_rate(state.model, 0.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdla.BatchNorm, "train", lambda self, mode=True: nn.Module.train(self, False))
        stats = ttrainer.train_step(state, {k: torch.from_numpy(v) for k, v in _batch().items()}, bf16=bf16)
    return state.model, {k: v.item() for k, v in stats.items()}


@pytest.fixture(scope="module")
def port_steps(jax_runs):
    return {bf16: _port_step(jax_runs[1], bf16) for bf16 in (True, False)}


def test_bf16_depth_step_master_gradients(jax_runs, port_steps):
    """The master gradients in L2; the zero gradients and the float32 step
    fail the bar."""
    runs = jax_runs[0]
    model = port_steps[True][0]
    named = dict(model.named_parameters())
    ref, ref32 = (tweights._convert(model, {"params": runs[b][1]}, named) for b in (True, False))
    port = {b: {k: p.grad.numpy() for k, p in port_steps[b][0].named_parameters()} for b in (True, False)}
    assert model.cfg.num_classes == N_KP and all(named[k].grad.dtype == torch.float32 for k in ref)
    live = [k for k, g in ref32.items() if np.abs(g).max() > 1e-7]

    def l2(a, b):
        num = sum(((a[k] - b[k]).astype(np.float64) ** 2).sum() for k in live)
        return np.sqrt(num / sum((b[k].astype(np.float64) ** 2).sum() for k in live))

    gap = l2(ref, ref32)
    assert 1e-3 < gap < 0.1
    assert l2(port[True], ref) <= 0.8 * gap, (l2(port[True], ref), gap)
    assert l2({k: 0 * g for k, g in ref.items()}, ref) > 0.8 * gap
    assert l2(port[False], ref) > 0.8 * gap, (l2(port[False], ref), gap)
    assert all(np.abs(port[True][k]).max() > 0 for k in live)
    dead = [k for k in port[True] if k.startswith(("transformer_0.", "transformer_1."))]
    assert dead and all(np.abs(port[True][k]).max() == 0 for k in dead)


def test_bf16_depth_step_loss_terms(jax_runs, port_steps):
    runs = jax_runs[0]
    rel = lambda got, ref: {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) for k in TERMS}  # noqa: E731
    gap = rel(runs[True][0], runs[False][0])
    err = rel(port_steps[True][1], runs[True][0])
    assert all(err[k] <= 1.5 * gap[k] for k in TERMS), (err, gap)
