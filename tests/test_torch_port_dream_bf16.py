"""Port parity of the Dream phase's bf16 mixed-precision train step on the CPU
(`trainer.train_step(bf16=True, phase="Dream")`: the float32 masters cast to
bf16 for the forward through `utils/precision.bf16_forward`, the current
image cast to bf16, the heatmap cast to float32 for the loss) against the
JAX package's (`sgtapose_tpu/train/trainer.py:train_step(bf16=True)`), from
the same seeded variables and batch: DreamHourglass at 64x64 with full
channel widths, batch 2, the heatmap loss alone.

Both frameworks round to bf16 at their own points, so the bars are multiples
of the gap between JAX bf16 and JAX float32 on the same step, measured here,
as tests/test_torch_port_train_bf16_step.py holds the flagship's. The
hourglass has no BatchNorm, so its bf16 backward is not chaotic and the
gradients are compared as the step computes them: the master gradients in
L2 <= 0.9x the gap (measured 0.79x), which zero gradients (19x) and the
port's own float32 step (1.0x: it lacks bf16's roundings) both fail; the
loss terms <= 1.5x the gap (measured 0.83x). Then `cli/train --bf16 --phase
Dream` for one epoch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.models import dream_baselines as jdb
from sgtapose_tpu.train import loss as jloss
from sgtapose_tpu.train.phases import loss_weights as jax_loss_weights
from sgtapose_tpu.utils.precision import cast_floating
from sgtapose_tpu_torch.cli import train as tcli
from sgtapose_tpu_torch.config import Config as PortConfig, ModelConfig as PortModelConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.utils import weights as tweights

from torch_port_common import random_train_batch, seeded_flax_variables

TERMS = ("tot", "hm")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps():
    """{"jax": {bf16: (loss terms, gradients)}, "port": {bf16: (loss terms,
    gradients)}, "model": the port's model}: JAX's train_step loss and
    gradients as its bf16 branch computes them (and in float32, the gap),
    and the port's train_step in both precisions."""
    module = jdb.DreamHourglass(7)
    batch = random_train_batch(5)
    variables = seeded_flax_variables(module, [batch["cur_img"][:1]], seed=11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, bf16):
        img = jbatch["cur_img"]
        if bf16:  # as sgtapose_tpu/train/trainer.py:170-180
            params, img = cast_floating(params, jnp.bfloat16), img.astype(jnp.bfloat16)
        out = {k: v.astype(jnp.float32) for k, v in module.apply({"params": params}, img, train=True).items()}
        return jloss.sgta_loss(out, jbatch, **jax_loss_weights("Dream"))

    out = {"jax": {}, "port": {}}
    for bf16 in (True, False):
        (_, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), static_argnums=1)(
            variables["params"], bf16)
        out["jax"][bf16] = ({k: float(v) for k, v in stats.items()}, jax.tree_util.tree_map(np.asarray, grads))
        cfg = PortConfig(model=PortModelConfig(arch="dreamhourglass", input_res=(64, 64)))
        state = ttrainer.create_train_state(cfg, 0, device="cpu", phase="Dream")
        tweights.load_flax_variables(state.model, variables)
        stats = ttrainer.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, bf16=bf16,
                                    phase="Dream")
        assert all(s.dtype == torch.float32 for s in stats.values())
        out["port"][bf16] = ({k: s.item() for k, s in stats.items()},
                             {k: p.grad.numpy() for k, p in state.model.named_parameters()})
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in state.model.parameters())
    out["model"] = state.model
    return out


def test_bf16_dream_step_loss_terms(steps):
    jx, port = steps["jax"], steps["port"]

    def rel(a, b):
        return {k: abs(a[k] - b[k]) / abs(b[k]) for k in TERMS}

    gap = rel(jx[True][0], jx[False][0])
    err = rel(port[True][0], jx[True][0])
    assert all(0 < gap[k] and err[k] <= 1.5 * gap[k] for k in TERMS), (err, gap)
    assert port[True][0]["reg"] == port[True][0]["tracking"] == 0.0


def test_bf16_dream_step_master_gradients(steps):
    """The master gradients in L2; the zero gradients and the float32 step
    fail the bar."""
    model = steps["model"]
    named = dict(model.named_parameters())
    ref, ref32 = (tweights._convert(model, {"params": steps["jax"][b][1]}, named) for b in (True, False))
    port = {b: steps["port"][b][1] for b in (True, False)}
    live = [k for k, g in ref32.items() if np.abs(g).max() > 1e-7]
    assert len(live) == len(ref) == 46

    def l2(a, b):
        num = sum(((a[k] - b[k]).astype(np.float64) ** 2).sum() for k in live)
        return np.sqrt(num / sum((b[k].astype(np.float64) ** 2).sum() for k in live))

    gap = l2(ref, ref32)
    assert 1e-3 < gap < 0.2
    assert l2(port[True], ref) <= 0.9 * gap, (l2(port[True], ref), gap)
    assert l2({k: 0 * g for k, g in ref.items()}, ref) > 0.9 * gap
    assert l2(port[False], ref) > 0.9 * gap, (l2(port[False], ref), gap)
    assert l2(port[False], ref32) < 1e-5  # float32 against float32


def test_bf16_dream_cli(tmp_path):
    """cli/train --bf16 --phase Dream --arch dreamhourglass: one epoch."""
    data = str(tmp_path / "syn")
    tsyn.write_synthetic_dataset(data, n_videos=1, n_frames=5, seed=3, device="cpu")
    res = tcli.main(["--dataset", data, "--output_dir", str(tmp_path / "out"), "--phase", "Dream", "--arch",
                     "dreamhourglass", "--bf16", "--num_epochs", "1", "--batch_size", "2", "--log_every", "1",
                     "--image_log_every", "1", "--input_res", "64", "--device", "cpu"])
    state = res["state"]
    assert state.step == 2 and all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert os.path.exists(tmp_path / "out" / "ckpt" / "epoch_1.pt")
