"""Port parity of training on the CPU: the loss, the schedules, the
batch pipeline with the JAX key splits replayed, one whole train step of the
tiny model from the same variables and Adam state, dropout, checkpoints and
the schedule resume.

Bars: the loss terms and schedules are the same float32 formulas (1e-6
relative, schedules exact to 1 float32 ulp); the batch tensors are the same
warps, renders and solves (images and targets 1e-4, heatmaps 1e-5, the prior
PnP's reprojection 1e-2 px). The whole float32 train step is held to what
float32 allows here: in train mode BatchNorm normalises by the batch
statistics of 2x2-16x16 maps, which amplifies rounding layer by layer
(`torch_port_common.train_variables`; the same step in float64,
`test_torch_port_train_f64.py`, agrees to 1.2e-7). Measured on this step,
port against JAX in float32: gradients up to 9.3 % of a tensor's largest
(1.0 % over all gradients, in L2), the loss terms 1.5e-5, the BN statistics
1.1e-5, the parameters after the Adam update (lr 7e-4) 6e-6. Bars: 20 % per
tensor and 3 % in L2, 1e-4, 1e-4, 3e-5.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.core import geometry as jgeom, pnp as jpnp
from sgtapose_tpu.data import pipeline as jpipe, synthetic as jsyn
from sgtapose_tpu.train import loss as jloss, schedule as jsched, trainer as jtrainer
from sgtapose_tpu.train.phases import loss_weights as jax_loss_weights
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.core import geometry as tgeom, pnp as tpnp
from sgtapose_tpu_torch.data import pipeline as tpipe, synthetic as tsyn
from sgtapose_tpu_torch.models.attention import Dropout, TransformerEncoderLayer, set_dropout_rate
from sgtapose_tpu_torch.train import loss as tloss, schedule as tsched, trainer as ttrainer
from sgtapose_tpu_torch.utils import weights as tweights

from torch_port_common import (adam_state, jax_cfg, no_dropout, port_cfg, random_train_batch,
                               replay_draws, train_variables)

B = 2
LR, MAX_ITERS, WARMUP = 1e-3, 20, 4
ADAM_COUNT, SCHED_COUNT = 5, 7  # a run resumed past its warmup


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _rel_err(a, b, floor=1.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(floor, np.abs(b).max())


# ---------------------------------------------------------------- loss --------


def test_sgta_loss_matches_jax():
    rs = np.random.RandomState(1)
    batch = random_train_batch(1)
    outputs = {"hm": 3 * rs.randn(B, 16, 16, 7), "reg": rs.randn(B, 16, 16, 2),
               "tracking": 2 * rs.randn(B, 16, 16, 2)}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    weights = dict(hm_weight=1.0, reg_weight=0.5, tracking_weight=0.25)
    _, ref = jloss.sgta_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                             {k: jnp.asarray(v) for k, v in batch.items()}, **weights)
    _, port = tloss.sgta_loss({k: _t(v) for k, v in outputs.items()}, {k: _t(v) for k, v in batch.items()},
                              **weights)
    for k in ("tot", "hm", "reg", "tracking"):
        assert _rel_err(port[k].numpy(), ref[k], floor=1e-30) <= 1e-6, k


# ------------------------------------------------------------ schedules --------


def test_schedules_match_jax():
    """Steps 0, 1, warmup - 1, warmup, warmup + 1, the tail and past the end;
    exact up to one float32 ulp."""
    for warmup in (WARMUP, 0):
        ref = jsched.warmup_poly_schedule(LR, MAX_ITERS, warmup)
        port = tsched.warmup_poly_schedule(LR, MAX_ITERS, warmup)
        for step in (0, 1, WARMUP - 1, WARMUP, WARMUP + 1, MAX_ITERS - 1, MAX_ITERS, MAX_ITERS + 5):
            r = float(ref(step))
            assert abs(port(step) - r) <= np.spacing(np.float32(max(abs(r), 1e-30))), (warmup, step)
    # the first update runs at base * 1e-6 (up to float32 rounding of 1 - (1 - 1e-6))
    assert tsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP)(0) == pytest.approx(LR * 1e-6, rel=0.02)
    ref = jsched.step_decay_schedule(LR, (2, 4), 10)
    port = tsched.step_decay_schedule(LR, (2, 4), 10)
    for step in (0, 19, 20, 39, 40, 100):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-7), step


# ------------------------------------------------------ batch pipeline ---------


@pytest.fixture(scope="module")
def pipeline_case():
    """Two raw pairs from the JAX generator, each sample's JAX batch tensors
    (cache_prior False and True, one compile) and its replayed draws."""
    jcfg = JaxConfig(model=jax_cfg("dcn"))
    raw = jax.tree_util.tree_map(np.asarray, jsyn.make_raw_batch(jax.random.PRNGKey(0), B))
    K = jsyn.camera_K()

    @jax.jit
    def both(rng, sample):
        return (jpipe.augment_and_render(rng, sample, K, jcfg),
                jpipe.augment_and_render(rng, sample, K, jcfg, cache_prior=True))

    refs, draws = [], []
    for b in range(B):
        rng = jax.random.PRNGKey(100 + b)
        sample = jpipe.RawSample(*(a[b] for a in raw))
        refs.append(jax.tree_util.tree_map(np.asarray, both(rng, sample)))
        draws.append(replay_draws(rng, 7, jsyn.RAW_H, jsyn.RAW_W))
    return raw, refs, draws


@pytest.mark.parametrize("cache_prior", [False, True])
def test_augment_and_render_matches_jax(pipeline_case, cache_prior):
    raw, refs, draws = pipeline_case
    samples = tpipe.RawSample(*(_t(a) for a in raw))
    stacked = tpipe.Draws(*(torch.stack(x) for x in zip(*draws)))
    port = tpipe.render_batch(stacked, samples, tsyn.camera_K("cpu"), PortConfig(model=port_cfg("dcn")),
                              cache_prior=cache_prior)
    ref = {k: np.stack([r[int(cache_prior)][k] for r in refs]) for k in refs[0][0]}
    assert set(port) == set(ref)
    for k, r in ref.items():
        p = port[k].numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, k
        tol = 1e-4 if k.endswith("img") or k.endswith("target") else 1e-5
        np.testing.assert_allclose(p, r, atol=tol, err_msg=k)
    assert (ref["repro_hm"].max(axis=(1, 2, 3)) > 0.9).all()  # the priors were drawn


def test_noised_pnp_prior_matches_jax(pipeline_case):
    """The prior-grade solve on the replayed draws: next_est to 1e-2 px (the
    LM loop stops where float32 steps stop improving, in either package)."""
    raw, _, draws = pipeline_case
    K = jsyn.camera_K()
    fn = jax.jit(lambda r, a, b, c: jpnp.noised_pnp_prior(r, a, b, c, K, 0.75, 0.2))
    for b in range(B):
        _, _, k_prior, _ = jax.random.split(jax.random.PRNGKey(100 + b), 4)
        ok, est, noised, _ = fn(k_prior, raw[4][b], raw[2][b], raw[5][b])
        d = draws[b]
        tok, test_, tnoised, _ = tpnp.noised_pnp_prior(d.prior_noise, d.prior_keep_u, _t(raw[4][b]),
                                                       _t(raw[2][b]), _t(raw[5][b]), _t(np.asarray(K)), 0.75, 0.2)
        assert bool(tok) == bool(ok)
        np.testing.assert_allclose(tnoised.numpy(), np.asarray(noised), atol=1e-4)
        np.testing.assert_allclose(test_.numpy(), np.asarray(est), atol=1e-2)


@pytest.mark.parametrize("fp", [0.0, 0.5])
def test_noised_prior_heatmap_matches_jax(fp):
    """The origin prior with and without the opt-in false positives."""
    rs = np.random.RandomState(2)
    projs = (rs.rand(7, 2) * [640, 360]).astype(np.float32)
    M = np.asarray(jgeom.get_affine_transform(jnp.array([320.0, 180.0]), 640.0, 0.0, (64, 64)))
    rng = jax.random.PRNGKey(3)
    ref = jgeom.render_noised_prior_heatmap(rng, jnp.asarray(projs), jnp.asarray(M), 64, 64, 640, 360,
                                            0.75, 0.2, fp)
    k_jit, k_drop, k_fp, k_fpjit = jax.random.split(rng, 4)
    d = [_t(np.asarray(a)) for a in (jax.random.normal(k_jit, (7, 2)), jax.random.uniform(k_drop, (7,)),
                                     jax.random.uniform(k_fp, (7,)), jax.random.normal(k_fpjit, (7, 2)))]
    port = tgeom.render_noised_prior_heatmap(*d, _t(projs), _t(M), 64, 64, 640, 360, 0.75, 0.2, fp)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)


def test_make_batch_fn_and_raw_batch_shapes():
    cfg = PortConfig(model=port_cfg("dcn"))
    raw = tsyn.make_raw_batch(torch.Generator().manual_seed(0), B, device="cpu")
    assert raw.prev_img.shape == (B, tsyn.RAW_H, tsyn.RAW_W, 3) and raw.prev_x3d_rob.shape == (B, 7, 3)
    batch = tpipe.make_batch_fn(cfg, tsyn.camera_K())(torch.Generator().manual_seed(1), raw)
    expect = ttrainer.example_batch(cfg, B, device="cpu")
    # the example batch also holds the three-frame pipeline's ppre_* inputs
    assert set(batch) == {k for k in expect if not k.startswith("ppre_")}
    for k in batch:
        v = expect[k]
        assert batch[k].shape == v.shape and batch[k].dtype == v.dtype, k
        assert torch.isfinite(batch[k].float()).all(), k
    # without augmentation the crop is the whole raw frame, centered
    d = tpipe.draw_augment(torch.Generator().manual_seed(2), B, 7, (tsyn.RAW_H, tsyn.RAW_W), augment=False,
                           device="cpu")
    assert torch.equal(d.aug_s, torch.ones(B))
    assert torch.equal(d.center, torch.tensor([[320.0, 180.0]] * B))


# ---------------------------------------------------------- train step ---------


@pytest.fixture(scope="module")
def jax_train_step():
    """One JAX train step of the tiny model (dropout intercepted to the
    identity): train_step's body, with the gradients kept."""
    flax_model, variables = train_variables()
    schedule = jsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP)
    tx = optax.adam(schedule)
    mu, nu = adam_state(variables["params"])
    adam, sched = tx.init(variables["params"])
    opt_state = (adam._replace(count=jnp.int32(ADAM_COUNT), mu=mu, nu=nu),
                 sched._replace(count=jnp.int32(SCHED_COUNT)))
    state = jtrainer.TrainState(step=jnp.int32(SCHED_COUNT), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=opt_state,
                                apply_fn=flax_model.apply, tx=tx)
    batch = {k: jnp.asarray(v) for k, v in random_train_batch(5).items()}

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
        stats, grads, new_state = jax.jit(step)(state, batch)
    flax_state = {"params": variables["params"], "batch_stats": variables["batch_stats"], "mu": mu,
                  "nu": nu, "adam_count": ADAM_COUNT, "schedule_count": SCHED_COUNT, "step": SCHED_COUNT}
    return flax_state, jax.tree_util.tree_map(np.asarray, (stats, grads, new_state.params,
                                                           new_state.batch_stats))


def _port_state(flax_state=None):
    cfg = PortConfig(model=port_cfg("dcn"))
    state = ttrainer.create_train_state(cfg, seed=0, max_iters=MAX_ITERS, device="cpu",
                                        schedule=tsched.warmup_poly_schedule(LR, MAX_ITERS, WARMUP))
    if flax_state is not None:
        tweights.load_flax_train_state(state, flax_state)
    return state


def test_train_step_matches_jax(jax_train_step):
    flax_state, (stats, grads, params, batch_stats) = jax_train_step
    state = _port_state(flax_state)
    set_dropout_rate(state.model, 0.0)
    model = state.model
    port_stats = ttrainer.train_step(state, {k: _t(v) for k, v in random_train_batch(5).items()})
    assert state.step == SCHED_COUNT + 1 and state.schedule_count == SCHED_COUNT + 1
    for k in ("tot", "hm", "reg", "tracking"):
        assert _rel_err(port_stats[k].numpy(), stats[k], floor=1e-30) <= 1e-4, k

    named = dict(model.named_parameters())
    ref_grads = tweights._convert(model, {"params": grads}, named)
    port_grads = {k: named[k].grad.numpy() for k in ref_grads}
    # levels 0 and 1 feed no head (the decoder starts at level 2), and the
    # tracking head's loss weight is 0: zero gradients on both sides
    unused = sorted(k for k, g in ref_grads.items() if np.abs(g).max() == 0)
    assert unused and all(k.startswith(("transformer_0.", "transformer_1.", "cat_layer_0.", "cat_layer_1.",
                                        "tracking.")) for k in unused), unused
    assert all(np.abs(port_grads[k]).max() == 0 for k in unused)
    # the rest (tensors whose gradient is not zero in exact arithmetic: the
    # DCN biases before a BatchNorm get float32 residue of ~1e-10)
    live = [k for k, g in ref_grads.items() if np.abs(g).max() > 1e-7]
    worst = max((_rel_err(port_grads[k], ref_grads[k], floor=1e-30), k) for k in live)
    assert worst[0] <= 0.2, worst
    num = sum(((port_grads[k] - ref_grads[k]).astype(np.float64) ** 2).sum() for k in live)
    den = sum((ref_grads[k].astype(np.float64) ** 2).sum() for k in live)
    assert np.sqrt(num / den) <= 0.03

    buffers = model.state_dict()
    ref_stats = tweights._convert(model, {"batch_stats": batch_stats}, {
        k: v for k, v in buffers.items() if k.endswith(("running_mean", "running_var"))})
    for k, r in ref_stats.items():
        assert _rel_err(buffers[k].numpy(), r) <= 1e-4, k

    ref_params = tweights._convert(model, {"params": params}, named)
    for k, r in ref_params.items():
        np.testing.assert_allclose(named[k].detach().numpy(), r, atol=3e-5, err_msg=k)
    assert max(np.abs(ref_params[k] - flax_p).max() for k, flax_p in
               tweights._convert(model, {"params": flax_state["params"]}, named).items()) > 1e-4


# ------------------------------------------------------------- dropout ---------


def test_dropout_rate_scale_and_places():
    """Rate 0.1 with kept elements scaled by 1/0.9; the identity in eval
    mode; applied to the residual query, after the FFN's ReLU and after its
    second layer, once per tied layer; reproducible from the generator's
    seed."""
    drop = Dropout(0.1).train()
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(1_000_000)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 3e-3
    assert torch.all(y[kept] == 1.0 / 0.9)
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.1).train()(x)

    layer = TransformerEncoderLayer(16, 4, 9, n_heads=4).train()
    gen = torch.Generator().manual_seed(1)
    for m in (layer.dropout1, layer.dropout2, layer.dropout3):
        m.generator = gen
    seen = {}
    for name in ("dropout1", "dropout2", "dropout3"):
        getattr(layer, name).register_forward_hook(
            lambda mod, inp, out, name=name: seen.setdefault(name, []).append((inp[0], out)))
    q, kv = torch.randn(2, 9, 16), torch.randn(2, 9, 16)
    gen.manual_seed(7)
    out1 = layer(q, kv, kv)
    assert torch.equal(seen["dropout1"][0][0], q)  # the residual query
    assert seen["dropout2"][0][0].shape == (2, 9, 1024) and (seen["dropout2"][0][0] >= 0).all()
    assert seen["dropout3"][0][0].shape == (2, 9, 16)
    assert all(not torch.equal(i, o) for i, o in (seen[n][0] for n in seen))
    gen.manual_seed(7)
    assert torch.equal(layer(q, kv, kv), out1)
    assert ttrainer.dropout_seed(317, 3) != ttrainer.dropout_seed(317, 4)


# --------------------------------------------------- checkpoint, resume --------


def test_checkpoint_round_trip_and_resume(tmp_path):
    batch = {k: _t(v) for k, v in random_train_batch(6).items()}
    a = _port_state()
    ttrainer.train_step(a, batch)
    path = str(tmp_path / "ckpt.pt")
    ttrainer.save_checkpoint(path, a)
    b = ttrainer.load_checkpoint(path, _port_state())
    assert (b.step, b.schedule_count) == (a.step, a.schedule_count) == (1, 1)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # the next step from both is the same step, dropout included
    la, lb = ttrainer.train_step(a, batch), ttrainer.train_step(b, batch)
    assert torch.equal(la["tot"], lb["tot"])
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert all(torch.equal(pa[k], pb[k]) for k in pa)

    # the evaluation forwards: running statistics, no dropout, one forward
    stats = ttrainer.eval_step(a, batch)
    heads = ttrainer.predict_step(a, batch)
    stats2, heads2 = ttrainer.eval_predict_step(a, batch)
    assert not a.model.training
    assert all(torch.equal(stats[k], stats2[k]) for k in stats)
    assert all(torch.equal(heads[k], heads2[k]) for k in heads)
    assert heads["hm"].shape == (B, 16, 16, 7) and 0 <= heads["hm"].min() and heads["hm"].max() <= 1

    # resume: the schedule count and step advance, Adam's bias-correction
    # count does not
    p = next(iter(b.model.parameters()))
    adam_count = b.optimizer.state[p]["step"].item()
    c = ttrainer.resume_schedule_state(b, 15)
    assert (c.step, c.schedule_count) == (15, 15)
    ttrainer.train_step(c, batch)
    assert c.optimizer.state[p]["step"].item() == adam_count + 1
    assert (c.step, c.schedule_count) == (16, 16)
    assert c.optimizer.param_groups[0]["lr"] == pytest.approx(float(jsched.warmup_poly_schedule(
        LR, MAX_ITERS, WARMUP)(15)), rel=1e-6)


def test_train_demo_resume_step_continues_the_batch_stream(tmp_path, monkeypatch):
    """Two segments of 2 steps, the second a warm start at --resume_step 2,
    draw the raw batches and augmentations of one 4-step run (the train step
    itself stubbed out: the stream is what is checked)."""
    from sgtapose_tpu_torch.cli import train_demo

    drawn = []

    def raw_batch(gen, batch, device):
        drawn.append(("raw", gen.initial_seed()))

    def batch_fn(gen, raw):
        drawn.append(("aug", gen.initial_seed()))

    def step(state, batch, **kw):
        state.step += 1
        return {"tot": torch.zeros(())}

    monkeypatch.setattr(train_demo.synthetic, "make_raw_batch", raw_batch)
    monkeypatch.setattr(train_demo.pipeline, "make_batch_fn", lambda *a, **k: batch_fn)
    monkeypatch.setattr(train_demo.trainer, "train_step", step)
    common = ["--device", "cpu", "--batch", "1", "--input_res", "64", "--eval_videos", "0", "--steps"]
    train_demo.main(common + ["4"])
    whole, drawn[:] = list(drawn), []
    ckpt = str(tmp_path / "first.pt")
    train_demo.main(common + ["2", "--ckpt_out", ckpt])
    res = train_demo.main(common + ["2", "--init_ckpt", ckpt, "--resume_step", "2"])
    assert res["state"].step == 4
    assert drawn == whole and len(set(whole)) == 8


def test_unported_training_options_raise():
    """The Dream phase is ported: it builds a DREAM baseline in train mode;
    it refuses the flagship, which takes the previous frame and priors."""
    state = ttrainer.create_train_state(
        PortConfig(model=dataclasses.replace(port_cfg(), arch="dreamhourglass")), 0, device="cpu", phase="Dream")
    assert type(state.model).__name__ == "DreamHourglass" and state.model.training
    with pytest.raises(ValueError, match="take the current image alone"):
        ttrainer.create_train_state(PortConfig(model=port_cfg()), 0, device="cpu", phase="Dream")


def test_train_demo_cli_runs_on_the_cpu_and_refuses_later_flags(tmp_path):
    """The CLI end to end at 64x64 (2 steps, batch 2, no eval), with a
    checkpoint; the flags not ported yet raise, and the default device is
    the card."""
    from sgtapose_tpu_torch.cli import train_demo

    ckpt = str(tmp_path / "demo.pt")
    res = train_demo.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--input_res", "64",
                           "--eval_videos", "0", "--log_every", "1", "--ckpt_out", ckpt])
    assert [e["step"] for e in res["logged"]] == [0, 1]
    assert all(np.isfinite(e["tot"]) for e in res["logged"])
    assert torch.load(ckpt, weights_only=True)["step"] == 2
    # a warm start from it: the model's weights, a fresh optimizer, the
    # parent's schedule from --resume_step
    res2 = train_demo.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--input_res", "64",
                            "--eval_videos", "0", "--init_ckpt", ckpt, "--resume_step", "5"])
    assert res2["state"].step == 6 and res2["state"].schedule_count == 6
    for flag in (["--quant_train"], ["--dcn_chunks", "2"], ["--dcn_remat"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            train_demo.main(["--device", "cpu"] + flag)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_demo.main(["--steps", "1"])
