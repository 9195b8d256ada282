"""Port parity of the training phases on the CPU: one whole train step of
each ported phase's model (tiny: 64x64 input, full channel widths) against
JAX's `train_step` body from the same numpy variables and Adam state; the
three-frame batch pipeline with JAX's key splits replayed; the three-frame
loader against JAX's on a set the port's writer makes; the phase table and
the trainer's phase wiring.

The steps run in float64 on both sides, as tests/test_torch_port_train_f64.py
runs the flagship's: in float32, train-mode BatchNorm on 2x2-16x16 maps
amplifies rounding layer by layer (measured here on the global variant: one
gradient tensor 23 % of its largest apart, where the flagship's float32 step
is 9.3 %), so float32 can only hold loose bars; float64 shows each step is
the same function. Bars: those of the float64 flagship step (loss terms 1e-6
relative, each gradient tensor above 1e-9 within 1e-6 of its largest, BN
statistics 1e-10 relative, parameters after the Adam update 1e-9); zero
gradients (levels that feed no head, the tracking head at weight 0) zero on
both sides. The port's attention and DCN run their plain versions under
torch autograd (their Functions and kernels are float32 and bf16 only). The
pipeline at tests/test_torch_port_train.py's bars (images and targets 1e-4,
heatmaps 1e-5); the loader bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.data import pipeline as jpipe, synthetic as jsyn
from sgtapose_tpu.data.discovery import find_ndds_seq_triples_in_dir as jax_triples
from sgtapose_tpu.data.loader import TripleBatchLoader as JaxTripleLoader
from sgtapose_tpu.train.phases import input_names as jax_input_names, loss_weights as jax_loss_weights
from sgtapose_tpu_torch.config import Config as PortConfig, KEYPOINT_NAMES, SYNTHETIC_CAMERA_K
from sgtapose_tpu_torch.data import discovery as tdisc, pipeline as tpipe, synthetic as tsyn
from sgtapose_tpu_torch.data.loader import TripleBatchLoader
from sgtapose_tpu_torch.train import phases as tphases, trainer as ttrainer

from torch_port_common import (check_phase_train_step, jax_cfg, phase_train_batch, port_cfg, replay_draws)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("phase", ["PlanA", "PlanA_three", "PlanACAT", "CenterTrack", "CenterNet"])
def test_train_step_matches_jax(phase, monkeypatch):
    check_phase_train_step(phase, monkeypatch)


def test_phase_table_and_wiring():
    """The port's phase table is JAX's; Dream raises, naming the ROADMAP
    item; eval and predict steps run every ported phase's model."""
    for phase in tphases.PORTED:
        assert tphases.input_names(phase) == jax_input_names(phase)
        assert tphases.loss_weights(phase) == jax_loss_weights(phase)
    assert set(tphases.PHASES) - set(tphases.PORTED) == {"Dream"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tphases.input_names("Dream")
    with pytest.raises(ValueError, match="unknown phase"):
        tphases.input_names("PlanB")
    batch = {k: _t(v.astype(np.float32) if v.dtype == np.float64 else v) for k, v in phase_train_batch().items()}
    state = ttrainer.create_train_state(PortConfig(model=dataclasses.replace(port_cfg(), arch="dlaabla_34")), 0,
                                        device="cpu", phase="ablation_wo_shared")
    assert state.model.mode == "wo_shared" and hasattr(state.model, "base1")
    stats = ttrainer.eval_step(state, batch, phase="ablation_wo_shared")
    pred = ttrainer.predict_step(state, batch, phase="ablation_wo_shared")
    assert np.isfinite(stats["tot"].item()) and pred["hm"].shape == (2, 16, 16, 7)
    example = ttrainer.example_batch(PortConfig(model=port_cfg()), 2, device="cpu")
    for phase in tphases.PORTED:
        assert set(tphases.input_names(phase)) <= set(example), phase


# ------------------------------------------------ three-frame pipeline ---------


@pytest.fixture(scope="module")
def three_case():
    """Two three-frame windows from the JAX raw generator (ppre from a second
    raw batch), JAX's batch tensors and the replayed draws."""
    jcfg = JaxConfig(model=jax_cfg("dcn"))
    a = jax.tree_util.tree_map(np.asarray, jsyn.make_raw_batch(jax.random.PRNGKey(0), 2))
    b = jax.tree_util.tree_map(np.asarray, jsyn.make_raw_batch(jax.random.PRNGKey(1), 2))
    raw = jpipe.RawSampleThree(ppre_img=b.prev_img, pre_img=a.prev_img, next_img=a.next_img,
                               ppre_projs=b.prev_projs, pre_projs=a.prev_projs, next_projs=a.next_projs,
                               ppre_x3d_rob=b.prev_x3d_rob, pre_x3d_rob=a.prev_x3d_rob,
                               next_x3d_rob=a.next_x3d_rob)
    rng = jax.random.PRNGKey(7)
    ref = jax.tree_util.tree_map(np.asarray, jpipe.make_batch_fn_three(jcfg, jsyn.camera_K())(rng, raw))
    draws = []
    for r in jax.random.split(rng, 2):
        k_pair, k_pp = jax.random.split(r, 3)[:2]
        k_jit, k_drop = jax.random.split(k_pp)
        draws.append(tpipe.DrawsThree(replay_draws(k_pair, 7, jsyn.RAW_H, jsyn.RAW_W),
                                      _t(np.asarray(jax.random.normal(k_jit, (7, 2)))),
                                      _t(np.asarray(jax.random.uniform(k_drop, (7,))))))
    return raw, ref, draws


def test_augment_and_render_three_matches_jax(three_case):
    raw, ref, draws = three_case
    samples = tpipe.RawSampleThree(*(_t(x) for x in raw))
    stacked = jax.tree_util.tree_map(lambda *xs: torch.stack(xs), *draws)
    port = tpipe.render_batch_three(stacked, samples, tsyn.camera_K("cpu"), PortConfig(model=port_cfg("dcn")))
    assert set(port) == set(ref)
    for k, r in ref.items():
        p = port[k].numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, k
        tol = 1e-4 if k.endswith("img") or k.endswith("target") else 1e-5
        np.testing.assert_allclose(p, r, atol=tol, err_msg=k)
    assert (ref["ppre_hm"].max(axis=(1, 2, 3)) > 0.9).all()  # the ppre priors were drawn


def test_make_batch_fn_three_shapes():
    cfg = PortConfig(model=port_cfg("dcn"))
    a = tsyn.make_raw_batch(torch.Generator().manual_seed(0), 2, device="cpu")
    b = tsyn.make_raw_batch(torch.Generator().manual_seed(1), 2, device="cpu")
    raw = tpipe.RawSampleThree(b.prev_img, a.prev_img, a.next_img, b.prev_projs, a.prev_projs, a.next_projs,
                               b.prev_x3d_rob, a.prev_x3d_rob, a.next_x3d_rob)
    batch = tpipe.make_batch_fn_three(cfg, tsyn.camera_K())(torch.Generator().manual_seed(2), raw)
    expect = ttrainer.example_batch(cfg, 2, device="cpu")
    for k in set(tphases.input_names("PlanA_three")) | {"gt_belief_maps", "kp_int", "reg_target"}:
        assert batch[k].shape == expect[k].shape and batch[k].dtype == expect[k].dtype, k
        assert torch.isfinite(batch[k].float()).all(), k


def test_triple_loader_matches_jax(tmp_path):
    """Windows of a set the port's writer makes: the JAX loader's batches,
    bit for bit, over a shuffled epoch."""
    tsyn.write_synthetic_dataset(str(tmp_path), n_videos=2, n_frames=4, seed=0, device="cpu")
    triples = tdisc.find_ndds_seq_triples_in_dir(str(tmp_path))
    assert len(triples) == 4
    assert [dataclasses.astuple(t) for t in triples] == [dataclasses.astuple(t) for t in jax_triples(str(tmp_path))]
    K = np.asarray(SYNTHETIC_CAMERA_K)
    names = KEYPOINT_NAMES["panda_synthetic"]
    kw = dict(seed=3, num_workers=2)
    jl = JaxTripleLoader(triples, JaxConfig(), K, "panda_synthetic", names, 2, **kw)
    tl = TripleBatchLoader(triples, PortConfig(), K, "panda_synthetic", names, 2, **kw)
    jb, tb = list(jl.epoch(1)), list(tl.epoch(1))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        assert type(b) is tpipe.RawSampleThree
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y)
