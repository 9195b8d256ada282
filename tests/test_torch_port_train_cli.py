"""Port parity of the training CLI's pieces (`sgtapose_tpu_torch.cli.train`
and the modules it runs) against the JAX package, on the CPU:

  * data/discovery.py: equal pair and triple lists, identity pairs and the
    seq_frame remap of every pair, on sets from both packages' writers
    (synthetic with a frame gap, kuka, depth);
  * data/loader.py:SeqBatchLoader: batches equal bit for bit to JAX's for two
    epochs, num_workers 1 and 4, shuffled and not, and depth; an early break
    stops its threads, a load failure raises in the consumer, samples of two
    raw resolutions in one batch raise;
  * utils/logging.py:MetricsLogger: the same records apart from "ts", the
    same viz/ PNG, resume appends, an inert logger writes nothing;
  * utils/visualize.py: training_debug_mosaic and teaser_prior_image equal
    pixel for pixel;
  * train/trainer.validate against the JAX CLI's validation (eval_predict_step,
    decode_heatmaps_batch, keypoint_metrics) with the same weights (carried
    by utils/weights.py; the tiny model's perturbed variables with the hm
    bias raised, so peaks decode) on the same model batches: loss terms
    within 1e-4 relative (the heads' bar, test_torch_port_model.py), keypoint
    counts equal, kp_l2_mean_px within 1e-2 px, the AUC within 1e-3;
  * cli/train.main --device cpu end to end at 64x64 on sets the port's
    writers make: checkpoints, metrics.jsonl keys, viz/, --resume against
    the JAX CLI run on the same set with the same flags (the epoch loop
    restarts at 1 while step, schedule and Adam go on: the epoch and
    iteration of every logged step, the checkpoint names, the step count,
    and with --lr_step the learning rate of every step within one float32
    ulp), --depth, --robot kuka, train then cli/infer.main on the
    checkpoint, and the flags that are not ported raising.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import threading
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sgtapose_tpu.cli import train as jcli
from sgtapose_tpu.config import Config as JaxConfig, KEYPOINT_NAMES, SYNTHETIC_CAMERA_K, TrainConfig as JaxTrainConfig
from sgtapose_tpu.data import discovery as jdisc, synthetic as jsyn
from sgtapose_tpu.data.loader import SeqBatchLoader as JaxLoader
from sgtapose_tpu.decode.peaks import decode_heatmaps_batch as jax_decode_batch
from sgtapose_tpu.eval import metrics as jmetrics
from sgtapose_tpu.train import schedule as jsched, trainer as jtrainer
from sgtapose_tpu.utils import logging as jlog, visualize as jvis
from sgtapose_tpu_torch.cli import infer as tinfer, train as tcli
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.data import discovery as tdisc, synthetic as tsyn
from sgtapose_tpu_torch.data.loader import SeqBatchLoader
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.utils import logging as tlog, visualize as tvis
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, jax_cfg, port_cfg, random_train_batch

K = np.asarray(SYNTHETIC_CAMERA_K)
KP = KEYPOINT_NAMES["panda_synthetic"]
TINY = ["--input_res", "64", "--kernel_list", "3,3,3,1,1,1", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """Datasets from both packages' writers; 'gap' lacks frame 2 of its
    video, 'mixed' has one video at twice the resolution."""
    root = tmp_path_factory.mktemp("train_cli_sets")
    d = {name: str(root / name) for name in ("jsyn", "tsyn", "gap", "jkuka", "tkuka", "jdepth", "tdepth",
                                             "val", "mixed")}
    jsyn.write_synthetic_dataset(d["jsyn"], n_videos=2, n_frames=4, seed=0)
    tsyn.write_synthetic_dataset(d["tsyn"], n_videos=2, n_frames=4, seed=0, device="cpu")
    jsyn.write_synthetic_dataset(d["gap"], n_videos=2, n_frames=6, seed=1)
    for suffix in ("_color.png", "_meta.json"):
        os.remove(os.path.join(d["gap"], "00000", "0002" + suffix))
    jsyn.write_synthetic_dataset(d["jkuka"], n_videos=1, n_frames=3, seed=2, robot_name="kuka")
    tsyn.write_synthetic_dataset(d["tkuka"], n_videos=2, n_frames=3, seed=2, robot_name="kuka", device="cpu")
    jsyn.write_depth_dataset(d["jdepth"], set_name="panda-depth", n_frames=5, seed=0)
    tsyn.write_depth_dataset(d["tdepth"], set_name="panda-depth", n_frames=3, seed=0, device="cpu")
    tsyn.write_synthetic_dataset(d["val"], n_videos=1, n_frames=5, seed=3, device="cpu")
    shutil.copytree(d["tsyn"], d["mixed"])
    for f in sorted(os.listdir(os.path.join(d["mixed"], "00001"))):
        if f.endswith(".png"):
            p = os.path.join(d["mixed"], "00001", f)
            im = Image.open(p)
            im.resize((im.width * 2, im.height * 2)).save(p)
    return d


def _as_tuples(items):
    return [dataclasses.astuple(x) for x in items]


# ------------------------------------------------------------ discovery -------

@pytest.mark.parametrize("name", ["jsyn", "tsyn", "gap", "jkuka", "tkuka"])
def test_discovery_matches_jax(sets, name):
    root = sets[name]
    ref = jdisc.find_ndds_seq_data_in_dir(root)
    got = tdisc.find_ndds_seq_data_in_dir(root)
    assert _as_tuples(got) == _as_tuples(ref) and got
    assert _as_tuples(tdisc.find_ndds_seq_data_in_dir(root, pair_frames=False)) == _as_tuples(
        jdisc.find_ndds_seq_data_in_dir(root, pair_frames=False))
    assert _as_tuples(tdisc.find_ndds_seq_triples_in_dir(root)) == _as_tuples(
        jdisc.find_ndds_seq_triples_in_dir(root))
    for seq_frame in (0, 2, 3):
        assert [dataclasses.astuple(tdisc.remap_seq_frame(p, seq_frame)) for p in got] == [
            dataclasses.astuple(jdisc.remap_seq_frame(p, seq_frame)) for p in ref]
    if name == "gap":  # the pairs around the missing frame are skipped
        names = [(p.prev_name, p.next_name) for p in got]
        assert (os.path.join("00000", "0001"), os.path.join("00000", "0003")) not in names
        assert len(got) == 5 + 3


@pytest.mark.parametrize("name", ["jdepth", "tdepth"])
def test_depth_discovery_matches_jax(sets, name):
    root = os.path.join(sets[name], "panda-depth")
    got = tdisc.find_depth_seq_data_in_dir(root)
    assert _as_tuples(got) == _as_tuples(jdisc.find_depth_seq_data_in_dir(root)) and got
    with pytest.raises(FileNotFoundError):
        tdisc.find_depth_seq_data_in_dir(os.path.join(root, "absent"))


# ------------------------------------------------------------ loader ----------

def _loaders(root, depth, batch_size, **kw):
    if depth:
        root = os.path.join(root, "panda-depth")
        jpairs, tpairs = jdisc.find_depth_seq_data_in_dir(root), tdisc.find_depth_seq_data_in_dir(root)
        names, robot = [], "Franka_Emika_Panda"
    else:
        jpairs, tpairs = jdisc.find_ndds_seq_data_in_dir(root), tdisc.find_ndds_seq_data_in_dir(root)
        names, robot = KP, "panda_synthetic"
    jcfg, tcfg = JaxConfig(train=JaxTrainConfig()), PortConfig()
    assert jcfg.train.seq_frame == tcfg.train.seq_frame
    return (JaxLoader(jpairs, jcfg, K, robot, names, batch_size, depth=depth, **kw),
            SeqBatchLoader(tpairs, tcfg, K, robot, names, batch_size, depth=depth, **kw))


@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("name", ["gap", "jdepth"])
def test_loader_batches_match_jax(sets, name, shuffle, num_workers):
    jl, tl = _loaders(sets[name], name == "jdepth", 2, shuffle=shuffle, num_workers=num_workers, seed=11)
    assert len(tl) == len(jl) >= 2
    for epoch in (1, 2):
        ref, got = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(got) == len(ref) == len(tl)
        for r, g in zip(ref, got):
            assert g._fields == r._fields
            for f in r._fields:
                np.testing.assert_array_equal(getattr(g, f), getattr(r, f), err_msg=f)
                assert getattr(g, f).dtype == getattr(r, f).dtype, f
                assert isinstance(getattr(g, f), np.ndarray), f


def test_loader_drop_last_and_epoch_order(sets):
    _, tl = _loaders(sets["gap"], False, 3, num_workers=2, seed=5)
    assert len(tl) == 8 // 3
    tl.drop_last = False
    assert len(tl) == 3 and [b.prev_img.shape[0] for b in tl.epoch(0)] == [3, 3, 2]
    tl.drop_last = True
    a, b = list(tl.epoch(1)), list(tl.epoch(2))
    assert any(not np.array_equal(x.prev_projs, y.prev_projs) for x, y in zip(a, b))


def test_loader_early_break_stops_its_threads(sets):
    _, tl = _loaders(sets["gap"], False, 1, num_workers=4)
    before = threading.active_count()
    it = tl.epoch(0)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("num_workers", [1, 2])
def test_loader_failure_raises_in_the_consumer(sets, tmp_path, num_workers):
    d = str(tmp_path / "broken")
    shutil.copytree(sets["tsyn"], d)
    with open(os.path.join(d, "00000", "0001_meta.json"), "w") as f:
        f.write("{not json")
    tl = SeqBatchLoader(tdisc.find_ndds_seq_data_in_dir(d), PortConfig(), K, "panda_synthetic", KP, 2,
                        shuffle=False, num_workers=num_workers)
    with pytest.raises(json.JSONDecodeError):
        list(tl.epoch(0))


def test_loader_mixed_resolutions_raise(sets):
    tl = SeqBatchLoader(tdisc.find_ndds_seq_data_in_dir(sets["mixed"]), PortConfig(), K, "panda_synthetic", KP,
                        6, shuffle=False, num_workers=2)
    with pytest.raises(ValueError):
        list(tl.epoch(0))


# ------------------------------------------------------------ logger, images --

def test_metrics_logger_matches_jax(tmp_path):
    img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (8, 12, 3)).astype(np.uint8))
    recs = {}
    for tag, mod in (("jax", jlog), ("port", tlog)):
        for resume in (False, True):
            lg = mod.MetricsLogger(str(tmp_path / tag), use_tensorboard=False, resume=resume)
            lg.log(3, {"tot": np.float32(0.5), "hm": 0.25})
            lg.log(3, {"tot": 1.0, "kp_found_inframe": 7}, prefix="val")
            lg.log_image(3, "train_mosaic", img)
            lg.close()
        with open(tmp_path / tag / "metrics.jsonl") as f:
            recs[tag] = [json.loads(line) for line in f]
        inert = mod.MetricsLogger(None)
        inert.log(1, {"a": 1.0})
        inert.log_image(1, "x", img)
        inert.close()
    assert len(recs["port"]) == 4  # the resumed logger appended
    strip = lambda rs: [{k: v for k, v in r.items() if k != "ts"} for r in rs]
    assert strip(recs["port"]) == strip(recs["jax"])
    assert sorted(os.listdir(tmp_path / "port" / "viz")) == ["train_mosaic_0000003.png"]
    a = np.asarray(Image.open(tmp_path / "port" / "viz" / "train_mosaic_0000003.png"))
    np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "jax" / "viz" / "train_mosaic_0000003.png")))


def test_training_mosaic_and_teaser_match_jax():
    rs = np.random.RandomState(4)
    img = rs.rand(64, 64, 3).astype(np.float32) * 300.0 - 20.0
    gt, pred = rs.rand(16, 16, 7).astype(np.float32), rs.rand(16, 16, 7).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(tvis.training_debug_mosaic(img, gt, pred)),
                                  np.asarray(jvis.training_debug_mosaic(img, gt, pred)))
    projs = rs.rand(7, 2).astype(np.float32) * np.array([640.0, 360.0], np.float32)
    trans = np.array([[0.1, 0.0, -0.5], [0.0, 0.1, 14.0]], np.float32)
    image = rs.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    for im in (None, image):
        got = tvis.teaser_prior_image(projs, trans, (64, 64), (640, 360), image=im)
        ref = jvis.teaser_prior_image(projs, trans, (64, 64), (640, 360), image=im)
        assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, ref)
        assert got.max() > 200  # some keypoints land in the window


# ------------------------------------------------------------ validate --------

def _decodable_variables():
    """The tiny model's perturbed variables with the hm bias raised (random
    weights decode no peak)."""
    _, variables = flax_model_and_variables("dcn")
    variables = jax.tree_util.tree_map(np.copy, variables)
    variables["params"]["hm"]["Conv_1"]["bias"][:] = 1.0
    return variables


def _jax_validate(variables, batches, jcfg):
    """The JAX CLI's validation loop (sgtapose_tpu/cli/train.py:338-374)."""
    flax_model, _ = flax_model_and_variables("dcn")
    state = jtrainer.TrainState(step=jnp.int32(0), params=variables["params"],
                                batch_stats=variables["batch_stats"], opt_state=None,
                                apply_fn=flax_model.apply, tx=None)
    eval_predict_fn = jax.jit(jtrainer.eval_predict_step)
    vals, det_all, gt_all = [], [], []
    ratio = float(jcfg.model.down_ratio)
    for batch in batches:
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        stats, pred = eval_predict_fn(state, batch)
        vals.append({k: float(v) for k, v in stats.items()})
        inf = jcfg.infer
        dec = jax_decode_batch(pred["hm"], pred["reg"], pred["tracking"], max_peaks=inf.max_peaks,
                               peak_thresh=inf.peak_thresh, ambiguity_gap=inf.ambiguity_gap,
                               peak_offset=inf.peak_offset, sigma=inf.peak_sigma, ref_sort=inf.ref_sort,
                               coord_mode=inf.decode_coord)
        det_all.append(np.asarray(dec.coords) * ratio)
        gt_all.append((np.asarray(batch["kp_int"], np.float32) + np.asarray(batch["reg_target"])) * ratio)
    mean = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}
    H, W = jcfg.model.input_res
    km = jmetrics.keypoint_metrics(np.concatenate(det_all).reshape(-1, 2), np.concatenate(gt_all).reshape(-1, 2),
                                   (W, H))
    mean.update({"kp_found_inframe": km["num_found_gt_inframe"],
                 "kp_missing_inframe": km["num_missing_gt_inframe"],
                 "kp_l2_mean_px": km["l2_error_mean_px"] or -1.0,
                 "kp_pck_auc_12px": km["l2_error_auc"] or 0.0})
    return mean


def test_validate_matches_jax():
    variables = _decodable_variables()
    batches = [random_train_batch(seed, B=2) for seed in (21, 22)]
    for b in batches:  # ground truth near the decoded peaks' range and off the border
        b["kp_int"] = np.clip(b["kp_int"], 2, 13)
    ref = _jax_validate(variables, batches, JaxConfig(model=jax_cfg("dcn")))

    cfg = PortConfig(model=port_cfg("dcn"))
    state = ttrainer.create_train_state(cfg, seed=0, device="cpu")
    load_flax_variables(state.model, variables)
    got = ttrainer.validate(state, ({k: torch.from_numpy(v) for k, v in b.items()} for b in batches), cfg)
    assert set(got) == set(ref) == {"tot", "hm", "reg", "tracking", "kp_found_inframe", "kp_missing_inframe",
                                    "kp_l2_mean_px", "kp_pck_auc_12px"}
    for k in ("tot", "hm", "reg", "tracking"):
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), k
    assert got["kp_found_inframe"] == ref["kp_found_inframe"] > 0
    assert got["kp_missing_inframe"] == ref["kp_missing_inframe"]
    assert abs(got["kp_l2_mean_px"] - ref["kp_l2_mean_px"]) <= 1e-2
    assert abs(got["kp_pck_auc_12px"] - ref["kp_pck_auc_12px"]) <= 1e-3
    assert ttrainer.validate(state, iter(()), cfg) == {}


# ------------------------------------------------------------ the CLI ---------

# one training run of 2 epochs, then --resume from epoch 2's checkpoint with
# --num_epochs 1: the JAX CLI's epoch loop runs epochs 1 .. --num_epochs
# again while step, schedule and Adam go on (sgtapose_tpu/cli/train.py:267-269,
# :307), so the resumed run is one more epoch, numbered 1, whose checkpoint
# replaces epoch_1
RESUME_FLAGS = ["--batch_size", "2", "--lr_step", "1", "--log_every", "1"]
LOGGED = re.compile(r"^epoch (\d+) it (\d+)/(\d+) ", re.M)


def _two_runs(main, argv, out, ckpt_suffix):
    """main(argv) for 2 epochs, then resumed from epoch 2 for 1; the
    (epoch, iteration) of every logged step, from the CLI's own lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = main(argv + ["--num_epochs", "2"])
        with open(os.path.join(out, "metrics.jsonl")) as f:
            first_records = [json.loads(line) for line in f]
        second = main(argv + ["--num_epochs", "1", "--resume", os.path.join(out, "ckpt", "epoch_2" + ckpt_suffix)])
    logged = [(int(e), int(i)) for e, i, _ in LOGGED.findall(buf.getvalue())]
    return first, second, first_records, logged


@pytest.fixture(scope="module")
def run_a(sets, tmp_path_factory):
    """Train 2 epochs with --lr_step 1 and validation, then resume from epoch
    2 for --num_epochs 1; the learning rate of every step recorded."""
    out = str(tmp_path_factory.mktemp("train_cli") / "exp")
    lrs = []
    real_step = ttrainer.train_step

    def recording_step(state, batch, **kw):
        lrs.append((state.step, state.schedule(state.schedule_count)))
        return real_step(state, batch, **kw)

    argv = ["--dataset", sets["tsyn"], "--val_dataset", sets["val"], "--output_dir", out, "--image_log_every", "2",
            "--num_workers", "2"] + RESUME_FLAGS + TINY
    ttrainer.train_step = recording_step
    try:
        first, second, first_records, logged = _two_runs(tcli.main, argv, out, ".pt")
    finally:
        ttrainer.train_step = real_step
    return {"out": out, "lrs": lrs, "first": first, "second": second, "first_records": first_records,
            "logged": logged}


class _TwoParameterModel(fnn.Module):
    """A stand-in for the JAX model in `jax_resume`: one parameter and one
    batch statistic."""

    @fnn.compact
    def __call__(self, *inputs, train=False):
        self.variable("batch_stats", "m", jnp.zeros, (1,))
        return self.param("w", fnn.initializers.zeros, (2,))


@pytest.fixture(scope="module")
def jax_resume(sets, tmp_path_factory):
    """The JAX CLI's `main` on the same set with the same flags, first run
    then resume: its loader, epoch loop, schedule, optax Adam, orbax
    checkpoints, resume and metrics log as they are, with a two-parameter
    stand-in for its model, whose step is the optimizer update of zero
    gradients (the step and the optax counts advance as in a real step), and
    an empty batch for its batch build: the flagship's initialisation, step
    and batch build take minutes to compile on the CPU and change no epoch,
    step or learning rate. No validation or mosaics (they would run the
    model)."""
    out = str(tmp_path_factory.mktemp("jax_train_cli") / "exp")
    argv = ["--dataset", sets["tsyn"], "--output_dir", out, "--image_log_every", "0", "--num_devices", "1",
            "--num_workers", "2"] + RESUME_FLAGS + TINY[:-2]

    def zero_update_step(mesh, **kw):
        def step(state, batch, rng):
            zeros = jax.tree_util.tree_map(jnp.zeros_like, state.params)
            return state.apply_gradients(zeros, state.batch_stats), {k: 0.0 for k in ("tot", "hm", "reg",
                                                                                       "tracking")}
        return step

    saved = jtrainer.create_model, jtrainer.make_parallel_train_step, jcli.make_batch_fn
    jtrainer.create_model = lambda model_cfg: _TwoParameterModel()
    jtrainer.make_parallel_train_step = zero_update_step
    jcli.make_batch_fn = lambda cfg, camera_k: (lambda rng, raw: {})
    try:
        _, _, _, logged = _two_runs(jcli.main, argv, out, "")
    finally:
        jtrainer.create_model, jtrainer.make_parallel_train_step, jcli.make_batch_fn = saved
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {"out": out, "logged": logged, "records": records}


def test_cli_trains_validates_and_writes_its_artifacts(run_a):
    out = run_a["out"]
    assert run_a["first"]["iters_per_epoch"] == 3 and run_a["first"]["state"].step == 6
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["epoch_1.pt", "epoch_2.pt"]
    recs = run_a["first_records"]
    train = [r for r in recs if r["prefix"] == "train"]
    val = [r for r in recs if r["prefix"] == "val"]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5, 6] and [r["step"] for r in val] == [3, 6]
    loss_keys = {"tot", "hm", "reg", "tracking"}
    assert all(set(r) == {"ts", "step", "prefix"} | loss_keys for r in train)
    kp_keys = {"kp_found_inframe", "kp_missing_inframe", "kp_l2_mean_px", "kp_pck_auc_12px"}
    assert all(set(r) == {"ts", "step", "prefix"} | loss_keys | kp_keys for r in val)
    assert all(np.isfinite(r[k]) for r in recs for k in loss_keys)
    assert val[0]["kp_found_inframe"] + val[0]["kp_missing_inframe"] == 2 * 2 * 7  # 2 batches of 2, 7 keypoints
    viz = sorted(os.listdir(os.path.join(out, "viz")))
    assert viz == [f"train_mosaic_{s:07d}.png" for s in (1, 3, 4, 6, 7, 9)]  # the resumed epoch: 7, 9
    assert np.asarray(Image.open(os.path.join(out, "viz", viz[0]))).shape == (64, 3 * 64 + 4, 3)


def test_cli_resume_continues_the_step_and_replays_the_step_decay(run_a, jax_resume):
    """--resume as the JAX CLI does it: the epoch loop restarts at 1, the
    step, the schedule and Adam go on from the checkpoint."""
    state = run_a["second"]["state"]
    assert state.step == 9 and state.schedule_count == 9
    # the epoch and iteration of every step, as both CLIs print them
    assert run_a["logged"] == jax_resume["logged"] == [(1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2),
                                                       (1, 0), (1, 1), (1, 2)]
    with open(os.path.join(run_a["out"], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs if r["prefix"] == "train"]
    assert steps == [r["step"] for r in jax_resume["records"] if r["prefix"] == "train"] == list(range(1, 10))
    ckpts = sorted(os.listdir(os.path.join(run_a["out"], "ckpt")))
    assert [c[:-len(".pt")] for c in ckpts] == sorted(os.listdir(os.path.join(jax_resume["out"], "ckpt")))
    # the learning rate of every update: the JAX schedule at the update's
    # step (the JAX steps are those its metrics record, each after its update)
    assert [s for s, _ in run_a["lrs"]] == [s - 1 for s in steps] == list(range(9))
    ref = jsched.step_decay_schedule(1.25e-4, [1], 3)
    for step, lr in run_a["lrs"]:
        r = float(ref(step))
        assert abs(lr - r) <= np.spacing(np.float32(r)), (step, lr, r)
    assert run_a["lrs"][2][1] == pytest.approx(1.25e-4) and run_a["lrs"][3][1] == pytest.approx(1.25e-5)
    assert state.optimizer.state[next(state.model.parameters())]["step"].item() == 9  # Adam restored


def test_cli_checkpoint_runs_through_the_inference_cli(run_a, sets, tmp_path):
    res = tinfer.main(["--dataset", sets["tsyn"], "--ckpt", os.path.join(run_a["out"], "ckpt", "epoch_1.pt"),
                       "--output_dir", str(tmp_path / "infer")] + TINY)
    km = res["keypoint_metrics"]
    assert km["num_gt_inframe"] + km["num_gt_outframe"] == 2 * 4 * 7


def test_cli_depth_and_kuka(sets, tmp_path):
    res = tcli.main(["--dataset", os.path.join(sets["tdepth"], "panda-depth"), "--output_dir",
                     str(tmp_path / "depth"), "--depth", "--num_epochs", "1", "--batch_size", "2",
                     "--log_every", "1", "--image_log_every", "0", "--num_workers", "1"] + TINY)
    assert res["state"].model.cfg.num_classes == 42 and res["state"].step == 1
    assert os.path.exists(tmp_path / "depth" / "ckpt" / "epoch_1.pt")
    assert not os.path.exists(tmp_path / "depth" / "viz")
    out = str(tmp_path / "kuka")
    kuka = ["--robot", "kuka"] + TINY
    res = tcli.main(["--dataset", sets["tkuka"], "--output_dir", out, "--num_epochs", "1", "--batch_size", "2",
                     "--log_every", "1", "--num_devices", "1"] + kuka)
    assert res["state"].model.cfg.num_classes == 9 and res["state"].step == 2
    results = tinfer.main(["--dataset", sets["tkuka"], "--ckpt", os.path.join(out, "ckpt", "epoch_1.pt"),
                           "--output_dir", str(tmp_path / "kuka_res")] + kuka)
    km = results["keypoint_metrics"]
    assert km["num_gt_inframe"] + km["num_gt_outframe"] == 2 * 3 * 9


@pytest.mark.parametrize("flags", [["--bf16", "--depth"], ["--phase", "Dream", "--arch", "dlaseg_34"],
                                   ["--arch", "dreamhourglass_34", "--phase", "CenterNet"],
                                   ["--arch", "resnetsimple_34", "--phase", "Dream"],
                                   ["--phase", "Dream", "--arch", "dreamhourglass_34"],
                                   ["--dcn_chunks", "2"], ["--dcn_remat"]])
def test_cli_unported_flags_raise(sets, tmp_path, flags):
    """Every flag is ported. The DREAM baselines and the Dream phase: a
    single-image wiring trains one epoch, but ResnetSimple under Dream,
    whose input/2 map the input/4 targets do not fit, raises ValueError at
    its first loss, where the JAX step fails on the shapes. --bf16 --depth:
    a 42-keypoint model trains one epoch in bf16 on the depth set, its
    masters float32. --dcn_chunks and --dcn_remat (the DCN's memory knobs)
    train one epoch."""
    depth = ["--dataset", os.path.join(sets["tdepth"], "panda-depth"), "--batch_size", "2"]
    argv = ["--dataset", sets["tsyn"], "--output_dir", str(tmp_path), "--num_epochs", "1",
            "--image_log_every", "0"] + TINY + flags + (depth if "--depth" in flags else [])
    if "resnetsimple_34" in flags:
        with pytest.raises(ValueError, match="input/2"):
            tcli.main(argv)
    else:
        res = tcli.main(argv)
        assert res["state"].step == res["iters_per_epoch"] > 0
        assert os.path.exists(os.path.join(str(tmp_path), "ckpt", "epoch_1.pt"))
        if "--depth" in flags:
            assert res["state"].model.cfg.num_classes == 42
            assert all(p.dtype == torch.float32 for p in res["state"].model.parameters())
        if "--dcn_chunks" in flags or "--dcn_remat" in flags:
            cfg = res["state"].model.cfg
            assert (cfg.dcn_chunks, cfg.dcn_remat) == ((2, False) if "--dcn_chunks" in flags else (1, True))


def test_cli_refuses_what_it_cannot_run(sets, tmp_path):
    base = ["--dataset", sets["tsyn"], "--output_dir", str(tmp_path / "o"), "--num_epochs", "1"] + TINY
    os.makedirs(tmp_path / "orbax_dir")
    with pytest.raises(NotImplementedError, match="orbax"):
        tcli.main(base + ["--resume", str(tmp_path / "orbax_dir")])
    with pytest.raises(SystemExit):
        tcli.main(base + ["--coordinator", "localhost:1"])
    with pytest.raises(SystemExit, match="mesh.num_devices 2"):
        tcli.main(base + ["--num_devices", "2"])
    assert tcli.build_config(tcli.parse_args(base + ["--num_devices", "2"])).mesh.num_devices == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["--dataset", sets["tsyn"], "--output_dir", str(tmp_path / "c"), "--device", "cuda"])
