"""Port parity of the DREAM baselines on the CPU (`models/dream_baselines.py`,
`data/image_space.py`, `infer/dream_detector.py`, decode without a reg head,
`convert_dream_state_dict`, the Dream training phase and both CLIs), against
the JAX package from the same seeded numpy weights (zero-initialised ones
perturbed) and inputs, at 64x64 with full channel widths and 7 keypoints;
ResnetSimple cut in depth only (blocks (1, 1, 2, 1)).

Bars: heads within HEAD_ATOL = 1e-3 (float32 convolutions summed in another
order through up to 20 layers), BatchNorm running statistics within 1e-5
after one train-mode call, both sides in float64 (flax's momentum 0.1:
running = 0.1 running + 0.9 batch); spatial_softmax within 1e-5; image_space exact in float64 (and the
PIL images equal); the detector's accept masks equal, raw coordinates within
1e-3 px, scores within 1e-5; decode without reg as tests/test_torch_port_decode.py
(coordinates 1e-4, scores 1e-5); the converter bit for bit; the float64 Dream
step at the other phases' float64 bars (tests/torch_port_common.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sgtapose_tpu.config import Config as JaxConfig, ModelConfig as JaxModelConfig
from sgtapose_tpu.data import image_space as jis
from sgtapose_tpu.decode import peaks as jpeaks
from sgtapose_tpu.infer.dream_detector import make_dream_detector as jax_make_dream_detector
from sgtapose_tpu.models import dream_baselines as jdb
from sgtapose_tpu.train import trainer as jtrainer
from sgtapose_tpu.utils import torch_convert as jtc
from sgtapose_tpu_torch.cli import infer as tinfer, train as tcli
from sgtapose_tpu_torch.config import Config as PortConfig, ModelConfig as PortModelConfig
from sgtapose_tpu_torch.data import image_space as tis, synthetic as tsyn
from sgtapose_tpu_torch.decode import peaks as tpeaks
from sgtapose_tpu_torch.infer.dream_detector import make_dream_detector
from sgtapose_tpu_torch.models import dream_baselines as tdb
from sgtapose_tpu_torch.models.sgta import build_model, create_model
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.utils import torch_convert as ttc
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from test_torch_port_decode import _maps
from torch_port_common import check_phase_train_step, random_train_batch, seeded_flax_variables

HEAD_ATOL = 1e-3
RES = 64
BLOCKS = (1, 1, 2, 1)
# name -> (JAX module, port module)
MODULES = {
    "hourglass": lambda: (jdb.DreamHourglass(7), tdb.DreamHourglass(7)),
    "hourglass_deconv": lambda: (jdb.DreamHourglass(7, deconv_decoder=True), tdb.DreamHourglass(7, deconv_decoder=True)),
    "hourglass_full_output": lambda: (jdb.DreamHourglass(7, full_output=True), tdb.DreamHourglass(7, full_output=True)),
    "hourglass_skip": lambda: (jdb.DreamHourglass(7, skip_connections=True),
                               tdb.DreamHourglass(7, skip_connections=True)),
    "hourglass_deconv_skip": lambda: (jdb.DreamHourglass(7, deconv_decoder=True, skip_connections=True),
                                      tdb.DreamHourglass(7, deconv_decoder=True, skip_connections=True)),
    "resnet": lambda: (jdb.ResnetSimple(7, blocks=BLOCKS), tdb.ResnetSimple(7, blocks=BLOCKS)),
    "resnet_full": lambda: (jdb.ResnetSimple(7, full=True, blocks=BLOCKS),
                            tdb.ResnetSimple(7, full=True, blocks=BLOCKS)),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(seed=0, B=2):
    return np.random.RandomState(seed).randn(B, RES, RES, 3).astype(np.float32)


def _pair(name, seed=0):
    """(JAX module, its numpy variables, the port module with them)."""
    jmod, tmod = MODULES[name]()
    variables = seeded_flax_variables(jmod, [_image()[:1]], seed=seed)
    load_flax_variables(tmod, variables)
    return jmod, variables, tmod


# ---------------------------------------------------------------- modules ---


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_flax(name, train):
    jmod, variables, tmod = _pair(name)
    x = _image(1)
    if train:
        ref, mutated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jmod.apply(variables, jnp.asarray(x), train=False)
    got = tmod.train(train)(torch.from_numpy(x))
    assert set(got) == {"hm"}
    ref_hm = np.asarray(ref["hm"])
    down = {"hourglass": 4, "hourglass_skip": 4, "resnet": 2}.get(name, 1)
    assert ref_hm.shape == (2, RES // down, RES // down, 7)
    np.testing.assert_allclose(got["hm"].detach().numpy(), ref_hm, rtol=0, atol=HEAD_ATOL)
    assert np.abs(ref_hm).max() > 10 * HEAD_ATOL
    if train and "batch_stats" in variables:
        # the running statistics after one train-mode call, in float64: in
        # float32 flax's one-pass variance, E[x^2] - E[x]^2, is a few 1e-5
        # off the two-pass one at these maps' means
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        with jax.enable_x64(True):
            _, mutated = jmod.apply(f64, jnp.asarray(x, jnp.float64), train=True, mutable=["batch_stats"])
            after = {"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])}
        model64 = MODULES[name]()[1].double()
        load_flax_variables(model64, f64)
        model64.train()(torch.from_numpy(x).double())
        expect = MODULES[name]()[1].double()
        load_flax_variables(expect, dict(f64, **after))
        stats = [k for k in expect.state_dict() if k.endswith(("running_mean", "running_var"))]
        assert len(stats) > 20
        for k in stats:
            np.testing.assert_allclose(model64.state_dict()[k].numpy(), expect.state_dict()[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


def test_batchnorm_momentum_is_the_dream_modules_own():
    """The DREAM modules' BatchNorm keeps 0.1 of its running average, the
    DLA models' 0.9."""
    from sgtapose_tpu_torch.models.dla import BatchNorm

    bn = tdb.ResnetSimple(7, blocks=BLOCKS).bn1
    assert bn.flax_momentum == pytest.approx(0.1) and BatchNorm(4).flax_momentum == pytest.approx(0.9)
    x = torch.randn(2, 64, 5, 5, generator=torch.Generator().manual_seed(0)) + 3.0
    bn.train()(x)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.9 * x.mean((0, 2, 3)).numpy(), rtol=1e-5)


def test_spatial_softmax_matches_jax():
    maps = np.random.RandomState(2).rand(2, 30, 40, 7).astype(np.float32)
    for beta, pool in ((25.0, 7), (5.0, 1), (10.0, 3)):
        ref = np.asarray(jdb.spatial_softmax(jnp.asarray(maps), beta, pool))
        got = tdb.spatial_softmax(torch.from_numpy(maps), beta, pool).numpy()
        assert got.shape == (2, 7, 2)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# ------------------------------------------------------------ image space ---


@pytest.mark.parametrize("mode", ["none", "resize", "shrink", "shrink-and-crop"])
def test_image_space_matches_jax(mode):
    rs = np.random.RandomState(3)
    for raw, net_in in (((640, 360), (480, 480)), ((640, 480), (400, 400)), ((300, 500), (256, 128)),
                        ((1280, 720), (64, 64))):
        assert tis.resolution_after_preprocessing(raw, net_in, mode) == jis.resolution_after_preprocessing(
            raw, net_in, mode)
        pts = rs.uniform(-20, max(raw) + 20, (11, 2))
        for port_fn, jax_fn in ((tis.convert_keypoints_to_netin_from_raw, jis.convert_keypoints_to_netin_from_raw),
                                (tis.convert_keypoints_to_raw_from_netin, jis.convert_keypoints_to_raw_from_netin)):
            got, ref = port_fn(pts, raw, net_in, mode), jax_fn(pts, raw, net_in, mode)
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, ref)
        net_out = (net_in[0] // 4, net_in[1] // 4)
        np.testing.assert_array_equal(tis.convert_keypoints_to_netin_from_netout(pts, net_out, net_in),
                                      jis.convert_keypoints_to_netin_from_netout(pts, net_out, net_in))
        np.testing.assert_array_equal(tis.convert_keypoints_to_netout_from_netin(pts, net_in, net_out),
                                      jis.convert_keypoints_to_netout_from_netin(pts, net_in, net_out))
        img = Image.fromarray(rs.randint(0, 255, (raw[1], raw[0], 3), np.uint8))
        np.testing.assert_array_equal(np.asarray(tis.preprocess_image(img, net_in, mode)),
                                      np.asarray(jis.preprocess_image(img, net_in, mode)))
    assert tis.shrink_and_crop_resolution((640, 360), (480, 480)) == jis.shrink_and_crop_resolution(
        (640, 360), (480, 480)) == ((360, 360), (140, 0))
    with pytest.raises(ValueError, match="preprocessing mode"):
        tis.resolution_after_preprocessing((4, 4), (4, 4), "crop")


# ---------------------------------------------------- decode without reg ---


@pytest.mark.parametrize("coord_mode", ["reg", "avg", "logquad", "mean"])
def test_decode_without_reg_matches_jax(coord_mode):
    """use_reg=False: "logquad" stays, the reg-dependent modes decode as
    "avg", as JAX's; the reg head's values never enter."""
    hm, reg, trk = _maps()
    ref = jpeaks.decode_heatmaps(jnp.asarray(hm), jnp.asarray(reg), jnp.asarray(trk), use_reg=False,
                                 coord_mode=coord_mode)
    port = tpeaks.decode_heatmaps(torch.from_numpy(hm), torch.from_numpy(100 * reg), torch.from_numpy(trk),
                                  use_reg=False, coord_mode=coord_mode)
    same = tpeaks.decode_heatmaps(torch.from_numpy(hm), torch.from_numpy(reg), torch.from_numpy(trk),
                                  coord_mode="logquad" if coord_mode == "logquad" else "avg")
    valid = np.asarray(ref.valid)
    assert valid.any() and not valid.all()
    np.testing.assert_array_equal(port.valid.numpy(), valid)
    np.testing.assert_array_equal(port.coords_int.numpy(), np.asarray(ref.coords_int))
    np.testing.assert_allclose(port.coords.numpy(), np.asarray(ref.coords), atol=1e-4)
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores), atol=1e-5)
    np.testing.assert_array_equal(port.coords.numpy(), same.coords.numpy())


# --------------------------------------------------------------- detector ---


def _peaky_hourglass(mirror_symmetric: bool = False):
    """Hourglass variables whose output conv is rescaled so each class's map
    has one clear peak on the test frames: the logits scaled to a spread of
    ~12 and shifted so each class's largest logit on frame 0 sits at 2.2.
    mirror_symmetric: every kernel made symmetric in x, so the network
    commutes with a horizontal flip and flip_test's average, done right, is
    the map itself (with one peak per class, not two ambiguous halves)."""
    jmod, variables, tmod = _pair("hourglass", seed=4)
    if mirror_symmetric:
        variables = jax.tree_util.tree_map_with_path(
            lambda p, a: (a + a[:, ::-1]) / 2 if p[-1].key == "kernel" else a, variables)
        load_flax_variables(tmod, variables)
    frames = _raw_frames()
    x = torch.from_numpy(np.stack([_netin(f) for f in frames]))
    with torch.no_grad():
        logits = tmod.eval()(x)["hm"].numpy()
    scale = 12.0 / logits.std(axis=(0, 1, 2))
    shift = 2.2 - scale * logits[0].max(axis=(0, 1))
    out = variables["params"]["heads_0_out"]
    out["kernel"] = (out["kernel"] * scale).astype(np.float32)
    out["bias"] = (out["bias"] * scale + shift).astype(np.float32)
    load_flax_variables(tmod, variables)
    return jmod, variables, tmod


def _raw_frames():
    rs = np.random.RandomState(7)
    base = rs.randint(0, 255, (1, 36, 64, 3)).astype(np.float32)
    up = np.asarray(Image.fromarray(base[0].astype(np.uint8)).resize((640, 360), Image.BILINEAR))
    noise = rs.randint(-20, 20, (2, 360, 640, 3))
    return np.clip(up[None] + noise, 0, 255).astype(np.uint8)


def _netin(frame):
    from sgtapose_tpu_torch.infer.dream_detector import preprocess_dream_frames

    return preprocess_dream_frames(frame[None], (RES, RES))[0]


@pytest.mark.parametrize("flip_test", [False, True], ids=["single", "flip"])
def test_dream_detector_matches_jax(flip_test):
    jmod, variables, tmod = _peaky_hourglass(mirror_symmetric=flip_test)
    frames = _raw_frames()
    jcfg = JaxConfig(model=JaxModelConfig(arch="dreamhourglass", input_res=(RES, RES)))
    pcfg = PortConfig(model=PortModelConfig(arch="dreamhourglass", input_res=(RES, RES)))
    ref_kps, ref_scores = jax_make_dream_detector(lambda v, x: jmod.apply(v, x), variables, jcfg, (640, 360),
                                                  flip_test=flip_test)(frames)
    kps, scores = make_dream_detector(tmod.eval(), pcfg, (640, 360), flip_test=flip_test, device="cpu")(frames)
    assert kps.shape == (2, 7, 2) and kps.dtype == np.float64 and scores.shape == (2, 7)
    found = ref_kps[..., 0] > -999.0
    assert found.sum() >= 4, found
    np.testing.assert_array_equal(kps[..., 0] > -999.0, found)
    np.testing.assert_array_equal(kps[~found], ref_kps[~found])
    np.testing.assert_allclose(kps[found], ref_kps[found], rtol=0, atol=1e-3)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-5)
    # the shrink-and-crop keeps the centred 360x360: 140 px gone on each side
    assert kps[found][:, 0].min() >= 139.0 and kps[found][:, 0].max() <= 501.0


# -------------------------------------------------------------- converter ---


def _reference_state_dict(mapping, variables, seed=0):
    """A reference-format state dict (`module.`-prefixed, num_batches_tracked
    included) holding seeded values under the names of JAX's mapping, in
    torch's layouts."""
    rs = np.random.RandomState(seed)
    sd = {}
    for path, leaf in jtc._tree_paths(variables["params"]):
        shape = np.asarray(leaf).shape
        if path in mapping:
            ref, tf = mapping[path]
            if tf is jtc._conv:
                shape = (shape[3], shape[2], shape[0], shape[1])
            elif tf is jtc._deconv_w:
                shape = (shape[2], shape[3], shape[0], shape[1])
            sd[ref] = rs.randn(*shape).astype(np.float32)
        else:
            head, leaf_name = path.rsplit("/", 1)
            prefix = mapping[head][0]
            sd[f"{prefix}.{jtc._BN_PARAM[leaf_name]}"] = rs.randn(*shape).astype(np.float32)
            sd[f"{prefix}.running_mean"] = rs.randn(*shape).astype(np.float32)
            sd[f"{prefix}.running_var"] = rs.rand(*shape).astype(np.float32) + 0.5
            sd[f"{prefix}.num_batches_tracked"] = np.array(7)
    return {f"module.{k}": v for k, v in sd.items()}


@pytest.mark.parametrize("name,bgr", [("hourglass", False), ("hourglass_deconv", False),
                                      ("hourglass_full_output", True), ("resnet", False), ("resnet_full", True)])
def test_convert_dream_state_dict_matches_jax(name, bgr):
    jmod, variables, tmod = _pair(name)
    if name.startswith("resnet"):
        kw = dict(arch="resnetsimple", full_output=name == "resnet_full", blocks=BLOCKS)
        mapping = jtc._resnet_simple_map(kw["full_output"], BLOCKS)
    else:
        kw = dict(arch="dreamhourglass", deconv_decoder=name == "hourglass_deconv",
                  full_output=name == "hourglass_full_output")
        mapping = jtc._dream_hourglass_map(kw["deconv_decoder"], kw["full_output"])
    sd = _reference_state_dict(mapping, variables)
    params, stats, ref_report = jtc.convert_dream_state_dict(sd, variables["params"],
                                                             variables.get("batch_stats", {}), bgr_to_rgb=bgr, **kw)
    expect = MODULES[name]()[1]
    load_flax_variables(expect, {"params": params, "batch_stats": stats})
    report = ttc.convert_dream_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmod,
                                          bgr_to_rgb=bgr)
    assert report["n_converted"] == ref_report["n_converted"] == len([k for k in sd if "num_batches" not in k])
    assert report["missing"] == report["mismatched"] == report["unused_ref_keys"] == []
    want = expect.state_dict()
    for k, v in tmod.state_dict().items():
        assert torch.equal(v, want[k]), k
    first = "layer_0_1_down.conv0.weight" if name.startswith("hourglass") else "conv1.weight"
    flip = [2, 1, 0] if bgr else [0, 1, 2]
    src = sd["module." + ("layer_0_1_down.0.weight" if name.startswith("hourglass") else "conv1.weight")]
    np.testing.assert_array_equal(tmod.state_dict()[first].numpy(), src[:, flip])
    del sd["module.heads_0.4.bias" if name.startswith("hourglass") else "module.bn1.running_var"]
    with pytest.raises(ValueError, match="conversion incomplete"):
        ttc.convert_dream_state_dict(sd, tmod)
    with pytest.raises(ValueError, match="not a DREAM baseline"):
        ttc.convert_dream_state_dict(sd, torch.nn.Linear(2, 2))


# --------------------------------------------------------------- training ---


def test_dream_train_step_matches_jax(monkeypatch):
    check_phase_train_step("Dream", monkeypatch)


def test_resnetsimple_under_dream_is_refused_by_both():
    """ResnetSimple's map (input/2) against the pipeline's input/4 targets:
    the JAX step fails on the shapes, the port's raises ValueError."""
    jcfg = JaxConfig(model=JaxModelConfig(arch="resnetsimple", input_res=(RES, RES)))
    batch = {k: jnp.asarray(v) for k, v in random_train_batch(B=1).items()}
    state = jax.eval_shape(lambda: jtrainer.create_train_state_for_phase(jcfg, jax.random.PRNGKey(0), "Dream"))
    with pytest.raises((TypeError, ValueError)):
        jax.eval_shape(lambda s, b: jtrainer.train_step(s, b, jax.random.PRNGKey(1), phase="Dream"), state, batch)
    pcfg = PortConfig(model=PortModelConfig(arch="resnetsimple", input_res=(RES, RES)))
    tstate = ttrainer.create_train_state(pcfg, 0, device="cpu", phase="Dream")
    assert type(tstate.model) is tdb.ResnetSimple and tstate.model.blocks == (3, 4, 23, 3)
    with pytest.raises(ValueError, match="input/2"):
        ttrainer.train_step(tstate, {k: torch.from_numpy(v) for k, v in random_train_batch(B=1).items()},
                            phase="Dream")


def test_build_model_and_heads_of_the_dream_archs():
    """build_model routes both DREAM archs; the prediction heads give zeros
    where the model has no reg or tracking head, as JAX's do."""
    hg = build_model(PortModelConfig(arch="dreamhourglass", num_classes=9))
    rs = build_model(PortModelConfig(arch="resnetsimple"))
    assert type(hg) is tdb.DreamHourglass and hg.heads_0_out.out_channels == 9
    assert type(rs) is tdb.ResnetSimple and rs.head.out_channels == 7
    pcfg = PortConfig(model=PortModelConfig(arch="dreamhourglass", input_res=(RES, RES)))
    state = ttrainer.create_train_state(pcfg, 0, device="cpu", phase="Dream")
    batch = {k: torch.from_numpy(v) for k, v in random_train_batch(B=2).items()}
    stats, pred = ttrainer.eval_predict_step(state, batch, phase="Dream")
    assert stats["reg"].item() == 0.0 and stats["tracking"].item() == 0.0
    assert pred["hm"].shape == (2, 16, 16, 7)
    assert torch.equal(pred["reg"], torch.zeros(2, 16, 16, 2))
    assert torch.equal(ttrainer.predict_step(state, batch, phase="Dream")["tracking"], torch.zeros(2, 16, 16, 2))
    # the transposed convs drawn as flax draws them: lecun-normal over
    # (k, k, in, out), fan-in k * k * in
    w = create_model(PortModelConfig(arch="resnetsimple"), device="cpu").up0_deconv.weight
    assert 0.95 < w.std().item() * np.sqrt(2048 * 16) < 1.05


# ------------------------------------------------------------------- CLIs ---

TINY = ["--input_res", str(RES), "--device", "cpu"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dream_sets")
    train, val = str(root / "train"), str(root / "val")
    tsyn.write_synthetic_dataset(train, n_videos=1, n_frames=5, seed=0, device="cpu")
    tsyn.write_synthetic_dataset(val, n_videos=1, n_frames=3, seed=1, device="cpu")
    return train, val


def test_train_cli_dream_then_infer(dataset, tmp_path):
    """cli/train --phase Dream --arch dreamhourglass: one epoch with
    validation, a resume, then cli/infer --is_ct false on its checkpoint."""
    train, val = dataset
    out = str(tmp_path / "train")
    res = tcli.main(["--dataset", train, "--val_dataset", val, "--output_dir", out, "--phase", "Dream",
                     "--arch", "dreamhourglass", "--num_epochs", "1", "--batch_size", "2", "--log_every", "1",
                     "--image_log_every", "1"] + TINY)
    assert type(res["state"].model) is tdb.DreamHourglass and res["state"].step == 2
    ckpt = os.path.join(out, "ckpt", "epoch_1.pt")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train_rec = [r for r in records if r["prefix"] == "train"]
    val_rec = [r for r in records if r["prefix"] == "val"]
    assert train_rec and all(r["reg"] == 0.0 and np.isfinite(r["tot"]) for r in train_rec)
    assert len(val_rec) == 1 and val_rec[0]["reg"] == 0.0 and val_rec[0]["kp_found_inframe"] >= 0
    assert os.listdir(os.path.join(out, "viz"))
    res2 = tcli.main(["--dataset", train, "--output_dir", str(tmp_path / "resumed"), "--phase", "Dream",
                      "--arch", "dreamhourglass", "--num_epochs", "1", "--batch_size", "2", "--image_log_every", "0",
                      "--resume", ckpt] + TINY)
    assert res2["state"].step == 4
    results = tinfer.main(["--dataset", val, "--ckpt", ckpt, "--output_dir", str(tmp_path / "infer"),
                           "--is_ct", "false", "--arch", "dreamhourglass"] + TINY)
    assert results["keypoint_metrics"]["num_gt_inframe"] > 0


@pytest.mark.parametrize("flip", [False, True], ids=["single", "flip"])
def test_infer_cli_dream_mode(dataset, tmp_path, flip):
    """cli/infer --is_ct false (+- --flip_test): the artifacts, every frame's
    ground truth counted, the detector's stages timed; the detections are
    make_dream_detector's on the same frames."""
    _, val = dataset
    out = str(tmp_path / "res")
    argv = ["--dataset", val, "--output_dir", out, "--is_ct", "false", "--arch", "dreamhourglass"] + TINY
    results = tinfer.main(argv + (["--flip_test"] if flip else []))
    km = results["keypoint_metrics"]
    assert km["num_gt_inframe"] + km["num_gt_outframe"] == 3 * 7
    assert os.path.exists(os.path.join(out, "syn_analysis_results.txt"))
    assert {"preprocess", "forward", "decode", "convert", "detect"} <= set(results["timing"]["stage_s"])
    with open(os.path.join(out, "dt_and_gt.json")) as f:
        det = np.asarray(json.load(f)["detections"])
    args = tinfer.parse_args(argv)
    args.phase = "Dream"
    cfg = tinfer.make_config(args)
    model = tinfer.load_model(args, cfg, torch.device("cpu"))
    from sgtapose_tpu_torch.data import loaders

    frames = sorted(f for f in os.listdir(os.path.join(val, "00000")) if f.endswith("_color.png"))
    imgs = np.stack([loaders.load_image(os.path.join(val, "00000", f)) for f in frames])
    kps, _ = make_dream_detector(model, cfg, (imgs.shape[2], imgs.shape[1]), flip_test=flip, device="cpu")(imgs)
    np.testing.assert_array_equal(det, kps)
