"""Port parity: int8 serving in the streaming runners and the CLIs, on the
CPU, tiny SGTAPose (64x64 input) with the same seeded weights as the JAX
package's, on synthetic 640x360 videos.

* The exact runner, teacher-forced over 3 frames (priors independent of
  the detections), and the feature-cache runner, closed loop from the
  ground-truth keypoints with the PnP warm start over 2 frames, both with
  `quant="int8"` and static scales calibrated on the port's model (the
  same numbers on both sides): JAX's runners take them through the wrapped
  apply (`quantized_apply`) and `make_cached_video_detector(quant=...)`.
  The int8 noise of the decoder (tests/test_torch_port_int8.py: the two
  frameworks' int8 heads are two draws of the same quantization noise) sets
  the bars: the post-sigmoid heatmaps within JAX's own int8-vs-float gap of
  the same run (max), the valid-detection patterns equal, raw keypoints
  within 0.5 px where valid (measured 0.07 and 0.03 px; a heatmap
  difference of 1e-3 at a peak moves the decoded sub-pixel peak by
  hundredths of an output px, 0.5 raw px is ~0.08 output px), scores within
  the heatmaps' bar, or 2e-3 in the cached run (measured 1.8e-4 in both).
* The mapping of sites to scales: with `groups` = V (the batched runner's
  V videos stepped together) a dynamic scale is taken per video, as JAX's
  vmap of one video's runner takes it: over 3 videos' stacked inputs, the
  trunk's scales equal each video's own (1e-6 relative: the same
  arithmetic at another batch size), where groups 1 takes one over the
  batch; the
  batched runner's stems take each video's own scales. (Detections are not
  compared across batch sizes: float32 rounding at another batch size
  moves a few x_q across a rounding boundary in the decoder, and with
  random weights a keypoint can then decode at another of two near-equal
  peaks.)
* `cli/infer.main --quant int8 --quant_static --quant_min_ch 64` equals the
  exact runner with the same calibration, and `cli/train_demo.main
  --quant_train` trains and evaluates under int8.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.infer import detector as jdet
from sgtapose_tpu.models import layers as jlayers
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.eval import synthetic_eval as tsev
from sgtapose_tpu_torch.infer import detector as tdet
from sgtapose_tpu_torch.models import layers as tlayers
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, jax_cfg, port_cfg

RAW_HW = (tsyn.RAW_H, tsyn.RAW_W)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _warm(cfg):
    return dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, pnp_warm_start=True))


@functools.lru_cache(maxsize=None)
def _video(seed: int, T: int):
    rs = np.random.RandomState(seed)
    q0 = np.array([0.9, 0.3, -0.2, 0.1], np.float32) + (0.1 * rs.randn(4)).astype(np.float32)
    t0 = np.array([0.02, -0.3, 2.0], np.float32) + (0.05 * rs.randn(3)).astype(np.float32)
    dq = (rs.randn(4) * 0.01).astype(np.float32)
    dt = (rs.randn(3) * 0.01).astype(np.float32)
    projs, imgs, _ = tsyn.sequence_from_motion(*(torch.from_numpy(a) for a in (q0, t0, dq, dt)), T)
    x3d = np.tile(np.asarray(tsyn.SKELETON, np.float32)[None], (T, 1, 1))
    return imgs.numpy(), projs.numpy(), x3d


@functools.lru_cache(maxsize=None)
def _model_and_scales():
    flax_model, variables = flax_model_and_variables("dcn")
    model = SGTAPose(port_cfg("dcn")).eval()
    load_flax_variables(model, variables)
    cfg = PortConfig(model=port_cfg("dcn"))
    scales = tlayers.calibrate(model, tsev.calibration_inputs(cfg, n_frames=2, device="cpu"))
    return flax_model, variables, model, scales


def _check(port, ref, ref_float=None):
    kj, kt = np.asarray(ref.detected_kps), port.detected_kps.numpy()
    valid = kj > tdet.KP_SENTINEL
    assert valid.all(-1).sum() >= 4
    np.testing.assert_array_equal(kt > tdet.KP_SENTINEL, valid)
    np.testing.assert_allclose(kt[valid], kj[valid], atol=0.5)
    bar = 2e-3
    if ref_float is not None:
        bar = np.abs(np.asarray(ref.debug_hm) - np.asarray(ref_float.debug_hm)).max()
        assert 0 < bar < 0.05
        assert np.abs(port.debug_hm.numpy() - np.asarray(ref.debug_hm)).max() <= bar
    assert np.abs(port.scores.numpy() - np.asarray(ref.scores)).max() <= bar


def test_exact_runner_int8_static_matches_jax():
    flax_model, variables, model, scales = _model_and_scales()
    raw, projs, x3d = _video(0, 3)
    jcfg = JaxConfig(model=jax_cfg("dcn"))
    images_j, _, _ = jdet.preprocess_frames(jnp.asarray(raw), jcfg)
    video_j = jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), teacher_kps=jnp.asarray(projs))
    K = np.asarray(tsyn.camera_K())
    ref_float = jdet.make_video_detector(flax_model.apply, variables, jcfg, K, RAW_HW, debug_outputs=True)(video_j)
    ref = jdet.make_video_detector(jlayers.quantized_apply(flax_model.apply, "int8", scales=scales), variables,
                                   jcfg, K, RAW_HW, debug_outputs=True)(video_j)
    pcfg = PortConfig(model=port_cfg("dcn"))
    images_t, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    port = tdet.make_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu", debug_outputs=True,
                                    quant="int8", quant_scales=scales)(
        tdet.VideoFrames(images=images_t, x3d=torch.from_numpy(x3d), teacher_kps=torch.from_numpy(projs)))
    _check(port, ref, ref_float)


def test_cached_runner_int8_static_matches_jax():
    flax_model, variables, model, scales = _model_and_scales()
    raw, projs, x3d = _video(0, 2)
    jcfg = _warm(JaxConfig(model=jax_cfg("dcn")))
    images_j, _, _ = jdet.preprocess_frames(jnp.asarray(raw), jcfg)
    video_j = jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), init_kps=jnp.asarray(projs[0]))
    K = np.asarray(tsyn.camera_K())
    ref = jdet.make_cached_video_detector(flax_model, variables, jcfg, K, RAW_HW, quant="int8",
                                          quant_scales=scales)(video_j)
    pcfg = _warm(PortConfig(model=port_cfg("dcn")))
    images_t, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    port = tdet.make_cached_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu", quant="int8",
                                           quant_scales=scales)(
        tdet.VideoFrames(images=images_t, x3d=torch.from_numpy(x3d), init_kps=torch.from_numpy(projs[0])))
    _check(port, ref)


class _ScaleLog:
    """Records every dynamic activation scale (`layers.activation_scale`)."""

    real = staticmethod(tlayers.activation_scale)

    def __init__(self, mp):
        self.scales = []
        mp.setattr(tlayers, "activation_scale", lambda *a, **k: self.scales.append(self.real(*a, **k)) or
                   self.scales[-1])


def test_dynamic_scales_are_per_video_with_groups(monkeypatch):
    """The trunk's 38 sites over 3 videos' stacked [pre; cur] inputs: with
    groups 3, each video's scale is its own single-video run's (1e-6
    relative: the same values up to float32 rounding at another batch
    size); with groups 1, one scale over the batch."""
    from torch_port_common import model_inputs

    _, _, model, _ = _model_and_scales()
    videos = [[torch.from_numpy(a) for a in model_inputs(seed)] for seed in (4, 5, 6)]
    videos[1] = [3.0 * a for a in videos[1]]  # its own activation range
    trunk = lambda v: (torch.cat([v[1], v[0]]), torch.cat([v[2], v[3]]))  # noqa: E731 (the runner's [pre; cur])
    imgs = torch.cat([v[1] for v in videos] + [v[0] for v in videos])
    hms = torch.cat([v[2] for v in videos] + [v[3] for v in videos])
    logs = {}
    with torch.no_grad():
        for name, groups, runs in (("grouped", 3, [(imgs, hms)]), ("pooled", 1, [(imgs, hms)]),
                                   ("single", 1, [trunk(v) for v in videos])):
            log = _ScaleLog(monkeypatch)
            with tlayers.quantized("int8", groups=groups):
                for run in runs:
                    model.trunk(*run)
            logs[name] = log.scales
    assert len(logs["grouped"]) == len(logs["pooled"]) == 38 and len(logs["single"]) == 3 * 38
    for site in range(38):
        single = torch.stack([logs["single"][v * 38 + site][0] for v in range(3)])  # (3,): one per video
        np.testing.assert_allclose(logs["grouped"][site].numpy(), single.repeat(2).numpy(), rtol=1e-6)
        np.testing.assert_allclose(logs["pooled"][site].numpy(), single.max().repeat(6).numpy(), rtol=1e-6)
    assert not torch.equal(logs["grouped"][0], logs["pooled"][0])


def test_batched_runner_int8_takes_scales_per_video(monkeypatch):
    """The batched runner over 3 videos (2 frames, teacher-forced): the two
    stems' scales each frame step are each video's scales of its own
    single-video run (1e-5 relative: the same images, and priors rendered
    from a batched PnP that sums in another order)."""
    _, _, model, _ = _model_and_scales()
    pcfg = PortConfig(model=port_cfg("dcn"))
    vids = [_video(seed, 2) for seed in (1, 2, 3)]
    images, _, _ = tdet.preprocess_frames(torch.from_numpy(np.stack([v[0] for v in vids])), pcfg)
    x3d = torch.from_numpy(np.stack([v[2] for v in vids]))
    teacher = torch.from_numpy(np.stack([v[1] for v in vids]))
    log = _ScaleLog(monkeypatch)
    batched = tdet.make_batched_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu", quant="int8")(
        tdet.VideoFrames(images=images, x3d=x3d, teacher_kps=teacher))
    assert batched.detected_kps.shape == (3, 2, 7, 2)
    per_step = len(log.scales) // 2
    assert per_step == 57
    single = tdet.make_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu", quant="int8")
    for v in range(3):
        start = len(log.scales)
        single(tdet.VideoFrames(images=images[v], x3d=x3d[v], teacher_kps=teacher[v]))
        for t in range(2):
            for site in (0, 1):  # the image stem and the prior-heatmap stem, over [pre; cur]
                got = log.scales[t * per_step + site][v::3]
                np.testing.assert_allclose(got.numpy(), log.scales[start + t * per_step + site].numpy(), rtol=1e-5)


def test_infer_cli_int8_static_min_ch_equals_the_runner(tmp_path):
    from sgtapose_tpu_torch.cli import infer as tinfer
    from sgtapose_tpu_torch.data import loaders
    from sgtapose_tpu_torch.models.sgta import create_model

    data = str(tmp_path / "syn")
    tsyn.write_synthetic_dataset(data, 1, 3, device="cpu")
    tiny = ["--device", "cpu", "--input_res", "64", "--kernel_list", "3,3,3,1,1,1"]
    res = tinfer.main(["--dataset", data, "--output_dir", str(tmp_path / "out"), "--quant", "int8",
                       "--quant_static", "--quant_min_ch", "64"] + tiny)
    with open(tmp_path / "out" / "dt_and_gt.json") as f:
        det = np.asarray(__import__("json").load(f)["detections"])
    assert det.shape == (3, 7, 2) and res["keypoint_metrics"]["num_gt_inframe"] > 0

    args = tinfer.parse_args(["--dataset", data] + tiny)
    cfg = tinfer.make_config(args)
    model = create_model(cfg.model, device="cpu", seed=0)
    scales = tlayers.calibrate(model, tsev.calibration_inputs(cfg, device="cpu"))
    assert len(scales) == 57
    (vname, frames), = tinfer.list_synthetic_videos(data).items()
    imgs = np.stack([loaders.load_image(f"{data}/{vname}/{f}_color.png") for f in frames])
    x3d = np.stack([loaders.load_seq_keypoints(f"{data}/{vname}/{f}_meta.json", "panda_synthetic",
                                               tinfer.KEYPOINT_NAMES["panda_synthetic"],
                                               np.asarray(tinfer.SYNTHETIC_CAMERA_K))["positions_wrt_robot"]
                    for f in frames]).astype(np.float32)
    images, _, _ = tdet.preprocess_frames(torch.from_numpy(imgs), cfg)
    runs = {}
    for min_ch in (64, 0):
        detector = tdet.make_video_detector(model, cfg, np.asarray(tinfer.SYNTHETIC_CAMERA_K), imgs.shape[1:3],
                                            device="cpu", debug_outputs=True, quant="int8", quant_scales=scales,
                                            quant_min_ch=min_ch)
        runs[min_ch] = detector(tdet.VideoFrames(images=images, x3d=torch.from_numpy(x3d)))
    np.testing.assert_array_equal(runs[64].detected_kps.numpy(), det)
    assert not torch.equal(runs[64].debug_hm, runs[0].debug_hm)  # the gate engaged


def test_train_demo_quant_train_trains_and_evaluates_in_int8(tmp_path):
    from sgtapose_tpu_torch.cli import train_demo

    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--input_res", "64", "--eval_videos", "1",
            "--eval_frames", "2", "--log_every", "1"]
    sites = []
    real = tlayers.take_site
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "take_site", lambda *a: sites.append(tlayers.quant_mode()) or real(*a))
        qat = train_demo.main(argv + ["--quant_train"])
    # 57 sites a forward: 2 training steps in int8_train, then 2 eval frames in int8
    assert sites == ["int8_train"] * 2 * 57 + ["int8"] * 2 * 57
    plain = train_demo.main(argv[:2] + ["--steps", "1"] + argv[4:8] + ["--eval_videos", "0"])
    # the first step's loss (the same weights): fake quantization moves it, by little
    q, p = qat["logged"][0]["tot"], plain["logged"][0]["tot"]
    assert q != p and abs(q - p) <= 1e-2 * abs(p)
    assert qat["results"]["keypoint_metrics"]["num_gt_inframe"] > 0
