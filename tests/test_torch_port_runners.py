"""Port parity: the feature-cache runner (`make_cached_video_detector`) and
the batched-video runner (`make_batched_video_detector`) on the CPU against
the JAX package's runners, tiny SGTAPose (64x64 input, full widths) with the
same seeded weights, on synthetic 640x360 videos.

Cached runner: closed loop from ground-truth initial keypoints, with the PnP
warm start on (the fast path the JAX benchmark runs), over 2 frames: frame 0
reuses its own trunk features, frame 1 the cached ones. (Later frames feed
random-weight detections back into PnP: 4-5 mutually inconsistent points,
whose optimum differs between the backends by whole pixels, ROADMAP.md
Queue 3.) Bars: float32 at the exact detector's (sentinel patterns equal, raw
keypoints <= 0.05 px, scores <= 1e-4); bf16 model against the JAX bf16
variables: sentinel patterns equal, raw keypoints <= 0.25 px (a bf16 unit in
the last place of the reg head is ~2^-9 output px, ~5.3 raw px per output px;
measured 0.06 px), scores <= 4e-3 (two bf16 units at a score of 0.3;
measured 1e-3).

Batched runner: 3 teacher-forced videos, each with its own motion, teacher
keypoints and initial keypoints, against the JAX `vmap` runner (bars of the
exact detector) and against 3 single-video port runs: post-sigmoid heatmaps
and scores within 1e-5, raw keypoints within 1e-5 relative (a float32 unit in
the last place of a 300 px coordinate is 3e-5 px; the batched PnP sums in
another order than a batch of one).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.infer import detector as jdet
from sgtapose_tpu.utils.precision import bf16_inference_variables
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.infer import detector as tdet
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.utils.precision import bf16_inference_model
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, jax_cfg, port_cfg

RAW_HW = (tsyn.RAW_H, tsyn.RAW_W)


def _warm(cfg):
    return dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, pnp_warm_start=True))


@functools.lru_cache(maxsize=None)
def _video(seed: int, T: int):
    """(raw frames, GT projections, robot-frame keypoints) as numpy."""
    rs = np.random.RandomState(seed)
    q0 = np.array([0.9, 0.3, -0.2, 0.1], np.float32) + (0.1 * rs.randn(4)).astype(np.float32)
    t0 = np.array([0.02, -0.3, 2.0], np.float32) + (0.05 * rs.randn(3)).astype(np.float32)
    dq = (rs.randn(4) * 0.01).astype(np.float32)
    dt = (rs.randn(3) * 0.01).astype(np.float32)
    projs, imgs, _ = tsyn.sequence_from_motion(*(torch.from_numpy(a) for a in (q0, t0, dq, dt)), T)
    x3d = np.tile(np.asarray(tsyn.SKELETON, np.float32)[None], (T, 1, 1))
    return imgs.numpy(), projs.numpy(), x3d


def _port_model(bf16: bool):
    _, variables = flax_model_and_variables("dcn")
    model = SGTAPose(port_cfg("dcn")).eval()
    load_flax_variables(model, variables)
    return bf16_inference_model(model) if bf16 else model


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_cached_runner_matches_jax(bf16):
    raw, projs, x3d = _video(0, 2)
    flax_model, variables = flax_model_and_variables("dcn")
    jcfg = _warm(JaxConfig(model=jax_cfg("dcn")))
    if bf16:
        variables = bf16_inference_variables(jax.tree_util.tree_map(jnp.asarray, variables))
    images_j, _, _ = jdet.preprocess_frames(jnp.asarray(raw), jcfg)
    ref = jdet.make_cached_video_detector(flax_model, variables, jcfg, np.asarray(tsyn.camera_K()),
                                          RAW_HW)(
        jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), init_kps=jnp.asarray(projs[0])))

    pcfg = _warm(PortConfig(model=port_cfg("dcn")))
    images_t, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    detector = tdet.make_cached_video_detector(_port_model(bf16), pcfg, tsyn.camera_K(), RAW_HW,
                                               device="cpu")
    port = detector(tdet.VideoFrames(images=images_t, x3d=torch.from_numpy(x3d),
                                     init_kps=torch.from_numpy(projs[0])))
    kj, kt = np.asarray(ref.detected_kps), port.detected_kps.numpy()
    valid = kj > tdet.KP_SENTINEL
    assert valid.all(-1).sum() >= 4  # detections feed the frame-1 prior
    np.testing.assert_array_equal(kt > tdet.KP_SENTINEL, valid)
    np.testing.assert_allclose(kt[valid], kj[valid], atol=0.25 if bf16 else 0.05)
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores), atol=4e-3 if bf16 else 1e-4)


def test_cached_runner_refuses_teacher_forcing_and_runs_the_trunk_once():
    raw, projs, x3d = _video(0, 2)
    pcfg = PortConfig(model=port_cfg("dcn"))
    images, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    model = _port_model(False)
    detector = tdet.make_cached_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu")
    with pytest.raises(ValueError, match="teacher"):
        detector(tdet.VideoFrames(images=images, x3d=torch.from_numpy(x3d),
                                  teacher_kps=torch.from_numpy(projs)))
    batches = []
    handle = model.base.register_forward_hook(lambda m, i, o: batches.append(i[0].shape[0]))
    try:
        detector(tdet.VideoFrames(images=images, x3d=torch.from_numpy(x3d)))
    finally:
        handle.remove()
    assert batches == [1, 1]  # one trunk image per frame (the exact runner passes 2)


@functools.lru_cache(maxsize=None)
def _batched_runs():
    T, seeds = 3, (1, 2, 3)
    vids = [_video(s, T) for s in seeds]
    raw = np.stack([v[0] for v in vids])
    projs = np.stack([v[1] for v in vids])
    x3d = np.stack([v[2] for v in vids])
    flax_model, variables = flax_model_and_variables("dcn")
    jcfg = JaxConfig(model=jax_cfg("dcn"))
    images_j = jnp.stack([jdet.preprocess_frames(jnp.asarray(r), jcfg)[0] for r in raw])
    ref = jdet.make_batched_video_detector(flax_model.apply, variables, jcfg,
                                           np.asarray(tsyn.camera_K()), RAW_HW)(
        jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), init_kps=jnp.asarray(projs[:, 0]),
                         teacher_kps=jnp.asarray(projs)))

    pcfg = PortConfig(model=port_cfg("dcn"))
    model = _port_model(False)
    images_t, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    videos = tdet.VideoFrames(images=images_t, x3d=torch.from_numpy(x3d),
                              init_kps=torch.from_numpy(projs[:, 0]),
                              teacher_kps=torch.from_numpy(projs))
    batched = tdet.make_batched_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu",
                                               debug_outputs=True)(videos)
    single = tdet.make_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu",
                                      debug_outputs=True)
    singles = [single(tdet.VideoFrames(*(x[v] for x in videos))) for v in range(len(seeds))]
    return ref, batched, singles


def test_batched_runner_matches_jax():
    ref, port, _ = _batched_runs()
    kj, kt = np.asarray(ref.detected_kps), port.detected_kps.numpy()
    assert kt.shape == kj.shape == (3, 3, 7, 2)
    valid = kj > tdet.KP_SENTINEL
    assert valid.any()
    np.testing.assert_array_equal(kt > tdet.KP_SENTINEL, valid)
    np.testing.assert_allclose(kt[valid], kj[valid], atol=0.05)
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores), atol=1e-4)
    np.testing.assert_allclose(port.tracking.numpy(), np.asarray(ref.tracking), atol=1e-3)


def test_batched_runner_matches_single_video_runs():
    _, batched, singles = _batched_runs()
    for v, single in enumerate(singles):
        np.testing.assert_allclose(batched.debug_hm[v].numpy(), single.debug_hm.numpy(), atol=1e-5)
        np.testing.assert_allclose(batched.debug_pre_hm[v].numpy(), single.debug_pre_hm.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(batched.scores[v].numpy(), single.scores.numpy(), atol=1e-5)
        np.testing.assert_allclose(batched.detected_kps[v].numpy(), single.detected_kps.numpy(),
                                   rtol=1e-5)
