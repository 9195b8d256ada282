"""Port parity: the exact streaming detector (`make_video_detector`) on the
CPU against the JAX `lax.scan` detector, tiny SGTAPose (64x64 input) with
the same seeded weights, on a synthetic 640x360 video.

The video runs teacher-forced (the prior PnP consumes the ground-truth
projections every frame; these random weights do decode peaks), then
closed-loop from ground-truth initial keypoints, with debug outputs on. In
the closed-loop run the hm head keeps its prior bias (-4.6), so frames after
the first decode nothing and run cold (zero priors, tied top-k, duplicate
scatter ids): feeding random-weight detections back into PnP gives it 4-5
mutually inconsistent points, where EPnP's nullspace is degenerate and the
optimum depends on eigh's basis, which differs between the backends (the
prior would then differ by whole pixels; see ROADMAP.md Queue 3).

Bars: warped frames <= 1e-4; rendered priors <= 1e-4 (exact renders of PnP
reprojections that agree to ~1e-3 px); post-sigmoid heatmaps <= 1e-4;
sentinel patterns equal and raw keypoints <= 0.05 px where valid.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.infer import detector as jdet
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.infer import detector as tdet
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, jax_cfg, port_cfg

T = 4
RAW_HW = (tsyn.RAW_H, tsyn.RAW_W)


@functools.lru_cache(maxsize=None)
def _video():
    """(raw frames, GT projections, robot-frame keypoints) as numpy."""
    rs = np.random.RandomState(0)
    q0 = np.array([0.9, 0.3, -0.2, 0.1], np.float32)
    t0 = np.array([0.02, -0.3, 2.0], np.float32)
    dq = (rs.randn(4) * 0.01).astype(np.float32)
    dt = (rs.randn(3) * 0.01).astype(np.float32)
    projs, imgs, _ = tsyn.sequence_from_motion(*(torch.from_numpy(a) for a in (q0, t0, dq, dt)), T)
    x3d = np.tile(np.asarray(tsyn.SKELETON, np.float32)[None], (T, 1, 1))
    return imgs.numpy(), projs.numpy(), x3d


@functools.lru_cache(maxsize=None)
def _runs(teacher: bool):
    import jax.numpy as jnp

    raw, projs, x3d = _video()
    flax_model, variables = flax_model_and_variables("dcn")
    if not teacher:
        variables = copy.deepcopy(variables)
        variables["params"]["hm"]["Conv_1"]["bias"][:] = -4.6
    jcfg = JaxConfig(model=jax_cfg("dcn"))
    images_j, _, _ = jdet.preprocess_frames(jnp.asarray(raw), jcfg)
    kw = dict(teacher_kps=jnp.asarray(projs)) if teacher else dict(init_kps=jnp.asarray(projs[0]))
    ref = jdet.make_video_detector(flax_model.apply, variables, jcfg, np.asarray(tsyn.camera_K()),
                                   RAW_HW, debug_outputs=True)(
        jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), **kw))

    pcfg = PortConfig(model=port_cfg("dcn"))
    model = SGTAPose(pcfg.model).eval()
    load_flax_variables(model, variables)
    images_t, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    kw = (dict(teacher_kps=torch.from_numpy(projs)) if teacher
          else dict(init_kps=torch.from_numpy(projs[0])))
    port = tdet.make_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu",
                                    debug_outputs=True)(
        tdet.VideoFrames(images=images_t, x3d=torch.from_numpy(x3d), **kw))
    return np.asarray(images_j), images_t.numpy(), ref, port


@pytest.mark.parametrize("teacher", [True, False], ids=["teacher_forced", "closed_loop"])
def test_detector_matches_jax(teacher):
    images_j, images_t, ref, port = _runs(teacher)
    np.testing.assert_allclose(images_t, images_j, atol=1e-4)
    pre_j = np.asarray(ref.debug_pre_hm)
    pre_t = port.debug_pre_hm.numpy()
    assert pre_t.shape == pre_j.shape == (T, 64, 64, 1)
    # frame 0 renders the teacher / initial keypoints; later frames render
    # detections (teacher-forced) or nothing (closed loop, cold)
    assert pre_j[0].max() > 0.5 and (pre_j[1:].max() > 0.5) == teacher
    np.testing.assert_allclose(pre_t, pre_j, atol=1e-4)
    np.testing.assert_allclose(port.debug_hm.numpy(), np.asarray(ref.debug_hm), atol=1e-4)
    kj = np.asarray(ref.detected_kps)
    kt = port.detected_kps.numpy()
    valid = kj > tdet.KP_SENTINEL
    assert valid.any() == teacher
    np.testing.assert_array_equal(kt > tdet.KP_SENTINEL, valid)
    np.testing.assert_allclose(kt[valid], kj[valid], atol=0.05)
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores), atol=1e-4)


def test_detector_refuses_missing_card_and_mismatched_model():
    model = SGTAPose(port_cfg("dcn")).eval()
    cfg = PortConfig(model=port_cfg("dcn"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdet.make_video_detector(model, cfg, tsyn.camera_K(), RAW_HW)
    warm = dataclasses.replace(cfg, infer=dataclasses.replace(cfg.infer, pnp_warm_start=True))
    det = tdet.make_video_detector(model, warm, tsyn.camera_K(), RAW_HW, device="cpu")
    assert det.cfg.infer.pnp_warm_start
