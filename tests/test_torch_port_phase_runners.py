"""Port parity of the streaming runners under the zoo's inference phases on
the CPU: the exact runner (`make_video_detector(..., phase=)`) and the
batched runner (two copies of the video) against the JAX package's
`make_video_detector` with the same phase, tiny models (64x64 input, full
widths) with the same seeded weights, over 3 frames of a synthetic 640x360
video, teacher-forced (the prior PnP consumes the ground truth every frame:
consistent inputs).

Bars: tests/test_torch_port_detector.py's: rendered priors and post-sigmoid
heatmaps 1e-4, scores 1e-4, sentinel patterns equal and raw keypoints within
0.01 px where valid.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.infer import detector as jdet
from sgtapose_tpu.models.sgta import create_model as jax_create_model
from sgtapose_tpu.train.phases import model_inputs as jax_model_inputs
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.infer import detector as tdet
from sgtapose_tpu_torch.models.sgta import build_model
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import phase_batch, phase_cfgs, port_cfg, seeded_flax_variables

T = 3
RAW_HW = (tsyn.RAW_H, tsyn.RAW_W)
PHASES = {"PlanA": "dlapa_34", "PlanACAT": "dlapacat_34", "ablation_shared_repro": "dlaabla_34",
          "ablation_shared": "dlaabla_34", "ablation_wo_shared": "dlaabla_34", "CenterTrack": "dlaseg_34"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _video():
    rs = np.random.RandomState(0)
    q0 = np.array([0.9, 0.3, -0.2, 0.1], np.float32)
    t0 = np.array([0.02, -0.3, 2.0], np.float32)
    dq = (rs.randn(4) * 0.01).astype(np.float32)
    dt = (rs.randn(3) * 0.01).astype(np.float32)
    projs, imgs, _ = tsyn.sequence_from_motion(*(torch.from_numpy(a) for a in (q0, t0, dq, dt)), T)
    x3d = np.tile(np.asarray(tsyn.SKELETON, np.float32)[None], (T, 1, 1))
    return imgs.numpy(), projs.numpy(), x3d


def _compare(port, ref):
    np.testing.assert_allclose(port.debug_pre_hm.numpy(), np.asarray(ref.debug_pre_hm), atol=1e-4)
    assert np.asarray(ref.debug_pre_hm).max() > 0.5  # the teacher's priors were rendered
    np.testing.assert_allclose(port.debug_hm.numpy(), np.asarray(ref.debug_hm), atol=1e-4)
    kj, kt = np.asarray(ref.detected_kps), port.detected_kps.numpy()
    valid = kj > tdet.KP_SENTINEL
    np.testing.assert_array_equal(kt > tdet.KP_SENTINEL, valid)
    np.testing.assert_allclose(kt[valid], kj[valid], atol=0.01)
    np.testing.assert_allclose(port.scores.numpy(), np.asarray(ref.scores), atol=1e-4)


@pytest.mark.parametrize("phase", list(PHASES))
def test_runners_match_jax_per_phase(phase):
    raw, projs, x3d = _video()
    jmodel_cfg, pmodel_cfg, tracking = phase_cfgs(PHASES[phase], phase)
    jcfg, pcfg = JaxConfig(model=jmodel_cfg), PortConfig(model=pmodel_cfg)
    module = jax_create_model(jcfg.model)
    variables = seeded_flax_variables(module, jax_model_inputs(phase, phase_batch()), seed=7)
    images_j, _, _ = jdet.preprocess_frames(jnp.asarray(raw), jcfg)
    ref = jdet.make_video_detector(module.apply, variables, jcfg, np.asarray(tsyn.camera_K()), RAW_HW,
                                   phase=phase, debug_outputs=True)(
        jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), teacher_kps=jnp.asarray(projs)))

    model = build_model(pcfg.model, tracking).eval()
    load_flax_variables(model, variables)
    images_t, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    video = tdet.VideoFrames(images=images_t, x3d=torch.from_numpy(x3d), teacher_kps=torch.from_numpy(projs))
    exact = tdet.make_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu", debug_outputs=True,
                                     phase=phase)(video)
    _compare(exact, ref)
    both = tdet.VideoFrames(*(None if x is None else torch.stack([x, x]) for x in video))
    batched = tdet.make_batched_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu",
                                               debug_outputs=True, phase=phase)(both)
    for v in range(2):
        _compare(tdet.FrameResult(*(None if x is None else x[v] for x in batched)), ref)


def test_runner_refuses_phases_it_cannot_wire():
    """PlanA_three and unknown phases raise, as JAX's runner does; the
    feature-cache runner stays the flagship's."""
    model = build_model(dataclasses.replace(port_cfg(), arch="dlapa_34"))
    cfg = PortConfig(model=port_cfg())
    for phase in ("PlanA_three", "Dream", "PlanB"):
        with pytest.raises(ValueError, match="unknown detector phase"):
            tdet.make_video_detector(model, cfg, tsyn.camera_K(), RAW_HW, device="cpu", phase=phase)
    with pytest.raises(TypeError):
        tdet.make_cached_video_detector(model, cfg, tsyn.camera_K(), RAW_HW, device="cpu", phase="PlanA")
