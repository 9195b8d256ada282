"""Port parity: `eval/` (metrics, analysis, the synthetic-video harness) and
the synthetic data it needs, against the JAX harness on the same numpy
detections.

The harness: the port's `analyze_sequence_results` and multiframe PnP run end
to end, and the JAX harness aggregates the port's per-frame ADD (its
`compute_add_batch` patched to return them), so both score the same
solves. Bars: keypoint and PnP metrics within 1e-5; the keypoints CSV, the
PnP CSV and the analysis txt byte-equal.

The per-frame ADD solves (`compute_add_batch`) against JAX's on detections
with 0.1 px noise: successes equal; ADD within 1e-4 m without the weighted
refinement (measured 3e-5: float32 LM stops anywhere on the nearly flat
depth valley of a 0.5 m object at 2.3 m, where JAX and the port take other
paths) and within 2e-3 m with it (measured 9e-4: its exp(-5 d^2) weights
change with the start pose; from one start the two refinements agree,
tests/test_torch_port_pnp.py::test_register_gn_matches_jax).

Skeletons equal; rendered frames within 1e-3 (einsum sum order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.data import synthetic as jsyn
from sgtapose_tpu.eval import analysis as janalysis
from sgtapose_tpu_torch.config import Config as PortConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.eval import analysis as tanalysis
from sgtapose_tpu_torch.eval import synthetic_eval as teval
from sgtapose_tpu_torch.infer import detector as tdet
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, port_cfg

K = np.asarray(jsyn.camera_K())
RES = (tsyn.RAW_W, tsyn.RAW_H)
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _detections():
    """2 videos x 5 frames: GT projections and camera-frame points of seeded
    motions, detections = GT + 0.7 px noise with some keypoints missing (two
    frames below 4 detections, where PnP fails) and some GT out of frame."""
    rs = np.random.RandomState(0)
    gts, poss = [], []
    for v in range(2):
        q0 = rs.randn(4).astype(np.float32)
        t0 = np.array([0.3 * v, -0.1, 2.3], np.float32)
        dq = (rs.randn(4) * 0.02).astype(np.float32)
        dt = (rs.randn(3) * 0.02).astype(np.float32)
        projs, _, pos = tsyn.sequence_from_motion(*(torch.from_numpy(a) for a in (q0, t0, dq, dt)), 5)
        gts.append(projs.numpy())
        poss.append(pos.numpy())
    gt, pos = np.concatenate(gts), np.concatenate(poss)
    det = (gt + rs.randn(*gt.shape) * 0.7).astype(np.float32)
    missing = rs.rand(*gt.shape[:2]) < 0.15
    missing[3, :4] = True
    missing[7, 1:] = True
    det[missing] = tdet.KP_SENTINEL
    return det, gt.astype(np.float32), pos.astype(np.float32)


def _close_metrics(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert abs(a[k] - b[k]) <= TOL, (k, a[k], b[k])


@pytest.fixture
def jax_scores_port_adds(monkeypatch):
    """Make the JAX harness aggregate the port's per-frame ADD solves."""
    from sgtapose_tpu.eval import metrics as jmetrics
    from sgtapose_tpu_torch.eval import metrics as tmetrics

    def port_adds(detected, gt_pos_cam, camera_K, rf=True):
        return tmetrics.compute_add_batch(detected, gt_pos_cam, camera_K, rf=rf, device="cpu")

    monkeypatch.setattr(jmetrics, "compute_add_batch", port_adds)


@pytest.mark.parametrize("rf", [False, True], ids=["pnp", "refined"])
def test_analyze_sequence_results_matches_jax(rf, tmp_path, jax_scores_port_adds):
    det, gt, pos = _detections()
    ref = janalysis.analyze_sequence_results(det, gt, pos, K, RES, output_dir=str(tmp_path / "jax"), rf=rf)
    out = tanalysis.analyze_sequence_results(det, gt, pos, K, RES, output_dir=str(tmp_path / "port"),
                                             rf=rf, device="cpu")
    assert out["keypoint_metrics"] == ref["keypoint_metrics"]
    _close_metrics(out["pnp_metrics"], ref["pnp_metrics"])
    assert 0 < out["pnp_metrics"]["num_pnp_found"] < len(det)  # some solves fail
    np.testing.assert_array_equal(out["adds"], np.asarray(ref["adds"]))
    for name in ("keypoints.csv", "pnp_results.csv", "analysis_results.txt"):
        assert (tmp_path / "port" / f"eval_{name}").read_bytes() == \
            (tmp_path / "jax" / f"eval_{name}").read_bytes(), name


def test_multiframe_pnp_matches_jax(tmp_path, jax_scores_port_adds):
    det, gt, pos = _detections()
    kw = dict(multiframe=2, video_lengths=[5, 5])
    ref = janalysis.solve_multiframe_pnp(det, gt, pos, K, RES, output_dir=str(tmp_path / "jax"), **kw)
    out = tanalysis.solve_multiframe_pnp(det, gt, pos, K, RES, output_dir=str(tmp_path / "port"),
                                         device="cpu", **kw)
    _close_metrics(out, ref)
    assert out["num_pnp_found"] == 8
    name = "eval_2_pnp_results.csv"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    ref = janalysis.solve_multiframe_pnp_real(det, pos, K, multiframe=2, n_samples=20, seed=3)
    out = tanalysis.solve_multiframe_pnp_real(det, pos, K, multiframe=2, n_samples=20, seed=3,
                                              device="cpu")
    _close_metrics(out, ref)


@pytest.mark.parametrize("rf", [False, True], ids=["pnp", "refined"])
def test_compute_add_batch_matches_jax(rf):
    from sgtapose_tpu.eval import metrics as jmetrics
    from sgtapose_tpu_torch.eval import metrics as tmetrics

    det0, gt, pos = _detections()
    det = (gt + np.random.RandomState(1).randn(*gt.shape) * 0.1).astype(np.float32)
    det[det0 < -999] = det0[det0 < -999]
    adds_j, succ_j = jmetrics.compute_add_batch(det, pos, K, rf=rf)
    adds_t, succ_t = tmetrics.compute_add_batch(det, pos, K, rf=rf, device="cpu")
    np.testing.assert_array_equal(succ_t, np.asarray(succ_j))
    assert not succ_t.all() and succ_t.any()
    np.testing.assert_allclose(adds_t, np.asarray(adds_j), atol=2e-3 if rf else 1e-4)


@pytest.mark.parametrize("n_kp", [7, 8, 9, 12])
def test_robot_skeleton_and_frames_match_jax(n_kp):
    np.testing.assert_allclose(tsyn.robot_skeleton(n_kp).numpy(), np.asarray(jsyn.robot_skeleton(n_kp)),
                               atol=1e-7)
    projs = np.random.RandomState(n_kp).rand(n_kp, 2).astype(np.float32) * [600, 330] + 20
    np.testing.assert_allclose(tsyn.render_frame(torch.from_numpy(projs)).numpy(),
                               np.asarray(jsyn.render_frame(jnp.asarray(projs))), atol=1e-3)


def test_make_sequence_returns_camera_points_on_request():
    g = torch.Generator().manual_seed(4)
    projs, imgs, pos = tsyn.make_sequence(g, 3, return_pos_cam=True, n_kp=8, device="cpu")
    assert projs.shape == (3, 8, 2) and imgs.shape == (3, tsyn.RAW_H, tsyn.RAW_W, 3)
    assert pos.shape == (3, 8, 3) and (pos[..., 2] > 0).all()
    assert len(tsyn.make_sequence(torch.Generator().manual_seed(4), 3, device="cpu")) == 2


def test_evaluate_runner_scores_a_port_detector():
    """The harness end to end on the CPU: held-out videos, the tiny float32
    detector, and `analyze_sequence_results` on its detections."""
    _, variables = flax_model_and_variables("dcn")
    model = SGTAPose(port_cfg("dcn")).eval()
    load_flax_variables(model, variables)
    cfg = PortConfig(model=port_cfg("dcn"))
    vids = teval.make_eval_videos(2, 2, seed=0, device="cpu")
    again = teval.make_eval_videos(2, 2, seed=0, device="cpu")
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(vids, again))
    assert not np.array_equal(vids[0][0], vids[1][0])
    run = tdet.make_video_detector(model, cfg, tsyn.camera_K(), (tsyn.RAW_H, tsyn.RAW_W), device="cpu")
    results, fps = teval.evaluate_runner(run, cfg, vids, rf=False, device="cpu")
    assert fps > 0
    assert results["keypoint_metrics"]["num_gt_inframe"] + results["keypoint_metrics"]["num_gt_outframe"] == 28
    assert results["adds"].shape == (4,)
    with pytest.raises(ValueError, match="keypoints"):
        teval.evaluate_runner(run, cfg, teval.make_eval_videos(1, 2, seed=0, n_kp=8, device="cpu"),
                              device="cpu")
