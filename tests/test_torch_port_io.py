"""Port parity of the host-side pieces the inference CLI runs, against the
JAX package on the same files and numpy inputs:

  * data/loaders.py on fixtures written by the JAX writers, exactly (float64
    keypoints, intrinsics, resolution, uint8 images), including a real-set
    keypoint without `projected_location` (NaN);
  * the port's fixture writers (data/synthetic.py): the same file names and
    JSON keys as the JAX writers', and files both packages' loaders read
    identically; `skeleton_42` equal to JAX's;
  * infer/tracker.py: `track_video` (greedy and Hungarian) on seeded
    detections with missing classes, the same ids;
  * utils/visualize.py and utils/debugger.py: the same images from the same
    inputs (colormaps, blends, overlays, arrows, ids);
  * utils/profiling.py: StageTimer's buckets, and a torch.profiler trace
    written to its directory.
"""

import json
import os

import numpy as np
import pytest
import torch

from sgtapose_tpu.config import KEYPOINT_NAMES, SYNTHETIC_CAMERA_K
from sgtapose_tpu.data import loaders as jload, synthetic as jsyn
from sgtapose_tpu.infer import tracker as jtrack
from sgtapose_tpu.utils import debugger as jdbg, visualize as jvis
from sgtapose_tpu_torch.data import loaders as tload, synthetic as tsyn
from sgtapose_tpu_torch.infer import tracker as ttrack
from sgtapose_tpu_torch.utils import debugger as tdbg, profiling as tprof, visualize as tvis

K = np.asarray(SYNTHETIC_CAMERA_K)


def _eq(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.fixture(scope="module")
def jax_fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_fixtures")
    jsyn.write_synthetic_dataset(str(root / "syn"), n_videos=1, n_frames=2, seed=3)
    jsyn.write_real_dataset(str(root / "real"), set_name="panda-test", n_videos=1, n_frames=2, seed=3)
    jsyn.write_depth_dataset(str(root / "depth"), set_name="panda-depth", n_frames=2, seed=3)
    return root


@pytest.fixture(scope="module")
def port_fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_fixtures")
    tsyn.write_synthetic_dataset(str(root / "syn"), n_videos=1, n_frames=2, seed=3, device="cpu")
    tsyn.write_real_dataset(str(root / "real"), set_name="panda-test", n_videos=1, n_frames=2, seed=3,
                            device="cpu")
    tsyn.write_depth_dataset(str(root / "depth"), set_name="panda-depth", n_frames=2, seed=3, device="cpu")
    return root


def _read_all(root, load):
    """Everything the CLI reads from one fixture tree, through `load` (a
    loaders module)."""
    names = KEYPOINT_NAMES["panda_synthetic"]
    out = {}
    for f in ("0000", "0001"):
        meta = str(root / "syn" / "00000" / f"{f}_meta.json")
        for k, v in load.load_seq_keypoints(meta, "panda_synthetic", names, K).items():
            out[f"syn_{f}_{k}"] = v
        out[f"syn_{f}_x3d"] = load.load_x3d(meta, "panda_synthetic", names)
        out[f"syn_{f}_img"] = load.load_image(str(root / "syn" / "00000" / f"{f}_color.png"))
        depth = str(root / "depth" / "panda-depth" / f"{f}.json")
        for k, v in load.load_depth_keypoints(depth, "Franka_Emika_Panda", K).items():
            out[f"depth_{f}_{k}"] = v
        out[f"depth_{f}_img"] = load.load_image(str(root / "depth" / "panda-depth" / f"{f}.png"))
    real = root / "real" / "panda-test"
    out["K"] = load.load_camera_intrinsics(str(real / "_camera_settings.json"))
    out["res"] = np.asarray(load.load_image_resolution(str(real / "_camera_settings.json")))
    for i in range(2):
        for k, v in load.load_keypoints(str(real / f"{i:06d}.json"), "panda", KEYPOINT_NAMES["panda"]).items():
            out[f"real_{i}_{k}"] = v
        out[f"real_{i}_img"] = load.load_image(str(real / f"{i:06d}.rgb.png"))
    return out


def test_loaders_match_jax_on_jax_fixtures(jax_fixtures):
    _eq(_read_all(jax_fixtures, tload), _read_all(jax_fixtures, jload))


def test_missing_projection_loads_as_nan(jax_fixtures, tmp_path):
    src = jax_fixtures / "real" / "panda-test" / "000000.json"
    blob = json.loads(src.read_text())
    del blob["objects"][0]["keypoints"][2]["projected_location"]
    path = tmp_path / "partial.json"
    path.write_text(json.dumps(blob))
    got = tload.load_keypoints(str(path), "panda", KEYPOINT_NAMES["panda"])
    _eq(got, jload.load_keypoints(str(path), "panda", KEYPOINT_NAMES["panda"]))
    assert np.isnan(got["projections"][2]).all() and np.isfinite(got["projections"][[0, 1, 3]]).all()


def _tree(root):
    """Relative file names and, per JSON file, its structure of keys."""
    def keys(x):
        if isinstance(x, dict):
            return {k: keys(v) for k, v in x.items()}
        if isinstance(x, list):
            return [keys(v) for v in x[:1]] + [len(x)]
        return type(x).__name__

    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            rel = os.path.relpath(os.path.join(r, f), root)
            out[rel] = keys(json.loads(open(os.path.join(r, f)).read())) if f.endswith(".json") else None
    return out


def test_port_writers_write_the_jax_layout(jax_fixtures, port_fixtures):
    assert _tree(port_fixtures) == _tree(jax_fixtures)


def test_port_written_files_load_the_same_in_both_packages(port_fixtures):
    port, ref = _read_all(port_fixtures, tload), _read_all(port_fixtures, jload)
    _eq(port, ref)
    # the port's frames show the skeleton where the loaders project it
    proj = port["syn_0000_projections"]
    img = port["syn_0000_img"]
    inside = (proj[:, 0] >= 0) & (proj[:, 0] < 640) & (proj[:, 1] >= 0) & (proj[:, 1] < 360)
    xy = np.round(proj[inside]).astype(int)
    assert img.shape == (360, 640, 3) and img[xy[:, 1], xy[:, 0]].max(-1).min() > 100
    # robot-frame positions are the skeleton (rigid motion of the robot frame)
    np.testing.assert_allclose(port["syn_0000_positions_wrt_robot"],
                               port["syn_0000_positions_wrt_robot"][:1] + tsyn.skeleton().numpy()
                               - tsyn.skeleton().numpy()[:1], atol=1e-5)
    assert port["depth_0000_positions_wrt_cam"].shape == (42, 3)


def test_skeleton_42_matches_jax():
    np.testing.assert_array_equal(tsyn.skeleton_42().numpy(), np.asarray(jsyn.skeleton_42()))


def _detections(seed, T=6, n_cls=7):
    rs = np.random.RandomState(seed)
    base = rs.rand(n_cls, 2) * np.array([600.0, 340.0]) + 20.0
    det = base[None] + np.cumsum(rs.randn(T, n_cls, 2) * 0.1, axis=0)
    tracking = -np.diff(det, axis=0, prepend=det[:1]) + rs.randn(T, n_cls, 2) * 0.02
    missing = rs.rand(T, n_cls) < 0.25
    det[missing] = -999.999 * 4
    scores = np.where(missing, -1.0, rs.rand(T, n_cls))
    return det, scores, tracking


@pytest.mark.parametrize("hungarian", [False, True], ids=["greedy", "hungarian"])
@pytest.mark.parametrize("gate", [0.2, 0.3])
def test_track_video_matches_jax(hungarian, gate):
    det, scores, tracking = _detections(7)
    got = ttrack.track_video(det, scores, tracking, gate=gate, hungarian=hungarian)
    want = jtrack.track_video(det, scores, tracking, gate=gate, hungarian=hungarian)
    np.testing.assert_array_equal(got, want)
    assert (got[det[..., 0] < -999] == -1).all() and (got[det[..., 0] > -999] > 0).all()
    assert got.max() > 7  # some tracks are lost and restarted


def test_assignments_match_jax():
    rs = np.random.RandomState(11)
    dist = rs.rand(5, 4)
    for gate in (0.3, 0.8, 2.0):
        assert ttrack.greedy_assignment(dist, gate) == jtrack.greedy_assignment(dist, gate)
        assert ttrack.hungarian_assignment(dist, gate) == jtrack.hungarian_assignment(dist, gate)
    assert ttrack.greedy_assignment(np.zeros((3, 0)), 1.0) == []


@pytest.mark.parametrize("n_cls", [7, 42])
def test_debugger_colormaps_and_blends_match_jax(n_cls):
    rs = np.random.RandomState(n_cls)
    hm = rs.rand(16, 16, n_cls).astype(np.float32) ** 4
    back = (rs.rand(64, 64, 3) * 255).astype(np.float32)
    t, j = tdbg.Debugger(num_classes=n_cls), jdbg.Debugger(num_classes=n_cls)
    np.testing.assert_array_equal(t.colors, j.colors)
    for kw in ({}, {"output_res": (64, 64)}):
        np.testing.assert_array_equal(t.gen_colormap(hm, **kw), j.gen_colormap(hm, **kw))
        np.testing.assert_array_equal(t.gen_colormap_hp(hm, **kw), j.gen_colormap_hp(hm, **kw))
    np.testing.assert_array_equal(t.gen_colormap(hm.transpose(2, 0, 1), channel_first=True),
                                  j.gen_colormap(hm.transpose(2, 0, 1), channel_first=True))
    for dbg in (t, j):
        dbg.add_blend_img(back, dbg.gen_colormap(hm), "blend")
        dbg.add_mask(hm[..., 0] > 0.5, back[:16, :16], "mask")
    for img_id in ("blend", "mask"):
        np.testing.assert_array_equal(t.imgs[img_id], j.imgs[img_id])


def test_debugger_annotations_match_jax(tmp_path):
    det, scores, tracking = _detections(3, T=1)
    ids = jtrack.track_video(det, scores, tracking)[0]
    img = (np.random.RandomState(0).rand(360, 640, 3) * 255).astype(np.uint8)
    out = {}
    for name, mod in (("port", tdbg), ("jax", jdbg)):
        dbg = mod.Debugger(num_classes=7)
        dbg.add_img(img, "generic")
        dbg.add_keypoints(det[0], "generic", scores=scores[0])
        for k in range(7):
            if det[0, k, 0] > -999:
                dbg.add_arrow(det[0, k], 20 * tracking[0, k], "generic")
                dbg.add_tracking_id(det[0, k], int(ids[k]), "generic")
        dbg.add_img(img, "rev", revert_color=True)
        dbg.save_all_imgs(str(tmp_path / name), prefix="f_")
        out[name] = dbg.imgs
    for img_id in ("generic", "rev"):
        np.testing.assert_array_equal(out["port"][img_id], out["jax"][img_id])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "f_generic.png", "f_rev.png"]


def test_visualize_matches_jax():
    rs = np.random.RandomState(5)
    img = (rs.rand(48, 64, 3) * 255).astype(np.uint8)
    pts = [(10.5, 20.25), (-999.999 * 4, -999.999 * 4), (40.0, 5.0)]
    a = tvis.overlay_points_on_image(img, pts, annotations=["a", "b", "c"])
    b = jvis.overlay_points_on_image(img, pts, annotations=["a", "b", "c"])
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    m = rs.rand(12, 16)
    for norm in ("frame", "none"):
        np.testing.assert_array_equal(np.asarray(tvis.image_from_belief_map(m, norm)),
                                      np.asarray(jvis.image_from_belief_map(m, norm)))
    ims = [tvis.image_from_belief_map(rs.rand(12, 16)) for _ in range(3)]
    np.testing.assert_array_equal(np.asarray(tvis.mosaic_images(ims, 2, 2)),
                                  np.asarray(jvis.mosaic_images(ims, 2, 2)))


def test_stage_timer_and_trace(tmp_path):
    timer = tprof.StageTimer(torch.device("cpu"))
    for _ in range(3):
        with timer.stage("load"):
            pass
    with timer.stage("detect"):
        torch.ones(8).sum()
    summary = timer.summary()
    assert list(summary) == ["detect", "load"] and timer.counts["load"] == 3
    assert all(v >= 0 for v in summary.values())
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(f.endswith(".json") for _, _, fs in os.walk(tmp_path / "trace") for f in fs)
