"""Port parity of multi-GPU serving and the multi-process dry run on the
CPU, with gloo process groups standing in for cards.

`make_sharded_video_detector`: 4 teacher-forced synthetic videos (each its
own motion), the tiny SGTAPose (64x64 input, full widths, seeded weights),
served by 2 ranks (tests/torch_port_sharded_worker.py, 2 videos a rank),
against the port's one-process batched runner and JAX's
`make_sharded_video_detector` on a 4-device CPU mesh. Bars: the two ranks'
gathered results equal bit for bit; against the batched runner scores and
keypoints within 1e-4 (`tests/test_infer_eval.py`'s sharded-vs-single bar;
a rank's batched PnP runs 2 problems where the one process runs 4);
against JAX the exact detector's bars (sentinel patterns equal, raw
keypoints within 0.05 px, scores within 1e-4, `tests/test_torch_port_runners.py`).
Without a process group the sharded runner is the batched runner, bit for
bit. A batch the ranks cannot split raises ValueError.

`run_two_process_dryrun`: the loss both ranks log against `dryrun_step`
alone on the global batch, within 5e-4 relative. float32: the global
BatchNorm statistics and the loss are reduced in another order, and
train-mode BatchNorm on 64x64 maps amplifies the difference (measured
1.0e-4; the one process's own loss moves 0.8e-4 between 2 and 8 CPU
threads).
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgtapose_tpu.config import Config as JaxConfig
from sgtapose_tpu.infer import detector as jdet
from sgtapose_tpu.parallel import mesh as jmesh
from sgtapose_tpu_torch.config import Config as PortConfig, MeshConfig
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.infer import detector as tdet
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.parallel import multihost_dryrun
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, jax_cfg, port_cfg

HERE = os.path.dirname(os.path.abspath(__file__))
RAW_HW = (tsyn.RAW_H, tsyn.RAW_W)
N_VIDEOS, T = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _videos():
    """(raw frames, GT projections, robot-frame keypoints) of N_VIDEOS
    videos as numpy, each with its own motion."""
    out = []
    for v in range(N_VIDEOS):
        rs = np.random.RandomState(20 + v)
        q0 = np.array([0.9, 0.3, -0.2, 0.1], np.float32) + (0.1 * rs.randn(4)).astype(np.float32)
        t0 = np.array([0.02, -0.3, 2.0], np.float32) + (0.05 * rs.randn(3)).astype(np.float32)
        dq, dt = (rs.randn(4) * 0.01).astype(np.float32), (rs.randn(3) * 0.01).astype(np.float32)
        projs, imgs, _ = tsyn.sequence_from_motion(*(torch.from_numpy(a) for a in (q0, t0, dq, dt)), T)
        out.append((imgs.numpy(), projs.numpy(), np.tile(np.asarray(tsyn.SKELETON, np.float32)[None], (T, 1, 1))))
    return tuple(np.stack([v[i] for v in out]) for i in range(3))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's batched runner in this process, the sharded one as 2
    gloo ranks, and JAX's sharded detector on a 4-device mesh."""
    raw, projs, x3d = _videos()
    flax_model, variables = flax_model_and_variables("dcn")
    pcfg = PortConfig(model=port_cfg("dcn"))
    model = SGTAPose(pcfg.model).eval()
    load_flax_variables(model, variables)
    images, _, _ = tdet.preprocess_frames(torch.from_numpy(raw), pcfg)
    videos = tdet.VideoFrames(images=images, x3d=torch.from_numpy(x3d), init_kps=torch.from_numpy(projs[:, 0]),
                              teacher_kps=torch.from_numpy(projs))
    d = tmp_path_factory.mktemp("sharded")
    torch.save({"state": model.state_dict(), "videos": videos._asdict()}, d / "inputs.pt")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_port_sharded_worker.py"), "2", str(r),
                               str(port), str(d)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    batched = tdet.make_batched_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu")(videos)
    one_rank = tdet.make_sharded_video_detector(model, pcfg, tsyn.camera_K(), RAW_HW, device="cpu")(videos)
    jcfg = JaxConfig(model=jax_cfg("dcn"))
    images_j = jnp.stack([jdet.preprocess_frames(jnp.asarray(r), jcfg)[0] for r in raw])
    ref = jdet.make_sharded_video_detector(flax_model.apply, variables, jcfg, np.asarray(tsyn.camera_K()), RAW_HW,
                                           mesh=jmesh.make_mesh(4))(
        jdet.VideoFrames(images=images_j, x3d=jnp.asarray(x3d), init_kps=jnp.asarray(projs[:, 0]),
                         teacher_kps=jnp.asarray(projs)))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(2)]
    return {"batched": batched, "one_rank": one_rank, "ranks": ranks, "jax": ref}


def test_sharded_ranks_gather_the_batch_in_video_order(runs):
    r0, r1 = (r["result"] for r in runs["ranks"])
    batched = runs["batched"]
    assert r0.keys() == r1.keys() and r0["debug_hm"] is None
    for field in ("detected_kps", "scores", "tracking"):
        assert r0[field].shape == getattr(batched, field).shape and r0[field].shape[:2] == (N_VIDEOS, T)
        assert torch.equal(r0[field], r1[field]), field
    np.testing.assert_allclose(r0["scores"].numpy(), batched.scores.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["detected_kps"].numpy(), batched.detected_kps.numpy(), atol=1e-4)
    np.testing.assert_allclose(r0["tracking"].numpy(), batched.tracking.numpy(), atol=1e-4)


def test_sharded_ranks_match_jax_sharded_detector(runs):
    got, ref = runs["ranks"][0]["result"], runs["jax"]
    kj, kt = np.asarray(ref.detected_kps), got["detected_kps"].numpy()
    assert kt.shape == kj.shape == (N_VIDEOS, T, 7, 2)
    valid = kj > tdet.KP_SENTINEL
    assert valid.any()
    np.testing.assert_array_equal(kt > tdet.KP_SENTINEL, valid)
    np.testing.assert_allclose(kt[valid], kj[valid], atol=0.05)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref.scores), atol=1e-4)


def test_sharded_runner_without_a_process_group_is_the_batched_runner(runs):
    for field in ("detected_kps", "scores", "tracking"):
        assert torch.equal(getattr(runs["one_rank"], field), getattr(runs["batched"], field)), field


def test_sharded_runner_refuses_a_batch_the_ranks_cannot_split(runs):
    assert all("not divisible" in r["raised"] for r in runs["ranks"])


def test_sharded_runner_holds_the_ranks_to_mesh_num_devices(runs):
    """cfg.mesh.num_devices is the number of ranks the runner expects: the 2
    ranks served with it set to 2 and refused 4; one process refuses 2."""
    assert all("mesh.num_devices 4" in r["raised_mesh"] for r in runs["ranks"])
    cfg = PortConfig(model=port_cfg("dcn"), mesh=MeshConfig(num_devices=2))
    with pytest.raises(ValueError, match="mesh.num_devices 2"):
        tdet.make_sharded_video_detector(None, cfg, tsyn.camera_K(), RAW_HW, device="cpu")


def test_two_process_dryrun_matches_one_process_on_the_global_batch(tmp_path):
    loss = multihost_dryrun.run_two_process_dryrun(str(tmp_path), timeout=300)
    ref = multihost_dryrun.dryrun_step()
    assert np.isfinite(loss) and loss > 0
    assert abs(loss - ref) <= 5e-4 * abs(ref), (loss, ref)
    assert sorted(os.listdir(tmp_path)) == ["rank0.log", "rank1.log"]
