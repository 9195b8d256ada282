"""Port parity: the inference CLI's DREAM-real and 42-joint depth modes on the
CPU against `sgtapose_tpu.cli.infer`, weights that decode nothing (the hm
bias at its prior, -4.6), so every frame runs cold: the loaded ground truth,
sentinel patterns, keypoint metrics, file names, CSV rows and tracks equal,
PnP metrics within 1e-6, debug images as in test_torch_port_infer_cli.py
(tests/torch_port_cli_common.py).

Real: a JAX-written set of 2 videos x 2 frames whose second video is
upscaled 2x with its projections scaled, run with --track --debug 1; each
CLI builds a runner per resolution and counts every frame's ground truth
against its own frame size. Depth: 3 frames, 42 classes (the tiny model
with a 42-class head); --debug and --track are ignored there.
"""

import json
import os

import pytest
import torch

from sgtapose_tpu.data import synthetic as jsyn

from torch_port_cli_common import (check_cold, check_debug_images, cli_args, run_both,
                                  write_mixed_real_dataset)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_real")
    write_mixed_real_dataset(str(root / "real"))
    args = cli_args(["--dataset", str(root / "real"), "--is_real", "panda-mixed", "--robot", "panda",
                     "--track", "--debug", "1", "--output_dir", str(root / "out")])
    return run_both(args, "real", cold=True, tag="cold")


@pytest.fixture(scope="module")
def depth(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_depth")
    jsyn.write_depth_dataset(str(root / "depth"), set_name="panda-depth", n_frames=3)
    args = cli_args(["--dataset", str(root / "depth"), "--is_real", "panda-depth", "--depth",
                     "--output_dir", str(root / "out")])
    return run_both(args, "depth", cold=True, tag="cold")


def test_cold_real_mixed_resolutions_match_jax(real):
    ref, port, jdir, pdir = real
    assert port["timing"]["runners"] == 2
    check_cold(ref, port, jdir, pdir, 4, 7, 24)
    check_debug_images(jdir, pdir, 4 * 3)
    with open(os.path.join(jdir, "dt_and_json_panda-mixed.json")) as f:
        jd = json.load(f)
    with open(os.path.join(pdir, "dt_and_json_panda-mixed.json")) as f:
        pd = json.load(f)
    assert pd["dt"] == jd["dt"]
    assert [os.path.basename(p) for p in pd["json"]] == [os.path.basename(p) for p in jd["json"]]


def test_cold_depth_matches_jax(depth):
    ref, port, jdir, pdir = depth
    files = check_cold(ref, port, jdir, pdir, 3, 42, 3 * 42 // 2)
    assert "panda-depth_42_pnp_results.csv" in files
