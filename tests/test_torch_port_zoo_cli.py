"""The arch zoo through the port's CLIs on the CPU, at 64x64 on sets the port's
writer makes: `cli/infer.py --arch dlapa_34 --phase PlanA`; `cli/train.py
--phase PlanA_three` (three-frame windows) with `--init_backbone` from a
dict the port's `export_imagenet_dla34` writes; `cli/train_demo.py
--init_backbone`; the refusals that stay (--phase PlanA_three with --depth
exits as JAX's CLI does).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sgtapose_tpu_torch.cli import infer as tinfer, train as tcli, train_demo
from sgtapose_tpu_torch.data import synthetic as tsyn
from sgtapose_tpu_torch.models.sgta import create_model
from sgtapose_tpu_torch.utils import torch_convert as ttc

from torch_port_common import port_cfg

TINY = ["--device", "cpu", "--input_res", "64", "--kernel_list", "3,3,3,1,1,1"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo")
    tsyn.write_synthetic_dataset(str(d), n_videos=2, n_frames=4, seed=0, device="cpu")
    return str(d)


@pytest.fixture(scope="module")
def imagenet_pth(tmp_path_factory):
    """A bare ImageNet-format DLA-34 dict from a seeded port model's trunk,
    with its image stem as the release's base_layer."""
    donor = create_model(dataclasses.replace(port_cfg(), arch="dlapa_34"), device="cpu", seed=5)
    sd = {k: torch.from_numpy(v) for k, v in ttc.export_imagenet_dla34(donor).items()}
    stem = donor.pre_img_stem
    sd["base_layer.0.weight"] = stem.Conv_0.weight.detach().clone()
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"base_layer.1.{k}"] = getattr(stem.BatchNorm_0, k).detach().clone()
    path = str(tmp_path_factory.mktemp("imagenet") / "dla34.pth")
    torch.save(sd, path)
    return path, donor


def test_infer_cli_runs_a_zoo_arch(dataset, tmp_path):
    res = tinfer.main(["--dataset", dataset, "--output_dir", str(tmp_path), "--arch", "dlapa_34",
                       "--phase", "PlanA"] + TINY)
    km = res["keypoint_metrics"]
    assert km["num_gt_inframe"] + km["num_gt_outframe"] == 2 * 4 * 7
    assert res["timing"]["frames"] == 8


def test_train_cli_three_frame_phase_with_imagenet_init(dataset, imagenet_pth, tmp_path):
    """--phase PlanA_three on three-frame windows (2 videos x 4 frames: 4
    windows, 2 steps at batch 2) after --init_backbone; at lr 0 the trunk's
    convolutions stay the donor's."""
    path, donor = imagenet_pth
    res = tcli.main(["--dataset", dataset, "--output_dir", str(tmp_path), "--arch", "dlapawd3_34",
                     "--phase", "PlanA_three", "--num_epochs", "1", "--batch_size", "2", "--lr", "0",
                     "--log_every", "1", "--image_log_every", "0", "--init_backbone", path] + TINY)
    state = res["state"]
    assert res["iters_per_epoch"] == 2 and state.step == 2
    assert type(state.model).__name__ == "SGTAPoseThree"
    got, want = state.model.state_dict(), donor.state_dict()
    convs = [k for k in want if k.startswith("base.") and k.endswith(".weight") and want[k].dim() == 4]
    assert convs and all(torch.equal(got[k], want[k]) for k in convs)
    with pytest.raises(SystemExit, match="PlanA_three"):
        tcli.main(["--dataset", dataset, "--output_dir", str(tmp_path / "d"), "--phase", "PlanA_three",
                   "--depth"] + TINY)


def test_train_demo_init_backbone(imagenet_pth):
    path, donor = imagenet_pth
    res = train_demo.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--input_res", "64",
                           "--eval_videos", "0", "--lr", "0", "--init_backbone", path, "--init_backbone_stem"])
    got = res["state"].model.state_dict()
    for k in ("base.level0.Conv_0.weight", "pre_img_stem.Conv_0.weight"):
        assert torch.equal(got[k], donor.state_dict()[k]), k
    assert np.isfinite(res["logged"][0]["tot"])
