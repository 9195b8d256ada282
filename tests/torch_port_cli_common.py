"""Shared pieces of the inference-CLI parity tests
(tests/test_torch_port_infer_cli*.py): both packages' run_synthetic /
run_real / run_depth on one `parse_args` namespace, the tiny model's
perturbed flax variables (optionally with the hm bias at its prior, so
nothing decodes), and the comparisons of a cold run's results and files."""

import copy
import csv
import dataclasses
import filecmp
import json
import os

import numpy as np
from PIL import Image

from sgtapose_tpu.cli import infer as jinfer
from sgtapose_tpu.config import Config as JaxConfig, InferConfig as JaxInferConfig
from sgtapose_tpu.data import synthetic as jsyn
from sgtapose_tpu_torch.cli import infer as tinfer
from sgtapose_tpu_torch.infer.detector import KP_SENTINEL
from sgtapose_tpu_torch.models.sgta import SGTAPose
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_common import flax_model_and_variables, jax_cfg

COMMON = ["--input_res", "64", "--kernel_list", "3,3,3,1,1,1", "--device", "cpu"]


def write_mixed_real_dataset(out_dir: str, set_name: str = "panda-mixed", n_frames: int = 2):
    """A JAX-written real set of 2 videos whose second video is upscaled 2x,
    its projections scaled to match."""
    jsyn.write_real_dataset(out_dir, set_name=set_name, n_videos=2, n_frames=n_frames)
    set_dir = os.path.join(out_dir, set_name)
    with open(os.path.join(out_dir, "dream_real_info", f"{set_name}_split_info.json")) as fh:
        split = json.load(fh)
    for img_rel, js_rel in zip(split["img_paths"][1], split["json_paths"][1]):
        p = os.path.join(set_dir, img_rel)
        im = Image.open(p)
        im.resize((im.width * 2, im.height * 2), Image.BILINEAR).save(p)
        jp = os.path.join(set_dir, js_rel)
        with open(jp) as fh:
            blob = json.load(fh)
        for kp in blob["objects"][0]["keypoints"]:
            kp["projected_location"] = [2 * v for v in kp["projected_location"]]
        with open(jp, "w") as fh:
            json.dump(blob, fh)


def variables_for(num_classes: int, cold: bool):
    _, variables = flax_model_and_variables("dcn", num_classes)
    if cold:
        variables = copy.deepcopy(variables)
        variables["params"]["hm"]["Conv_1"]["bias"][:] = -4.6
    return variables


def cli_args(argv):
    args = tinfer.parse_args(argv + COMMON)
    args.phase = "PlanA_win"
    return args


def run_both(args, mode: str, cold: bool, tag: str):
    """(JAX results, port results, JAX output dir, port output dir)."""
    num_classes = 42 if args.depth else 7
    variables = variables_for(num_classes, cold)
    jargs = tinfer._replaced(args, output_dir=os.path.join(args.output_dir, tag, "jax"))
    pargs = tinfer._replaced(args, output_dir=os.path.join(args.output_dir, tag, "port"))
    flax_model = flax_model_and_variables("dcn", num_classes)[0]
    jcfg = JaxConfig(model=jax_cfg("dcn", num_classes),
                     infer=JaxInferConfig(ref_sort=args.ref_sort, decode_coord=args.decode_coord),
                     robot=args.robot)
    pcfg = tinfer.make_config(args)
    assert dataclasses.astuple(pcfg.model)[:6] == dataclasses.astuple(jcfg.model)[:6]
    model = SGTAPose(pcfg.model).eval()
    load_flax_variables(model, variables)
    jrun, prun = {"syn": (jinfer.run_synthetic, tinfer.run_synthetic),
                  "real": (jinfer.run_real, tinfer.run_real),
                  "depth": (jinfer.run_depth, tinfer.run_depth)}[mode]
    ref = jrun(jargs, jcfg, flax_model, variables)
    port = prun(pargs, pcfg, model)
    return ref, port, jargs.output_dir, pargs.output_dir


def csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def same_files(jdir, pdir):
    jfiles = sorted(os.path.relpath(os.path.join(r, f), jdir) for r, _, fs in os.walk(jdir) for f in fs)
    pfiles = sorted(os.path.relpath(os.path.join(r, f), pdir) for r, _, fs in os.walk(pdir) for f in fs)
    assert jfiles == pfiles
    return jfiles


def check_cold(ref, port, jdir, pdir, n_frames, n_classes, gt_inframe):
    jm, pm = ref["_multiframe_inputs"], port["_multiframe_inputs"]
    for key in ("gt", "pos", "det"):
        np.testing.assert_array_equal(pm[key], jm[key], err_msg=key)
    assert pm["video_lengths"] == jm["video_lengths"] and pm["set_name"] == jm["set_name"]
    np.testing.assert_array_equal(np.asarray(pm["image_resolution"]), np.asarray(jm["image_resolution"]))
    assert pm["det"].shape == (n_frames, n_classes, 2)
    assert (pm["det"] == KP_SENTINEL).all()  # nothing decodes: every frame runs cold
    assert port["keypoint_metrics"] == ref["keypoint_metrics"]
    km = port["keypoint_metrics"]
    assert km["num_gt_inframe"] + km["num_gt_outframe"] == n_frames * n_classes
    assert km["num_gt_inframe"] >= gt_inframe
    for k, r in ref["pnp_metrics"].items():
        p = port["pnp_metrics"][k]
        if isinstance(r, float) and not np.isnan(r):
            assert abs(p - r) <= 1e-6, k
        else:
            assert p == r or (np.isnan(p) and np.isnan(r)), k
    np.testing.assert_allclose(port["adds"], ref["adds"], atol=1e-6)
    files = same_files(jdir, pdir)
    for f in files:
        if f.endswith(".csv"):
            assert csv_rows(os.path.join(pdir, f)) == csv_rows(os.path.join(jdir, f)), f
        elif f.endswith(".txt") or f.endswith("tracks.json") or f.startswith("tracks_"):
            assert filecmp.cmp(os.path.join(pdir, f), os.path.join(jdir, f), shallow=False), f
    return files


def check_debug_images(jdir, pdir, n_images):
    """The same debug image names; 'generic' images equal byte for byte (a
    cold run draws no detection), the heatmap blends within 1 uint8 level."""
    names = sorted(os.listdir(os.path.join(pdir, "debug")))
    assert names == sorted(os.listdir(os.path.join(jdir, "debug")))
    assert len(names) == n_images
    for name in names:
        pa, pb = os.path.join(pdir, "debug", name), os.path.join(jdir, "debug", name)
        a = np.asarray(Image.open(pa)).astype(np.int16)
        b = np.asarray(Image.open(pb)).astype(np.int16)
        assert a.shape == b.shape, name
        if name.endswith("_generic.png"):
            assert filecmp.cmp(pa, pb, shallow=False), name
        else:
            assert np.abs(a - b).max() <= 1, name
