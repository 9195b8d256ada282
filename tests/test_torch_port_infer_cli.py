"""Port parity: the inference CLI (`sgtapose_tpu_torch.cli.infer`) on the CPU
against `sgtapose_tpu.cli.infer` on synthetic videos written by the JAX
package's fixture writer (2 videos x 2 frames), tiny SGTAPose (64x64 input,
full channel widths, DCN decoder) with the same perturbed flax variables on
both sides. Both sides run `run_synthetic` with one `parse_args` namespace
(the port's, a superset; --device cpu) and write to their own output
directories (tests/torch_port_cli_common.py). The real and depth sets are in
test_torch_port_infer_cli_sets.py.

(a) Weights that decode nothing (the hm bias at its prior, -4.6), so every
    frame runs cold, with --track --debug 1 and then --multi_frame 2: the
    loaded ground truth equal in float64 (dt_and_gt.json), sentinel
    patterns, keypoint metrics, file names, CSV rows, tracks.json and the
    generic debug images (byte for byte) equal; PnP metrics within 1e-6;
    heatmap blends within 1 uint8 level (the warped input differs by float32
    rounding). (--rf's weighted refinement is held against JAX in
    test_torch_port_eval.py; here it would double the time.)
(b) The perturbed weights as they are: keypoints <= 0.05 px where valid,
    scores <= 1e-4. Frame 1's prior PnP consumes frame 0's detections of
    random weights, 4-5 mutually inconsistent points, where EPnP's null space
    is degenerate and the two backends' eigh bases settle in different
    optima (ROADMAP.md Queue 3), so only frame 0 of each video is compared.
(c) `main()` with --ckpt (a `trainer.save_checkpoint` file) equals the
    direct call of (b).
(d) Flags that are not ported raise, and --device cuda raises without a
    card.
"""

import json
import os

import numpy as np
import pytest
import torch

from sgtapose_tpu.cli import infer as jinfer
from sgtapose_tpu.data import synthetic as jsyn
from sgtapose_tpu_torch.cli import infer as tinfer
from sgtapose_tpu_torch.infer.detector import KP_SENTINEL
from sgtapose_tpu_torch.train import trainer as ttrainer
from sgtapose_tpu_torch.utils.weights import load_flax_variables

from torch_port_cli_common import (COMMON, check_cold, check_debug_images, cli_args, csv_rows, run_both,
                                  variables_for)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_syn")
    d = {"syn": str(root / "syn"), "out": str(root / "out")}
    jsyn.write_synthetic_dataset(d["syn"], n_videos=2, n_frames=2, seed=0)
    return d


@pytest.fixture(scope="module")
def cold(data):
    """(a)'s run on both sides."""
    args = cli_args(["--dataset", data["syn"], "--track", "--debug", "1", "--output_dir", data["out"]])
    return run_both(args, "syn", cold=True, tag="cold")


def test_cold_synthetic_matches_jax(cold):
    ref, port, jdir, pdir = cold
    files = check_cold(ref, port, jdir, pdir, 4, 7, 20)
    with open(os.path.join(jdir, "dt_and_gt.json")) as f:
        jd = json.load(f)
    with open(os.path.join(pdir, "dt_and_gt.json")) as f:
        pd = json.load(f)
    assert pd == jd  # names, detections and float64 ground truth, exactly
    assert "tracks.json" in files
    with open(os.path.join(pdir, "tracks.json")) as f:
        tracks = json.load(f)
    assert sorted(tracks) == ["00000", "00001"] and all(i == -1 for v in tracks.values()
                                                        for row in v for i in row)


def test_cold_synthetic_multiframe_matches_jax(cold):
    """--multi_frame 2 as each CLI's main runs it on the run's inputs."""
    from sgtapose_tpu.eval.analysis import solve_multiframe_pnp, solve_multiframe_pnp_real

    ref, port, jdir, pdir = cold
    args = tinfer._replaced(cli_args(["--dataset", "", "--multi_frame", "2"]), output_dir=pdir)
    got = tinfer.run_multiframe(args, port["_multiframe_inputs"])
    mi = ref["_multiframe_inputs"]
    want = {
        "multiframe_pnp_metrics": solve_multiframe_pnp(
            mi["det"], mi["gt"], mi["pos"], mi["camera_K"], mi["image_resolution"], multiframe=2,
            video_lengths=mi["video_lengths"], rf=False, output_dir=jdir, set_name="syn"),
        "multiframe_pnp_real_metrics": solve_multiframe_pnp_real(
            mi["det"], mi["pos"], mi["camera_K"], multiframe=2, rf=False, output_dir=jdir,
            set_name="syn")}
    for key, metrics in want.items():
        assert set(got[key]) == set(metrics)
        for k, r in metrics.items():
            p = got[key][k]
            assert p == r or (np.isnan(p) and np.isnan(r)) or abs(p - r) <= 1e-6, (key, k)
    for f in ("syn_2_pnp_results.csv", "syn_2_real_pnp_results.csv"):
        assert csv_rows(os.path.join(pdir, f)) == csv_rows(os.path.join(jdir, f)), f


def test_cold_synthetic_debug_images_match_jax(cold):
    _, _, jdir, pdir = cold
    check_debug_images(jdir, pdir, 4 * 3)


@pytest.fixture(scope="module")
def warm(data):
    """(b): the perturbed weights on 2-frame videos with --track; the
    per-video detector outputs (DetOut: scores and tracking offsets too) are
    recorded where each CLI hands them to its tracker pass."""
    args = cli_args(["--dataset", data["syn"], "--output_dir", data["out"], "--track"])
    outs = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        for side, mod in (("jax", jinfer), ("port", tinfer)):
            def record(out, a, side=side, inner=mod._track_pass):
                outs[side].append(out)
                return inner(out, a)

            mp.setattr(mod, "_track_pass", record)
        runs = run_both(args, "syn", cold=False, tag="warm")
    return args, runs, outs


def test_perturbed_weights_frame0_match_jax(warm):
    _, (ref, port, _, _), outs = warm
    assert len(outs["jax"]) == len(outs["port"]) == 2
    for jo, po in zip(outs["jax"], outs["port"]):
        jv, pv = jo.det[0] > KP_SENTINEL, po.det[0] > KP_SENTINEL
        np.testing.assert_array_equal(pv, jv)
        assert np.abs(po.det[0][pv] - jo.det[0][jv]).max() <= 0.05
        np.testing.assert_allclose(po.scores[0], jo.scores[0], atol=1e-4)
        np.testing.assert_allclose(po.tracking[0], jo.tracking[0], atol=1e-3)
    # these weights decode peaks, which frame 1's prior PnP then consumes
    assert sum((o.det[0] > KP_SENTINEL).all(-1).sum() for o in outs["port"]) >= 4
    jd, pd = ref["_multiframe_inputs"]["det"], port["_multiframe_inputs"]["det"]
    np.testing.assert_array_equal(pd[[0, 2]], np.stack([o.det[0] for o in outs["port"]]))
    np.testing.assert_array_equal(jd[[0, 2]], np.stack([o.det[0] for o in outs["jax"]]))


def test_main_with_checkpoint_equals_direct_call(warm, tmp_path):
    args, (_, port, _, _), _ = warm
    cfg = tinfer.make_config(args)
    state = ttrainer.create_train_state(cfg, 0, max_iters=1, device="cpu")
    load_flax_variables(state.model, variables_for(7, cold=False))
    ckpt = str(tmp_path / "model.pt")
    ttrainer.save_checkpoint(ckpt, state)
    out = str(tmp_path / "main")
    res = tinfer.main(["--dataset", args.dataset, "--output_dir", out, "--track", "--multi_frame", "2",
                       "--ckpt", ckpt] + COMMON)
    assert set(res["multiframe_pnp_metrics"]) == set(res["pnp_metrics"])
    assert os.path.exists(os.path.join(out, "syn_2_real_pnp_results.csv"))
    np.testing.assert_array_equal(res["adds"], port["adds"])
    assert res["keypoint_metrics"] == port["keypoint_metrics"]
    with open(os.path.join(out, "dt_and_gt.json")) as f:
        np.testing.assert_array_equal(np.asarray(json.load(f)["detections"]),
                                      port["_multiframe_inputs"]["det"])
    with open(os.path.join(out, "tracks.json")) as f, \
            open(os.path.join(args.output_dir, "warm", "port", "tracks.json")) as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("flags,error", [
    (["--is_ct", "false"], NotImplementedError),
    (["--quant", "int8"], NotImplementedError),
    (["--quant_min_ch", "64"], NotImplementedError),
    (["--phase", "PlanA"], NotImplementedError),
    (["--arch", "dlapawdl3_34"], NotImplementedError),
    (["--flip_test"], SystemExit),
    (["--ckpt", "."], NotImplementedError),  # a directory: an orbax checkpoint
    (["--device", "cuda"], RuntimeError),
], ids=["is_ct", "quant", "quant_min_ch", "phase", "arch", "flip_test", "orbax", "cuda"])
def test_unported_flags_raise(flags, error, tmp_path):
    if flags == ["--device", "cuda"] and torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    argv = ["--dataset", str(tmp_path), "--output_dir", str(tmp_path / "out"), "--input_res", "64",
            "--kernel_list", "3,3,3,1,1,1"]
    argv += flags if "--device" in flags else flags + ["--device", "cpu"]
    with pytest.raises(error):
        tinfer.main(argv)
