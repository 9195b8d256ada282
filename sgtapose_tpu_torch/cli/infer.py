"""Inference and evaluation on datasets read from disk.

Counterpart of `sgtapose_tpu/cli/infer.py`:

  python -m sgtapose_tpu_torch.cli.infer --dataset DIR --ckpt CKPT \\
      [--is_real panda-orb --split_info dream_real_info/...json | --depth] \\
      --output_dir OUT [--rf] [--multi_frame N] [--track] [--debug 1]

Synthetic mode walks per-video directories (NNNN_color.png +
NNNN_meta.json); --is_real reads a DREAM-real set's video splits; --depth
reads a flat 42-joint set. Per video the exact streaming detector
(`infer/detector.py:make_video_detector`, float32) runs every frame on the
device given by --device (default cuda, which raises without a card; the
hand-written kernels run there, never their plain versions), then the
analysis harness writes PCK / ADD AUC, the CSVs and the detections JSON.
--track adds tracks.json, --debug the per-frame debug images,
--multi_frame both multiframe PnP estimators.

--ckpt is a `train/trainer.save_checkpoint` file (its "model" entry);
without it the weights are random (seeded), a smoke mode. Not ported yet,
and raising: --is_ct false and --flip_test (the DREAM detector), --phase
other than PlanA_win and --arch other than dlapawdl3new_34 (variants and
phases), --quant / --quant_static / --quant_min_ch (int8), and orbax
checkpoint directories (checkpoint conversion); ROADMAP.md Queue 1 names
the item that brings each.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
import warnings
from typing import Dict, List

import numpy as np
import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import KEYPOINT_NAMES, SYNTHETIC_CAMERA_K, Config, InferConfig, ModelConfig
from sgtapose_tpu_torch.data import loaders
from sgtapose_tpu_torch.eval.analysis import analyze_sequence_results
from sgtapose_tpu_torch.infer import detector as det_lib
from sgtapose_tpu_torch.models.sgta import create_model
from sgtapose_tpu_torch.utils.profiling import StageTimer

FLAGSHIP_ARCH = "dlapawdl3new_34"


def parse_args(argv=None):
    p = argparse.ArgumentParser("sgtapose_tpu_torch infer")
    p.add_argument("--dataset", required=True)
    p.add_argument("--ckpt", default=None, help="checkpoint file of train/trainer.save_checkpoint")
    p.add_argument("--output_dir", default="results/default")
    p.add_argument("--robot", default="panda_synthetic")
    p.add_argument("--object_name", default=None)
    p.add_argument("--is_real", default=None, help="real set name (e.g. panda-orb)")
    p.add_argument("--split_info", default=None, help="real split json path")
    p.add_argument("--arch", default=FLAGSHIP_ARCH, help=f"only {FLAGSHIP_ARCH} is ported")
    p.add_argument("--input_res", type=int, default=480)
    p.add_argument("--dla_node", default="dcn", choices=["dcn", "conv"])
    p.add_argument("--kernel_list", default="12,6,3,1,1,1", help="per-level attention window sizes")
    p.add_argument("--rf", action="store_true", help="LM pose refinement")
    p.add_argument("--multi_frame", type=int, default=0,
                   help="multiframe PnP window size (0 = off)")
    p.add_argument("--max_videos", type=int, default=None)
    p.add_argument("--ref_sort", default="score", choices=["score", "y"],
                   help="peak ambiguity ordering (decode/peaks.py)")
    p.add_argument("--quant", default=None, choices=["int8"], help="not ported")
    p.add_argument("--quant_static", action="store_true", help="not ported")
    p.add_argument("--quant_min_ch", type=int, default=0, help="not ported above 0")
    p.add_argument("--decode_coord", default="reg", choices=["reg", "avg", "logquad", "mean"],
                   help="final sub-pixel coordinate estimator (decode/peaks.py)")
    p.add_argument("--phase", default=None, help="only PlanA_win (the default) is ported")
    p.add_argument("--flip_test", action="store_true",
                   help="flip test-time augmentation of the DREAM single-frame mode (not ported)")
    p.add_argument("--is_ct", default="true", choices=["true", "false"],
                   help="false = the DREAM single-frame mode (not ported)")
    p.add_argument("--depth", action="store_true", help="42-joint depth-variant evaluation")
    p.add_argument("--track", action="store_true",
                   help="association pass per video; writes tracks.json")
    p.add_argument("--debug", type=int, default=0,
                   help="save per-frame debug images to output_dir/debug")
    p.add_argument("--hungarian", action="store_true",
                   help="Hungarian instead of greedy association (--track)")
    p.add_argument("--track_gate", type=float, default=0.2,
                   help="association distance gate in raw px (--track)")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu (plain PyTorch)")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """SystemExit for --flip_test on the temporal detector (as the JAX CLI);
    NotImplementedError, naming the ROADMAP item, for what is not ported."""
    if args.flip_test and args.is_ct != "false":
        raise SystemExit(
            "--flip_test is only defined for the DREAM single-frame mode (--is_ct false). On the "
            "temporal detector the reference's own flag is broken (pre_process never doubles the "
            "image batch, so _flip_output averages an empty [1:2] slice); flip-TTA is also "
            "ill-posed there because the PnP prior and attention cls maps are not "
            "mirror-equivariant.")
    unported = [
        ("--is_ct false / --flip_test (the DREAM single-frame detector)", args.is_ct == "false", 6),
        (f"--phase {args.phase}", args.phase != "PlanA_win", 6),
        (f"--arch {args.arch}", args.arch != FLAGSHIP_ARCH, 6),
        ("--quant", args.quant is not None, 8),
        ("--quant_static", args.quant_static, 8),
        ("--quant_min_ch > 0", args.quant_min_ch > 0, 8),
    ]
    asked = [f"{flag} (ROADMAP.md Queue 1 item {item})" for flag, on, item in unported if on]
    if asked:
        raise NotImplementedError(f"not ported to sgtapose_tpu_torch yet: {', '.join(asked)}")


class DetOut:
    """Per-video detector output: detections and what the tracker pass and
    the debug images need, as numpy."""

    def __init__(self, det, scores=None, tracking=None, debug_hm=None, debug_pre_hm=None):
        self.det = det  # (T, K, 2) raw coords / sentinel
        self.scores = scores  # (T, K)
        self.tracking = tracking  # (T, K, 2) raw-pixel displacement
        self.debug_hm = debug_hm  # (T, Ho, Wo, K) post-sigmoid, --debug only
        self.debug_pre_hm = debug_pre_hm  # (T, H_in, W_in, 1), --debug only


def _make_runner(args, model, cfg: Config, camera_K, raw_hw):
    """The exact streaming detector of one raw resolution: fn(raw uint8
    frames (T,H,W,3), x3d (T,K,3)) -> DetOut with raw-pixel detections (the
    device synchronised)."""
    debug = args.debug > 0
    detector = det_lib.make_video_detector(model, cfg, camera_K, raw_hw, device=args.device,
                                           debug_outputs=debug)

    def run(imgs_np, x3d):
        raw = torch.from_numpy(np.ascontiguousarray(imgs_np)).to(args.device)
        images, _, _ = det_lib.preprocess_frames(raw, cfg)
        video = det_lib.VideoFrames(images=images,
                                    x3d=torch.as_tensor(np.asarray(x3d), dtype=torch.float32))
        res = detector(video)
        return DetOut(res.detected_kps.cpu().numpy(), res.scores.cpu().numpy(), res.tracking.cpu().numpy(),
                      debug_hm=res.debug_hm.cpu().numpy() if debug else None,
                      debug_pre_hm=res.debug_pre_hm.cpu().numpy() if debug else None)

    return run


def _track_pass(out: DetOut, args):
    """Association over one video's detections with --track (None without)."""
    if not args.track or out.scores is None:
        return None
    from sgtapose_tpu_torch.infer.tracker import track_video

    return track_video(out.det, out.scores, out.tracking, gate=args.track_gate, hungarian=args.hungarian)


class _VideoLoop:
    """Per-video orchestration of `run_synthetic` and `run_real`: a runner
    per raw resolution (a mixed-resolution set builds one per resolution),
    each frame's resolution for the metrics, the detect time, the --track
    pass and the --debug images."""

    def __init__(self, args, model, cfg, camera_K, timer=None):
        self.args, self.model = args, model
        self.cfg, self.camera_K, self.timer = cfg, camera_K, timer
        self.runners = {}
        self.tracks = {}
        self.frame_res = []  # (w, h) per frame
        self.t_total, self.n_frames = 0.0, 0

    def run(self, vname, imgs_np, prior_pos, frame_names) -> DetOut:
        raw_hw = (imgs_np.shape[1], imgs_np.shape[2])
        if raw_hw not in self.runners:
            if self.runners:
                print(f"{vname}: new resolution {raw_hw}; building runner")
            self.runners[raw_hw] = _make_runner(self.args, self.model, self.cfg, self.camera_K, raw_hw)
        self.frame_res += [(imgs_np.shape[2], imgs_np.shape[1])] * imgs_np.shape[0]
        t0 = time.perf_counter()
        if self.timer is not None:
            with self.timer.stage("detect"):
                out_v = self.runners[raw_hw](imgs_np, prior_pos)
        else:
            out_v = self.runners[raw_hw](imgs_np, prior_pos)
        self.t_total += time.perf_counter() - t0
        self.n_frames += imgs_np.shape[0]
        ids = _track_pass(out_v, self.args)
        if ids is not None:
            self.tracks[vname] = ids.tolist()
        if self.args.debug:
            _write_debug_images(self.args, out_v, imgs_np, vname, frame_names, ids=ids)
        return out_v

    def res_arg(self):
        """(w, h) when uniform, else (F, 2) per frame."""
        return self.frame_res[0] if len(set(self.frame_res)) == 1 else np.array(self.frame_res)

    def fps(self) -> float:
        return self.n_frames / max(self.t_total, 1e-9)

    def report(self):
        print(f"inference: {self.n_frames} frames in {self.t_total:.2f}s ({self.fps():.1f} fps)")

    def timing(self) -> Dict[str, object]:
        return {"frames": self.n_frames, "detect_s": self.t_total, "fps": self.fps(),
                "runners": len(self.runners)}

    def dump_tracks(self, path):
        if self.tracks:
            with open(path, "w") as f:
                json.dump(self.tracks, f)
            print(f"tracks written for {len(self.tracks)} videos")


def _write_debug_images(args, out: DetOut, imgs_np, vname, frame_names, ids=None):
    """Per-frame debug images with --debug: 'generic', the raw frame with the
    detections, their scores, tracking arrows and (with --track) track ids;
    'pred_hm', the class-coloured post-sigmoid heatmaps blended over the
    warped network input; 'pre_hm', the rendered prior over the same. The
    heatmaps live in the centred-square warp frame, so they are drawn over
    the warped input, not resized onto the raw rectangle."""
    from sgtapose_tpu_torch.core import geometry
    from sgtapose_tpu_torch.utils.debugger import Debugger

    dbg_dir = os.path.join(args.output_dir, "debug")
    K = out.det.shape[1]
    dbg = Debugger(num_classes=K)
    need_warp = out.debug_hm is not None or out.debug_pre_hm is not None
    if need_warp:
        H_raw, W_raw = imgs_np.shape[1], imgs_np.shape[2]
        in_res = int(args.input_res)
        center = torch.tensor([W_raw / 2.0, H_raw / 2.0], dtype=torch.float32, device=args.device)
        trans_in = geometry.get_affine_transform(center, float(max(H_raw, W_raw)), 0.0, (in_res, in_res))
    for t, fname in enumerate(frame_names):
        dbg.clear()
        img = imgs_np[t]
        dbg.add_img(img, "generic")
        kps = out.det[t]
        dbg.add_keypoints(kps, "generic", scores=out.scores[t] if out.scores is not None else None)
        if out.tracking is not None:
            for k in range(K):
                if kps[k, 0] > -999.0:
                    dbg.add_arrow(kps[k], out.tracking[t, k], "generic")
        if ids is not None:
            for k in range(K):
                if kps[k, 0] > -999.0:
                    dbg.add_tracking_id(kps[k], int(ids[t][k]), "generic")
        if need_warp:
            warped = geometry.warp_affine(torch.as_tensor(img, dtype=torch.float32, device=args.device),
                                          trans_in, (in_res, in_res)).cpu().numpy()
            in_wh = (in_res, in_res)
            if out.debug_hm is not None:
                dbg.add_blend_img(warped, dbg.gen_colormap(out.debug_hm[t], output_res=in_wh), "pred_hm")
            if out.debug_pre_hm is not None:
                dbg.add_blend_img(warped, dbg.gen_colormap(out.debug_pre_hm[t], output_res=in_wh), "pre_hm")
        dbg.save_all_imgs(dbg_dir, prefix=f"{vname}_{fname}_")


def list_synthetic_videos(dataset_dir: str) -> Dict[str, List[str]]:
    """video name -> ordered frame basenames (without suffix), for videos of
    at least 2 frames."""
    videos = {}
    for vd in sorted(os.listdir(dataset_dir)):
        full = os.path.join(dataset_dir, vd)
        if not os.path.isdir(full):
            continue
        frames = sorted(f[: -len("_color.png")] for f in os.listdir(full) if f.endswith("_color.png"))
        if len(frames) >= 2:
            videos[vd] = frames
    return videos


def _multiframe_inputs(det, gt, pos, camera_K, res_arg, lengths, set_name):
    return dict(det=det, gt=gt, pos=pos, camera_K=camera_K, image_resolution=res_arg,
                video_lengths=lengths, set_name=set_name)


def run_synthetic(args, cfg: Config, model):
    """Synthetic videos under args.dataset: detections, metrics and the
    syn_* artifacts, dt_and_gt.json and (with --track) tracks.json."""
    camera_K = np.asarray(SYNTHETIC_CAMERA_K)
    kp_names = KEYPOINT_NAMES[args.robot]
    object_name = args.object_name or args.robot
    videos = list_synthetic_videos(args.dataset)
    names = list(videos)[: args.max_videos] if args.max_videos else list(videos)

    all_det, all_gt, all_pos, sample_names = [], [], [], []
    timer = StageTimer(resolve_device(args.device))
    loop = _VideoLoop(args, model, cfg, camera_K, timer=timer)
    for vname in names:
        frames = videos[vname]
        imgs, projs, pos_cam, x3d_rob = [], [], [], []
        with timer.stage("load"):
            for f in frames:
                imgs.append(loaders.load_image(os.path.join(args.dataset, vname, f + "_color.png")))
                kp = loaders.load_seq_keypoints(os.path.join(args.dataset, vname, f + "_meta.json"),
                                                object_name, kp_names, camera_K)
                projs.append(kp["projections"])
                pos_cam.append(kp["positions_wrt_cam"])
                x3d_rob.append(kp["positions_wrt_robot"])
        out_v = loop.run(vname, np.stack(imgs), np.stack(x3d_rob), frames)
        all_det.append(out_v.det)
        all_gt.append(np.stack(projs))
        all_pos.append(np.stack(pos_cam))
        sample_names += [f"{vname}/{f}" for f in frames]
        print(f"{vname}: {len(frames)} frames")

    det = np.concatenate(all_det)
    gt = np.concatenate(all_gt)
    pos = np.concatenate(all_pos)
    loop.report()
    res_arg = loop.res_arg()
    with timer.stage("eval"):
        results = analyze_sequence_results(
            det, gt.astype(np.float32), pos.astype(np.float32), camera_K, res_arg, args.output_dir,
            set_name="syn", sample_names=sample_names, rf=args.rf, syn=True, device=args.device)
    stages = timer.summary()
    print("stage times (s/video):", {k: round(v, 3) for k, v in stages.items()})
    os.makedirs(args.output_dir, exist_ok=True)
    loop.dump_tracks(os.path.join(args.output_dir, "tracks.json"))
    with open(os.path.join(args.output_dir, "dt_and_gt.json"), "w") as f:
        json.dump({"names": sample_names, "detections": det.tolist(), "gt_projections": gt.tolist()}, f)
    results["timing"] = dict(loop.timing(), stage_s=stages, stage_calls=dict(timer.counts))
    results["_multiframe_inputs"] = _multiframe_inputs(
        det, gt.astype(np.float32), pos.astype(np.float32), camera_K, res_arg,
        [a.shape[0] for a in all_det], "syn")
    return results


def run_real(args, cfg: Config, model):
    """A DREAM-real set: the split info json lists each video's relative
    image and json paths; intrinsics come from the set's
    _camera_settings.json; the camera-frame GT keypoints feed both the prior
    PnP and the ADD evaluation."""
    set_dir = os.path.join(args.dataset, args.is_real)
    camera_K = loaders.load_camera_intrinsics(os.path.join(set_dir, "_camera_settings.json"))
    split_path = args.split_info or os.path.join(args.dataset, "dream_real_info",
                                                 f"{args.is_real}_split_info.json")
    with open(split_path) as f:
        split = json.load(f)
    kp_names = KEYPOINT_NAMES["panda"]

    all_det, all_gt, all_pos, sample_names, json_list = [], [], [], [], []
    loop = _VideoLoop(args, model, cfg, camera_K)
    videos = list(zip(split["img_paths"], split["json_paths"]))
    if args.max_videos:
        videos = videos[: args.max_videos]
    for vi, (imgs_rel, jsons_rel) in enumerate(videos):
        imgs, projs, pos_cam = [], [], []
        for img_rel, js_rel in zip(imgs_rel, jsons_rel):
            js_path = os.path.join(set_dir, js_rel)
            imgs.append(loaders.load_image(os.path.join(set_dir, img_rel)))
            kp = loaders.load_keypoints(js_path, "panda", kp_names)
            projs.append(kp["projections"])
            pos_cam.append(kp["positions_wrt_cam"])
            json_list.append(js_path)
            sample_names.append(f"{vi:03d}/{os.path.basename(js_rel)}")
        imgs_np = np.stack(imgs)
        out_v = loop.run(f"{vi:03d}", imgs_np, np.stack(pos_cam),
                         [os.path.splitext(os.path.basename(r))[0] for r in imgs_rel])
        all_det.append(out_v.det)
        all_gt.append(np.stack(projs))
        all_pos.append(np.stack(pos_cam))
        print(f"video {vi}: {imgs_np.shape[0]} frames")

    det = np.concatenate(all_det)
    gt = np.concatenate(all_gt)
    pos = np.concatenate(all_pos)
    loop.report()
    os.makedirs(args.output_dir, exist_ok=True)
    loop.dump_tracks(os.path.join(args.output_dir, f"tracks_{args.is_real}.json"))
    with open(os.path.join(args.output_dir, f"dt_and_json_{args.is_real}.json"), "w") as f:
        json.dump({"dt": det.tolist(), "json": json_list}, f, indent=1)

    res_arg = loop.res_arg()
    results = analyze_sequence_results(
        det, gt.astype(np.float32), pos.astype(np.float32), camera_K, res_arg, args.output_dir,
        set_name=args.is_real, sample_names=sample_names, rf=args.rf, syn=False, device=args.device)
    results["timing"] = loop.timing()
    results["_multiframe_inputs"] = _multiframe_inputs(
        det, gt.astype(np.float32), pos.astype(np.float32), camera_K, res_arg,
        [a.shape[0] for a in all_det], args.is_real)
    return results


def run_depth(args, cfg: Config, model):
    """The 42-joint depth set: one flat directory of NNNN.png + NNNN.json
    frames (joints_3n_fixed_42), detection as usual, then the metric harness
    with 42 classes. --debug and --track are ignored with a warning, as the
    JAX CLI does."""
    if args.debug or args.track:
        warnings.warn("--debug/--track are not supported in --depth mode; ignoring")

    set_dir = os.path.join(args.dataset, args.is_real) if args.is_real else args.dataset
    pngs = sorted(glob.glob(os.path.join(set_dir, "*.png")))
    jsons = [p[: -len("png")] + "json" for p in pngs]
    camera_K = np.asarray(SYNTHETIC_CAMERA_K)
    object_name = args.object_name or "Franka_Emika_Panda"

    imgs, projs, pos_cam = [], [], []
    for img_path, js_path in zip(pngs, jsons):
        imgs.append(loaders.load_image(img_path))
        kp = loaders.load_depth_keypoints(js_path, object_name, camera_K)
        projs.append(kp["projections"])
        pos_cam.append(kp["positions_wrt_cam"])
    imgs_np = np.stack(imgs)
    raw_hw = (imgs_np.shape[1], imgs_np.shape[2])
    run = _make_runner(_replaced(args, debug=0), model, cfg, camera_K, raw_hw)
    t0 = time.perf_counter()
    det = run(imgs_np, np.stack(pos_cam).astype(np.float32)).det
    t_total = time.perf_counter() - t0
    print(f"depth inference: {len(pngs)} frames in {t_total:.2f}s")

    set_name = (args.is_real or "depth") + "_42"
    sample_names = [os.path.basename(p) for p in pngs]
    os.makedirs(args.output_dir, exist_ok=True)
    np_gt = np.stack(projs).astype(np.float32)
    np_pos = np.stack(pos_cam).astype(np.float32)
    with open(os.path.join(args.output_dir, f"dt_and_json_{set_name}.json"), "w") as f:
        json.dump({"dt": det.tolist(), "json": jsons}, f, indent=1)
    res_wh = (raw_hw[1], raw_hw[0])
    results = analyze_sequence_results(
        det, np_gt, np_pos, camera_K, res_wh, args.output_dir, set_name=set_name,
        sample_names=sample_names, rf=args.rf, syn=False, device=args.device)
    results["timing"] = {"frames": len(pngs), "detect_s": t_total, "fps": len(pngs) / max(t_total, 1e-9),
                         "runners": 1}
    results["_multiframe_inputs"] = _multiframe_inputs(det, np_gt, np_pos, camera_K, res_wh,
                                                       [len(pngs)], set_name)
    return results


def run_multiframe(args, mi) -> Dict[str, Dict]:
    """Both multiframe PnP estimators over a run's `_multiframe_inputs`: the
    sliding window per video and the random frame combinations, each with
    its CSV."""
    from sgtapose_tpu_torch.eval.analysis import solve_multiframe_pnp, solve_multiframe_pnp_real

    mf = solve_multiframe_pnp(
        mi["det"], mi["gt"], mi["pos"], mi["camera_K"], mi["image_resolution"],
        multiframe=args.multi_frame, video_lengths=mi["video_lengths"], rf=args.rf,
        output_dir=args.output_dir, set_name=mi["set_name"], device=args.device)
    mf_real = solve_multiframe_pnp_real(
        mi["det"], mi["pos"], mi["camera_K"], multiframe=args.multi_frame, rf=args.rf,
        output_dir=args.output_dir, set_name=mi["set_name"], device=args.device)
    print(f"multiframe({args.multi_frame}) ADD AUC@0.06m: "
          f"sliding={mf['add_auc']:.5f} random={mf_real['add_auc']:.5f}")
    return {"multiframe_pnp_metrics": mf, "multiframe_pnp_real_metrics": mf_real}


def _replaced(args, **overrides):
    """A copy of the argparse namespace with some fields replaced."""
    return argparse.Namespace(**{**vars(args), **overrides})


def load_model(args, cfg: Config, device):
    """The flagship model on `device`: the "model" entry of a
    `train/trainer.save_checkpoint` file, or seeded random weights (with a
    warning) without --ckpt."""
    model = create_model(cfg.model, device=device, seed=0)
    if args.ckpt:
        path = os.path.abspath(args.ckpt)
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{args.ckpt} is a directory (an orbax checkpoint of the JAX package?); the port reads "
                "train/trainer.save_checkpoint files. Converting JAX checkpoints is ROADMAP.md Queue 1 "
                "item 5 (checkpoint conversion)")
        payload = torch.load(path, map_location=device, weights_only=True)
        model.load_state_dict(payload["model"])
        print(f"loaded {args.ckpt}")
    else:
        warnings.warn(
            "no --ckpt given: running with RANDOM weights — detections will be empty/garbage. This "
            "mode only exercises the pipeline (tests/smoke); pass --ckpt for real inference.",
            stacklevel=2)
        print("WARNING: no --ckpt — random-weight model, smoke mode only")
    return model.eval()


def make_config(args) -> Config:
    num_classes = 42 if args.depth else len(KEYPOINT_NAMES[args.robot])
    return Config(
        model=ModelConfig(arch=args.arch, input_res=(args.input_res, args.input_res),
                          num_classes=num_classes, dla_node=args.dla_node,
                          kernel_list=tuple(int(x) for x in args.kernel_list.split(","))),
        infer=InferConfig(ref_sort=args.ref_sort, decode_coord=args.decode_coord),
        robot=args.robot,
    )


def main(argv=None):
    args = parse_args(argv)
    if args.phase is None:
        args.phase = "Dream" if args.is_ct == "false" else "PlanA_win"
    _refuse_unported(args)
    dev = resolve_device(args.device)
    # float32 inference is float32: cuDNN convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_config(args)
    model = load_model(args, cfg, dev)

    if args.depth:
        results = run_depth(args, cfg, model)
    elif args.is_real:
        results = run_real(args, cfg, model)
    else:
        results = run_synthetic(args, cfg, model)

    mi = results.pop("_multiframe_inputs")
    if args.multi_frame > 0:
        results.update(run_multiframe(args, mi))
    km, pm = results["keypoint_metrics"], results["pnp_metrics"]
    print(f"PCK AUC@12px: {km['l2_error_auc']}")
    print(f"ADD AUC@0.06m: {pm['add_auc']}")
    return results


if __name__ == "__main__":
    main()
