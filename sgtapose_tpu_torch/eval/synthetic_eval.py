"""Synthetic-video evaluation harness.

Counterpart of `sgtapose_tpu/eval/synthetic_eval.py`: the bf16 inference
wrapper (`make_bf16_apply`, with int8 serving through `quant=`), the int8
calibration frames (`calibration_inputs`), held-out synthetic videos
(`make_eval_videos`) and the runner -> `analyze_sequence_results` plumbing
(`evaluate_runner`), which scores a detector's keypoints and ADD on the same
videos, so the accuracy cost of bf16 and int8 serving and of the feature
cache can be read beside the exact float32 detector's.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from sgtapose_tpu_torch.config import Config
from sgtapose_tpu_torch.data import pipeline, synthetic
from sgtapose_tpu_torch.eval.analysis import analyze_sequence_results
from sgtapose_tpu_torch.infer import detector as det_lib
from sgtapose_tpu_torch.models import layers
from sgtapose_tpu_torch.utils.precision import cast_floating


def make_bf16_apply(model, quant: str | None = None, quant_scales=None, quant_min_ch: int = 0) -> Callable:
    """fn(*inputs) -> heads: the inputs cast to bf16, the model run, the head
    outputs cast to float32. `model` is a bf16 model
    (`utils/precision.bf16_inference_model`). quant="int8" runs every call as
    one forward under `models/layers.quantized`: quant_scales (from
    `layers.calibrate`) make the activation scales static, quant_min_ch
    leaves sites with min(out_ch, in_ch) below it in float."""

    @torch.no_grad()
    def apply(*inputs):
        out = model(*cast_floating(inputs, torch.bfloat16))
        return {k: v.to(torch.float32) for k, v in out.items()}

    if quant is not None:
        apply = layers.quantized_apply(apply, quant, scales=quant_scales, min_ch=quant_min_ch)
    return apply


def calibration_inputs(cfg: Config, n_frames: int = 4, seed: int = 0, device="cuda"):
    """Single-frame model inputs for int8 calibration, as the JAX package
    draws them (from the port's generators: frame i from one seeded from
    (seed + 4242, i)): a 2-frame synthetic video through the training
    batch pipeline's preprocessing and ground-truth prior rendering, giving
    (cur, pre, pre_hm, repro_hm, pre_cls, repro_cls) tuples of batch 1 on
    `device`, shaped like the streaming detector's per-frame inputs. The
    keypoint count follows cfg.model.num_classes."""
    n_kp = cfg.model.num_classes
    skel = synthetic.robot_skeleton(n_kp, device)
    batch_fn = pipeline.make_batch_fn(cfg, synthetic.camera_K(device))
    out = []
    for i in range(n_frames):
        gen = torch.Generator().manual_seed((seed + 4242) * 1_000_003 + i)
        projs, imgs = synthetic.make_sequence(gen, 2, n_kp=n_kp, device=device)
        raw = pipeline.RawSample(prev_img=imgs[0][None], next_img=imgs[1][None], prev_projs=projs[0][None],
                                 next_projs=projs[1][None], prev_x3d_rob=skel[None], next_x3d_rob=skel[None])
        b = batch_fn(gen, raw)
        out.append(tuple(b[k] for k in ("cur_img", "pre_img", "pre_hm", "repro_hm", "pre_hm_cls",
                                         "repro_hm_cls")))
    return out


def make_eval_videos(n_videos: int, n_frames: int, seed: int, n_kp: int | None = None,
                     device="cuda") -> List[Tuple[np.ndarray, torch.Tensor, np.ndarray]]:
    """Held-out synthetic videos [(gt_projs (T,K,2), raw_imgs (T,H,W,3) on
    `device`, gt_pos_cam (T,K,3)), ...]; video v is drawn from its own
    generator, seeded from (seed + 99, v)."""
    vids = []
    for v in range(n_videos):
        gen = torch.Generator().manual_seed((seed + 99) * 100003 + v)
        projs, imgs, pos_cam = synthetic.make_sequence(gen, n_frames, return_pos_cam=True,
                                                       n_kp=n_kp, device=device)
        vids.append((projs.cpu().numpy(), imgs, pos_cam.cpu().numpy()))
    return vids


def evaluate_runner(run, cfg: Config, vids, rf: bool = True, device="cuda"):
    """Drive a single-video runner (fn(VideoFrames) -> FrameResult, e.g.
    `make_video_detector`'s) over the videos; return (results of
    `analyze_sequence_results`, fps). fps counts every frame of every video
    over the host clock, synchronised, including any first-call set-up."""
    n_kp = cfg.model.num_classes
    skel = synthetic.robot_skeleton(n_kp)
    all_det, all_gt, all_pos = [], [], []
    t0 = time.perf_counter()
    n_total = 0
    for projs, imgs, pos_cam in vids:
        if projs.shape[1] != n_kp:
            raise ValueError(f"eval vids have {projs.shape[1]} keypoints but the model expects "
                             f"{n_kp}; generate them with make_eval_videos(..., n_kp={n_kp})")
        T = imgs.shape[0]
        n_total += T
        images, _, _ = det_lib.preprocess_frames(imgs, cfg)
        x3d = skel.to(images.device)[None].expand(T, -1, -1)
        res = run(det_lib.VideoFrames(images=images, x3d=x3d))
        all_det.append(res.detected_kps.cpu().numpy())  # synchronises
        all_gt.append(projs)
        all_pos.append(pos_cam)
    dt = time.perf_counter() - t0
    results = analyze_sequence_results(
        np.concatenate(all_det), np.concatenate(all_gt).astype(np.float32),
        np.concatenate(all_pos).astype(np.float32), synthetic.camera_K().numpy(),
        (synthetic.RAW_W, synthetic.RAW_H), output_dir=None, rf=rf, syn=False, device=device)
    return results, n_total / max(dt, 1e-9)
