"""Synthetic sequences: random camera-to-robot poses of a fixed keypoint
skeleton (the 7-keypoint panda chain, or it resampled to n keypoints),
rendered as colour-coded blob images (640x360 raws, the synthetic camera).
Counterpart of `sgtapose_tpu/data/synthetic.py` (`robot_skeleton`,
`random_pose`, `render_frame`, `make_sequence`, `make_raw_batch`, and the
on-disk fixture writers `write_synthetic_dataset`, `write_real_dataset`,
`write_depth_dataset` with `skeleton_42`); randomness comes from an
explicit `torch.Generator`, so the numbers differ from `jax.random` draws,
while `robot_skeleton`, `skeleton_42`, `sequence_from_motion` and
`render_frame` are the same functions of their inputs, and the writers write
the same file names and JSON keys.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch
from PIL import Image

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import KEYPOINT_NAMES, SYNTHETIC_CAMERA_K
from sgtapose_tpu_torch.core import geometry
from sgtapose_tpu_torch.data.pipeline import RawSample

RAW_H, RAW_W = 360, 640

# a panda-ish 7-keypoint chain in the robot frame (meters)
SKELETON = (
    (0.0, 0.0, 0.0),
    (0.0, 0.0, 0.333),
    (0.0, -0.1, 0.45),
    (0.08, -0.1, 0.6),
    (0.08, 0.05, 0.75),
    (0.0, 0.1, 0.85),
    (0.0, 0.12, 0.95),
)

PALETTE = (
    (255.0, 40.0, 40.0),
    (40.0, 255.0, 40.0),
    (40.0, 80.0, 255.0),
    (255.0, 255.0, 40.0),
    (255.0, 40.0, 255.0),
    (40.0, 255.0, 255.0),
    (255.0, 255.0, 255.0),
    (255.0, 140.0, 40.0),
    (140.0, 40.0, 255.0),
)


def skeleton(device="cpu") -> torch.Tensor:
    return torch.tensor(SKELETON, dtype=torch.float32, device=device)


def robot_skeleton(n_kp: int, device="cpu") -> torch.Tensor:
    """Skeleton of an n-keypoint robot: the panda chain, linearly resampled
    to n points (kuka has 9 keypoints, ur5e 8)."""
    skel = skeleton(device)
    if n_kp == skel.shape[0]:
        return skel
    seg = torch.linspace(0.0, skel.shape[0] - 1.0, n_kp, device=skel.device)
    lo = torch.floor(seg).to(torch.int64).clamp(0, skel.shape[0] - 2)
    frac = (seg - lo)[:, None]
    return skel[lo] * (1 - frac) + skel[lo + 1] * frac


def camera_K(device="cpu") -> torch.Tensor:
    return torch.tensor(SYNTHETIC_CAMERA_K, dtype=torch.float32, device=device)


def random_pose(generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-from-robot pose (quat wxyz, trans) on the CPU, with the
    skeleton's centroid on the optical axis at ~2.15-2.65 m and a lateral
    spread that leaves a few distal keypoints out of frame."""
    q = torch.randn(4, generator=generator)
    q = q / torch.linalg.vector_norm(q)
    centroid = skeleton().mean(0)
    R = geometry.quat_to_matrix(q)
    u = torch.rand(3, generator=generator) * 0.5 - 0.25
    depth = torch.tensor([0.0, 0.0, 2.4]) + u * torch.tensor([2.6, 2.8, 1.0])
    return q, depth - R @ centroid


def render_frame(projs: torch.Tensor) -> torch.Tensor:
    """One gaussian blob per keypoint, coloured per class (past 9 classes the
    palette cycles with a brightness ramp), on a dark background:
    (RAW_H, RAW_W, 3) float in [0, 255]."""
    n = projs.shape[0]
    conf = torch.ones(n, dtype=torch.float32, device=projs.device)
    per = geometry.render_gaussian_heatmap(projs, conf, RAW_H, RAW_W, radius=8, sigma=3.0,
                                           per_class=True)
    palette = torch.tensor(PALETTE, dtype=torch.float32, device=projs.device)
    reps = -(-n // len(PALETTE))
    colors = torch.cat([palette * s for s in torch.linspace(1.0, 0.45, reps).tolist()])[:n]
    img = torch.einsum("khw,kc->hwc", per, colors)
    return (img + 20.0).clamp(0.0, 255.0)


def _motion(generator: torch.Generator, device):
    """(q0, t0, dq, dt) of one video's smooth motion on `device`."""
    q0, t0 = random_pose(generator)
    dq = torch.randn(4, generator=generator) * 0.01
    dt = torch.randn(3, generator=generator) * 0.01
    return tuple(x.to(device) for x in (q0, t0, dq, dt))


def motion_pose(q0, t0, dq, dt, f: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, t) of frame f of a smooth motion: (normalize(q0 + f*dq), t0 + f*dt)."""
    q = q0 + dq * f
    q = q / torch.linalg.vector_norm(q)
    return geometry.quat_to_matrix(q), t0 + dt * f


def sequence_from_motion(q0, t0, dq, dt, num_frames: int, skel=None):
    """Frame f has pose `motion_pose(..., f)`. Returns projections (T,K,2),
    images (T,H,W,3) and camera-frame keypoints (T,K,3) of `skel` (default:
    the 7-keypoint chain)."""
    skel = skeleton(q0.device) if skel is None else skel.to(q0.device)
    K = camera_K(q0.device)
    projs, imgs, pos = [], [], []
    for f in range(num_frames):
        R, t = motion_pose(q0, t0, dq, dt, f)
        p = geometry.project_points(skel, R, t, K)
        projs.append(p)
        imgs.append(render_frame(p))
        pos.append(geometry.transform_points(skel, R, t))
    return torch.stack(projs), torch.stack(imgs), torch.stack(pos)


def make_sequence(generator: torch.Generator, num_frames: int = 2, return_pos_cam: bool = False,
                  n_kp: int | None = None, device="cuda"):
    """A short video: smooth camera motion around a static robot, drawn from
    `generator`. Returns (projs (T,K,2), imgs (T,H,W,3)) on `device` and, with
    return_pos_cam, also the camera-frame keypoints (T,K,3) for ADD
    evaluation. n_kp selects the robot (default: the 7-keypoint chain)."""
    dev = resolve_device(device)
    skel = None if n_kp is None else robot_skeleton(n_kp)
    out = sequence_from_motion(*_motion(generator, dev), num_frames, skel)
    return out if return_pos_cam else out[:2]


def make_raw_batch(generator: torch.Generator, batch_size: int, device="cuda") -> RawSample:
    """A batch of (prev, next) synthetic frame pairs of the 7-keypoint chain,
    sample after sample from `generator`, rendered on `device`."""
    seqs = [make_sequence(generator, 2, device=device) for _ in range(batch_size)]
    projs = torch.stack([p for p, _ in seqs])  # (B, 2, K, 2)
    imgs = torch.stack([i for _, i in seqs])  # (B, 2, H, W, 3)
    skel = skeleton(projs.device).expand(batch_size, -1, -1)
    return RawSample(prev_img=imgs[:, 0], next_img=imgs[:, 1], prev_projs=projs[:, 0],
                     next_projs=projs[:, 1], prev_x3d_rob=skel, next_x3d_rob=skel)


# -----------------------------------------------------------------------------
# On-disk datasets in the formats `data/loaders.py` reads
# -----------------------------------------------------------------------------


def _frame(skel, R, t, K):
    """(camera-frame points, projections, uint8 blob image) as numpy."""
    pos_cam = geometry.transform_points(skel, R, t)
    projs = geometry.project_points(skel, R, t, K)
    img = render_frame(projs).cpu().numpy().astype(np.uint8)
    return pos_cam.cpu().numpy(), projs.cpu().numpy(), img


def write_synthetic_dataset(out_dir: str, n_videos: int = 2, n_frames: int = 4, seed: int = 0,
                            robot_name: str = "panda_synthetic", device="cuda"):
    """Write {out_dir}/VVVVV/NNNN_color.png + NNNN_meta.json videos in the
    synthetic sequence format: per-keypoint `location_wrt_cam` and the
    frame-level `R2C Mat` rotation under "keypoints", the robot under
    "ROBOT NAME". Video v moves smoothly from a pose drawn from a generator
    seeded from (seed, v); frames are rendered on `device`."""
    dev = resolve_device(device)
    K = camera_K(dev)
    base = robot_name.replace("_synthetic", "")
    kp_names = KEYPOINT_NAMES.get(robot_name, KEYPOINT_NAMES.get(base, KEYPOINT_NAMES["panda_synthetic"]))
    skel = robot_skeleton(len(kp_names), dev)
    for v in range(n_videos):
        vdir = os.path.join(out_dir, f"{v:05d}")
        os.makedirs(vdir, exist_ok=True)
        motion = _motion(torch.Generator().manual_seed(seed * 1_000_003 + v), dev)
        for f in range(n_frames):
            R, t = motion_pose(*motion, f)
            pos_cam, _, img = _frame(skel, R, t, K)
            Image.fromarray(img).save(os.path.join(vdir, f"{f:04d}_color.png"))
            R_list = R.cpu().numpy().tolist()
            meta = [{"ROBOT NAME": robot_name,
                     "keypoints": [{"Name": name, "location_wrt_cam": pos_cam[i].tolist(), "R2C Mat": R_list}
                                   for i, name in enumerate(kp_names)]}]
            with open(os.path.join(vdir, f"{f:04d}_meta.json"), "w") as fp:
                json.dump(meta, fp)


def write_real_dataset(out_dir: str, set_name: str = "panda-test", n_videos: int = 1, n_frames: int = 3,
                       seed: int = 0, device="cuda"):
    """Write a set in the DREAM-real format: {set}/NNNNNN.rgb.png + NNNNNN.json
    (objects[0] of class "panda" with keypoints' `location` and
    `projected_location`), {set}/_camera_settings.json (the synthetic camera,
    640x360) and dream_real_info/{set}_split_info.json (per video, its
    img_paths and json_paths)."""
    dev = resolve_device(device)
    K = camera_K(dev)
    Kn = np.asarray(SYNTHETIC_CAMERA_K)
    kp_names = KEYPOINT_NAMES["panda"]
    set_dir = os.path.join(out_dir, set_name)
    info_dir = os.path.join(out_dir, "dream_real_info")
    os.makedirs(set_dir, exist_ok=True)
    os.makedirs(info_dir, exist_ok=True)
    with open(os.path.join(set_dir, "_camera_settings.json"), "w") as f:
        json.dump({"camera_settings": [{
            "intrinsic_settings": {"fx": Kn[0, 0], "fy": Kn[1, 1], "cx": Kn[0, 2], "cy": Kn[1, 2]},
            "captured_image_size": {"width": RAW_W, "height": RAW_H}}]}, f)

    skel = skeleton(dev)
    img_paths, json_paths = [], []
    idx = 0
    for v in range(n_videos):
        motion = _motion(torch.Generator().manual_seed(seed * 1_000_003 + v), dev)
        v_imgs, v_jsons = [], []
        for f in range(n_frames):
            R, t = motion_pose(*motion, f)
            pos_cam, projs, img = _frame(skel, R, t, K)
            img_name, js_name = f"{idx:06d}.rgb.png", f"{idx:06d}.json"
            Image.fromarray(img).save(os.path.join(set_dir, img_name))
            blob = {"objects": [{"class": "panda", "keypoints": [
                {"name": name, "location": pos_cam[i].tolist(), "projected_location": projs[i].tolist()}
                for i, name in enumerate(kp_names)]}]}
            with open(os.path.join(set_dir, js_name), "w") as fp:
                json.dump(blob, fp)
            v_imgs.append(img_name)
            v_jsons.append(js_name)
            idx += 1
        img_paths.append(v_imgs)
        json_paths.append(v_jsons)
    with open(os.path.join(info_dir, f"{set_name}_split_info.json"), "w") as f:
        json.dump({"img_paths": img_paths, "json_paths": json_paths}, f)


def skeleton_42(device="cpu") -> torch.Tensor:
    """The 42-joint depth skeleton: each of the 7-keypoint chain's 6 segments
    at 7 evenly spaced points from its start, (42, 3)."""
    skel = skeleton(device)
    return torch.stack([skel[i] + (skel[i + 1] - skel[i]) * (s / 7.0) for i in range(6) for s in range(7)])


def write_depth_dataset(out_dir: str, set_name: str = "panda-depth", n_frames: int = 4, seed: int = 0,
                        robot_name: str = "Franka_Emika_Panda", device="cuda"):
    """Write the 42-joint depth format: flat {set}/NNNN.png + NNNN.json, each
    json a one-element list with "ROBOT NAME", keypoints[0] (`R2C_mat` and
    the `location_wrt_cam` of the robot's base, the camera-to-robot anchor)
    and the camera-frame `joints_3n_fixed_42`. One smooth motion drawn from
    a generator seeded from seed."""
    dev = resolve_device(device)
    K = camera_K(dev)
    joints = skeleton_42(dev)
    base = skeleton(dev)[:1]
    set_dir = os.path.join(out_dir, set_name)
    os.makedirs(set_dir, exist_ok=True)
    motion = _motion(torch.Generator().manual_seed(seed), dev)
    for f in range(n_frames):
        R, t = motion_pose(*motion, f)
        pos_cam, _, img = _frame(joints, R, t, K)
        Image.fromarray(img).save(os.path.join(set_dir, f"{f:04d}.png"))
        anchor = geometry.transform_points(base, R, t)[0].cpu().numpy()
        meta = [{"ROBOT NAME": robot_name,
                 "keypoints": [{"Name": "Link0", "R2C_mat": R.cpu().numpy().tolist(),
                                "location_wrt_cam": anchor.tolist()}],
                 "joints_3n_fixed_42": [{"location_wrt_cam": p.tolist()} for p in pos_cam]}]
        with open(os.path.join(set_dir, f"{f:04d}.json"), "w") as fp:
            json.dump(meta, fp)
