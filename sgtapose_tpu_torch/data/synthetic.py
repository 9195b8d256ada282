"""Synthetic sequences: random camera-to-robot poses of a fixed keypoint
skeleton (the 7-keypoint panda chain, or it resampled to n keypoints),
rendered as colour-coded blob images (640x360 raws, the synthetic camera).
Counterpart of `sgtapose_tpu/data/synthetic.py` (`robot_skeleton`,
`random_pose`, `render_frame`, `make_sequence`); randomness comes from an
explicit `torch.Generator`, so the numbers differ from `jax.random` draws,
while `robot_skeleton`, `sequence_from_motion` and `render_frame` are the
same functions of their inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import SYNTHETIC_CAMERA_K
from sgtapose_tpu_torch.core import geometry

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


def sequence_from_motion(q0, t0, dq, dt, num_frames: int, skel=None):
    """Frame f has pose (normalize(q0 + f*dq), t0 + f*dt). Returns projections
    (T,K,2), images (T,H,W,3) and camera-frame keypoints (T,K,3) of `skel`
    (default: the 7-keypoint chain)."""
    skel = skeleton(q0.device) if skel is None else skel.to(q0.device)
    K = camera_K(q0.device)
    projs, imgs, pos = [], [], []
    for f in range(num_frames):
        q = q0 + dq * f
        q = q / torch.linalg.vector_norm(q)
        t = t0 + dt * f
        R = geometry.quat_to_matrix(q)
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
    q0, t0 = random_pose(generator)
    dq = torch.randn(4, generator=generator) * 0.01
    dt = torch.randn(3, generator=generator) * 0.01
    dev = resolve_device(device)
    skel = None if n_kp is None else robot_skeleton(n_kp)
    out = sequence_from_motion(q0.to(dev), t0.to(dev), dq.to(dev), dt.to(dev), num_frames, skel)
    return out if return_pos_cam else out[:2]
