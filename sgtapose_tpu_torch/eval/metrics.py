"""Evaluation metrics: PCK / keypoint L2 AUC, PnP ADD AUC, and the CSV/txt
writers.

Counterpart of `sgtapose_tpu/eval/metrics.py` (the reference's analysis
metrics): keypoint_metrics (in/out-frame found/missing buckets, L2 stats over
found in-frame keypoints, PCK AUC at 12 px by a 0.01 px trapezoid, `syn`
mode's 140 px horizontal gap), pnp_metrics (ADD stats over PnP successes, ADD
AUC at 0.06 m by a 1e-5 trapezoid, viable = at least 4 in-frame GT
keypoints), and the per-frame ADD: PnP on the detected subset against the GT
camera-frame 3D points, with the optional weighted refinement (rf: w =
exp(-5 d^2), add = min(refined, pnp)).

Aggregation is numpy on the host, as in the JAX package; the per-frame PnP
and refinement solves run batched over frames in torch (`torch.func.vmap`:
one launch per operation for all frames), on the device of `device`.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Tuple

import numpy as np
import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.core import geometry, pnp

PNP_MAGIC = -999.0

# np.trapezoid is NumPy >= 2.0; the old name on 1.x installs
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def keypoint_metrics(
    keypoints_detected: np.ndarray,
    keypoints_gt: np.ndarray,
    image_resolution: Tuple[int, int],
    auc_pixel_threshold: float = 12.0,
    syn: bool = False,
) -> Dict[str, object]:
    """detected/gt: (N, 2) raw-pixel coords over all frames x keypoints;
    detections below -999 are missing. image_resolution: (w, h), or (N, 2)
    per row for mixed-resolution sets."""
    det = np.asarray(keypoints_detected, np.float64)
    gt = np.asarray(keypoints_gt, np.float64)
    gap = 140.0 if syn else 0.0
    res = np.asarray(image_resolution)
    if res.ndim == 1:
        w, h = res
    else:
        w, h = res[:, 0], res[:, 1]

    out_of_frame = (gt[:, 0] < gap) | (gt[:, 0] > w - gap) | (gt[:, 1] < 0.0) | (gt[:, 1] > h)
    missing = (det[:, 0] < -999.0) & (det[:, 1] < -999.0)

    num_gt_inframe = int((~out_of_frame).sum())
    found_in = ~out_of_frame & ~missing
    num_found_gt_inframe = int(found_in.sum())
    if num_found_gt_inframe > 0:
        errs = np.linalg.norm(det[found_in] - gt[found_in], axis=1)
        mean, med, std = float(errs.mean()), float(np.median(errs)), float(errs.std())
        delta = 0.01
        thresholds = np.arange(0, auc_pixel_threshold, delta)
        y = (errs[None, :] < thresholds[:, None]).sum(axis=1)
        auc = float(_trapezoid(y, dx=delta) / auc_pixel_threshold / num_gt_inframe)
    else:
        mean = med = std = auc = None

    return {
        "num_gt_outframe": int(out_of_frame.sum()),
        "num_missing_gt_outframe": int((out_of_frame & missing).sum()),
        "num_found_gt_outframe": int((out_of_frame & ~missing).sum()),
        "num_gt_inframe": num_gt_inframe,
        "num_found_gt_inframe": num_found_gt_inframe,
        "num_missing_gt_inframe": int((~out_of_frame & missing).sum()),
        "l2_error_mean_px": mean,
        "l2_error_median_px": med,
        "l2_error_std_px": std,
        "l2_error_auc": auc,
        "l2_error_auc_thresh_px": auc_pixel_threshold,
    }


def pnp_metrics(
    pnp_add: np.ndarray,
    num_inframe_projs_gt: np.ndarray,
    num_min_inframe_projs_gt_for_pnp: int = 4,
    add_auc_threshold: float = 0.06,
) -> Dict[str, object]:
    pnp_add = np.asarray(pnp_add, np.float64)
    n_inframe = np.asarray(num_inframe_projs_gt)
    found = pnp_add > PNP_MAGIC
    add_found = pnp_add[found]
    num_found = int(found.sum())
    num_possible = int((n_inframe >= num_min_inframe_projs_gt_for_pnp).sum())

    delta = 1e-5
    thresholds = np.arange(0.0, add_auc_threshold, delta)
    counts = (add_found[None, :] <= thresholds[:, None]).sum(axis=1) / max(float(num_possible), 1.0)
    auc = float(_trapezoid(counts, dx=delta) / add_auc_threshold)

    def stat(f):
        return float(f(add_found)) if num_found else None

    return {
        "num_pnp_found": num_found,
        "num_pnp_not_found": num_possible - num_found,
        "num_pnp_possible": num_possible,
        "add_mean": stat(np.mean),
        "add_median": stat(np.median),
        "add_std": stat(np.std),
        "add_max": stat(np.max),
        "add_min": stat(np.min),
        "add_auc": auc,
        "add_auc_thresh": add_auc_threshold,
    }


# -----------------------------------------------------------------------------
# Per-frame ADD (batched over frames)
# -----------------------------------------------------------------------------


def _frame_add(detected, gt_pos_cam, K_cam, rf: bool):
    """One frame (or stacked multiframe window): PnP on the detected subset
    and the optional weighted refinement -> (ADD, success). detected (M, 2),
    gt_pos_cam (M, 3)."""
    valid = (detected > PNP_MAGIC).all(1)
    res = pnp.solve_pnp(gt_pos_cam, detected, K_cam, valid)
    R = geometry.quat_to_matrix(res.quat)
    aligned = geometry.transform_points(gt_pos_cam, R, res.trans)
    err = torch.linalg.vector_norm(aligned - gt_pos_cam, dim=1)
    validf = valid.to(torch.float32)
    wsum = validf.sum().clamp(min=1.0)
    add_pnp = (err * validf).sum() / wsum  # mean over the detected subset

    if rf:
        # weights from the SQUARED reprojection distance
        proj = geometry.project_points(gt_pos_cam, R, res.trans, K_cam)
        d2 = ((detected - proj) ** 2).sum(1)
        w = torch.exp(-5.0 * d2)[:, None].expand(-1, 2) * validf[:, None]
        q1, t1 = pnp.register_gn(detected, gt_pos_cam, res.quat, res.trans, w, K_cam)
        qn = q1 / torch.linalg.vector_norm(q1).clamp(min=1e-12)
        finite = torch.isfinite(q1).all() & torch.isfinite(t1).all()
        R1 = geometry.quat_to_matrix(torch.where(finite, qn, res.quat))
        t1 = torch.where(finite, t1, res.trans)
        aligned1 = geometry.transform_points(gt_pos_cam, R1, t1)
        err1 = torch.linalg.vector_norm(aligned1 - gt_pos_cam, dim=1)
        add_rf = (err1 * validf).sum() / wsum
        add_pnp = torch.minimum(add_pnp, add_rf)

    add = torch.where(res.success, add_pnp, torch.full_like(add_pnp, -999.99))
    return add, res.success


@torch.no_grad()
def compute_add_batch(
    detected: np.ndarray,
    gt_pos_cam: np.ndarray,
    camera_K: np.ndarray,
    rf: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(F, M, 2), (F, M, 3) -> (adds (F,) float32, successes (F,) bool), all
    frames in one batched solve on `device`. Rows may be stacked multiframe
    windows (M = multiframe * K)."""
    dev = resolve_device(device)
    if len(detected) == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), bool)
    K = torch.as_tensor(np.array(camera_K, np.float32), device=dev)
    adds, succ = torch.func.vmap(lambda d, g: _frame_add(d, g, K, rf))(
        torch.as_tensor(np.array(detected, np.float32), device=dev),
        torch.as_tensor(np.array(gt_pos_cam, np.float32), device=dev))
    return adds.cpu().numpy(), succ.cpu().numpy()


def count_inframe_gt(gt_projs: np.ndarray, image_resolution) -> np.ndarray:
    """Per frame: the number of strictly in-frame GT projections.
    image_resolution: (w, h), or (F, 2) per frame."""
    res = np.asarray(image_resolution)
    if res.ndim == 1:
        w, h = res
    else:
        w, h = res[:, 0][:, None], res[:, 1][:, None]
    inb = (gt_projs[..., 0] > 0.0) & (gt_projs[..., 0] < w) & (gt_projs[..., 1] > 0.0) & (gt_projs[..., 1] < h)
    return inb.sum(axis=-1)


# -----------------------------------------------------------------------------
# Artifact writers
# -----------------------------------------------------------------------------


def write_keypoints_csv(path, names, detected, gt):
    """Per-keypoint CSV: name, kp index, detected xy, gt xy."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "keypoint", "det_x", "det_y", "gt_x", "gt_y"])
        for name, det_f, gt_f in zip(names, detected, gt):
            for k in range(len(det_f)):
                w.writerow([name, k, det_f[k][0], det_f[k][1], gt_f[k][0], gt_f[k][1]])


def write_pnp_csv(path, names, successes, adds, n_inframe):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "pnp_success", "add", "n_inframe_gt"])
        for row in zip(names, successes, adds, n_inframe):
            w.writerow(list(row))


def write_analysis_results(path, kp_metrics: Dict, pnp_results: Dict):
    """The analysis_results.txt summary: keypoint then PnP metrics."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Keypoint metrics\n")
        for k, v in kp_metrics.items():
            f.write(f"  {k}: {v}\n")
        f.write("PnP metrics\n")
        for k, v in pnp_results.items():
            f.write(f"  {k}: {v}\n")
