"""Set-level evaluation and its artifacts, and multiframe PnP.

Counterpart of `sgtapose_tpu/eval/analysis.py` (`analyze_sequence_results`,
`solve_multiframe_pnp`, `solve_multiframe_pnp_real`) on top of
`eval/metrics.py`. Inputs and outputs are numpy; the PnP solves of a call run
as one batched solve on `device`.
"""

from __future__ import annotations

import os
from itertools import combinations
from math import comb
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from sgtapose_tpu_torch.eval import metrics


def analyze_sequence_results(
    detections: np.ndarray,
    gt_projs: np.ndarray,
    gt_pos_cam: np.ndarray,
    camera_K: np.ndarray,
    image_resolution: Tuple[int, int],
    output_dir: Optional[str] = None,
    set_name: str = "eval",
    sample_names: Optional[Sequence[str]] = None,
    rf: bool = True,
    syn: bool = False,
    device="cuda",
) -> Dict[str, Dict]:
    """Keypoint metrics, per-frame PnP/ADD and, with output_dir, the
    {set}_keypoints.csv, {set}_pnp_results.csv and {set}_analysis_results.txt
    artifacts. detections/gt_projs: (F, K, 2) raw-pixel coords (below -999
    for a missing detection); gt_pos_cam: (F, K, 3) camera-frame GT points;
    image_resolution: (w, h), or (F, 2) per frame."""
    F, K, _ = detections.shape
    res = np.asarray(image_resolution)
    kp_res = res if res.ndim == 1 else np.repeat(res, K, axis=0)
    kp_m = metrics.keypoint_metrics(detections.reshape(F * K, 2), gt_projs.reshape(F * K, 2),
                                    kp_res, syn=syn)
    adds, succ = metrics.compute_add_batch(detections, gt_pos_cam, camera_K, rf=rf, device=device)
    n_inframe = metrics.count_inframe_gt(gt_projs, image_resolution)
    pnp_m = metrics.pnp_metrics(adds, n_inframe)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        names = sample_names or [f"{set_name}_{i:06d}" for i in range(F)]
        metrics.write_keypoints_csv(os.path.join(output_dir, f"{set_name}_keypoints.csv"),
                                    names, detections, gt_projs)
        metrics.write_pnp_csv(os.path.join(output_dir, f"{set_name}_pnp_results.csv"),
                              names, succ.tolist(), adds.tolist(), n_inframe.tolist())
        metrics.write_analysis_results(
            os.path.join(output_dir, f"{set_name}_analysis_results.txt"), kp_m, pnp_m)
    return {"keypoint_metrics": kp_m, "pnp_metrics": pnp_m, "adds": adds}


def solve_multiframe_pnp(
    detections: np.ndarray,
    gt_projs: np.ndarray,
    gt_pos_cam: np.ndarray,
    camera_K: np.ndarray,
    image_resolution: Tuple[int, int],
    multiframe: int = 2,
    video_lengths: Optional[Sequence[int]] = None,
    rf: bool = False,
    output_dir: Optional[str] = None,
    set_name: str = "eval",
    device="cuda",
) -> Dict[str, object]:
    """Sliding-window multiframe PnP: per video, each frame ind >=
    multiframe-1 stacks the last `multiframe` frames' (detected 2D, GT 3D)
    pairs into one solve (missing detections masked). The viability count
    comes from the current frame's GT projections. `video_lengths` splits the
    flat frame axis so windows never span videos. Returns pnp_metrics; with
    output_dir writes {set}_{multiframe}_pnp_results.csv."""
    F, K, _ = detections.shape
    lengths = list(video_lengths) if video_lengths is not None else [F]
    if sum(lengths) != F:
        raise ValueError(f"video_lengths {lengths} do not sum to {F} frames")
    res = np.asarray(image_resolution)

    det_stacks, pos_stacks, n_inframe, names = [], [], [], []
    start = 0
    for vi, L in enumerate(lengths):
        for ind in range(multiframe - 1, L):
            f = start + ind
            det_stacks.append(detections[f - multiframe + 1: f + 1].reshape(-1, 2))
            pos_stacks.append(gt_pos_cam[f - multiframe + 1: f + 1].reshape(-1, 3))
            n_inframe.append(int(metrics.count_inframe_gt(gt_projs[f], res if res.ndim == 1 else res[f])))
            names.append(f"{vi:03d}/{ind}")
        start += L

    if not det_stacks:
        return metrics.pnp_metrics(np.zeros((0,)), np.zeros((0,), np.int32))

    adds, succ = metrics.compute_add_batch(np.stack(det_stacks), np.stack(pos_stacks), camera_K,
                                           rf=rf, device=device)
    n_inframe = np.asarray(n_inframe)
    results = metrics.pnp_metrics(adds, n_inframe)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        metrics.write_pnp_csv(os.path.join(output_dir, f"{set_name}_{multiframe}_pnp_results.csv"),
                              names, succ.tolist(), adds.tolist(), n_inframe.tolist())
    return results


def solve_multiframe_pnp_real(
    detections: np.ndarray,
    gt_pos_cam: np.ndarray,
    camera_K: np.ndarray,
    multiframe: int = 2,
    rf: bool = False,
    n_samples: int = 2500,
    seed: int = 0,
    output_dir: Optional[str] = None,
    set_name: str = "eval",
    device="cuda",
) -> Dict[str, object]:
    """Random-combination multiframe PnP: `n_samples` random
    `multiframe`-sized frame combinations over all frames (every combination
    when there are fewer), each stacked into one solve. Viability is fixed at
    multiframe*K in-frame points per combination. The combinations are drawn
    from numpy's RandomState(seed), as the JAX harness draws them."""
    F, K, _ = detections.shape
    rng = np.random.RandomState(seed)
    if comb(F, multiframe) > n_samples:
        idx = [rng.choice(F, size=multiframe, replace=False) for _ in range(n_samples)]
    else:
        idx = [list(c) for c in combinations(range(F), multiframe)]
    idx = np.asarray(idx)  # (n, multiframe)

    det_stacks = detections[idx].reshape(len(idx), -1, 2)
    pos_stacks = gt_pos_cam[idx].reshape(len(idx), -1, 3)
    adds, succ = metrics.compute_add_batch(det_stacks, pos_stacks, camera_K, rf=rf, device=device)
    n_inframe = np.full((len(idx),), multiframe * K, np.int32)
    results = metrics.pnp_metrics(adds, n_inframe)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        names = ["+".join(str(i) for i in row) for row in idx]
        metrics.write_pnp_csv(
            os.path.join(output_dir, f"{set_name}_{multiframe}_real_pnp_results.csv"),
            names, succ.tolist(), adds.tolist(), n_inframe.tolist())
    return results
