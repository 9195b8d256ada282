"""Training losses (counterpart of `sgtapose_tpu/train/loss.py`): the MSE
between the clamped sigmoid of the heatmap logits and the GT belief maps, and
SmoothL1 of the reg / tracking heads gathered at the GT integer keypoint
pixels; weights hm 1, reg 0.01, tracking 0."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-4, 1 - 1e-4]."""
    return torch.sigmoid(x).clamp(1e-4, 1.0 - 1e-4)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.SmoothL1Loss (beta 1, mean), written as the JAX package does."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def gather_at_keypoints(feat: torch.Tensor, coords_int: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, 2), coords_int (B, K, 2) integer (x, y) -> (B, K, 2)."""
    b = torch.arange(feat.shape[0], device=feat.device)[:, None]
    c = coords_int.to(torch.int64)
    return feat[b, c[..., 1], c[..., 0]]


def sgta_loss(outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
              hm_weight: float = 1.0, reg_weight: float = 0.01,
              tracking_weight: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"tot", "hm", "reg", "tracking"}) from the heads' logits and a
    batch with gt_belief_maps (B, H/4, W/4, C), kp_int (B, K, 2), reg_target
    and tracking_target (B, K, 2)."""
    hm = clamped_sigmoid(outputs["hm"])
    hm_loss = ((hm - batch["gt_belief_maps"]) ** 2).mean()
    zero = hm_loss.new_zeros(())
    reg_loss = (smooth_l1(gather_at_keypoints(outputs["reg"], batch["kp_int"]), batch["reg_target"])
                if "reg" in outputs else zero)
    tracking_loss = (smooth_l1(gather_at_keypoints(outputs["tracking"], batch["kp_int"]),
                               batch["tracking_target"]) if "tracking" in outputs else zero)
    total = hm_weight * hm_loss + reg_weight * reg_loss + tracking_weight * tracking_loss
    return total, {"tot": total, "hm": hm_loss, "reg": reg_loss, "tracking": tracking_loss}
