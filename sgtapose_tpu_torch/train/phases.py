"""Training phases (counterpart of `sgtapose_tpu/train/phases.py`): which
batch tensors feed the model and which loss terms apply.

  PlanA_win     the flagship's six inputs
  PlanA_three   the three-frame variant's nine
  PlanA, PlanACAT, ablation_shared_repro / _shared / _wo_shared
                the image pair and the 1-channel priors (the shared and
                wo_shared ablations ignore repro_hm)
  CenterTrack   the current and previous images and the noised previous
                ground-truth prior
  CenterNet     the current image alone
  Dream         the DREAM baselines (heatmap loss only): not ported yet
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from sgtapose_tpu_torch.config import ModelConfig

PHASES = (
    "PlanA_win", "PlanA_three", "PlanA", "PlanACAT",
    "ablation_shared_repro", "ablation_shared", "ablation_wo_shared",
    "CenterTrack", "CenterNet", "Dream",
)
PORTED = PHASES[:-1]

_PAIR = ("cur_img", "pre_img", "pre_hm", "repro_hm")
_INPUTS = {
    "PlanA_win": _PAIR + ("pre_hm_cls", "repro_hm_cls"),
    "PlanA_three": ("cur_img", "ppre_img", "pre_img", "ppre_hm", "pre_hm", "repro_hm",
                    "ppre_hm_cls", "pre_hm_cls", "repro_hm_cls"),
    "PlanA": _PAIR, "PlanACAT": _PAIR, "ablation_shared_repro": _PAIR,
    "ablation_shared": _PAIR, "ablation_wo_shared": _PAIR,
    "CenterTrack": ("cur_img", "pre_img", "pre_origin_hm"),
    "CenterNet": ("cur_img",),
}


def _check(phase: str) -> None:
    if phase not in PHASES:
        raise ValueError(f"unknown phase: {phase}")
    if phase not in PORTED:
        raise NotImplementedError(
            f"phase {phase!r} (the DREAM baselines) is not ported to sgtapose_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 6)")


def input_names(phase: str) -> Tuple[str, ...]:
    """Batch keys fed to the model, in order."""
    _check(phase)
    return _INPUTS[phase]


def model_inputs(phase: str, batch: Dict) -> Tuple:
    """Positional model inputs of the phase."""
    return tuple(batch[k] for k in input_names(phase))


def model_wiring(cfg: ModelConfig, phase: str) -> Tuple[ModelConfig, bool]:
    """How `phase` wires cfg.arch's model: the model config (an ablation_*
    phase sets its ablation_mode; other phases keep cfg's) and whether the
    single-frame model takes the previous frame and a prior (CenterTrack),
    the arguments of `models/sgta.create_model` / `build_model`."""
    _check(phase)
    if phase.startswith("ablation_"):
        cfg = dataclasses.replace(cfg, ablation_mode=phase[len("ablation_"):])
    return cfg, phase == "CenterTrack"


def loss_weights(phase: str, hm=1.0, reg=0.01, tracking=0.0) -> Dict[str, float]:
    """Per-head loss weights (Dream: the heatmap only)."""
    if phase == "Dream":
        return {"hm_weight": hm, "reg_weight": 0.0, "tracking_weight": 0.0}
    return {"hm_weight": hm, "reg_weight": reg, "tracking_weight": tracking}
