"""Training phases (counterpart of `sgtapose_tpu/train/phases.py`): which
batch tensors feed the model and which loss terms apply. Only the flagship
`PlanA_win` is ported; the other phases' architectures are not, and raise."""

from __future__ import annotations

from typing import Dict, Tuple

PHASES = (
    "PlanA_win", "PlanA_three", "PlanA", "PlanACAT",
    "ablation_shared_repro", "ablation_shared", "ablation_wo_shared",
    "CenterTrack", "CenterNet", "Dream",
)
PORTED = ("PlanA_win",)


def _check(phase: str) -> None:
    if phase not in PHASES:
        raise ValueError(f"unknown phase: {phase}")
    if phase not in PORTED:
        raise NotImplementedError(f"phase {phase!r} is not ported to sgtapose_tpu_torch (PlanA_win only)")


def input_names(phase: str) -> Tuple[str, ...]:
    """Batch keys fed to the model, in order."""
    _check(phase)
    return ("cur_img", "pre_img", "pre_hm", "repro_hm", "pre_hm_cls", "repro_hm_cls")


def model_inputs(phase: str, batch: Dict) -> Tuple:
    """Positional model inputs of the phase."""
    return tuple(batch[k] for k in input_names(phase))


def loss_weights(phase: str, hm=1.0, reg=0.01, tracking=0.0) -> Dict[str, float]:
    """Per-head loss weights (Dream: the heatmap only)."""
    if phase == "Dream":
        return {"hm_weight": hm, "reg_weight": 0.0, "tracking_weight": 0.0}
    return {"hm_weight": hm, "reg_weight": reg, "tracking_weight": tracking}
