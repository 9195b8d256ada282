"""Configuration dataclasses for the port (own copy of the reference's
`sgtapose_tpu/config.py` subset this slice runs, with identical defaults)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

KEYPOINT_NAMES = {
    "panda": [
        "panda_link0",
        "panda_link2",
        "panda_link3",
        "panda_link4",
        "panda_link6",
        "panda_link7",
        "panda_hand",
    ],
    "panda_synthetic": [
        "Link0",
        "Link1",
        "Link3",
        "Link4",
        "Link6",
        "Link7",
        "Panda_hand",
    ],
    "kuka": [
        "Link0",
        "Link1",
        "Link2",
        "Link3",
        "Link4",
        "Link5",
        "Link6",
        "Link7",
        "Kuka_hand",
    ],
    "ur5e": [
        "Link0",
        "Link1",
        "Link2",
        "Link3",
        "Link4",
        "Link5",
        "Link6",
        "Ur_hand",
    ],
}

# Fixed synthetic camera intrinsics
SYNTHETIC_CAMERA_K = (
    (502.30, 0.0, 319.75),
    (0.0, 502.30, 179.75),
    (0.0, 0.0, 1.0),
)

# Image normalization: mean=std=0.5 (the SGTAPose convention, not ImageNet)
IMAGE_MEAN = (0.5, 0.5, 0.5)
IMAGE_STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config. Fields the port does not use yet (bf16, int8,
    DCN chunking, fused-attention switches) are absent: the port always runs
    its attention kernel and float32."""

    arch: str = "dlapawdl3new_34"  # flagship: DLA-34 + l3new windowed attention
    num_classes: int = 7
    input_res: Tuple[int, int] = (480, 480)  # (H, W) network input
    down_ratio: int = 4  # output stride -> 120x120 heatmaps
    head_conv: int = 256
    prior_bias: float = -4.6  # hm head bias init
    dla_node: str = "dcn"  # decoder node type: dcn | conv
    num_decoder_layers: int = 3  # cross-attention encoder depth (weight-tied)
    n_heads: int = 8
    pos_embed: bool = True  # learned (heads, n, n) attention bias
    k_list: Tuple[int, ...] = (1, 1, 1, 1, 1, 1)
    kernel_list: Tuple[int, ...] = (12, 6, 3, 1, 1, 1)
    scale_list: Tuple[float, ...] = (4.0, 2.0, 1.0, 0.5, 0.25, 0.125)

    @property
    def output_res(self) -> Tuple[int, int]:
        return (self.input_res[0] // self.down_ratio, self.input_res[1] // self.down_ratio)


@dataclass(frozen=True)
class InferConfig:
    out_thresh: float = 0.1
    peak_thresh: float = 0.01  # min blurred-map intensity for a peak
    peak_sigma: float = 3.0  # gaussian blur before local-max
    peak_offset: float = 0.4395  # offset_due_to_upsampling
    ambiguity_gap: float = 0.25  # 2-peak score-gap acceptance rule
    max_peaks: int = 8  # candidate-peak budget per class
    ref_sort: str = "score"  # "score" or "y" (see decode/peaks.py)
    decode_coord: str = "reg"  # reg | avg | logquad | mean
    # warm-start the per-frame prior PnP from the previous frame's pose
    pnp_warm_start: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    robot: str = "panda_synthetic"

    @property
    def keypoint_names(self) -> Sequence[str]:
        return KEYPOINT_NAMES[self.robot]
