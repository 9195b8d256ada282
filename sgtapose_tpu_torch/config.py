"""Configuration dataclasses for the port (own copy of the reference's
`sgtapose_tpu/config.py` subset the port runs, with identical defaults)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

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
    """Architecture config. bf16, int8 and the fused-attention switch are not
    fields here: bf16 is a cast of the model (`utils/precision.py`), int8 a
    context around its calls (`models/layers.py`), and the port always runs
    its attention kernel."""

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
    # the global-attention variant's (dlapa) token count per level
    topk_global: int = 28
    # the ablation variant's (dlaabla) trunk sharing and prior wiring:
    # wo_shared | shared | shared_repro
    ablation_mode: str = "shared_repro"
    # large-batch training memory knobs of the DCN decoder nodes (numbers
    # unchanged; models/dla.py:DeformNode): dcn_chunks > 1 forms the DCN's
    # sampled columns in row slabs where the port forms them (the plain
    # versions, the int8 modes), bounding their (B,H,W,9,C) gather temps;
    # dcn_remat recomputes the DCN in the backward instead of keeping its
    # activations
    dcn_chunks: int = 1
    dcn_remat: bool = False

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
class TrainConfig:
    """Training config: the fields the port's trainer and batch pipeline
    read, with the JAX package's defaults."""

    lr: float = 1.25e-4
    warmup_iters: int = 3000  # linear warmup
    poly_power: float = 1.0  # poly decay to max_iters
    seed: int = 317
    # prior heatmap fault-injection curriculum
    hm_disturb: float = 0.75
    lost_disturb: float = 0.2
    # false-positive blobs in the origin prior: inert unless fp_disturb_active
    # (the reference's live renderer has the block commented out)
    fp_disturb: float = 0.1
    fp_disturb_active: bool = False
    # sequence window remap of the training pairs (data/discovery.py)
    seq_frame: int = 3


@dataclass(frozen=True)
class MeshConfig:
    """The data-parallel layout (`parallel/mesh.py`): the number of ranks,
    one card each, that a run expects (None: every process of the run);
    `parallel/mesh.check_num_devices` holds the process group to it. JAX's
    MeshConfig also names its mesh axis ("data"); a process group has no
    axis names, so the port has no such field."""

    num_devices: Optional[int] = None


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    infer: InferConfig = field(default_factory=InferConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    robot: str = "panda_synthetic"

    @property
    def keypoint_names(self) -> Sequence[str]:
        return KEYPOINT_NAMES[self.robot]


def default_config() -> Config:
    return Config()
