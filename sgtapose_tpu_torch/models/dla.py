"""DLA-34 backbone and the iterative deep aggregation decoder.

Counterpart of `sgtapose_tpu/models/dla.py`. Submodules carry the flax
module names (`Conv_0`, `BatchNorm_0`, `tree1`, `project_conv`, `proj_1`,
`up_1`, `node_1`, ...) so each torch parameter sits at the path of its flax
counterpart and `utils/weights.py` maps the two trees one to one.

Modules take and return NCHW tensors; the model feeds them NHWC data viewed
as NCHW (channels_last memory), so the convolutions and the DCN sampler
share one memory layout without copies. Inference only: BatchNorm runs on
its running statistics (flax momentum 0.9 == torch momentum 0.1, eps 1e-5).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch.models.deform_conv import DeformConv2d

BN_MOMENTUM = 0.1  # torch convention; flax's 0.9


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


class ConvBnAct(nn.Module):
    """3x3 conv (stride 1 or 2) + BN + ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 3, stride, padding=1, bias=False)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class BasicBlock(nn.Module):
    """Two 3x3 convs + residual."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBnAct_0 = ConvBnAct(in_features, features, stride)
        self.Conv_0 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = self.BatchNorm_0(self.Conv_0(self.ConvBnAct_0(x)))
        return F.relu(out + residual)


class Root(nn.Module):
    """1x1 conv over concatenated children (DLA-34 roots add no residual)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 1, bias=False)
        self.BatchNorm_0 = _bn(features)

    def forward(self, children: Sequence[torch.Tensor]):
        return F.relu(self.BatchNorm_0(self.Conv_0(torch.cat(list(children), dim=1))))


class Tree(nn.Module):
    """Hierarchical aggregation tree. As in the JAX module, the residual is
    always this tree's own projected bottom, and levels > 1 trees create no
    (dead) projection."""

    def __init__(self, levels: int, in_features: int, features: int, stride: int = 1,
                 level_root: bool = False, root_in: int = 0):
        super().__init__()
        self.levels = levels
        self.stride = stride
        self.level_root = level_root
        if root_in == 0:
            root_in = 2 * features + (in_features if level_root else 0)
        if levels == 1:
            if in_features != features:
                self.project_conv = nn.Conv2d(in_features, features, 1, bias=False)
                self.project_bn = _bn(features)
            else:
                self.project_conv = None
            self.tree1 = BasicBlock(in_features, features, stride)
            self.tree2 = BasicBlock(features, features, 1)
            self.root = Root(root_in, features)
        else:
            self.tree1 = Tree(levels - 1, in_features, features, stride)
            self.tree2 = Tree(levels - 1, features, features, 1, root_in=root_in + features)

    def forward(self, x, children=None):
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            proj = bottom
            if self.project_conv is not None:
                proj = self.project_bn(self.project_conv(bottom))
            x1 = self.tree1(x, proj)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class Stem(nn.Module):
    """7x7 conv-bn-relu conditioning stem."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, features, 7, padding=3, bias=False)
        self.BatchNorm_0 = _bn(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class DLA34Backbone(nn.Module):
    """DLA-34 trunk: 6 levels, channels (16, 32, 64, 128, 256, 512); takes the
    stem-summed level-0 input and returns all 6 level features."""

    def __init__(self, channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)):
        super().__init__()
        ch = channels
        self.level0 = ConvBnAct(ch[0], ch[0], 1)
        self.level1 = ConvBnAct(ch[0], ch[1], 2)
        self.level2 = Tree(1, ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(2, ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(2, ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(1, ch[4], ch[5], 2, level_root=True)

    def forward(self, x) -> List[torch.Tensor]:
        y = []
        for name in ("level0", "level1", "level2", "level3", "level4", "level5"):
            x = getattr(self, name)(x)
            y.append(x)
        return y


def bilinear_upsample_kernel(factor: int) -> torch.Tensor:
    """(2f, 2f) bilinear kernel (the reference's fill_up_weights)."""
    k = 2 * factor
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    wx = 1 - torch.abs(torch.arange(k, dtype=torch.float32) / f - c)
    return wx[:, None] * wx[None, :]


def depthwise_upsample(features: int, factor: int) -> nn.ConvTranspose2d:
    """Trainable depthwise 2f x 2f transposed conv, stride f, bilinear init
    (the JAX DepthwiseUpsample; every decoder factor is >= 2). The JAX
    module's lhs-dilated grouped conv with kernel w equals this
    ConvTranspose2d with w rotated by 180 degrees (utils/weights.py)."""
    k = 2 * factor
    up = nn.ConvTranspose2d(features, features, k, stride=factor, padding=factor // 2,
                            groups=features, bias=False)
    with torch.no_grad():
        up.weight.copy_(bilinear_upsample_kernel(factor).expand(features, 1, k, k))
    return up


class DeformNode(nn.Module):
    """DCN (or 1x1 conv) + BN + ReLU decoder node."""

    def __init__(self, in_features: int, features: int, node_type: str = "dcn"):
        super().__init__()
        if node_type == "dcn":
            self.conv = DeformConv2d(in_features, features)
        elif node_type == "conv":
            self.conv = nn.Conv2d(in_features, features, 1, bias=False)
        else:
            raise ValueError(f"unknown dla_node {node_type!r}")
        self.BatchNorm_0 = _bn(features)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.conv(x)))


class IDAUp(nn.Module):
    """Iterative deep aggregation step: for each finer level, project ->
    upsample -> merge with the previous level through a node, writing the
    result back into the list."""

    def __init__(self, features: int, in_channels: Tuple[int, ...], up_factors: Tuple[int, ...],
                 node_type: str = "dcn"):
        super().__init__()
        self.n = len(in_channels)
        for j in range(1, self.n):
            setattr(self, f"proj_{j}", DeformNode(in_channels[j], features, node_type))
            setattr(self, f"up_{j}", depthwise_upsample(features, int(up_factors[j])))
            setattr(self, f"node_{j}", DeformNode(features, features, node_type))

    def forward(self, layers: List[torch.Tensor], startp: int, endp: int) -> List[torch.Tensor]:
        for i in range(startp + 1, endp):
            j = i - startp
            x = getattr(self, f"up_{j}")(getattr(self, f"proj_{j}")(layers[i]))
            layers[i] = getattr(self, f"node_{j}")(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    """Full decoder pyramid."""

    def __init__(self, startp: int, channels: Tuple[int, ...], scales: Tuple[int, ...],
                 node_type: str = "dcn"):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels)
        scales = list(scales)
        self.n = len(channels) - 1
        for i in range(self.n):
            j = -i - 2
            up_f = tuple(s // scales[j] for s in scales[j:])
            setattr(self, f"ida_{i}", IDAUp(channels[j], tuple(in_channels[j:]), up_f, node_type))
            scales[j + 1:] = [scales[j] for _ in scales[j + 1:]]
            in_channels[j + 1:] = [channels[j] for _ in in_channels[j + 1:]]

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        layers = list(layers)
        out = [layers[-1]]
        for i in range(self.n):
            getattr(self, f"ida_{i}")(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out
