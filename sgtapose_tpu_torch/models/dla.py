"""DLA-34 backbone and the iterative deep aggregation decoder.

Counterpart of `sgtapose_tpu/models/dla.py`. Submodules carry the flax
module names (`Conv_0`, `BatchNorm_0`, `tree1`, `project_conv`, `proj_1`,
`up_1`, `node_1`, ...) so each torch parameter sits at the path of its flax
counterpart and `utils/weights.py` maps the two trees one to one.

Modules take and return NCHW tensors; the model feeds them NHWC data viewed
as NCHW (channels_last memory), so the convolutions and the DCN sampler
share one memory layout without copies. BatchNorm is flax's (`BatchNorm`):
running statistics in eval mode, batch statistics with flax's running
average in train mode (`model.train()` / `model.eval()` switch it).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch.models.deform_conv import DeformConv2d
from sgtapose_tpu_torch.parallel import mesh

BN_MOMENTUM = 0.9  # flax convention: running = 0.9 running + 0.1 batch


class BatchNorm(nn.BatchNorm2d):
    """flax `nn.BatchNorm(momentum=momentum, epsilon=1e-5)` over NCHW. Eval
    mode: the running statistics, as `nn.BatchNorm2d`. Train mode: the
    batch's statistics over N*H*W, its BIASED variance both for normalising
    and for the running average, running = momentum running + (1 - momentum)
    batch (flax's convention: the DLA models' 0.9 by default, the DREAM
    baselines pass 0.1; nn.BatchNorm2d feeds the unbiased variance into
    running_var). Under several data-parallel ranks the statistics are the global batch's
    (`parallel/mesh.global_moments`), as the JAX mesh step computes them.

    bf16 training (bf16 input and parameters, float32 running statistics,
    `utils/precision.bf16_forward`): as flax computes it, the statistics,
    the normalisation, scale and shift in float32 (`_compute_stats` promotes
    to at least float32), the output rounded once to bf16, the running
    averages updated in float32; in eval mode the float32 running
    statistics. (bf16 serving casts the statistics too.)"""

    def __init__(self, c: int, momentum: float = BN_MOMENTUM):
        super().__init__(c, eps=1e-5)
        self.flax_momentum = momentum

    def forward(self, x):
        # the parameters in the statistics' dtype: a no-op but in bf16
        # training, where batch_norm then takes a bf16 x with float32
        # parameters and statistics and returns x's dtype
        stat_dtype = self.running_mean.dtype
        weight, bias = self.weight.to(stat_dtype), self.bias.to(stat_dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, weight, bias, False, 0.0, self.eps)
        if mesh.world_size() > 1:
            mean, var = mesh.global_moments(x, (0, 2, 3))
            scale = weight * torch.rsqrt(var + self.eps)
            out = (x - mean[None, :, None, None]) * scale[None, :, None, None] + bias[None, :, None, None]
            out = out.to(x.dtype)
            mean, var = mean.detach(), var.detach()
        else:
            out = F.batch_norm(x, None, None, weight, bias, True, 0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.to(stat_dtype), dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.to(stat_dtype), alpha=1 - m)
            self.running_var.mul_(m).add_(var.to(stat_dtype), alpha=1 - m)
        return out


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c)


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
