"""The DREAM baseline family: single-frame belief-map networks.

Counterpart of `sgtapose_tpu/models/dream_baselines.py`:

  * `DreamHourglass`: a VGG19-features encoder (five stages of 3x3 conv +
    ReLU, 2x2 max pooling between them) and either decoder: nearest x2
    upsampling (the default; each stage's last conv has NO ReLU after it, as
    in the reference) or transposed convs (`deconv_decoder`), with the
    `full_output` extra upsampling and `skip_connections`. Output at input/4
    (default) or input/1 (full_output, deconv_decoder).
  * `ResnetSimple`: a resnet trunk of `Bottleneck`s (stride on the 3x3; resnet101's
    (3, 4, 23, 3) blocks by default) and 4 [ConvTranspose2d(4, 2, 1) + BN +
    ReLU] stages, a 1x1 head. Output at input/2 (`full`: input/1 through a
    fifth stage).
  * `spatial_softmax`: the soft-argmax keypoint decoder.

Modules run NCHW inside; `forward` takes NHWC images and returns {"hm":
NHWC logits}, like the flax modules and the port's other models. Submodules
carry the flax module names (`layer_0_1_down.conv0`, `upsample_0_4_conv1`,
`layer3_0.downsample_bn`, `up0_deconv`, ...), so `utils/weights.py` maps the
two trees one to one. BatchNorm uses flax's momentum 0.1 here (running =
0.1 running + 0.9 batch), the JAX module's BN_MOMENTUM.

The JAX `TorchDeconv` is a ConvTranspose2d written as an lhs-dilated conv
whose kernel (kh, kw, in, out) is the torch weight rotated by 180 degrees;
here it is `nn.ConvTranspose2d`, and `utils/weights.py` moves the rotation
into the weight loader.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch.models.dla import BatchNorm

BN_MOMENTUM = 0.1


def torch_deconv(in_features: int, features: int, kernel: int, padding: int,
                 output_padding: int = 0) -> nn.ConvTranspose2d:
    """The JAX `TorchDeconv`: a stride-2 transposed conv with a bias."""
    return nn.ConvTranspose2d(in_features, features, kernel, stride=2, padding=padding,
                              output_padding=output_padding)


def _conv3(in_features: int, features: int) -> nn.Conv2d:
    return nn.Conv2d(in_features, features, 3, padding=1)


class VGGStage(nn.Module):
    """Consecutive VGG19 conv + ReLU pairs (the pooling is the caller's)."""

    def __init__(self, in_features: int, features: int, convs: int):
        super().__init__()
        self.n = convs
        for i in range(convs):
            setattr(self, f"conv{i}", _conv3(in_features if i == 0 else features, features))

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


_ENCODER = (("layer_0_1_down", 64, 2), ("layer_0_2_down", 128, 2), ("layer_0_3_down", 256, 4),
            ("layer_0_4_down", 512, 4), ("layer_0_5_down", 512, 4))
# deconv decoder stages: (name, features, has a conv after the deconv)
_DECONV = (("deconv_0_4", 256, True), ("deconv_0_3", 128, True), ("deconv_0_2", 64, True),
           ("deconv_0_1", 64, False))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class DreamHourglass(nn.Module):
    """NHWC image (B, H, W, 3) -> {"hm": (B, H/4, W/4, K)} logits, or at H, W
    with full_output or deconv_decoder."""

    def __init__(self, n_keypoints: int, deconv_decoder: bool = False, full_output: bool = False,
                 skip_connections: bool = False):
        super().__init__()
        self.deconv_decoder, self.full_output = deconv_decoder, full_output
        self.skip_connections = skip_connections
        c_in = 3
        for name, c, n in _ENCODER:
            setattr(self, name, VGGStage(c_in, c, n))
            c_in = c
        if deconv_decoder:
            for name, c, has_conv in _DECONV:
                setattr(self, f"{name}_deconv", torch_deconv(c_in, c, 3, padding=1, output_padding=1))
                if has_conv:
                    setattr(self, f"{name}_conv", _conv3(c, c))
                c_in = c
        else:
            for name, mid, c in (("upsample_0_4", 256, 256), ("upsample_0_3", 128, 64)):
                setattr(self, f"{name}_conv1", _conv3(c_in, mid))
                setattr(self, f"{name}_conv2", _conv3(mid, c))
                c_in = c
            if full_output:
                for name in ("upsample_0_2", "upsample_0_1"):
                    setattr(self, f"{name}_conv1", _conv3(c_in, 64))
                    setattr(self, f"{name}_conv2", _conv3(64, 64))
                    c_in = 64
        self.heads_0_conv1 = _conv3(c_in, 64)
        self.heads_0_conv2 = _conv3(64, 32)
        self.heads_0_out = _conv3(32, n_keypoints)

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = img.permute(0, 3, 1, 2)
        feats, pooled = [], []
        for name, _, _ in _ENCODER:
            x = getattr(self, name)(x)
            feats.append(x)
            if len(feats) < len(_ENCODER):
                x = F.max_pool2d(x, 2)
                pooled.append(x)
        x_0_1, _, _, _, _ = feats
        x_0_1_d, x_0_2_d, x_0_3_d, x_0_4_d = pooled
        skip = self.skip_connections
        y = x + x_0_4_d if skip else x
        if self.deconv_decoder:
            skips = {"deconv_0_3": x_0_3_d, "deconv_0_2": x_0_2_d, "deconv_0_1": x_0_1_d}
            for name, _, has_conv in _DECONV:
                if skip and name in skips:
                    y = y + skips[name]
                y = F.relu(getattr(self, f"{name}_deconv")(y))
                if has_conv:
                    y = F.relu(getattr(self, f"{name}_conv")(y))
            if skip:
                y = y + x_0_1
        else:
            # nearest x2 + conv + ReLU + conv, no ReLU after the stage's last conv
            y = self.upsample_0_4_conv2(F.relu(self.upsample_0_4_conv1(_up2(y))))
            if skip:
                y = y + x_0_3_d
            y = self.upsample_0_3_conv2(F.relu(self.upsample_0_3_conv1(_up2(y))))
            if self.full_output:
                for name in ("upsample_0_2", "upsample_0_1"):
                    y = _up2(y)
                    y = F.relu(getattr(self, f"{name}_conv2")(F.relu(getattr(self, f"{name}_conv1")(y))))
        y = F.relu(self.heads_0_conv2(F.relu(self.heads_0_conv1(y))))
        return {"hm": self.heads_0_out(y).permute(0, 2, 3, 1)}


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, momentum=BN_MOMENTUM)


class Bottleneck(nn.Module):
    """torchvision's ResNet Bottleneck (stride on the 3x3 conv)."""

    def __init__(self, in_features: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = nn.Conv2d(in_features, planes * 4, 1, stride, bias=False)
            self.downsample_bn = _bn(planes * 4)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(y + identity)


class ResnetSimple(nn.Module):
    """NHWC image (B, H, W, 3) -> {"hm": (B, H/2, W/2, K)} logits (H, W with
    full). `blocks`: bottlenecks per stage (resnet101's by default; fewer
    make cheap test instances of the same widths)."""

    def __init__(self, n_keypoints: int, full: bool = False, blocks: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.full, self.blocks = full, tuple(blocks)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _bn(64)
        c_in = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), self.blocks)):
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                setattr(self, f"layer{stage + 1}_{b}", Bottleneck(c_in, planes, stride, has_downsample=(b == 0)))
                c_in = planes * 4
        for i in range(5 if full else 4):
            setattr(self, f"up{i}_deconv", torch_deconv(c_in, 256, 4, padding=1))
            setattr(self, f"up{i}_bn", _bn(256))
            c_in = 256
        self.head = nn.Conv2d(256, n_keypoints, 1)

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(img.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for stage, n in enumerate(self.blocks):
            for b in range(n):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
        for i in range(5 if self.full else 4):
            x = F.relu(getattr(self, f"up{i}_bn")(getattr(self, f"up{i}_deconv")(x)))
        return {"hm": self.head(x).permute(0, 2, 3, 1)}


def spatial_softmax(belief_maps: torch.Tensor, beta: float = 25.0, smooth_pool: int = 7) -> torch.Tensor:
    """Soft-argmax keypoints: a smooth_pool x smooth_pool average (the padded
    zeros counted, as flax's avg_pool counts them), a softmax at temperature
    1/beta over each map, the expected (x, y) over the pixel grid.
    belief_maps (B, H, W, K) -> (B, K, 2) in map coordinates."""
    B, H, W, K = belief_maps.shape
    x = belief_maps.permute(0, 3, 1, 2)
    if smooth_pool > 1:
        x = F.avg_pool2d(x, smooth_pool, stride=1, padding=smooth_pool // 2, count_include_pad=True)
    probs = torch.softmax((x * beta).reshape(B, K, H * W), dim=-1).reshape(B, K, H, W)
    ys = torch.arange(H, dtype=probs.dtype, device=probs.device)
    xs = torch.arange(W, dtype=probs.dtype, device=probs.device)
    return torch.stack([torch.einsum("bkhw,w->bk", probs, xs), torch.einsum("bkhw,h->bk", probs, ys)], dim=-1)
