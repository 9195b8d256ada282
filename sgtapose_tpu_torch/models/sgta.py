"""Flagship SGTAPose: DLA-34 + l3new windowed temporal cross-attention.

Counterpart of `sgtapose_tpu/models/sgta.py` (`HeadConv`, `SGTAPose`,
`CenterNetSingle`, and `create_model`, which builds every arch of the JAX
factory; the temporal variants are in `models/variants.py`, the DREAM
baselines in `models/dream_baselines.py`). The Siamese trunk runs once on
the previous and current frames stacked along the batch (same stems and
weights); levels 0-2 fuse through 3x weight-tied cross-attention, levels 3-5
substitute the previous frame's window features; the DLAUp/IDAUp decoder
(DCN nodes by default) and the hm/reg/tracking heads follow.

`forward`, `trunk` and `fuse` take and return NHWC tensors, like the flax
module. Inside, NHWC data is viewed as NCHW with channels_last memory.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import ModelConfig
from sgtapose_tpu_torch.models import attention as attn_lib
from sgtapose_tpu_torch.models.dla import DLA34Backbone, DLAUp, IDAUp, Stem

CHANNELS = (16, 32, 64, 128, 256, 512)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class HeadConv(nn.Module):
    """3x3 (-> head_conv) + ReLU + 1x1 (-> classes)."""

    def __init__(self, in_features: int, classes: int, head_conv: int = 256,
                 out_bias_init: float = 0.0):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_features, head_conv, 3, padding=1)
        self.Conv_1 = nn.Conv2d(head_conv, classes, 1)
        nn.init.constant_(self.Conv_1.bias, out_bias_init)

    def forward(self, x):
        return self.Conv_1(F.relu(self.Conv_0(x)))


def window_transformer(cfg: ModelConfig, i: int) -> attn_lib.TransformerEncoder:
    """Level i's transformer stack over the windows of the top-k class
    peaks (levels 0-2)."""
    kernel = cfg.kernel_list[i]
    n_tokens = cfg.num_classes * cfg.k_list[i] * (1 + 2 * (kernel // 2)) ** 2
    return attn_lib.TransformerEncoder(d_inp=16 * 2 ** i, d_model=4 * 2 ** i, n_tokens=n_tokens,
                                       num_layers=cfg.num_decoder_layers, n_heads=cfg.n_heads,
                                       pos_embed=cfg.pos_embed)


def window_ids(cfg: ModelConfig, i: int, xy: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Flat ids into level i's features `feats` (NHWC) of the windows around
    the class peaks xy (`attn_lib.topk_class_indices`)."""
    return attn_lib.window_feat_ids(xy, cfg.scale_list[i], cfg.kernel_list[i], feats.shape[1], feats.shape[2])


def fuse_level(transformer, cat_layer, key_feats: torch.Tensor, query_feats: torch.Tensor,
               key_ids: torch.Tensor, query_ids: torch.Tensor) -> torch.Tensor:
    """One level's token fusion: the tokens at key_ids and query_ids gathered
    from key_feats and query_feats (NHWC), the query tokens attending the key
    tokens through `transformer` (None substitutes the key tokens), and
    cat_layer over [out, query] written back into query_feats."""
    key = attn_lib.gather_window_features(key_feats, key_ids)
    query = attn_lib.gather_window_features(query_feats, query_ids)
    out = key if transformer is None else transformer(query, key, key)
    merged = cat_layer(torch.cat([out, query], dim=-1))
    return attn_lib.scatter_window_features(query_feats, query_ids, merged)


class DecoderHeads(nn.Module):
    """DLAUp + IDAUp + the hm/reg/tracking heads over the 6 fused levels
    (NHWC); width_mult widens every decoder level (the concat variant). The
    variants hold one as `decoder`; the flagship and the single-frame model
    are one (their flax trees keep the decoder at the top level)."""

    def __init__(self, cfg: ModelConfig, width_mult: int = 1):
        super().__init__()
        self._decoder_heads(cfg, width_mult)

    def _decoder_heads(self, cfg: ModelConfig, width_mult: int = 1) -> None:
        ch = tuple(c * width_mult for c in CHANNELS)
        first_level, last_level = 2, 5
        dla_channels = ch[first_level:]
        self.dla_up = DLAUp(first_level, dla_channels,
                            tuple(2 ** i for i in range(len(dla_channels))), cfg.dla_node)
        self.ida_up = IDAUp(dla_channels[0], tuple(dla_channels[:last_level - first_level]),
                            tuple(2 ** i for i in range(last_level - first_level)), cfg.dla_node)
        head_in = dla_channels[0]
        self.hm = HeadConv(head_in, cfg.num_classes, cfg.head_conv, cfg.prior_bias)
        self.reg = HeadConv(head_in, 2, cfg.head_conv)
        self.tracking = HeadConv(head_in, 2, cfg.head_conv)

    def forward(self, fused: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        first_level, last_level = 2, 5
        outs = self.dla_up([_nchw(f) for f in fused[first_level:]])
        feat = self.ida_up(outs[:last_level - first_level], 0, last_level - first_level)[-1]
        return {"hm": _nhwc(self.hm(feat)), "reg": _nhwc(self.reg(feat)),
                "tracking": _nhwc(self.tracking(feat))}


class Siamese(nn.Module):
    """The two-frame models' shared stems and trunk, run once over [pre;
    cur] stacked along the batch. A subclass registers them with
    `_stems_and_base` and defines `fuse_features(feats, *inputs)`."""

    def _stems_and_base(self) -> None:
        self.pre_img_stem = Stem(3, CHANNELS[0])
        self.pre_hm_stem = Stem(1, CHANNELS[0])
        self.base = DLA34Backbone(CHANNELS)

    def trunk(self, imgs: torch.Tensor, hms: torch.Tensor) -> List[torch.Tensor]:
        """One backbone pass: image stem + prior-heatmap stem summed; returns
        the 6 level features (NHWC)."""
        x = self.pre_img_stem(_nchw(imgs)) + self.pre_hm_stem(_nchw(hms))
        return [_nhwc(f) for f in self.base(x)]

    def trunk_features(self, cur_img, pre_img, pre_hm, repro_hm, *unused):
        """The trunk pass of `forward`: (previous, current) level features."""
        B = cur_img.shape[0]
        feats = self.trunk(torch.cat([pre_img, cur_img]), torch.cat([pre_hm, repro_hm]))
        return [f[:B] for f in feats], [f[B:] for f in feats]

    def forward(self, *inputs):
        return self.fuse_features(self.trunk_features(*inputs), *inputs)


class SGTAPose(Siamese, DecoderHeads):
    """Inputs (NHWC): cur_img, pre_img (B,H,W,3) normalized frames; pre_hm,
    repro_hm (B,H,W,1) prior heatmaps; pre_hm_cls, repro_hm_cls
    (B,H/4,W/4,C) per-class priors. Returns {"hm", "reg", "tracking"}
    (B,H/4,W/4,*) raw logits."""

    def __init__(self, cfg: ModelConfig):
        # registered in this order (the decoder last), which fixes the order
        # of `reset_parameters`' seeded draws
        nn.Module.__init__(self)
        self.cfg = cfg
        self._stems_and_base()
        for i in range(3):
            setattr(self, f"transformer_{i}", window_transformer(cfg, i))
        for i in range(6):
            setattr(self, f"cat_layer_{i}", attn_lib.CatLayer(CHANNELS[i]))
        self._decoder_heads(cfg)

    def fuse(self, pre_feats: List[torch.Tensor], cur_feats: List[torch.Tensor],
             pre_hm_cls: torch.Tensor, repro_hm_cls: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Temporal fusion + decoder + heads over trunk features (NHWC)."""
        cfg = self.cfg
        # every level ranks the same class priors: rank once per distinct k
        pre_xy = {k: attn_lib.topk_class_indices(pre_hm_cls, k) for k in set(cfg.k_list)}
        cur_xy = {k: attn_lib.topk_class_indices(repro_hm_cls, k) for k in set(cfg.k_list)}
        fused = [fuse_level(getattr(self, f"transformer_{i}", None), getattr(self, f"cat_layer_{i}"),
                            pre_feats[i], cur_feats[i], window_ids(cfg, i, pre_xy[cfg.k_list[i]], pre_feats[i]),
                            window_ids(cfg, i, cur_xy[cfg.k_list[i]], cur_feats[i]))
                 for i in range(6)]
        return DecoderHeads.forward(self, fused)

    def fuse_features(self, feats, cur_img, pre_img, pre_hm, repro_hm, pre_hm_cls, repro_hm_cls):
        """The rest of `forward` over `trunk_features`' output."""
        return self.fuse(feats[0], feats[1], pre_hm_cls, repro_hm_cls)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator, self.cfg.prior_bias)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator, prior_bias: float) -> None:
    """Flax's initialisation, drawn from `generator`: lecun-normal
    (truncated) conv/dense kernels, the DREAM baselines' transposed convs
    included, zero biases, except the zero-initialised DCN offset/mask
    convs, the bilinear (depthwise) up-convs, the pos_embed biases (zero)
    and the hm heads' prior bias; BN/LayerNorm at identity."""
    for name, mod in model.named_modules():
        deconv = isinstance(mod, nn.ConvTranspose2d) and mod.groups == 1
        if not (deconv or isinstance(mod, (nn.Conv2d, nn.Linear))) or name.endswith("conv_offset_mask"):
            continue
        # flax's fan-in: a transposed conv's kernel is (kh, kw, in, out)
        fan_in = mod.weight[:, 0].numel() if deconv else mod.weight[0].numel()
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if mod.bias is not None:
            nn.init.zeros_(mod.bias)
    for name, mod in model.named_modules():
        if isinstance(mod, HeadConv) and name.split(".")[-1] == "hm":
            nn.init.constant_(mod.Conv_1.bias, prior_bias)


class CenterNetSingle(DecoderHeads):
    """The single-frame baseline (the CenterNet and CenterTrack phases'
    model). Inputs: cur_img and, with tracking=True (the CenterTrack
    phase), pre_img and a prior heatmap pre_hm, whose stems are summed with
    the image's."""

    def __init__(self, cfg: ModelConfig, tracking: bool = False):
        super().__init__(cfg)
        self.cfg, self.tracking_inputs = cfg, tracking
        ch = CHANNELS
        self.base_stem = Stem(3, ch[0])
        if tracking:
            self.pre_img_stem = Stem(3, ch[0])
            self.pre_hm_stem = Stem(1, ch[0])
        self.base = DLA34Backbone(ch)

    def trunk_features(self, cur_img, pre_img=None, pre_hm=None):
        x = self.base_stem(_nchw(cur_img))
        if self.tracking_inputs:
            x = x + self.pre_img_stem(_nchw(pre_img)) + self.pre_hm_stem(_nchw(pre_hm))
        return [_nhwc(f) for f in self.base(x)]

    def fuse_features(self, feats, *inputs):
        return DecoderHeads.forward(self, feats)

    def forward(self, *inputs):
        want = 3 if self.tracking_inputs else 1
        if len(inputs) != want:
            raise TypeError(f"CenterNetSingle(tracking={self.tracking_inputs}) takes {want} inputs, got {len(inputs)}")
        return self.fuse_features(self.trunk_features(*inputs), *inputs)


DREAM_ARCHS = ("dreamhourglass", "resnetsimple")
SINGLE_FRAME_ARCHS = ("dlaseg", "centernet", "dla")


def build_model(cfg: ModelConfig, tracking: bool = False) -> nn.Module:
    """The module of cfg.arch (the JAX factory's names; the part before the
    first "_"), its parameters uninitialised. With tracking the single-frame
    archs take pre_img and a prior heatmap (the CenterTrack wiring;
    `train/phases.model_wiring` gives it per phase). The DREAM baselines
    (`models/dream_baselines.py`) take the image alone. An unknown name
    raises ValueError."""
    from sgtapose_tpu_torch.models import dream_baselines, variants

    arch = cfg.arch.split("_")[0]
    if arch == "dlapawdl3new":
        return SGTAPose(cfg)
    if arch == "dlapa":
        return variants.SGTAPoseGlobal(cfg)
    if arch == "dlapawd":
        return variants.SGTAPoseWindowDense(cfg)
    if arch == "dlaabla":
        return variants.SGTAPoseAblation(cfg)
    if arch in ("dlapawd3", "dlapawthree"):
        return variants.SGTAPoseThree(cfg)
    if arch == "dlapawd3shared":
        return variants.SGTAPoseThree(cfg, shared_ca=True)
    if arch == "dlapacat":
        return variants.SGTAPoseCat(cfg)
    if arch == "dreamhourglass":
        return dream_baselines.DreamHourglass(cfg.num_classes)
    if arch == "resnetsimple":
        return dream_baselines.ResnetSimple(cfg.num_classes)
    if arch in SINGLE_FRAME_ARCHS:
        return CenterNetSingle(cfg, tracking=tracking)
    raise ValueError(f"unknown arch: {cfg.arch}")


def create_model(cfg: ModelConfig, device="cuda", seed: int = 0, tracking: bool = False) -> nn.Module:
    """The model of cfg.arch (`build_model`) in eval mode on `device`, its
    weights drawn from `seed` (flax's initialisation)."""
    dev = resolve_device(device)
    model = build_model(cfg, tracking)
    reset_parameters(model, torch.Generator().manual_seed(seed), cfg.prior_bias)
    return model.to(dev).eval()
