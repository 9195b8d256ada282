"""Flagship SGTAPose: DLA-34 + l3new windowed temporal cross-attention.

Counterpart of `sgtapose_tpu/models/sgta.py` (`HeadConv`, `SGTAPose`,
`create_model` for the flagship arch only). The Siamese trunk runs once on
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


class SGTAPose(nn.Module):
    """Inputs (NHWC): cur_img, pre_img (B,H,W,3) normalized frames; pre_hm,
    repro_hm (B,H,W,1) prior heatmaps; pre_hm_cls, repro_hm_cls
    (B,H/4,W/4,C) per-class priors. Returns {"hm", "reg", "tracking"}
    (B,H/4,W/4,*) raw logits."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        ch = CHANNELS
        self.pre_img_stem = Stem(3, ch[0])
        self.pre_hm_stem = Stem(1, ch[0])
        self.base = DLA34Backbone(ch)
        for i in range(3):
            kernel = cfg.kernel_list[i]
            n_tokens = cfg.num_classes * cfg.k_list[i] * (1 + 2 * (kernel // 2)) ** 2
            setattr(self, f"transformer_{i}", attn_lib.TransformerEncoder(
                d_inp=16 * 2 ** i, d_model=4 * 2 ** i, n_tokens=n_tokens,
                num_layers=cfg.num_decoder_layers, n_heads=cfg.n_heads, pos_embed=cfg.pos_embed))
        for i in range(6):
            setattr(self, f"cat_layer_{i}", attn_lib.CatLayer(ch[i]))
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

    def trunk(self, imgs: torch.Tensor, hms: torch.Tensor) -> List[torch.Tensor]:
        """One backbone pass: image stem + prior-heatmap stem summed; returns
        the 6 level features (NHWC)."""
        x = self.pre_img_stem(_nchw(imgs)) + self.pre_hm_stem(_nchw(hms))
        return [_nhwc(f) for f in self.base(x)]

    def fuse(self, pre_feats: List[torch.Tensor], cur_feats: List[torch.Tensor],
             pre_hm_cls: torch.Tensor, repro_hm_cls: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Temporal fusion + decoder + heads over trunk features (NHWC)."""
        cfg = self.cfg
        # every level ranks the same class priors: rank once per distinct k
        pre_xy = {k: attn_lib.topk_class_indices(pre_hm_cls, k) for k in set(cfg.k_list)}
        cur_xy = {k: attn_lib.topk_class_indices(repro_hm_cls, k) for k in set(cfg.k_list)}
        fused = []
        for i in range(6):
            k, kernel, scale = cfg.k_list[i], cfg.kernel_list[i], cfg.scale_list[i]
            Hf, Wf = pre_feats[i].shape[1], pre_feats[i].shape[2]
            pre_ids = attn_lib.window_feat_ids(pre_xy[k], scale, kernel, Hf, Wf)
            cur_ids = attn_lib.window_feat_ids(cur_xy[k], scale, kernel, Hf, Wf)
            pre_key = attn_lib.gather_window_features(pre_feats[i], pre_ids)
            cur_query = attn_lib.gather_window_features(cur_feats[i], cur_ids)
            if i < 3:
                out = getattr(self, f"transformer_{i}")(cur_query, pre_key, pre_key)
            else:
                out = pre_key
            merged = getattr(self, f"cat_layer_{i}")(torch.cat([out, cur_query], dim=-1))
            fused.append(attn_lib.scatter_window_features(cur_feats[i], cur_ids, merged))

        first_level, last_level = 2, 5
        outs = self.dla_up([_nchw(f) for f in fused[first_level:]])
        y = self.ida_up(outs[:last_level - first_level], 0, last_level - first_level)
        feat = y[-1]
        return {"hm": _nhwc(self.hm(feat)), "reg": _nhwc(self.reg(feat)),
                "tracking": _nhwc(self.tracking(feat))}

    def forward(self, cur_img, pre_img, pre_hm, repro_hm, pre_hm_cls, repro_hm_cls):
        B = cur_img.shape[0]
        feats = self.trunk(torch.cat([pre_img, cur_img]), torch.cat([pre_hm, repro_hm]))
        return self.fuse([f[:B] for f in feats], [f[B:] for f in feats], pre_hm_cls, repro_hm_cls)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisation, drawn from `generator`: lecun-normal
        (truncated) conv/dense kernels, zero biases, except the zero-initialised
        DCN offset/mask convs, the bilinear up-convs, the pos_embed biases
        (zero) and the hm head's prior bias; BN/LayerNorm at identity."""
        for name, mod in self.named_modules():
            if not isinstance(mod, (nn.Conv2d, nn.Linear)) or name.endswith("conv_offset_mask"):
                continue
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        nn.init.constant_(self.hm.Conv_1.bias, self.cfg.prior_bias)


def create_model(cfg: ModelConfig, device="cuda", seed: int = 0) -> SGTAPose:
    """The flagship arch (dlapawdl3new_34) in eval mode on `device`, its
    weights drawn from `seed` (flax's initialisation). Other archs of the JAX
    factory are not ported yet and raise."""
    if cfg.arch.split("_")[0] != "dlapawdl3new":
        raise ValueError(f"arch {cfg.arch!r} is not ported to sgtapose_tpu_torch (flagship only)")
    dev = resolve_device(device)
    model = SGTAPose(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
