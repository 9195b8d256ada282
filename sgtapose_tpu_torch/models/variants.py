"""The arch zoo: the reference's temporal variants beside the flagship.

Counterpart of `sgtapose_tpu/models/variants.py`:
  * SGTAPoseThree       three frames (ppre, pre, cur): the current frame's
                        windowed queries attend the ppre and pre keys with
                        two transformer stacks (one, shared, with
                        shared_ca) at levels 0-2; a 3C -> 6C -> C cat_layer
                        merges; levels 3-5 fuse densely;
  * SGTAPoseCat         no attention: per-level concat of (pre, cur), the
                        decoder at double width;
  * SGTAPoseGlobal      top-28 global attention on all 6 levels, tokens
                        from the full-resolution 1-channel priors' flat
                        fractions, plain MHA without a position bias (the
                        no-bias attention kernels on the card);
  * SGTAPoseWindowDense windowed attention at levels 0-2, dense per-pixel
                        concat + cat_layer fusion at levels 3-5;
  * SGTAPoseAblation    dense fusion at every level, trunk sharing and prior
                        wiring by cfg.ablation_mode (wo_shared | shared |
                        shared_repro).
Submodules carry the flax names (`decoder`, `transformer_{i}`,
`cat_layer_{i}`, `attn_{i}`, `base1`, `cur_img_stem`, ...), so
`utils/weights.load_flax_variables` carries any variant's tree.

The reference's quirks stay, for checkpoint parity: the three-frame model
never uses ppre at levels 3-5 (pre is concatenated twice); the global
variant accepts the class priors and ignores them; the `shared` and
`wo_shared` ablations ignore repro_hm.

Every model takes and returns NHWC tensors. Each has `trunk_features(*inputs)`
(stems and backbone) and `fuse_features(feats, *inputs)` (fusion, decoder,
heads); `forward(*inputs)` is the two in turn, and the detector times them
as its trunk and fuse stages.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from sgtapose_tpu_torch.config import ModelConfig
from sgtapose_tpu_torch.models import attention as attn_lib
from sgtapose_tpu_torch.models.dla import DLA34Backbone, Stem
from sgtapose_tpu_torch.models.sgta import (CHANNELS, DecoderHeads, Siamese, _nchw, _nhwc, fuse_level, window_ids,
                                             window_transformer)


def _window_ids(cfg: ModelConfig, i: int, hm_cls: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    return window_ids(cfg, i, attn_lib.topk_class_indices(hm_cls, cfg.k_list[i]), feats)


class _WindowAttention(nn.Module):
    """One level's windowed cross-attention (levels 0-2; levels 3-5
    substitute the key windows) and cat_layer write-back
    (`sgta.fuse_level`)."""

    def __init__(self, cfg: ModelConfig, level: int):
        super().__init__()
        self.cfg, self.level = cfg, level
        if level < 3:
            self.transformer = window_transformer(cfg, level)
        self.cat_layer = attn_lib.CatLayer(CHANNELS[level])

    def forward(self, key_feats, query_feats, key_hm_cls, query_hm_cls):
        return fuse_level(getattr(self, "transformer", None), self.cat_layer, key_feats, query_feats,
                          _window_ids(self.cfg, self.level, key_hm_cls, key_feats),
                          _window_ids(self.cfg, self.level, query_hm_cls, query_feats))


class _DenseCatFusion(nn.Module):
    """Per-pixel cat_layer over cat([pre, cur]) along channels."""

    def __init__(self, features: int):
        super().__init__()
        self.mlp = attn_lib.CatLayer(features)

    def forward(self, pre_f, cur_f):
        return self.mlp(torch.cat([pre_f, cur_f], dim=-1))


class SGTAPoseThree(Siamese):
    """Inputs: cur_img, ppre_img, pre_img (B,H,W,3); ppre_hm, pre_hm,
    repro_hm (B,H,W,1); ppre_hm_cls, pre_hm_cls, repro_hm_cls (B,H/4,W/4,C)."""

    def __init__(self, cfg: ModelConfig, shared_ca: bool = False):
        super().__init__()
        self.cfg, self.shared_ca = cfg, shared_ca
        self._stems_and_base()
        for i in range(6):
            C = CHANNELS[i]
            if i < 3:
                setattr(self, f"prev_transformer_{i}", window_transformer(cfg, i))
                if not shared_ca:
                    setattr(self, f"pprev_transformer_{i}", window_transformer(cfg, i))
            setattr(self, f"cat_layer_{i}", attn_lib.CatLayer(C, hidden=6 * C, inputs=3 * C))
        self.decoder = DecoderHeads(cfg)

    def trunk_features(self, cur_img, ppre_img, pre_img, ppre_hm, pre_hm, repro_hm, *unused):
        B = cur_img.shape[0]
        feats = self.trunk(torch.cat([ppre_img, pre_img, cur_img]), torch.cat([ppre_hm, pre_hm, repro_hm]))
        return [f[:B] for f in feats], [f[B:2 * B] for f in feats], [f[2 * B:] for f in feats]

    def fuse_features(self, feats, cur_img, ppre_img, pre_img, ppre_hm, pre_hm, repro_hm,
                      ppre_hm_cls, pre_hm_cls, repro_hm_cls):
        ppre, pre, cur = feats
        fused = []
        for i in range(6):
            cat_layer = getattr(self, f"cat_layer_{i}")
            if i < 3:
                ppre_ids = _window_ids(self.cfg, i, ppre_hm_cls, ppre[i])
                pre_ids = _window_ids(self.cfg, i, pre_hm_cls, pre[i])
                cur_ids = _window_ids(self.cfg, i, repro_hm_cls, cur[i])
                ppre_key = attn_lib.gather_window_features(ppre[i], ppre_ids)
                pre_key = attn_lib.gather_window_features(pre[i], pre_ids)
                cur_query = attn_lib.gather_window_features(cur[i], cur_ids)
                pre_tr = getattr(self, f"prev_transformer_{i}")
                ppre_tr = pre_tr if self.shared_ca else getattr(self, f"pprev_transformer_{i}")
                ppre_out = ppre_tr(cur_query, ppre_key, ppre_key)
                pre_out = pre_tr(cur_query, pre_key, pre_key)
                merged = cat_layer(torch.cat([ppre_out, pre_out, cur_query], dim=-1))
                fused.append(attn_lib.scatter_window_features(cur[i], cur_ids, merged))
            else:
                # the reference's quirk: pre twice, ppre unused
                fused.append(cat_layer(torch.cat([pre[i], pre[i], cur[i]], dim=-1)))
        return self.decoder(fused)


class SGTAPoseGlobal(Siamese):
    """Inputs: cur_img, pre_img, pre_hm, repro_hm, and the class priors
    (accepted, unused). Global top-k attention on all 6 levels."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self._stems_and_base()
        for i in range(6):
            setattr(self, f"transformer_{i}", attn_lib.TransformerEncoder(
                d_inp=16 * 2 ** i, d_model=4 * 2 ** i, n_tokens=cfg.topk_global,
                num_layers=cfg.num_decoder_layers, n_heads=cfg.n_heads, pos_embed=False))
            setattr(self, f"cat_layer_{i}", attn_lib.CatLayer(CHANNELS[i]))
        self.decoder = DecoderHeads(cfg)

    def fuse_features(self, feats, cur_img, pre_img, pre_hm, repro_hm, pre_hm_cls=None, repro_hm_cls=None):
        pre, cur = feats
        pre_frac = attn_lib.topk_flat_fractions(pre_hm, self.cfg.topk_global)
        cur_frac = attn_lib.topk_flat_fractions(repro_hm, self.cfg.topk_global)
        fused = []
        for i in range(6):
            Hf, Wf = cur[i].shape[1], cur[i].shape[2]
            fused.append(fuse_level(getattr(self, f"transformer_{i}"), getattr(self, f"cat_layer_{i}"),
                                    pre[i], cur[i], attn_lib.flat_ids_from_fractions(pre_frac, Hf, Wf),
                                    attn_lib.flat_ids_from_fractions(cur_frac, Hf, Wf)))
        return self.decoder(fused)


class SGTAPoseWindowDense(Siamese):
    """Inputs: the flagship's six. Windowed attention at levels 0-2, dense
    concat fusion at levels 3-5."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self._stems_and_base()
        for i in range(3):
            setattr(self, f"attn_{i}", _WindowAttention(cfg, i))
        for i in range(3, 6):
            setattr(self, f"cat_layer_{i}", _DenseCatFusion(CHANNELS[i]))
        self.decoder = DecoderHeads(cfg)

    def fuse_features(self, feats, cur_img, pre_img, pre_hm, repro_hm, pre_hm_cls, repro_hm_cls):
        pre, cur = feats
        fused = [getattr(self, f"attn_{i}")(pre[i], cur[i], pre_hm_cls, repro_hm_cls) for i in range(3)]
        fused += [getattr(self, f"cat_layer_{i}")(pre[i], cur[i]) for i in range(3, 6)]
        return self.decoder(fused)


ABLATION_MODES = ("wo_shared", "shared", "shared_repro")


class SGTAPoseAblation(Siamese):
    """Inputs: cur_img, pre_img, pre_hm, repro_hm (and unused class priors).
    Dense fusion at every level; cfg.ablation_mode: wo_shared (two trunks,
    the current pass without a prior), shared (one trunk, the current pass
    without a prior), shared_repro (one trunk, the current pass on repro_hm)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.ablation_mode not in ABLATION_MODES:
            raise ValueError(f"unknown ablation_mode: {cfg.ablation_mode}")
        self.cfg = cfg
        self.mode = cfg.ablation_mode
        self._stems_and_base()
        if self.mode == "wo_shared":
            self.cur_img_stem = Stem(3, CHANNELS[0])
            self.base1 = DLA34Backbone(CHANNELS)
        for i in range(6):
            setattr(self, f"cat_layer_{i}", _DenseCatFusion(CHANNELS[i]))
        self.decoder = DecoderHeads(cfg)

    def trunk_features(self, cur_img, pre_img, pre_hm, repro_hm, *unused):
        B = cur_img.shape[0]
        if self.mode == "wo_shared":
            return self.trunk(pre_img, pre_hm), [_nhwc(f) for f in self.base1(self.cur_img_stem(_nchw(cur_img)))]
        if self.mode == "shared_repro":
            return super().trunk_features(cur_img, pre_img, pre_hm, repro_hm)
        stem = self.pre_img_stem(_nchw(torch.cat([pre_img, cur_img])))
        stem = torch.cat([stem[:B] + self.pre_hm_stem(_nchw(pre_hm)), stem[B:]])
        feats = [_nhwc(f) for f in self.base(stem)]
        return [f[:B] for f in feats], [f[B:] for f in feats]

    def fuse_features(self, feats, *inputs):
        pre, cur = feats
        return self.decoder([getattr(self, f"cat_layer_{i}")(pre[i], cur[i]) for i in range(6)])


class SGTAPoseCat(Siamese):
    """Inputs: cur_img, pre_img, pre_hm, repro_hm (and unused class priors).
    Per-level concat of (pre, cur), no mixing layer, the decoder at double
    width."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self._stems_and_base()
        self.decoder = DecoderHeads(cfg, width_mult=2)

    def fuse_features(self, feats, *inputs):
        pre, cur = feats
        return self.decoder([torch.cat([p, c], dim=-1) for p, c in zip(pre, cur)])
