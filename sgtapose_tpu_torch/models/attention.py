"""Temporal top-k windowed cross-attention.

Counterpart of `sgtapose_tpu/models/attention.py`: per-class top-k peaks of
the prior class heatmaps pick kernel^2 windows of features; the current
frame's window tokens attend the previous frame's (learned (heads, n, n)
position bias, through the biased-attention kernel); a 2-layer MLP merges the
result, which is written back into the feature map. Feature maps are NHWC.

Dtypes follow flax's promotion, so a bf16 model (`utils/precision.py`)
computes as the JAX package's bf16 serving does: every Dense layer runs in the
promoted dtype of its input and parameters (`dense`), so the attention's
float32 output makes `fc`, the LayerNorms, the FFN and the tied layers after
it float32 while their bf16 parameters are promoted; `CatLayer` runs in
float32 on levels 0-2 (float32 attention output beside bf16 query tokens) and
in bf16 on levels 3-5; the write-back casts to the feature map's dtype.

Two places where the obvious torch call would not match JAX:
  * ties: `lax.top_k` returns the lowest index first among equal values (all
    priors are zero on a video's first frame); `torch.topk` does not promise
    that, so the port takes a stable descending sort;
  * duplicate ids in the scatter (clamped or colliding windows): XLA on the
    CPU keeps the LAST write, and CUDA's `index_put_` is nondeterministic;
    here the last position per pixel is found with `scatter_reduce(amax)`,
    only the winners are written to their pixels and the losers to a dump
    row that is cut off, on every device. So the gradient reaches each
    winner once and no loser, as the VJP of JAX's `.at[ids].set` sends it
    (writing the winner's value from every duplicate gave the winner one
    copy of the gradient per duplicate).

Dropout (rate 0.1, train mode only) acts where flax applies it, drawn from
the explicit generator the trainer sets (`set_dropout_generator`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch.ops.attention_kernel import fused_biased_attention
from sgtapose_tpu_torch.parallel import mesh


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` in the promoted dtype of x and the layer's parameters, as
    flax's Dense computes (bf16 parameters against a float32 input run in
    float32)."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """`norm(x)` in the promoted dtype of x and the norm's parameters."""
    dt = torch.promote_types(x.dtype, norm.weight.dtype)
    return F.layer_norm(x.to(dt), norm.normalized_shape, norm.weight.to(dt), norm.bias.to(dt),
                        norm.eps)


def _topk_flat_ids(hm: torch.Tensor, k: int) -> torch.Tensor:
    """hm (B, H, W, C) -> (B, C*k) flat pixel ids y*W + x of each channel's
    top-k values, channel-major, ties broken toward the lowest id."""
    B, H, W, C = hm.shape
    flat = hm.permute(0, 3, 1, 2).reshape(B, C, H * W)
    return torch.sort(flat, dim=-1, descending=True, stable=True).indices[..., :k].reshape(B, C * k)


def topk_class_indices(hm_cls: torch.Tensor, k: int) -> torch.Tensor:
    """hm_cls (B, H, W, C) -> (B, C*k, 2) float32 (x, y) of each class's top-k
    pixels, class-major, ties broken toward the lowest flat index."""
    W = hm_cls.shape[2]
    idx = _topk_flat_ids(hm_cls, k)
    return torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)


def topk_flat_fractions(hm: torch.Tensor, k: int) -> torch.Tensor:
    """hm (B, H, W, C) -> (B, C*k) float32: each channel's top-k flat pixel
    ids (ties toward the lowest id) as fractions id / (H*W), the float32
    quotient the global variant rescales into each level's id space."""
    H, W = hm.shape[1], hm.shape[2]
    return _topk_flat_ids(hm, k).to(torch.float32) / torch.tensor(H * W, dtype=torch.float32, device=hm.device)


def flat_ids_from_fractions(frac: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, M) fractions -> (B, M) int64 flat ids at this level's resolution:
    the float32 product frac * (H*W), truncated."""
    prod = frac * torch.tensor(height * width, dtype=torch.float32, device=frac.device)
    return prod.to(torch.int32).to(torch.int64)


def window_feat_ids(topk_xy: torch.Tensor, scale: float, kernel: int, height: int,
                    width: int) -> torch.Tensor:
    """Flat pixel ids y*W + x of the kernel windows around each (scaled)
    top-k coordinate, clamped per axis to the map; (B, K*n_win) int64 with
    n_win = (2*(kernel//2)+1)^2, row-major window offsets. Coordinates are
    clamped as floats, then truncated (the fractional part at scales < 1)."""
    r = kernel // 2
    c1 = torch.arange(-r, r + 1, dtype=torch.float32, device=topk_xy.device)
    n1 = c1.shape[0]
    offsets = torch.stack([c1.repeat_interleave(n1), c1.repeat(n1)], dim=-1)  # (n_win, 2)
    coords = topk_xy[:, :, None, :] * scale + offsets[None, None]
    x = coords[..., 0].clamp(0.0, float(width - 1))
    y = coords[..., 1].clamp(0.0, float(height - 1))
    feat_id = y * width + x
    return feat_id.reshape(topk_xy.shape[0], -1).to(torch.int64)


def gather_window_features(feats: torch.Tensor, feat_ids: torch.Tensor) -> torch.Tensor:
    """feats (B, H, W, C), feat_ids (B, M) -> (B, M, C)."""
    B, H, W, C = feats.shape
    flat = feats.reshape(B, H * W, C)
    return torch.gather(flat, 1, feat_ids[:, :, None].expand(-1, -1, C))


def scatter_window_features(feats: torch.Tensor, feat_ids: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """Write values (B, M, C) into a copy of feats (B, H, W, C) at feat_ids
    (B, M); where ids repeat, the last position wins, deterministically, and
    alone receives the gradient of its pixel."""
    B, H, W, C = feats.shape
    M = feat_ids.shape[1]
    pos = torch.arange(M, device=feats.device).expand(B, M)
    winner = torch.full((B, H * W), -1, dtype=torch.int64, device=feats.device)
    winner.scatter_reduce_(1, feat_ids, pos, reduce="amax")
    wins = winner.gather(1, feat_ids) == pos  # (B, M): the last position of its id
    target = torch.where(wins, feat_ids, H * W)  # losers go to the dump row
    flat = torch.cat([feats.reshape(B, H * W, C), feats.new_zeros(B, 1, C)], dim=1)
    flat = flat.scatter(1, target[:, :, None].expand(-1, -1, C), values.to(feats.dtype))
    return flat[:, :H * W].reshape(B, H, W, C)


class Dropout(nn.Module):
    """flax `nn.Dropout(rate)`: in train mode each element is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; in eval
    mode (or at rate 0) the identity. The keep mask is drawn from
    `self.generator`, a torch.Generator on the input's device that the
    trainer sets (`set_dropout_generator`); train mode without one raises.
    Under several data-parallel ranks each draws the mask of the global
    batch and keeps its own rows (`parallel/mesh.global_rand`), as JAX draws
    one mask for the global array."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("train-mode dropout needs a generator: models.attention.set_dropout_generator")
        keep_prob = 1.0 - self.rate
        keep = mesh.global_rand(x.shape, self.generator, x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Give every `Dropout` of `model` the generator it draws from."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_dropout_rate(model: nn.Module, rate: float) -> None:
    """Set the rate of every `Dropout` of `model` (0 turns dropout off)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = rate


class MultiHeadCrossAttention(nn.Module):
    """Multi-head attention with a learned (heads, n, n) position bias, or
    without one (pos_embed=False: the global variant's plain MHA); the
    attention itself always goes through `fused_biased_attention`, whose
    no-bias kernels take bias None."""

    def __init__(self, n_heads: int, inp_dim: int, hid_dim: int, n_tokens: int,
                 pos_embed: bool = True):
        super().__init__()
        self.n_heads = n_heads
        self.hid_dim = hid_dim
        self.n_tokens = n_tokens
        self.w_q = nn.Linear(inp_dim, hid_dim, bias=False)
        self.w_k = nn.Linear(inp_dim, hid_dim, bias=False)
        self.w_v = nn.Linear(inp_dim, hid_dim, bias=False)
        self.pos_embed = nn.Parameter(torch.zeros(n_heads, n_tokens, n_tokens)) if pos_embed else None
        self.fc = nn.Linear(hid_dim, inp_dim)

    def forward(self, query, key, value):
        B, N, _ = query.shape
        h = self.n_heads
        d = self.hid_dim // h

        def heads(t):
            return t.reshape(B, N, h, d).transpose(1, 2).contiguous()

        q = heads(dense(self.w_q, query))
        k, v = heads(dense(self.w_k, key)), heads(dense(self.w_v, value))
        out = fused_biased_attention(q, k, v, self.pos_embed)  # float32
        return dense(self.fc, out.transpose(1, 2).reshape(B, N, self.hid_dim))


class TransformerEncoderLayer(nn.Module):
    """Cross-attention + FFN block, keeping the reference's residual quirk:
    dropout acts on the residual query, not on the attention output; the
    other two act after the FFN's ReLU and after its second layer."""

    def __init__(self, d_inp: int, d_model: int, n_tokens: int, d_ffn: int = 1024,
                 dropout: float = 0.1, n_heads: int = 8, pos_embed: bool = True):
        super().__init__()
        self.cross_attn = MultiHeadCrossAttention(n_heads, d_inp, d_model * n_heads, n_tokens, pos_embed)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_inp, eps=1e-5)
        self.linear1 = nn.Linear(d_inp, d_ffn)
        self.dropout2 = Dropout(dropout)
        self.linear2 = nn.Linear(d_ffn, d_inp)
        self.dropout3 = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d_inp, eps=1e-5)

    def forward(self, query, key, value):
        attn = self.cross_attn(query, key, value)
        x = layer_norm(self.norm1, attn + self.dropout1(query))
        y = self.dropout3(dense(self.linear2, self.dropout2(F.relu(dense(self.linear1, x)))))
        return layer_norm(self.norm3, x + y)


class TransformerEncoder(nn.Module):
    """`num_layers` applications of ONE shared (weight-tied) layer."""

    def __init__(self, d_inp: int, d_model: int, n_tokens: int, num_layers: int = 3,
                 n_heads: int = 8, pos_embed: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.layer = TransformerEncoderLayer(d_inp, d_model, n_tokens, n_heads=n_heads,
                                             pos_embed=pos_embed)

    def forward(self, query, key, value):
        out = query
        for _ in range(self.num_layers):
            out = self.layer(out, key, value)
        return out


class CatLayer(nn.Module):
    """2-layer MLP merging attended + current features: 2C -> 4C -> C, or,
    given `inputs` and `hidden`, inputs -> hidden -> C (the three-frame
    variant's 3C -> 6C -> C)."""

    def __init__(self, features: int, hidden: int | None = None, inputs: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(inputs or 2 * features, hidden or 4 * features)
        self.fc2 = nn.Linear(hidden or 4 * features, features)

    def forward(self, x):
        return dense(self.fc2, F.relu(dense(self.fc1, x)))
