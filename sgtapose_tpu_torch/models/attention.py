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
    here the last position per pixel is found with `scatter_reduce(amax)`
    and every duplicate writes that winner's value, on every device.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sgtapose_tpu_torch.ops.attention_kernel import fused_biased_attention


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


def topk_class_indices(hm_cls: torch.Tensor, k: int) -> torch.Tensor:
    """hm_cls (B, H, W, C) -> (B, C*k, 2) float32 (x, y) of each class's top-k
    pixels, class-major, ties broken toward the lowest flat index."""
    B, H, W, C = hm_cls.shape
    flat = hm_cls.permute(0, 3, 1, 2).reshape(B, C, H * W)
    idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices[..., :k].reshape(B, C * k)
    return torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)


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
    (B, M); where ids repeat, the last position wins, deterministically."""
    B, H, W, C = feats.shape
    M = feat_ids.shape[1]
    pos = torch.arange(M, device=feats.device).expand(B, M)
    winner = torch.full((B, H * W), -1, dtype=torch.int64, device=feats.device)
    winner.scatter_reduce_(1, feat_ids, pos, reduce="amax")
    src = winner.gather(1, feat_ids)  # (B, M): the winning position of each id
    vals = torch.gather(values.to(feats.dtype), 1, src[:, :, None].expand(-1, -1, C))
    flat = feats.reshape(B, H * W, C).scatter(1, feat_ids[:, :, None].expand(-1, -1, C), vals)
    return flat.reshape(B, H, W, C)


class MultiHeadCrossAttention(nn.Module):
    """Multi-head attention with a learned (heads, n, n) position bias; the
    attention itself always goes through `fused_biased_attention`."""

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
        bias = self.pos_embed
        if bias is None:
            bias = torch.zeros(h, N, N, dtype=k.dtype, device=k.device)
        out = fused_biased_attention(q, k, v, bias)  # float32
        return dense(self.fc, out.transpose(1, 2).reshape(B, N, self.hid_dim))


class TransformerEncoderLayer(nn.Module):
    """Cross-attention + FFN block, keeping the reference's residual quirk:
    dropout acts on the residual query, not on the attention output."""

    def __init__(self, d_inp: int, d_model: int, n_tokens: int, d_ffn: int = 1024,
                 dropout: float = 0.1, n_heads: int = 8, pos_embed: bool = True):
        super().__init__()
        self.cross_attn = MultiHeadCrossAttention(n_heads, d_inp, d_model * n_heads, n_tokens, pos_embed)
        self.dropout1 = nn.Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_inp, eps=1e-5)
        self.linear1 = nn.Linear(d_inp, d_ffn)
        self.dropout2 = nn.Dropout(dropout)
        self.linear2 = nn.Linear(d_ffn, d_inp)
        self.dropout3 = nn.Dropout(dropout)
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
    """2-layer MLP merging attended + current features (2C -> 4C -> C)."""

    def __init__(self, features: int):
        super().__init__()
        self.fc1 = nn.Linear(2 * features, 4 * features)
        self.fc2 = nn.Linear(4 * features, features)

    def forward(self, x):
        return dense(self.fc2, F.relu(dense(self.fc1, x)))
