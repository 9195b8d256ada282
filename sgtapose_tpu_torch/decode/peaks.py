"""On-device peak finding + sub-pixel decode.

Counterpart of `sgtapose_tpu/decode/peaks.py:decode_heatmaps`: sigma=3
gaussian blur with scipy's 'reflect' (numpy 'symmetric') boundary, 4-neighbour
local maxima above a threshold on the blurred map, the top `max_peaks`
candidates per class, 5x5 weighted-average sub-pixel refinement (+0.4395) on
the original map, the 0.25 score-gap ambiguity rule, and the final coordinate
from the reg head (or the other `coord_mode`s). Static shapes, no host sync.
`decode_heatmaps_batch` decodes a leading batch of frames (one per video of
the batched detector) in one pass (`torch.func.vmap`, as the JAX package
vmaps its decode).

Matching JAX exactly needs two non-obvious choices:
  * the symmetric pad repeats the edge sample ([1,0,|0,1,2,3|,3,2]), which
    `F.pad(mode="reflect")` does not; the pad is built by index;
  * `lax.top_k` breaks ties toward the lowest index (the -inf-masked maps are
    all ties); a stable descending sort does the same.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

SENTINEL = -999.999
COORD_MODES = ("reg", "avg", "logquad", "mean")


class DecodedKeypoints(NamedTuple):
    coords: torch.Tensor  # (C, 2) sub-pixel (x, y); SENTINEL if missing
    coords_int: torch.Tensor  # (C, 2) int64 peak pixel (0, 0 if missing)
    scores: torch.Tensor  # (C,) original-map score; -1 if missing
    tracking: torch.Tensor  # (C, 2) tracking offsets at the peaks
    valid: torch.Tensor  # (C,) bool


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Source index of each position of a length-n axis padded by r on both
    sides in numpy's 'symmetric' mode (period 2n, edge sample repeated)."""
    p = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(p < n, p, 2 * n - 1 - p)


def gaussian_blur(hm: torch.Tensor, sigma: float = 3.0, truncate: float = 4.0) -> torch.Tensor:
    """Separable gaussian blur of (H, W, C), scipy.ndimage-compatible."""
    radius = int(truncate * sigma + 0.5)
    H, W, C = hm.shape
    k = _gaussian_kernel1d(sigma, radius, hm.device)
    x = hm.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    x = x.index_select(2, _symmetric_index(H, radius, hm.device))
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = x.index_select(3, _symmetric_index(W, radius, hm.device))
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x[:, 0].permute(1, 2, 0)


def _local_max_mask(blurred: torch.Tensor, thresh: float) -> torch.Tensor:
    """4-neighbour local maxima of (H, W, C); out-of-map neighbours are 0."""
    z = torch.zeros_like(blurred[:1])
    up = torch.cat([z, blurred[:-1]], dim=0)
    down = torch.cat([blurred[1:], z], dim=0)
    zc = torch.zeros_like(blurred[:, :1])
    left = torch.cat([zc, blurred[:, :-1]], dim=1)
    right = torch.cat([blurred[:, 1:], zc], dim=1)
    return ((blurred >= up) & (blurred >= down) & (blurred >= left) & (blurred >= right)
            & (blurred > thresh))


def _subpixel_refine(map_cf: torch.Tensor, px: torch.Tensor, py: torch.Tensor, offset: float):
    """5x5 weighted average around integer peaks on the original map.
    map_cf (C, H, W); px, py (C, P) int64 -> (x, y) float (C, P) each."""
    C, H, W = map_cf.shape
    d = torch.arange(-2, 3, device=map_cf.device)
    yy, xx = torch.broadcast_tensors(py[..., None, None] + d[:, None],
                                     px[..., None, None] + d[None, :])  # (C, P, 5, 5)
    inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    flat = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(C, -1)
    w = torch.gather(map_cf.reshape(C, H * W), 1, flat).reshape(yy.shape) * inb.to(map_cf.dtype)
    total = w.sum((-2, -1))
    denom = torch.where(total > 0, total, torch.ones_like(total))
    x_avg = (w * xx.to(torch.float32)).sum((-2, -1)) / denom
    y_avg = (w * yy.to(torch.float32)).sum((-2, -1)) / denom
    # all-zero weights -> the integer peak
    x_avg = torch.where(total > 0, x_avg, px.to(torch.float32))
    y_avg = torch.where(total > 0, y_avg, py.to(torch.float32))
    return x_avg + offset, y_avg + offset


def _logquad_delta(f_m, f_0, f_p):
    """1-D sub-pixel offset of a log-parabola through (peak-1, peak, peak+1)."""
    eps = 1e-12
    lm, l0, lp = (torch.log(v.clamp(min=eps)) for v in (f_m, f_0, f_p))
    denom = 2.0 * l0 - lm - lp
    safe = torch.where(denom.abs() > eps, denom, torch.ones_like(denom))
    delta = torch.where(denom.abs() > eps, (lp - lm) / (2.0 * safe), torch.zeros_like(denom))
    return delta.clamp(-0.5, 0.5)


def _logquad_refine(blurred_cf: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Separable log-parabola sub-pixel peak per class on the BLURRED map.
    blurred_cf (C, H, W); px, py (C,) int64 -> (x, y) float (C,) each."""
    C, H, W = blurred_cf.shape
    flat = blurred_cf.reshape(C, H * W)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi)[:, None])[:, 0]

    xm, xp = (px - 1).clamp(0, W - 1), (px + 1).clamp(0, W - 1)
    ym, yp = (py - 1).clamp(0, H - 1), (py + 1).clamp(0, H - 1)
    c = at(py, px)
    dx = _logquad_delta(at(py, xm), c, at(py, xp))
    dy = _logquad_delta(at(ym, px), c, at(yp, px))
    dx = torch.where((px > 0) & (px < W - 1), dx, torch.zeros_like(dx))
    dy = torch.where((py > 0) & (py < H - 1), dy, torch.zeros_like(dy))
    return px.to(torch.float32) + dx, py.to(torch.float32) + dy


def decode_heatmaps(
    hm: torch.Tensor,
    reg: torch.Tensor,
    tracking: torch.Tensor,
    max_peaks: int = 8,
    peak_thresh: float = 0.01,
    ambiguity_gap: float = 0.25,
    peak_offset: float = 0.4395,
    sigma: float = 3.0,
    ref_sort: str = "score",
    coord_mode: str = "reg",
) -> DecodedKeypoints:
    """Decode one frame. hm (H, W, C) AFTER sigmoid; reg/tracking (H, W, 2).
    ref_sort: "score" or "y" (the reference's sort by refined y).
    coord_mode: "reg" (int(refined) + reg head), "avg" (5x5 average +
    offset), "logquad" (log-parabola on the blurred map), "mean" (average of
    reg and logquad)."""
    if coord_mode not in COORD_MODES:
        raise ValueError(f"unknown coord_mode {coord_mode!r}")
    H, W, C = hm.shape
    blurred = gaussian_blur(hm, sigma)
    mask = _local_max_mask(blurred, peak_thresh)

    neg_inf = torch.full((), float("-inf"), device=hm.device)
    flat_blur = torch.where(mask, blurred, neg_inf).permute(2, 0, 1).reshape(C, H * W)
    srt = torch.sort(flat_blur, dim=1, descending=True, stable=True)
    cand_val, cand_idx = srt.values[:, :max_peaks], srt.indices[:, :max_peaks]  # (C, P)
    cand_valid = torch.isfinite(cand_val)
    n_peaks = cand_valid.sum(1)
    px = cand_idx % W
    py = cand_idx // W

    hm_cf = hm.permute(2, 0, 1)  # (C, H, W)
    hm_flat = hm_cf.reshape(C, H * W)
    scores = torch.where(cand_valid, torch.gather(hm_flat, 1, cand_idx), neg_inf)
    sxs, sys_ = _subpixel_refine(hm_cf, px, py, peak_offset)

    sort_key = torch.where(cand_valid, sys_, neg_inf) if ref_sort == "y" else scores
    order = torch.sort(-sort_key, dim=1, stable=True).indices

    def take(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    best = order[:, 0]
    best_score = take(scores, best)
    if max_peaks > 1:
        unambiguous = best_score - take(scores, order[:, 1]) >= ambiguity_gap
    else:
        unambiguous = torch.ones_like(best_score, dtype=torch.bool)
    accept = (n_peaks == 1) | ((n_peaks > 1) & unambiguous)

    sx = take(sxs, best)
    sy = take(sys_, best)
    zero = torch.zeros((), dtype=torch.int64, device=hm.device)
    ix = torch.where(accept, torch.trunc(sx).to(torch.int64).clamp(0, W - 1), zero)
    iy = torch.where(accept, torch.trunc(sy).to(torch.int64).clamp(0, H - 1), zero)
    out_score = torch.where(accept, take(hm_flat, iy * W + ix), torch.full_like(best_score, -1.0))

    reg_at = reg[iy, ix]  # (C, 2)
    trk_at = tracking[iy, ix]
    if coord_mode in ("logquad", "mean"):
        qx, qy = _logquad_refine(blurred.permute(2, 0, 1), take(px, best), take(py, best))
    if coord_mode == "avg":
        coords = torch.stack([sx, sy], dim=1)
    elif coord_mode == "logquad":
        coords = torch.stack([qx, qy], dim=1)
    else:
        coords = torch.stack([ix.to(torch.float32) + reg_at[:, 0],
                              iy.to(torch.float32) + reg_at[:, 1]], dim=1)
        if coord_mode == "mean":
            coords = 0.5 * (coords + torch.stack([qx, qy], dim=1))
    coords = torch.where(accept[:, None], coords, torch.full_like(coords, SENTINEL))
    return DecodedKeypoints(coords=coords, coords_int=torch.stack([ix, iy], dim=1),
                            scores=out_score, tracking=trk_at, valid=accept)


def decode_heatmaps_batch(hm: torch.Tensor, reg: torch.Tensor, tracking: torch.Tensor,
                          **kwargs) -> DecodedKeypoints:
    """`decode_heatmaps` over a leading batch dim of hm (V, H, W, C), reg and
    tracking (V, H, W, 2); every field gains the leading V."""
    return torch.func.vmap(functools.partial(decode_heatmaps, **kwargs))(hm, reg, tracking)
