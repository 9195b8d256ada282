"""Training-batch construction on the device: one random affine shared by a
(prev, next) frame pair, the warped and normalised frames, GT heatmaps and
regression targets, the noised PnP structure prior and the prior heatmaps.

Counterpart of `sgtapose_tpu/data/pipeline.py` (`RawSample`, `_border`,
`_derive_affine`, `augment_and_render`, `make_batch_fn`, and the three-frame
window's `RawSampleThree`, `augment_and_render_three`,
`make_batch_fn_three`). JAX's key splits cannot be reproduced with torch
generators, so each random function is split in two: `draw_augment` draws
every random number a batch needs from a `torch.Generator` (`Draws`), and
`augment_and_render` is a deterministic function of one sample's draws. The
batch runs `augment_and_render` under `torch.func.vmap`, so its B PnP priors
are one batched prior-grade solve.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from sgtapose_tpu_torch.config import IMAGE_MEAN, IMAGE_STD, Config
from sgtapose_tpu_torch.core import geometry, pnp


class RawSample(NamedTuple):
    """Raw inputs of one (prev, next) frame pair (a leading batch dim when
    batched)."""

    prev_img: torch.Tensor  # (H_raw, W_raw, 3) in [0, 255]
    next_img: torch.Tensor
    prev_projs: torch.Tensor  # (K, 2) raw-pixel GT projections
    next_projs: torch.Tensor
    prev_x3d_rob: torch.Tensor  # (K, 3) keypoints in the robot frame
    next_x3d_rob: torch.Tensor


class Draws(NamedTuple):
    """The random numbers of one sample (a leading batch dim when batched)."""

    aug_s: torch.Tensor  # () crop scale factor, one of 0.6, 0.7, ..., 1.3
    center: torch.Tensor  # (2,) crop center (x, y) in raw pixels
    prior_noise: torch.Tensor  # (K, 2) N(0,1): PnP prior jitter
    prior_keep_u: torch.Tensor  # (K,) U[0,1): PnP prior keep draws
    origin_noise: torch.Tensor  # (K, 2) N(0,1): origin prior jitter
    origin_keep_u: torch.Tensor  # (K,) U[0,1): origin prior keep draws
    origin_fp_u: torch.Tensor  # (K,) U[0,1): origin prior false-positive draws
    origin_fp_noise: torch.Tensor  # (K, 2) N(0,1): false-positive jitter


def _border(border: int, size: int) -> int:
    """The largest border // 2^i that leaves the crop center a non-empty
    range (the reference's _get_border)."""
    i = 1
    while size - border // i <= border // i:
        i *= 2
    return border // i


def draw_augment(generator: torch.Generator, batch: int, n_kp: int, raw_hw, augment: bool = True,
                 device="cuda") -> Draws:
    """A batch's draws from `generator` (a CPU generator), moved to `device`.
    Without augmentation the crop is the whole raw frame, centered."""
    H_raw, W_raw = raw_hw
    g = generator
    if augment:
        scales = torch.arange(0.6, 1.4, 0.1, dtype=torch.float32)
        aug_s = scales[torch.randint(0, scales.shape[0], (batch,), generator=g)]
        wb, hb = _border(128, W_raw), _border(128, H_raw)
        cx = torch.randint(wb, W_raw - wb, (batch,), generator=g)
        cy = torch.randint(hb, H_raw - hb, (batch,), generator=g)
        center = torch.stack([cx, cy], dim=-1).to(torch.float32)
    else:
        aug_s = torch.ones(batch)
        center = torch.tensor([W_raw / 2.0, H_raw / 2.0]).expand(batch, 2)
    shape = (batch, n_kp)
    draws = Draws(
        aug_s=aug_s, center=center,
        prior_noise=torch.randn(shape + (2,), generator=g), prior_keep_u=torch.rand(shape, generator=g),
        origin_noise=torch.randn(shape + (2,), generator=g), origin_keep_u=torch.rand(shape, generator=g),
        origin_fp_u=torch.rand(shape, generator=g), origin_fp_noise=torch.randn(shape + (2,), generator=g),
    )
    return Draws(*(t.to(device) for t in draws))


def _derive_affine(draws: Draws, H_raw: int, W_raw: int, cfg: Config):
    """(trans_input, trans_output) of the crop of side max(H_raw, W_raw) *
    aug_s around center."""
    in_h, in_w = cfg.model.input_res
    out_h, out_w = cfg.model.output_res
    s = float(max(H_raw, W_raw)) * draws.aug_s
    trans_input = geometry.get_affine_transform(draws.center, s, 0.0, (in_w, in_h))
    trans_output = geometry.get_affine_transform(draws.center, s, 0.0, (out_w, out_h))
    return trans_input, trans_output


def augment_and_render(draws: Draws, sample: RawSample, camera_K: torch.Tensor, cfg: Config,
                       cache_prior: bool = False) -> Dict[str, torch.Tensor]:
    """One sample's training inputs from its draws (vmap-safe).

    cache_prior=True conditions the pre pass on a PnP-reprojection prior (the
    prev frame's 3D points projected under the solved prior pose) instead of
    the detection-style noised prior: the feature-cache runner's input
    distribution."""
    H_raw, W_raw = sample.prev_img.shape[0], sample.prev_img.shape[1]
    in_h, in_w = cfg.model.input_res
    out_h, out_w = cfg.model.output_res
    tc = cfg.train
    trans_input, trans_output = _derive_affine(draws, H_raw, W_raw, cfg)

    # both frames warped with the same transform, then normalised
    prev_in = geometry.normalize_image(geometry.warp_affine(sample.prev_img, trans_input, (in_h, in_w)),
                                       IMAGE_MEAN, IMAGE_STD)
    next_in = geometry.normalize_image(geometry.warp_affine(sample.next_img, trans_input, (in_h, in_w)),
                                       IMAGE_MEAN, IMAGE_STD)

    # GT targets at output resolution
    next_out = geometry.affine_transform_and_clip(sample.next_projs, trans_output, out_w, out_h, W_raw, H_raw)
    prev_out = geometry.affine_transform_and_clip(sample.prev_projs, trans_output, out_w, out_h, W_raw, H_raw)
    next_int = torch.stack([next_out[:, 0].clamp(0, out_w - 1).to(torch.int32),
                            next_out[:, 1].clamp(0, out_h - 1).to(torch.int32)], dim=1)
    gt_belief = geometry.render_gt_heatmap(next_int, out_w, out_h)  # (K, Ho, Wo)

    # the CenterTrack phase's origin prior: noised prev GT at input resolution
    pre_origin_hm = geometry.render_noised_prior_heatmap(
        draws.origin_noise, draws.origin_keep_u, draws.origin_fp_u, draws.origin_fp_noise,
        sample.prev_projs, trans_input, in_w, in_h, W_raw, H_raw, tc.hm_disturb, tc.lost_disturb,
        tc.fp_disturb if tc.fp_disturb_active else 0.0)

    # the PnP structure prior with fault injection
    ok, next_est, prev_noised, prior_pose = pnp.noised_pnp_prior(
        draws.prior_noise, draws.prior_keep_u, sample.prev_x3d_rob, sample.prev_projs,
        sample.next_x3d_rob, camera_K, tc.hm_disturb, tc.lost_disturb)
    okf = ok.to(torch.float32)
    if cache_prior:
        R_prior = geometry.quat_to_matrix(prior_pose.quat)
        prev_est = geometry.project_points(sample.prev_x3d_rob, R_prior, prior_pose.trans, camera_K)
        pre_hm = geometry.render_prior_heatmap(prev_est, trans_input, in_w, in_h, W_raw, H_raw) * okf
    else:
        pre_hm = geometry.render_prior_heatmap(prev_noised, trans_input, in_w, in_h, W_raw, H_raw) * okf
    repro_hm = geometry.render_prior_heatmap(next_est, trans_input, in_w, in_h, W_raw, H_raw) * okf
    pre_hm_cls = geometry.render_prior_heatmap_cls(prev_noised, trans_output, out_w, out_h, W_raw, H_raw) * okf
    repro_hm_cls = geometry.render_prior_heatmap_cls(next_est, trans_output, out_w, out_h, W_raw, H_raw) * okf

    next_f = next_int.to(torch.float32)
    return {
        "cur_img": next_in,
        "pre_img": prev_in,
        "pre_origin_hm": pre_origin_hm[..., None],
        "pre_hm": pre_hm[..., None],
        "repro_hm": repro_hm[..., None],
        "pre_hm_cls": pre_hm_cls.permute(1, 2, 0),  # (Ho, Wo, K)
        "repro_hm_cls": repro_hm_cls.permute(1, 2, 0),
        "gt_belief_maps": gt_belief.permute(1, 2, 0),
        "kp_int": next_int,
        "reg_target": next_out - next_f,
        # the reference's quirk: an out-of-frame prev keypoint's clipped
        # position is 0, so its tracking target is -next_int (harmless at the
        # shipping tracking weight 0)
        "tracking_target": prev_out - next_f,
    }


def render_batch(draws: Draws, samples: RawSample, camera_K: torch.Tensor, cfg: Config,
                 cache_prior: bool = False) -> Dict[str, torch.Tensor]:
    """`augment_and_render` over a batch of draws and samples (torch.func.vmap:
    one batched prior-grade PnP solve for the B priors)."""
    return torch.func.vmap(lambda d, s: augment_and_render(d, s, camera_K, cfg, cache_prior))(draws, samples)


def make_batch_fn(cfg: Config, camera_K, augment: bool = True, cache_prior: bool = False):
    """fn(generator, batched RawSample) -> the model batch dict (B, ...) on
    the samples' device: the draws from `generator` (`draw_augment`), then
    `render_batch`."""

    def batch_fn(generator: torch.Generator, samples: RawSample) -> Dict[str, torch.Tensor]:
        dev = samples.prev_img.device
        K = torch.as_tensor(camera_K, dtype=torch.float32, device=dev)
        B, n_kp = samples.prev_projs.shape[:2]
        draws = draw_augment(generator, B, n_kp, samples.prev_img.shape[1:3], augment, device=dev)
        return render_batch(draws, samples, K, cfg, cache_prior)

    return batch_fn


class RawSampleThree(NamedTuple):
    """Raw inputs of a three-frame window (ppre, pre, next), a leading batch
    dim when batched."""

    ppre_img: torch.Tensor
    pre_img: torch.Tensor
    next_img: torch.Tensor
    ppre_projs: torch.Tensor
    pre_projs: torch.Tensor
    next_projs: torch.Tensor
    ppre_x3d_rob: torch.Tensor
    pre_x3d_rob: torch.Tensor
    next_x3d_rob: torch.Tensor


class DrawsThree(NamedTuple):
    """The random numbers of one three-frame sample, in the JAX function's
    order: the (pre, next) pair's, then the ppre -> pre prior chain's."""

    pair: Draws
    ppre_prior_noise: torch.Tensor  # (K, 2) N(0,1)
    ppre_prior_keep_u: torch.Tensor  # (K,) U[0,1)


def draw_augment_three(generator: torch.Generator, batch: int, n_kp: int, raw_hw, augment: bool = True,
                       device="cuda") -> DrawsThree:
    """A batch's three-frame draws from `generator` (the pair's, as
    `draw_augment` draws them, then the ppre prior chain's)."""
    pair = draw_augment(generator, batch, n_kp, raw_hw, augment, device)
    shape = (batch, n_kp)
    noise = torch.randn(shape + (2,), generator=generator)
    keep = torch.rand(shape, generator=generator)
    return DrawsThree(pair, noise.to(device), keep.to(device))


def augment_and_render_three(draws: DrawsThree, sample: RawSampleThree, camera_K: torch.Tensor,
                             cfg: Config) -> Dict[str, torch.Tensor]:
    """One three-frame sample's training inputs (vmap-safe): the (pre, next)
    pair as `augment_and_render` builds it, which fixes the window's affine;
    the ppre frame warped with the same affine; the noised ppre -> pre PnP
    prior's ppre heatmaps."""
    pair = RawSample(prev_img=sample.pre_img, next_img=sample.next_img, prev_projs=sample.pre_projs,
                     next_projs=sample.next_projs, prev_x3d_rob=sample.pre_x3d_rob,
                     next_x3d_rob=sample.next_x3d_rob)
    out = augment_and_render(draws.pair, pair, camera_K, cfg)
    H_raw, W_raw = sample.pre_img.shape[0], sample.pre_img.shape[1]
    in_h, in_w = cfg.model.input_res
    out_h, out_w = cfg.model.output_res
    tc = cfg.train
    trans_input, trans_output = _derive_affine(draws.pair, H_raw, W_raw, cfg)
    ppre_in = geometry.normalize_image(geometry.warp_affine(sample.ppre_img, trans_input, (in_h, in_w)),
                                       IMAGE_MEAN, IMAGE_STD)
    ok2, _, ppre_noised, _ = pnp.noised_pnp_prior(
        draws.ppre_prior_noise, draws.ppre_prior_keep_u, sample.ppre_x3d_rob, sample.ppre_projs,
        sample.pre_x3d_rob, camera_K, tc.hm_disturb, tc.lost_disturb)
    ok2f = ok2.to(torch.float32)
    ppre_hm = geometry.render_prior_heatmap(ppre_noised, trans_input, in_w, in_h, W_raw, H_raw) * ok2f
    ppre_hm_cls = geometry.render_prior_heatmap_cls(ppre_noised, trans_output, out_w, out_h, W_raw, H_raw) * ok2f
    out.update(ppre_img=ppre_in, ppre_hm=ppre_hm[..., None], ppre_hm_cls=ppre_hm_cls.permute(1, 2, 0))
    return out


def render_batch_three(draws: DrawsThree, samples: RawSampleThree, camera_K: torch.Tensor,
                       cfg: Config) -> Dict[str, torch.Tensor]:
    """`augment_and_render_three` over a batch (torch.func.vmap)."""
    return torch.func.vmap(lambda d, s: augment_and_render_three(d, s, camera_K, cfg))(draws, samples)


def make_batch_fn_three(cfg: Config, camera_K, augment: bool = True):
    """fn(generator, batched RawSampleThree) -> the model batch dict of the
    PlanA_three phase (B, ...) on the samples' device."""

    def batch_fn(generator: torch.Generator, samples: RawSampleThree) -> Dict[str, torch.Tensor]:
        dev = samples.pre_img.device
        K = torch.as_tensor(camera_K, dtype=torch.float32, device=dev)
        B, n_kp = samples.pre_projs.shape[:2]
        draws = draw_augment_three(generator, B, n_kp, samples.pre_img.shape[1:3], augment, device=dev)
        return render_batch_three(draws, samples, K, cfg)

    return batch_fn
