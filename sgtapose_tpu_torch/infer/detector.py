"""Exact streaming video detector.

Counterpart of `sgtapose_tpu/infer/detector.py:make_video_detector` (the
`lax.scan` runner of `_build_video_runner`), as a Python loop over frames
with the same carry (`DetectorCarry`). Each frame runs five stages:

  1. pnp     prior PnP from the previous detections (or teacher keypoints)
             and reprojection of this frame's 3D keypoints; on PnP failure
             the previous detections are reused;
  2. render  prior heatmaps at input resolution and per class at output
             resolution (all zero while no detection is valid);
  3. trunk   the Siamese DLA-34 pass over [previous; current] frame;
  4. fuse    windowed temporal attention + DCN decoder + heads;
  5. decode  sigmoid, peak decode, inverse affine to raw pixels, score
             threshold.

Everything stays on the device; the frame loop never reads a value back to
the host (PnP's eigh/SVD check their own status, see core/pnp.py).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import IMAGE_MEAN, IMAGE_STD, Config
from sgtapose_tpu_torch.core import geometry, pnp
from sgtapose_tpu_torch.decode import peaks as decode_lib

KP_SENTINEL = -999.999 * 4  # missing-detection marker
STAGES = ("pnp", "render", "trunk", "fuse", "decode")


class VideoFrames(NamedTuple):
    """Pre-warped per-video inputs."""

    images: torch.Tensor  # (T, H_in, W_in, 3) normalized network inputs
    x3d: torch.Tensor  # (T, K, 3) keypoint positions for the PnP prior
    # optional GT-initialized prior: raw-frame keypoints used as frame 0's
    # "detections" (None starts cold, with all-zero priors)
    init_kps: Optional[torch.Tensor] = None  # (K, 2)
    # optional teacher-forced prior detections: frame t's prior PnP consumes
    # teacher_kps[t] instead of the previous frame's detections
    teacher_kps: Optional[torch.Tensor] = None  # (T, K, 2)


class DetectorCarry(NamedTuple):
    pre_img: torch.Tensor  # (H_in, W_in, 3)
    detected_kps: torch.Tensor  # (K, 2) raw coords or KP_SENTINEL
    frame_idx: torch.Tensor  # () int32
    # previous frame's solved pose: the warm start of the prior PnP when
    # cfg.infer.pnp_warm_start
    quat: torch.Tensor  # (4,) wxyz
    trans: torch.Tensor  # (3,)
    pose_ok: torch.Tensor  # () bool


class FrameResult(NamedTuple):
    detected_kps: torch.Tensor  # (K, 2) raw coords or KP_SENTINEL
    scores: torch.Tensor  # (K,)
    tracking: Optional[torch.Tensor] = None  # (K, 2) raw-pixel tracking offsets
    debug_hm: Optional[torch.Tensor] = None  # (Ho, Wo, K) post-sigmoid heatmaps
    debug_pre_hm: Optional[torch.Tensor] = None  # (H_in, W_in, 1) rendered prior


def _video_transforms(cfg: Config, raw_hw: Tuple[int, int], device):
    H_raw, W_raw = raw_hw
    in_h, in_w = cfg.model.input_res
    out_h, out_w = cfg.model.output_res
    c = torch.tensor([W_raw / 2.0, H_raw / 2.0], dtype=torch.float32, device=device)
    s = float(max(H_raw, W_raw))
    trans_input = geometry.get_affine_transform(c, s, 0.0, (in_w, in_h))
    trans_output = geometry.get_affine_transform(c, s, 0.0, (out_w, out_h))
    return trans_input, trans_output


def preprocess_frames(raw_images: torch.Tensor, cfg: Config):
    """Warp + normalize all frames (T, H_raw, W_raw, 3) of a video with the
    fixed center/scale transform. Returns (images, trans_input, trans_output)."""
    H_raw, W_raw = raw_images.shape[1], raw_images.shape[2]
    trans_input, trans_output = _video_transforms(cfg, (H_raw, W_raw), raw_images.device)
    warped = geometry.warp_affine(raw_images.to(torch.float32), trans_input, cfg.model.input_res)
    return geometry.normalize_image(warped, IMAGE_MEAN, IMAGE_STD), trans_input, trans_output


def _render_priors(detected_kps, repro_kps, any_valid, trans_input, trans_output,
                   cfg: Config, raw_wh: Tuple[int, int]):
    """pre/repro heatmaps at input res (H,W,1) + per-class at output res
    (Ho,Wo,K); all zero when no detection was valid."""
    in_h, in_w = cfg.model.input_res
    out_h, out_w = cfg.model.output_res
    W_raw, H_raw = raw_wh
    okf = any_valid.to(torch.float32)
    pre_hm = geometry.render_prior_heatmap(detected_kps, trans_input, in_w, in_h, W_raw, H_raw) * okf
    repro_hm = geometry.render_prior_heatmap(repro_kps, trans_input, in_w, in_h, W_raw, H_raw) * okf
    pre_cls = geometry.render_prior_heatmap_cls(
        detected_kps, trans_output, out_w, out_h, W_raw, H_raw) * okf
    repro_cls = geometry.render_prior_heatmap_cls(
        repro_kps, trans_output, out_w, out_h, W_raw, H_raw) * okf
    return pre_hm[..., None], repro_hm[..., None], pre_cls.permute(1, 2, 0), repro_cls.permute(1, 2, 0)


class VideoDetector:
    """fn(VideoFrames) -> FrameResult stacked over T, for one video.

    stage_timer: optional callable(stage_name) -> context manager wrapped
    around each of the five stages of every frame (see STAGES), for
    measurement; None runs them bare."""

    def __init__(self, model, cfg: Config, camera_K, raw_hw: Tuple[int, int], device,
                 debug_outputs: bool = False,
                 stage_timer: Optional[Callable[[str], contextlib.AbstractContextManager]] = None):
        self.device = resolve_device(device)
        p = next(model.parameters())
        if p.device.type != self.device.type:
            raise ValueError(f"model is on {p.device}, detector device is {self.device}")
        self.model = model
        self.cfg = cfg
        self.raw_hw = raw_hw
        self.debug_outputs = debug_outputs
        self.stage_timer = stage_timer
        self.K_cam = torch.as_tensor(camera_K, dtype=torch.float32).to(self.device)
        self.trans_input, self.trans_output = _video_transforms(cfg, raw_hw, self.device)
        self.trans_output_inv = geometry.invert_affine(self.trans_output)

    def _stage(self, name: str):
        return self.stage_timer(name) if self.stage_timer is not None else contextlib.nullcontext()

    def frame_step(self, carry: DetectorCarry, cur_img, prev_x3d, next_x3d,
                   teacher=None) -> Tuple[DetectorCarry, FrameResult]:
        cfg = self.cfg
        H_raw, W_raw = self.raw_hw
        # first frame: pre image := current image
        pre_img = torch.where(carry.frame_idx == 0, cur_img, carry.pre_img)

        with self._stage("pnp"):
            prior_kps = carry.detected_kps if teacher is None else teacher
            valid = (prior_kps > KP_SENTINEL).all(1)
            warm = (carry.quat, carry.trans, carry.pose_ok) if cfg.infer.pnp_warm_start else None
            ok, repro, pose = pnp.pnp_reprojection_prior(
                prev_x3d, prior_kps, next_x3d, self.K_cam, valid, init=warm)
            repro = torch.where(ok, repro, prior_kps)  # PnP failure -> previous detections
        with self._stage("render"):
            pre_hm, repro_hm, pre_cls, repro_cls = _render_priors(
                prior_kps, repro, valid.any(), self.trans_input, self.trans_output,
                cfg, (W_raw, H_raw))
        with self._stage("trunk"):
            feats = self.model.trunk(torch.stack([pre_img, cur_img]),
                                     torch.stack([pre_hm, repro_hm]))
        with self._stage("fuse"):
            out = self.model.fuse([f[:1] for f in feats], [f[1:] for f in feats],
                                  pre_cls[None], repro_cls[None])
        with self._stage("decode"):
            hm = torch.sigmoid(out["hm"][0]).clamp(1e-4, 1 - 1e-4)
            inf = cfg.infer
            dec = decode_lib.decode_heatmaps(
                hm, out["reg"][0], out["tracking"][0], max_peaks=inf.max_peaks,
                peak_thresh=inf.peak_thresh, ambiguity_gap=inf.ambiguity_gap,
                peak_offset=inf.peak_offset, sigma=inf.peak_sigma, ref_sort=inf.ref_sort,
                coord_mode=inf.decode_coord)
            raw_kps = geometry.affine_points(dec.coords, self.trans_output_inv)
            keep = dec.valid & (dec.scores > inf.out_thresh)
            detected = torch.where(keep[:, None], raw_kps, torch.full_like(raw_kps, KP_SENTINEL))
            scores = torch.where(keep, dec.scores, torch.full_like(dec.scores, -1.0))
            trk_raw = dec.tracking @ self.trans_output_inv[:, :2].T

        new_carry = DetectorCarry(pre_img=cur_img, detected_kps=detected,
                                  frame_idx=carry.frame_idx + 1, quat=pose.quat,
                                  trans=pose.trans, pose_ok=pose.success)
        extras = {"debug_hm": hm, "debug_pre_hm": pre_hm} if self.debug_outputs else {}
        return new_carry, FrameResult(detected_kps=detected, scores=scores, tracking=trk_raw, **extras)

    def initial_carry(self, video: VideoFrames) -> DetectorCarry:
        dev = self.device
        n_kp = self.cfg.model.num_classes
        init_kps = (video.init_kps.to(dev, torch.float32) if video.init_kps is not None
                    else torch.full((n_kp, 2), KP_SENTINEL, dtype=torch.float32, device=dev))
        return DetectorCarry(
            pre_img=torch.zeros_like(video.images[0], device=dev),
            detected_kps=init_kps,
            frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
            quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
            trans=torch.zeros(3, device=dev),
            pose_ok=torch.zeros((), dtype=torch.bool, device=dev),
        )

    @torch.no_grad()
    def __call__(self, video: VideoFrames) -> FrameResult:
        dev = self.device
        images = video.images.to(dev, torch.float32)
        x3d = video.x3d.to(dev, torch.float32)
        teacher = None if video.teacher_kps is None else video.teacher_kps.to(dev, torch.float32)
        # the prior PnP of frame t uses frame t-1's 3D keypoints
        prev_x3d = torch.cat([x3d[:1], x3d[:-1]])
        carry = self.initial_carry(video)
        results = []
        for t in range(images.shape[0]):
            carry, res = self.frame_step(carry, images[t], prev_x3d[t], x3d[t],
                                         None if teacher is None else teacher[t])
            results.append(res)
        return FrameResult(*(None if res0 is None else torch.stack([getattr(r, f) for r in results])
                             for f, res0 in zip(FrameResult._fields, results[0])))


def make_video_detector(model, cfg: Config, camera_K, raw_hw: Tuple[int, int], device="cuda",
                        debug_outputs: bool = False, stage_timer=None) -> VideoDetector:
    """Single-video exact streaming detector: fn(VideoFrames) -> FrameResult
    stacked over T. `model` is an `SGTAPose` on `device` (trunk/fuse are
    called per frame). debug_outputs adds the per-frame post-sigmoid heatmaps
    and rendered prior."""
    return VideoDetector(model, cfg, camera_K, raw_hw, device, debug_outputs=debug_outputs,
                         stage_timer=stage_timer)
