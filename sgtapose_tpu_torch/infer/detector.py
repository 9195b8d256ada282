"""Streaming video detectors: exact, feature-cache and batched.

Counterpart of `sgtapose_tpu/infer/detector.py`: `make_video_detector` (the
`lax.scan` runner of `_build_video_runner`), `make_batched_video_detector`
(its `vmap` over videos) and `make_cached_video_detector` (the feature-cache
fast path of `_build_cached_video_runner`), as Python loops over frames with
the same carry (`DetectorCarry`). Every runner steps a batch of V videos
together (V = 1 for the single-video runners), each video with its own
carry; each frame runs five stages over the whole batch:

  1. pnp     prior PnP from the previous detections (or teacher keypoints)
             and reprojection of this frame's 3D keypoints, one batched solve
             for all videos; a video whose PnP fails reuses its previous
             detections;
  2. render  prior heatmaps at input resolution and per class at output
             resolution (all zero for a video with no valid detection);
  3. trunk   the Siamese DLA-34 pass over [previous frames; current frames]
             (2V images), or, in the feature-cache runner, over the current
             frames only (V images);
  4. fuse    windowed temporal attention + DCN decoder + heads over V;
  5. decode  sigmoid, peak decode, inverse affine to raw pixels, score
             threshold, batched over V.

The model may be float32 or bf16 (`utils/precision.bf16_inference_model`):
its six inputs are cast to its parameter dtype and its heads back to float32,
as the JAX package's `make_bf16_apply` does; PnP, rendering and decode stay
float32. Everything stays on the device; the frame loop never reads a value
back to the host (PnP's eigh/SVD check their own status, see core/pnp.py).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import IMAGE_MEAN, IMAGE_STD, Config
from sgtapose_tpu_torch.core import geometry, pnp
from sgtapose_tpu_torch.decode import peaks as decode_lib
from sgtapose_tpu_torch.models.sgta import CHANNELS
from sgtapose_tpu_torch.utils.precision import param_dtype

KP_SENTINEL = -999.999 * 4  # missing-detection marker
STAGES = ("pnp", "render", "trunk", "fuse", "decode")


class VideoFrames(NamedTuple):
    """Pre-warped per-video inputs; the batched runner takes the same fields
    with a leading video dim."""

    images: torch.Tensor  # (T, H_in, W_in, 3) normalized network inputs
    x3d: torch.Tensor  # (T, K, 3) keypoint positions for the PnP prior
    # optional GT-initialized prior: raw-frame keypoints used as frame 0's
    # "detections" (None starts cold, with all-zero priors)
    init_kps: Optional[torch.Tensor] = None  # (K, 2)
    # optional teacher-forced prior detections: frame t's prior PnP consumes
    # teacher_kps[t] instead of the previous frame's detections
    teacher_kps: Optional[torch.Tensor] = None  # (T, K, 2)


class DetectorCarry(NamedTuple):
    """Cross-frame state of a batch of V videos."""

    pre_img: torch.Tensor  # (V, H_in, W_in, 3)
    detected_kps: torch.Tensor  # (V, K, 2) raw coords or KP_SENTINEL
    frame_idx: torch.Tensor  # () int32, shared: the videos step together
    # previous frame's solved pose: the warm start of the prior PnP when
    # cfg.infer.pnp_warm_start
    quat: torch.Tensor  # (V, 4) wxyz
    trans: torch.Tensor  # (V, 3)
    pose_ok: torch.Tensor  # (V,) bool
    # feature-cache runner: the previous frame's trunk features, levels 0-5
    pre_feats: Optional[List[torch.Tensor]] = None


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
    """Warp + normalize all frames (..., T, H_raw, W_raw, 3) of a video (or a
    batch of videos of one camera) with the fixed center/scale transform.
    Returns (images, trans_input, trans_output)."""
    H_raw, W_raw = raw_images.shape[-3], raw_images.shape[-2]
    trans_input, trans_output = _video_transforms(cfg, (H_raw, W_raw), raw_images.device)
    warped = geometry.warp_affine(raw_images.to(torch.float32), trans_input, cfg.model.input_res)
    return geometry.normalize_image(warped, IMAGE_MEAN, IMAGE_STD), trans_input, trans_output


def _render_priors(detected_kps, repro_kps, any_valid, trans_input, trans_output,
                   cfg: Config, raw_wh: Tuple[int, int], with_pre_hm: bool = True):
    """For (V, K, 2) keypoints: pre/repro heatmaps at input res (V,H,W,1) and
    per-class at output res (V,Ho,Wo,K); all zero for a video whose
    any_valid (V,) is False. with_pre_hm=False skips the pre heatmap (None)."""
    in_h, in_w = cfg.model.input_res
    out_h, out_w = cfg.model.output_res
    W_raw, H_raw = raw_wh
    okf = any_valid.to(torch.float32)[:, None, None]
    pre_hm = None
    if with_pre_hm:
        pre_hm = geometry.render_prior_heatmap(
            detected_kps, trans_input, in_w, in_h, W_raw, H_raw) * okf
        pre_hm = pre_hm[..., None]
    repro_hm = geometry.render_prior_heatmap(repro_kps, trans_input, in_w, in_h, W_raw, H_raw) * okf
    pre_cls = geometry.render_prior_heatmap_cls(
        detected_kps, trans_output, out_w, out_h, W_raw, H_raw) * okf[..., None]
    repro_cls = geometry.render_prior_heatmap_cls(
        repro_kps, trans_output, out_w, out_h, W_raw, H_raw) * okf[..., None]
    return pre_hm, repro_hm[..., None], pre_cls.permute(0, 2, 3, 1), repro_cls.permute(0, 2, 3, 1)


class VideoDetector:
    """The exact streaming detector over a batch of videos.

    `run_batch(videos)` takes VideoFrames with a leading video dim V and
    returns FrameResult fields (V, T, ...); calling the detector on one
    video's VideoFrames returns (T, ...) fields. stage_timer: optional
    callable(stage_name) -> context manager wrapped around each of the five
    stages of every frame step (see STAGES), for measurement; None runs them
    bare."""

    def __init__(self, model, cfg: Config, camera_K, raw_hw: Tuple[int, int], device,
                 debug_outputs: bool = False,
                 stage_timer: Optional[Callable[[str], contextlib.AbstractContextManager]] = None):
        self.device = resolve_device(device)
        p = next(model.parameters())
        if p.device.type != self.device.type:
            raise ValueError(f"model is on {p.device}, detector device is {self.device}")
        self.model = model
        self.dtype = param_dtype(model)  # the model's inputs are cast to it
        self.cfg = cfg
        self.raw_hw = raw_hw
        self.debug_outputs = debug_outputs
        self.stage_timer = stage_timer
        self.K_cam = torch.as_tensor(camera_K, dtype=torch.float32).to(self.device)
        self.trans_input, self.trans_output = _video_transforms(cfg, raw_hw, self.device)
        self.trans_output_inv = geometry.invert_affine(self.trans_output)

    def _stage(self, name: str):
        return self.stage_timer(name) if self.stage_timer is not None else contextlib.nullcontext()

    def _prior(self, carry: DetectorCarry, prev_x3d, next_x3d, teacher, with_pre_hm=True):
        """Stages 1-2: (pose, pre_hm, repro_hm, pre_cls, repro_cls)."""
        cfg = self.cfg
        H_raw, W_raw = self.raw_hw
        with self._stage("pnp"):
            prior_kps = carry.detected_kps if teacher is None else teacher
            valid = (prior_kps > KP_SENTINEL).all(-1)  # (V, K)
            warm = (carry.quat, carry.trans, carry.pose_ok) if cfg.infer.pnp_warm_start else None
            ok, repro, pose = pnp.pnp_reprojection_prior_batch(
                prev_x3d, prior_kps, next_x3d, self.K_cam, valid, init=warm)
            # a video whose PnP fails reuses its previous detections
            repro = torch.where(ok[:, None, None], repro, prior_kps)
        with self._stage("render"):
            priors = _render_priors(prior_kps, repro, valid.any(-1), self.trans_input,
                                    self.trans_output, cfg, (W_raw, H_raw), with_pre_hm)
        return (pose,) + priors

    def _network(self, cur_img, pre_img, pre_hm, repro_hm, pre_cls, repro_cls):
        """Stages 3-4: the heads, cast to float32."""
        dt = self.dtype
        V = cur_img.shape[0]
        with self._stage("trunk"):
            feats = self.model.trunk(torch.cat([pre_img, cur_img]).to(dt),
                                     torch.cat([pre_hm, repro_hm]).to(dt))
        with self._stage("fuse"):
            out = self.model.fuse([f[:V] for f in feats], [f[V:] for f in feats],
                                  pre_cls.to(dt), repro_cls.to(dt))
        return {k: v.to(torch.float32) for k, v in out.items()}

    def _decode(self, out):
        """Stage 5: (detected, scores, tracking, post-sigmoid hm), batched."""
        with self._stage("decode"):
            hm = torch.sigmoid(out["hm"]).clamp(1e-4, 1 - 1e-4)
            inf = self.cfg.infer
            dec = decode_lib.decode_heatmaps_batch(
                hm, out["reg"], out["tracking"], max_peaks=inf.max_peaks,
                peak_thresh=inf.peak_thresh, ambiguity_gap=inf.ambiguity_gap,
                peak_offset=inf.peak_offset, sigma=inf.peak_sigma, ref_sort=inf.ref_sort,
                coord_mode=inf.decode_coord)
            raw_kps = geometry.affine_points(dec.coords, self.trans_output_inv)
            keep = dec.valid & (dec.scores > inf.out_thresh)
            detected = torch.where(keep[..., None], raw_kps, torch.full_like(raw_kps, KP_SENTINEL))
            scores = torch.where(keep, dec.scores, torch.full_like(dec.scores, -1.0))
            trk_raw = dec.tracking @ self.trans_output_inv[:, :2].T
        return detected, scores, trk_raw, hm

    def frame_step(self, carry: DetectorCarry, cur_img, prev_x3d, next_x3d,
                   teacher=None) -> Tuple[DetectorCarry, FrameResult]:
        """One frame of V videos: cur_img (V,H,W,3), prev_x3d/next_x3d
        (V,K,3), teacher (V,K,2) or None."""
        # first frame: pre image := current image
        pre_img = torch.where(carry.frame_idx == 0, cur_img, carry.pre_img)
        pose, pre_hm, repro_hm, pre_cls, repro_cls = self._prior(carry, prev_x3d, next_x3d, teacher)
        out = self._network(cur_img, pre_img, pre_hm, repro_hm, pre_cls, repro_cls)
        detected, scores, trk_raw, hm = self._decode(out)
        new_carry = DetectorCarry(pre_img=cur_img, detected_kps=detected,
                                  frame_idx=carry.frame_idx + 1, quat=pose.quat,
                                  trans=pose.trans, pose_ok=pose.success)
        extras = {"debug_hm": hm, "debug_pre_hm": pre_hm} if self.debug_outputs else {}
        return new_carry, FrameResult(detected_kps=detected, scores=scores, tracking=trk_raw, **extras)

    def initial_carry(self, videos: VideoFrames) -> DetectorCarry:
        """The carry before frame 0 of a batch of videos (leading dim V)."""
        dev = self.device
        V = videos.images.shape[0]
        n_kp = self.cfg.model.num_classes
        init_kps = (videos.init_kps.to(dev, torch.float32) if videos.init_kps is not None
                    else torch.full((V, n_kp, 2), KP_SENTINEL, dtype=torch.float32, device=dev))
        return DetectorCarry(
            pre_img=torch.zeros(videos.images.shape[:1] + videos.images.shape[2:], device=dev),
            detected_kps=init_kps,
            frame_idx=torch.zeros((), dtype=torch.int32, device=dev),
            quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(V, 4),
            trans=torch.zeros(V, 3, device=dev),
            pose_ok=torch.zeros(V, dtype=torch.bool, device=dev),
        )

    @torch.no_grad()
    def run_batch(self, videos: VideoFrames) -> FrameResult:
        """Videos with a leading dim V (same T) -> FrameResult fields (V, T, ...)."""
        dev = self.device
        images = videos.images.to(dev, torch.float32)
        x3d = videos.x3d.to(dev, torch.float32)
        teacher = None if videos.teacher_kps is None else videos.teacher_kps.to(dev, torch.float32)
        # the prior PnP of frame t uses frame t-1's 3D keypoints
        prev_x3d = torch.cat([x3d[:, :1], x3d[:, :-1]], dim=1)
        carry = self.initial_carry(videos)
        results = []
        for t in range(images.shape[1]):
            carry, res = self.frame_step(carry, images[:, t], prev_x3d[:, t], x3d[:, t],
                                         None if teacher is None else teacher[:, t])
            results.append(res)
        return FrameResult(*(None if res0 is None else torch.stack([getattr(r, f) for r in results], 1)
                             for f, res0 in zip(FrameResult._fields, results[0])))

    def __call__(self, video: VideoFrames) -> FrameResult:
        """One video (no leading video dim) -> FrameResult fields (T, ...)."""
        res = self.run_batch(VideoFrames(*(None if x is None else x[None] for x in video)))
        return FrameResult(*(None if x is None else x[0] for x in res))


class BatchedVideoDetector(VideoDetector):
    """The exact detector over a batch of videos: fn(VideoFrames with a
    leading video dim) -> FrameResult fields (V, T, ...). All videos share T
    and the camera; teacher_kps and init_kps, where given, are per video."""

    def __call__(self, videos: VideoFrames) -> FrameResult:
        return self.run_batch(videos)


class CachedVideoDetector(VideoDetector):
    """The feature-cache detector: frame t reuses frame t-1's current-pass
    trunk features as its previous-pass features, so the trunk runs once per
    frame, on (current frame, repro_hm). Frame 0 reuses its own features
    (exact there: both passes would see zero priors). The cached features
    were conditioned on repro_hm of t-1 instead of pre_hm of t: a documented
    deviation from the exact runner (`sgtapose_tpu/infer/detector.py:346-350`).
    The features are carried in the model's parameter dtype, starting from
    zeros of the six level shapes."""

    def frame_step(self, carry: DetectorCarry, cur_img, prev_x3d, next_x3d,
                   teacher=None) -> Tuple[DetectorCarry, FrameResult]:
        if teacher is not None:
            raise ValueError("teacher forcing is only implemented on the exact runner "
                             "(make_video_detector); the feature-cache runner would "
                             "silently run closed-loop")
        pose, _, repro_hm, pre_cls, repro_cls = self._prior(carry, prev_x3d, next_x3d, None,
                                                            with_pre_hm=False)
        dt = self.dtype
        with self._stage("trunk"):
            cur_feats = self.model.trunk(cur_img.to(dt), repro_hm.to(dt))
        with self._stage("fuse"):
            first = carry.frame_idx == 0
            pre_feats = [torch.where(first, c, p) for c, p in zip(cur_feats, carry.pre_feats)]
            out = self.model.fuse(pre_feats, cur_feats, pre_cls.to(dt), repro_cls.to(dt))
        out = {k: v.to(torch.float32) for k, v in out.items()}
        detected, scores, trk_raw, _ = self._decode(out)
        new_carry = DetectorCarry(pre_img=cur_img, detected_kps=detected,
                                  frame_idx=carry.frame_idx + 1, quat=pose.quat,
                                  trans=pose.trans, pose_ok=pose.success, pre_feats=cur_feats)
        return new_carry, FrameResult(detected_kps=detected, scores=scores, tracking=trk_raw)

    def initial_carry(self, videos: VideoFrames) -> DetectorCarry:
        if videos.teacher_kps is not None:
            raise ValueError("teacher forcing is only implemented on the exact runner "
                             "(make_video_detector); the feature-cache runner would "
                             "silently run closed-loop")
        carry = super().initial_carry(videos)
        V = videos.images.shape[0]
        in_h, in_w = self.cfg.model.input_res
        feats = [torch.zeros(V, in_h // 2 ** i, in_w // 2 ** i, c, dtype=self.dtype, device=self.device)
                 for i, c in enumerate(CHANNELS)]
        return carry._replace(pre_feats=feats)


def make_video_detector(model, cfg: Config, camera_K, raw_hw: Tuple[int, int], device="cuda",
                        debug_outputs: bool = False, stage_timer=None) -> VideoDetector:
    """Single-video exact streaming detector: fn(VideoFrames) -> FrameResult
    stacked over T. `model` is an `SGTAPose` on `device`, float32 or bf16
    (trunk/fuse are called per frame). debug_outputs adds the per-frame
    post-sigmoid heatmaps and rendered prior."""
    return VideoDetector(model, cfg, camera_K, raw_hw, device, debug_outputs=debug_outputs,
                         stage_timer=stage_timer)


def make_batched_video_detector(model, cfg: Config, camera_K, raw_hw: Tuple[int, int],
                                device="cuda", debug_outputs: bool = False,
                                stage_timer=None) -> BatchedVideoDetector:
    """The exact detector over a batch of videos (frames depend on each other,
    videos do not): fn(VideoFrames with a leading video dim) -> FrameResult
    fields (V, T, ...). One trunk pass over 2V images, one fuse over V and one
    batched PnP solve per frame step."""
    return BatchedVideoDetector(model, cfg, camera_K, raw_hw, device, debug_outputs=debug_outputs,
                                stage_timer=stage_timer)


def make_cached_video_detector(model, cfg: Config, camera_K, raw_hw: Tuple[int, int],
                               device="cuda", stage_timer=None) -> CachedVideoDetector:
    """Single-video feature-cache detector (one trunk pass per frame; see
    `CachedVideoDetector`): fn(VideoFrames) -> FrameResult stacked over T.
    Set cfg.infer.pnp_warm_start for the fast path the JAX benchmark runs.
    Teacher forcing raises."""
    return CachedVideoDetector(model, cfg, camera_K, raw_hw, device, stage_timer=stage_timer)
