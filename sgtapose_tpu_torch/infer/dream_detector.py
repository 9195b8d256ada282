"""The DREAM single-frame detector (the --is_ct false mode).

Counterpart of `sgtapose_tpu/infer/dream_detector.py`: a single-frame
belief-map network (`models/dream_baselines.py`: DreamHourglass or
ResnetSimple), no temporal priors and no PnP, four stages per call:

  1. preprocess  host: each raw frame shrink-and-cropped to the network's
                 input with PIL (`data/image_space.py`), then normalised;
  2. forward     device: all T frames in one batched forward (a doubled
                 batch with flip_test), the clamped sigmoid;
  3. decode      device: `decode_heatmaps` with use_reg=False over the batch
                 (the 5x5 weighted average; "logquad" where asked);
  4. convert     host: net-out -> net-in -> raw pixels in float64, missing
                 keypoints at the -999.999 * 4 sentinel.

The model may be float32 or bf16 (`utils/precision.bf16_inference_model`):
its input is cast to its parameter dtype and its heatmap back to float32.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from sgtapose_tpu_torch import resolve_device
from sgtapose_tpu_torch.config import IMAGE_MEAN, IMAGE_STD, Config
from sgtapose_tpu_torch.data import image_space
from sgtapose_tpu_torch.decode.peaks import decode_heatmaps_batch
from sgtapose_tpu_torch.infer.detector import KP_SENTINEL
from sgtapose_tpu_torch.utils.precision import param_dtype

PREPROC = "shrink-and-crop"


def preprocess_dream_frames(raw_images: np.ndarray, in_wh: Tuple[int, int]) -> np.ndarray:
    """Raw uint8 frames (T, H, W, 3) -> normalised float32 network inputs
    (T, in_h, in_w, 3): PIL shrink-and-crop, then (x / 255 - mean) / std."""
    from PIL import Image

    mean = np.asarray(IMAGE_MEAN, np.float32)
    std = np.asarray(IMAGE_STD, np.float32)
    out = []
    for img in np.asarray(raw_images):
        pre = image_space.preprocess_image(Image.fromarray(np.asarray(img, np.uint8)), in_wh, PREPROC)
        out.append((np.asarray(pre, np.float32) / 255.0 - mean) / std)
    return np.stack(out)


def make_dream_detector(model, cfg: Config, raw_wh: Tuple[int, int], flip_test: bool = False, device="cuda",
                        stage_timer=None):
    """fn(raw uint8 frames (T, H_raw, W_raw, 3), numpy) -> (raw-pixel
    keypoints (T, K, 2) float64 with the sentinel where missing, scores
    (T, K) float32), numpy. `model` lives on `device`.

    flip_test: horizontal-flip test-time augmentation. The mirrored frames
    go through the same forward as the second half of one doubled batch;
    their belief maps are mirrored back and averaged with the originals.
    No keypoint is swapped: robot links have no mirror pairs.
    stage_timer: optional fn(name) -> context manager around each stage:
    "preprocess", "forward", "decode", "convert"."""
    dev = resolve_device(device)
    in_h, in_w = cfg.model.input_res
    raw_w, raw_h = raw_wh
    inf = cfg.infer
    timed = stage_timer or (lambda name: contextlib.nullcontext())

    @torch.no_grad()
    def run(raw_images: np.ndarray):
        with timed("preprocess"):
            images = torch.from_numpy(preprocess_dream_frames(raw_images, (in_w, in_h))).to(dev)
        T = images.shape[0]
        with timed("forward"):
            x = torch.cat([images, images.flip(2)]) if flip_test else images
            logits = model(x.to(param_dtype(model)))["hm"].to(torch.float32)
            hm = torch.sigmoid(logits).clamp(1e-4, 1 - 1e-4)
            if flip_test:
                hm = (hm[:T] + hm[T:].flip(2)) / 2.0
        with timed("decode"):
            zeros = hm.new_zeros(hm.shape[:3] + (2,))
            dec = decode_heatmaps_batch(hm, zeros, zeros, max_peaks=inf.max_peaks, peak_thresh=inf.peak_thresh,
                                        ambiguity_gap=inf.ambiguity_gap, peak_offset=inf.peak_offset,
                                        sigma=inf.peak_sigma, use_reg=False, ref_sort=inf.ref_sort,
                                        coord_mode=inf.decode_coord)
            coords_netout, scores = dec.coords.cpu().numpy(), dec.scores.cpu().numpy()
        with timed("convert"):
            out_h, out_w = hm.shape[1:3]
            missing = coords_netout[..., 0] < -999.0
            netin = image_space.convert_keypoints_to_netin_from_netout(
                coords_netout.reshape(-1, 2), (out_w, out_h), (in_w, in_h))
            raw_pts = image_space.convert_keypoints_to_raw_from_netin(
                netin, (in_w, in_h), (raw_w, raw_h), PREPROC).reshape(coords_netout.shape)
            raw_pts[missing] = KP_SENTINEL
        return raw_pts, scores

    return run
