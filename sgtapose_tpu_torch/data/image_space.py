"""Image preprocessing modes and keypoint coordinate-space conversions.

Counterpart of `sgtapose_tpu/data/image_space.py` (the port's own copy): the
preprocessing types none / resize / shrink / shrink-and-crop on PIL images,
and the raw <-> net-input <-> net-output keypoint conversions, in float64
numpy on the host. They feed the DREAM single-frame detector
(`infer/dream_detector.py`): a 640x360 raw frame shrink-and-cropped to
480x480 loses 140 px on each side.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PREPROC_TYPES = ("none", "resize", "shrink", "shrink-and-crop")


def shrink_resolution(input_res, ref_res) -> Tuple[int, int]:
    """Aspect-preserving resize to the reference height."""
    factor = float(ref_res[1]) / float(input_res[1])
    return (int(input_res[0] * factor), ref_res[1])


def shrink_and_crop_resolution(input_res, ref_res):
    """The largest centred crop of `input_res` with the aspect of `ref_res`:
    (cropped resolution, top-left corner of the crop)."""
    in_w, in_h = input_res
    ref_w, ref_h = ref_res
    ref_h_by_w = int(float(in_w) / ref_w * ref_h)
    ref_w_by_h = int(float(in_h) / ref_h * ref_w)
    if in_w >= ref_w_by_h:
        cropped = (ref_w_by_h, in_h)
    else:
        if in_h < ref_h_by_w:
            raise ValueError(f"no crop of {input_res} has the aspect of {ref_res}")
        cropped = (in_w, ref_h_by_w)
    return cropped, ((in_w - cropped[0]) // 2, (in_h - cropped[1]) // 2)


def _check(mode: str) -> None:
    if mode not in PREPROC_TYPES:
        raise ValueError(f"unknown preprocessing mode {mode!r}; one of {PREPROC_TYPES}")


def resolution_after_preprocessing(input_res, ref_res, mode: str):
    _check(mode)
    if mode == "none":
        return input_res
    if mode in ("resize", "shrink-and-crop"):
        return ref_res
    return shrink_resolution(input_res, ref_res)


def preprocess_image(image, ref_res, mode: str):
    """PIL image -> preprocessed PIL image (bilinear resampling)."""
    from PIL import Image

    _check(mode)
    if mode == "none":
        return image
    if mode == "resize":
        return image.resize(ref_res, resample=Image.BILINEAR)
    if mode == "shrink":
        return image.resize(shrink_resolution(image.size, ref_res), resample=Image.BILINEAR)
    cropped_res, (u, v) = shrink_and_crop_resolution(image.size, ref_res)
    cropped = image.crop((u, v, u + cropped_res[0], v + cropped_res[1]))
    return cropped.resize(ref_res, resample=Image.BILINEAR)


def _scale(points, from_res, to_res):
    s = np.array([to_res[0] / from_res[0], to_res[1] / from_res[1]])
    return np.asarray(points, np.float64) * s


def convert_keypoints_to_netout_from_netin(points, net_in_res, net_out_res):
    return _scale(points, net_in_res, net_out_res)


def convert_keypoints_to_netin_from_netout(points, net_out_res, net_in_res):
    return _scale(points, net_out_res, net_in_res)


def convert_keypoints_to_netin_from_raw(points, raw_res, net_in_res, mode: str):
    _check(mode)
    pts = np.asarray(points, np.float64)
    if mode == "none":
        return pts
    if mode == "resize":
        return _scale(pts, raw_res, net_in_res)
    if mode == "shrink":
        return _scale(pts, raw_res, shrink_resolution(raw_res, net_in_res))
    cropped_res, corner = shrink_and_crop_resolution(raw_res, net_in_res)
    return _scale(pts - np.asarray(corner, np.float64), cropped_res, net_in_res)


def convert_keypoints_to_raw_from_netin(points, net_in_res, raw_res, mode: str):
    _check(mode)
    pts = np.asarray(points, np.float64)
    if mode == "none":
        return pts
    if mode in ("resize", "shrink"):
        return _scale(pts, net_in_res, raw_res)
    cropped_res, corner = shrink_and_crop_resolution(raw_res, net_in_res)
    return _scale(pts, net_in_res, cropped_res) + np.asarray(corner, np.float64)
