"""Keypoint metadata and image loaders (host side, numpy and json).

Counterpart of `sgtapose_tpu/data/loaders.py`, the same functions of the same
files:
  * load_seq_keypoints: the synthetic NDDS sequence format, per-keypoint
    `location_wrt_cam` and a frame-level `R2C Mat` rotation; projections
    through K, robot-frame positions through the inverse camera-to-robot
    transform;
  * load_keypoints: the DREAM-real format, `objects[i].keypoints` with
    `projected_location` (NaN where a keypoint has none);
  * load_depth_keypoints: the 42-joint depth format (`joints_3n_fixed_42`);
  * load_camera_intrinsics, load_image_resolution, load_image, load_x3d.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np


def _load_json(path: str):
    with open(path, "r") as f:
        return json.loads(f.read().replace("\t", " "))


def load_camera_intrinsics(camera_data_path: str) -> np.ndarray:
    data = _load_json(camera_data_path)
    s = data["camera_settings"][0]["intrinsic_settings"]
    return np.array([[s["fx"], 0.0, s["cx"]], [0.0, s["fy"], s["cy"]], [0.0, 0.0, 1.0]])


def load_image_resolution(camera_data_path: str):
    data = _load_json(camera_data_path)
    size = data["camera_settings"][0]["captured_image_size"]
    return (size["width"], size["height"])


def load_seq_keypoints(data_path: str, object_name: str, keypoint_names: Sequence[str],
                       camera_K: np.ndarray) -> Dict[str, np.ndarray]:
    """Synthetic sequence format. Returns float64 arrays: projections (K,2),
    positions_wrt_cam (K,3), positions_wrt_robot (K,3)."""
    data = _load_json(data_path)[0]
    assert object_name == data["ROBOT NAME"], (object_name, data["ROBOT NAME"])
    kps = data["keypoints"]

    inv = np.array(kps[0]["R2C Mat"]).T  # cam -> robot rotation
    trans = np.array(kps[0]["location_wrt_cam"])

    # names are found in order with a cursor that only moves forward
    by_name = {}
    cursor = 0
    for name in keypoint_names:
        while kps[cursor]["Name"] != name:
            cursor += 1
        by_name[name] = kps[cursor]

    projections, pos_cam, pos_rob = [], [], []
    for name in keypoint_names:
        p_cam = np.array(by_name[name]["location_wrt_cam"], dtype=np.float64)
        proj = camera_K @ p_cam
        projections.append((proj / proj[2])[:2])
        pos_cam.append(p_cam)
        pos_rob.append(inv @ (p_cam - trans))

    return {
        "projections": np.array(projections),
        "positions_wrt_cam": np.array(pos_cam),
        "positions_wrt_robot": np.array(pos_rob),
    }


def load_keypoints(data_path: str, object_name: str, keypoint_names: Sequence[str]
                   ) -> Dict[str, np.ndarray]:
    """DREAM-real format (panda-orb / 3cam sets): projections (K,2), NaN where
    a keypoint has no projected_location, and positions_wrt_cam (K,3)."""
    data = _load_json(data_path)
    object_names = [o["class"] for o in data["objects"]]
    obj = data["objects"][object_names.index(object_name)]
    kp_by_name = {kp["name"]: kp for kp in obj["keypoints"]}

    projections, pos_cam = [], []
    for name in keypoint_names:
        kp = kp_by_name[name]
        pos_cam.append(kp["location"])
        projections.append(kp.get("projected_location", [np.nan, np.nan]))
    return {
        "projections": np.array(projections, dtype=np.float64),
        "positions_wrt_cam": np.array(pos_cam, dtype=np.float64),
    }


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_depth_keypoints(data_path: str, object_name: str, camera_K: np.ndarray
                         ) -> Dict[str, np.ndarray]:
    """42-joint depth format: a frame-level `R2C_mat` and the camera-frame
    `joints_3n_fixed_42`; projections through K, robot-frame positions
    through the inverse camera-to-robot transform anchored at keypoint 0."""
    data = _load_json(data_path)[0]
    assert object_name == data["ROBOT NAME"], (object_name, data["ROBOT NAME"])
    kps = data["keypoints"]
    joints = data["joints_3n_fixed_42"]

    inv = np.array(kps[0]["R2C_mat"]).T
    trans = np.array(kps[0]["location_wrt_cam"]).reshape(1, 3)

    pos_cam = np.array([j["location_wrt_cam"] for j in joints], dtype=np.float64)
    pos_rob = (inv @ (pos_cam - trans).T).T
    proj = (camera_K @ pos_cam.T).T
    proj = proj[:, :2] / proj[:, 2:3]
    return {"projections": proj, "positions_wrt_cam": pos_cam, "positions_wrt_robot": pos_rob}


def load_x3d(data_path: str, object_name: str, keypoint_names) -> np.ndarray:
    """Camera-frame 3D keypoint positions of the synthetic format."""
    return load_seq_keypoints(data_path, object_name, keypoint_names, np.eye(3))["positions_wrt_cam"]
