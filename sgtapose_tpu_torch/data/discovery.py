"""NDDS sequence-dataset discovery.

Counterpart of `sgtapose_tpu/data/discovery.py` (the port's own copy of the
pure-Python module): walk a directory of per-video subdirectories holding
NNNN_color.png + NNNN_meta.json pairs and emit consecutive (prev, next)
frame pairs per video, skipping gaps of more than one frame (with
pair_frames=False, identity pairs: the DREAM single-frame mode); the
seq_frame window remap; the flat 42-joint depth directory; consecutive
frame triples.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class FramePair:
    prev_name: str
    prev_img_path: str
    prev_data_path: str
    next_name: str
    next_img_path: str
    next_data_path: str


def find_ndds_seq_data_in_dir(
    input_dir: str, pair_frames: bool = True
) -> List[FramePair]:
    input_dir = os.path.expanduser(input_dir)
    if not os.path.exists(input_dir):
        raise FileNotFoundError(input_dir)

    found: List[FramePair] = []
    for video_dir in sorted(os.listdir(input_dir)):
        if video_dir.endswith(".json"):
            continue
        vdir = os.path.join(input_dir, video_dir)
        if not os.path.isdir(vdir):
            continue
        entries = sorted(os.listdir(vdir))
        pngs = sorted(f for f in entries if f.endswith("color.png"))
        jsons = sorted(f for f in entries if f.endswith(".json"))
        if min(len(pngs), len(jsons)) < 2:
            continue
        jsons = jsons[: len(pngs)]
        if len(pngs) != len(jsons):
            raise ValueError(f"{vdir}: png/json count mismatch")
        for png, js in zip(pngs, jsons):
            if png[:4] != js[:4]:
                raise ValueError(f"{vdir}: unpaired {png} / {js}")

        names = [os.path.join(video_dir, f[:4]) for f in jsons]
        img_paths = [os.path.join(vdir, f) for f in pngs]
        data_paths = [os.path.join(vdir, f) for f in jsons]

        if pair_frames:
            rng = range(len(pngs) - 1) if len(pngs) > 2 else [0]
            for i in rng:
                prev_ind = int(names[i].split(os.sep)[-1])
                next_ind = int(names[i + 1].split(os.sep)[-1])
                if len(pngs) > 2 and next_ind - prev_ind > 1:
                    continue  # temporal gap: not consecutive
                found.append(
                    FramePair(
                        names[i], img_paths[i], data_paths[i],
                        names[i + 1], img_paths[i + 1], data_paths[i + 1],
                    )
                )
        else:
            for i in range(len(pngs)):
                found.append(
                    FramePair(
                        names[i], img_paths[i], data_paths[i],
                        names[i], img_paths[i], data_paths[i],
                    )
                )
    return found


def remap_seq_frame(pair: FramePair, seq_frame: int) -> FramePair:
    """seq_frame window remap (ref sgtapose/datasets.py:63-91): when the next
    frame index is a multiple of seq_frame, the pair is replaced by
    (ind - seq_frame, prev) so temporal context never crosses a window
    boundary."""
    frame_dir, ind_s = os.path.split(pair.next_name)
    ind = int(ind_s)
    if seq_frame and ind % seq_frame == 0:
        old = ind_s.zfill(4)
        new = str(ind - seq_frame).zfill(4)
        return FramePair(
            prev_name=os.path.join(frame_dir, new),
            prev_img_path=pair.next_img_path.replace(old + "_color.png", new + "_color.png"),
            prev_data_path=pair.next_data_path.replace(old + "_meta.json", new + "_meta.json"),
            next_name=pair.prev_name,
            next_img_path=pair.prev_img_path,
            next_data_path=pair.prev_data_path,
        )
    return pair


def find_depth_seq_data_in_dir(input_dir: str) -> List[FramePair]:
    """42-joint depth-variant discovery: ONE flat directory of NNNN.png +
    NNNN.json frames (ref inference.py:407-423 globbing; the depth training
    dataset CenterTrackSeqDepthDataset, ref datasets.py:445-635, consumes the
    same flat frame stream as consecutive pairs)."""
    input_dir = os.path.expanduser(input_dir)
    if not os.path.exists(input_dir):
        raise FileNotFoundError(input_dir)
    pngs = sorted(f for f in os.listdir(input_dir) if f.endswith(".png"))
    pairs: List[FramePair] = []
    for a, b in zip(pngs[:-1], pngs[1:]):
        a_js = a[: -len("png")] + "json"
        b_js = b[: -len("png")] + "json"
        if not (os.path.exists(os.path.join(input_dir, a_js))
                and os.path.exists(os.path.join(input_dir, b_js))):
            continue
        pairs.append(
            FramePair(
                a[: -len(".png")], os.path.join(input_dir, a),
                os.path.join(input_dir, a_js),
                b[: -len(".png")], os.path.join(input_dir, b),
                os.path.join(input_dir, b_js),
            )
        )
    return pairs


@dataclass(frozen=True)
class FrameTriple:
    """Three consecutive frames (ref CenterTrackThreeDataset,
    datasets.py:215-440: ppre -> pre -> next)."""

    ppre_img_path: str
    ppre_data_path: str
    pre_img_path: str
    pre_data_path: str
    next_img_path: str
    next_data_path: str


def find_ndds_seq_triples_in_dir(input_dir: str) -> List[FrameTriple]:
    """Consecutive frame TRIPLES per video for 3-frame training (ref
    CenterTrackThreeDataset). Reuses the pair discovery's ordering and
    gap rules: a triple exists where (i, i+1) and (i+1, i+2) are both
    consecutive pairs."""
    pairs = find_ndds_seq_data_in_dir(input_dir)
    by_next = {p.next_name: p for p in pairs}
    triples: List[FrameTriple] = []
    for p in pairs:
        q = by_next.get(p.prev_name)
        if q is None:
            continue
        triples.append(
            FrameTriple(
                q.prev_img_path, q.prev_data_path,
                p.prev_img_path, p.prev_data_path,
                p.next_img_path, p.next_data_path,
            )
        )
    return triples
