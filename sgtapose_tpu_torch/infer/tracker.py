"""Detection-to-track association (CenterTrack style), on the host.

Counterpart of `sgtapose_tpu/infer/tracker.py`: each detection carries the
tracking head's backward displacement; a previous track whose centre lies
within a distance gate of (centre + displacement) is a candidate match, and
the assignment is greedy (row order) or Hungarian. Keypoints are matched per
class by the decode already, so association only labels them with ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Track:
    track_id: int
    ct: np.ndarray  # (2,) centre
    cls: int
    score: float
    age: int = 0
    active: int = 1


def greedy_assignment(dist: np.ndarray, gate: float) -> List[tuple]:
    """Row-major greedy matching: a matched column is masked out for every
    later row, so a row whose best track is taken searches its next-best
    candidate instead of going unmatched."""
    matches = []
    if dist.shape[1] == 0:
        return matches
    dist = dist.copy()
    for i in range(dist.shape[0]):
        j = int(np.argmin(dist[i]))
        if dist[i, j] < gate:
            dist[:, j] = 1e18
            matches.append((i, j))
    return matches


def hungarian_assignment(dist: np.ndarray, gate: float) -> List[tuple]:
    from scipy.optimize import linear_sum_assignment

    if dist.size == 0:
        return []
    rows, cols = linear_sum_assignment(dist)
    return [(int(i), int(j)) for i, j in zip(rows, cols) if dist[i, j] < gate]


class Tracker:
    def __init__(self, gate: float = 0.2, hungarian: bool = False, max_age: int = 1):
        self.gate = gate
        self.hungarian = hungarian
        self.max_age = max_age
        self.tracks: List[Track] = []
        self._next_id = 1

    def init_track(self, detections: Optional[List[Dict]] = None):
        self.tracks = []
        self._next_id = 1
        for det in detections or []:
            self._new_track(det)

    def _new_track(self, det: Dict) -> Track:
        t = Track(track_id=self._next_id, ct=np.asarray(det["ct"], np.float64),
                  cls=int(det.get("class", 0)), score=float(det.get("score", 1.0)))
        self._next_id += 1
        self.tracks.append(t)
        return t

    def step(self, detections: List[Dict]) -> List[Dict]:
        """detections: [{'ct': (2,), 'tracking': (2,), 'score', 'class'}].
        Returns the detections annotated with 'tracking_id'."""
        if not self.tracks:
            out = []
            for det in detections:
                t = self._new_track(det)
                out.append({**det, "tracking_id": t.track_id})
            return out

        det_pred = np.array([np.asarray(d["ct"]) + np.asarray(d.get("tracking", (0.0, 0.0)))
                             for d in detections]).reshape(-1, 2)
        trk_ct = np.array([t.ct for t in self.tracks]).reshape(-1, 2)
        dist = np.linalg.norm(det_pred[:, None, :] - trk_ct[None, :, :], axis=2)
        # a detection never matches a track of another class
        for i, d in enumerate(detections):
            for j, t in enumerate(self.tracks):
                if int(d.get("class", 0)) != t.cls:
                    dist[i, j] = 1e18

        assign = hungarian_assignment if self.hungarian else greedy_assignment
        matches = assign(dist, self.gate)

        out = []
        matched_tracks, matched_dets = set(), set()
        for i, j in matches:
            t = self.tracks[j]
            t.ct = np.asarray(detections[i]["ct"], np.float64)
            t.score = float(detections[i].get("score", 1.0))
            t.age = 0
            t.active = 1
            matched_tracks.add(j)
            matched_dets.add(i)
            out.append({**detections[i], "tracking_id": t.track_id})
        new_ids = set()
        for i, det in enumerate(detections):
            if i not in matched_dets:
                t = self._new_track(det)
                new_ids.add(t.track_id)
                out.append({**det, "tracking_id": t.track_id})
        survivors = []
        for j, t in enumerate(self.tracks):
            if j in matched_tracks or t.track_id in new_ids:
                survivors.append(t)
            else:  # an unmatched earlier track ages out
                t.age += 1
                t.active = 0
                if t.age <= self.max_age:
                    survivors.append(t)
        self.tracks = survivors
        return out


def track_video(detected_kps: np.ndarray, scores: np.ndarray, tracking: Optional[np.ndarray] = None,
                gate: float = 0.2, hungarian: bool = False, sentinel: Optional[float] = None
                ) -> np.ndarray:
    """One video's association pass over the detector's outputs, one
    `Tracker.step` per frame. detected_kps: (T, K, 2) raw coords (the
    sentinel marks a missing one), scores: (T, K), tracking: (T, K, 2)
    raw-pixel backward displacements (None: zeros). Returns (T, K) int track
    ids, -1 where the class was not detected in that frame."""
    if sentinel is None:
        from sgtapose_tpu_torch.infer.detector import KP_SENTINEL

        sentinel = KP_SENTINEL
    T, K, _ = detected_kps.shape
    tracker = Tracker(gate=gate, hungarian=hungarian)
    tracker.init_track([])
    ids = np.full((T, K), -1, np.int64)
    for t in range(T):
        dets = []
        for k in range(K):
            if np.all(detected_kps[t, k] > sentinel + 1e-6):
                dets.append({"ct": detected_kps[t, k],
                             "tracking": tracking[t, k] if tracking is not None else np.zeros(2),
                             "score": float(scores[t, k]), "class": k})
        for d in tracker.step(dets):
            ids[t, int(d["class"])] = int(d["tracking_id"])
    return ids
