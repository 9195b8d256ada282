"""Host-side batch loader: PNG decode and JSON parse on worker threads, a
2-batch prefetch window ahead of the training loop.

Counterpart of `sgtapose_tpu/data/loader.py:SeqBatchLoader` and
`TripleBatchLoader` (three-frame windows for the PlanA_three phase). The host only
reads files here: batches are numpy `RawSample`s (uint8 frames, float32
projections and robot-frame points), and no worker thread touches CUDA. The
training loop moves each batch to the card on its own thread, where
`data/pipeline.py:make_batch_fn` augments it and renders its priors.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np

from sgtapose_tpu_torch.config import Config
from sgtapose_tpu_torch.data.discovery import FramePair, FrameTriple, remap_seq_frame
from sgtapose_tpu_torch.data.loaders import load_depth_keypoints, load_image, load_seq_keypoints
from sgtapose_tpu_torch.data.pipeline import RawSample, RawSampleThree


class SeqBatchLoader:
    """Iterates epochs of collated RawSample batches.

    The seq_frame remap (none under `depth`, a flat frame stream) is applied
    per sample; the order is shuffled per epoch by a numpy Generator seeded
    with seed + epoch (DistributedSampler's set_epoch); with drop_last the
    last partial batch is dropped. Samples of different raw resolutions in
    one batch cannot be stacked and raise.
    """

    def __init__(self, pairs: Sequence[FramePair], cfg: Config, camera_K: np.ndarray, robot_name: str,
                 keypoint_names: Sequence[str], batch_size: int, seed: int = 317, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True, depth: bool = False):
        self.pairs = list(pairs)
        self.cfg = cfg
        self.camera_K = np.asarray(camera_K)
        self.robot_name = robot_name
        self.keypoint_names = list(keypoint_names)
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.depth = depth

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.pairs) // self.batch_size
        return (len(self.pairs) + self.batch_size - 1) // self.batch_size

    def _load_one(self, pair: FramePair) -> RawSample:
        if self.depth:
            prev_kp = load_depth_keypoints(pair.prev_data_path, self.robot_name, self.camera_K)
            next_kp = load_depth_keypoints(pair.next_data_path, self.robot_name, self.camera_K)
        else:
            pair = remap_seq_frame(pair, self.cfg.train.seq_frame)
            prev_kp = load_seq_keypoints(pair.prev_data_path, self.robot_name, self.keypoint_names,
                                         self.camera_K)
            next_kp = load_seq_keypoints(pair.next_data_path, self.robot_name, self.keypoint_names,
                                         self.camera_K)
        return RawSample(
            prev_img=load_image(pair.prev_img_path), next_img=load_image(pair.next_img_path),
            prev_projs=prev_kp["projections"].astype(np.float32),
            next_projs=next_kp["projections"].astype(np.float32),
            prev_x3d_rob=prev_kp["positions_wrt_robot"].astype(np.float32),
            next_x3d_rob=next_kp["positions_wrt_robot"].astype(np.float32))

    @staticmethod
    def _collate(samples: List[RawSample]) -> RawSample:
        return RawSample(*(np.stack([getattr(s, f) for s in samples]) for f in RawSample._fields))

    def epoch(self, epoch_idx: int) -> Iterator[RawSample]:
        """Yield the collated batches of one epoch in a deterministic order.
        Samples load on a pool of `num_workers` threads while a coordinator
        thread keeps 2 batches in flight beyond a 2-batch queue; the batches
        are the same whatever num_workers is. A load failure is re-raised
        here, in the consumer; leaving the loop early stops the threads."""
        order = np.arange(len(self.pairs))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        batch_indices = [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that notices the consumer leaving (a bare put
            # would block forever on a full queue after an early break)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def coordinator():
            try:
                if self.num_workers <= 1:
                    for idxs in batch_indices:
                        if not put(self._collate([self._load_one(self.pairs[i]) for i in idxs])):
                            return
                    return
                in_flight = 2  # batches of sample futures beyond the queue
                with ThreadPoolExecutor(self.num_workers) as ex:
                    pending: deque = deque()
                    for idxs in batch_indices:
                        if stop.is_set():
                            return
                        pending.append([ex.submit(self._load_one, self.pairs[i]) for i in idxs])
                        if len(pending) > in_flight:
                            if not put(self._collate([f.result() for f in pending.popleft()])):
                                return
                    while pending:
                        if not put(self._collate([f.result() for f in pending.popleft()])):
                            return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=coordinator, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


class TripleBatchLoader(SeqBatchLoader):
    """Epochs of collated RawSampleThree batches (three-frame windows from
    `data/discovery.find_ndds_seq_triples_in_dir`, no seq_frame remap): the
    pair loader's epoch machinery with its own per-sample load and
    collate."""

    def _load_one(self, triple: FrameTriple) -> RawSampleThree:
        def kp(path):
            return load_seq_keypoints(path, self.robot_name, self.keypoint_names, self.camera_K)

        ppre_kp, pre_kp, next_kp = (kp(p) for p in (triple.ppre_data_path, triple.pre_data_path,
                                                    triple.next_data_path))
        return RawSampleThree(
            ppre_img=load_image(triple.ppre_img_path), pre_img=load_image(triple.pre_img_path),
            next_img=load_image(triple.next_img_path),
            ppre_projs=ppre_kp["projections"].astype(np.float32),
            pre_projs=pre_kp["projections"].astype(np.float32),
            next_projs=next_kp["projections"].astype(np.float32),
            ppre_x3d_rob=ppre_kp["positions_wrt_robot"].astype(np.float32),
            pre_x3d_rob=pre_kp["positions_wrt_robot"].astype(np.float32),
            next_x3d_rob=next_kp["positions_wrt_robot"].astype(np.float32))

    @staticmethod
    def _collate(samples: List[RawSampleThree]) -> RawSampleThree:
        return RawSampleThree(*(np.stack([getattr(s, f) for s in samples]) for f in RawSampleThree._fields))
