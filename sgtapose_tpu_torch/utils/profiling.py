"""Per-stage timing and the profiler trace.

Counterpart of `sgtapose_tpu/utils/profiling.py`:
  * StageTimer: accumulating wall-clock buckets per named stage. Given a
    CUDA device, a stage synchronises the device before each reading of the
    clock, so a stage times the card's work and not the launch queue;
  * trace(log_dir): a `torch.profiler` trace of the CPU and, where there is
    one, the CUDA device, written for TensorBoard (the JAX package's
    `jax.profiler` trace).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    def __init__(self, device: Optional[torch.device] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.device = None if device is None else torch.device(device)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        """Mean seconds per call of each stage."""
        return {k: self.totals[k] / max(self.counts[k], 1) for k in sorted(self.totals)}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the CPU and CUDA activity inside the block,
    written to log_dir for TensorBoard's profiler plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
