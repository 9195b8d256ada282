"""Learning-rate schedules as plain functions of the optimizer's schedule
count (counterpart of `sgtapose_tpu/train/schedule.py`). The trainer sets
the learning rate of update t to schedule(t), t counted from 0, as optax's
`scale_by_schedule` does."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def warmup_poly_schedule(base_lr: float, max_iters: int, warmup_iters: int = 3000,
                         warmup_ratio: float = 1e-6, power: float = 1.0) -> Callable[[int], float]:
    """step -> lr: base * (1 - (1 - step/warmup)(1 - warmup_ratio)) while
    step <= warmup_iters, then base * max(1 - (step - 1)/max_iters, 0)^power;
    warmup_iters == 0 takes the poly branch from step 0. Computed in float32,
    as the JAX schedule is."""
    f32 = np.float32

    def schedule(step: int) -> float:
        s = f32(step)
        if warmup_iters > 0 and s <= warmup_iters:
            k = (f32(1.0) - s / f32(warmup_iters)) * f32(1.0 - warmup_ratio)
            return float(f32(base_lr) * (f32(1.0) - k))
        return float(f32(base_lr) * max(f32(1.0) - (s - f32(1.0)) / f32(max_iters), f32(0.0)) ** f32(power))

    return schedule


def step_decay_schedule(base_lr: float, lr_step_epochs: Sequence[int], iters_per_epoch: int,
                        gamma: float = 0.1) -> Callable[[int], float]:
    """step -> base * gamma^(number of milestones passed), epochs counted as
    step / iters_per_epoch (CenterTrack's step decay, which a resumed run
    replays from its step)."""
    milestones = sorted(int(e) for e in lr_step_epochs)

    def schedule(step: int) -> float:
        epoch = np.float32(step) / np.float32(max(iters_per_epoch, 1))
        n = sum(1 for m in milestones if epoch >= m)
        return float(np.float32(base_lr) * np.float32(gamma) ** np.float32(n))

    return schedule
