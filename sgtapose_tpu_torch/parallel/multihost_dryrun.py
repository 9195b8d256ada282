"""Two-process data-parallel dry run: the multi-process launch path end to
end, a tcp:// rendezvous over a free local port, each rank on its shard of
one global batch, one step whose BatchNorm statistics, gradient and logged
loss are reduced over the ranks.

Counterpart of `sgtapose_tpu/parallel/multihost_dryrun.py`
(`run_two_process_dryrun`): two worker processes join one process group
(`parallel/mesh.initialize_multihost`, gloo on the CPU), each feeds its
local shard of one fixed global batch (the tiny model at 64x64 with a conv
decoder, a synthetic batch through the training pipeline) through one
`train/trainer.train_step`, and both must log the same global loss. The
JAX module's compile cache has no counterpart here (the port's kernel build
cache is `ops/build.py`). One worker:

    python -m sgtapose_tpu_torch.parallel.multihost_dryrun HOST:PORT WORLD RANK
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch

from sgtapose_tpu_torch.config import Config, ModelConfig
from sgtapose_tpu_torch.parallel import mesh

GLOBAL_BATCH = 2
TINY = ModelConfig(input_res=(64, 64), kernel_list=(3, 3, 3, 1, 1, 1), dla_node="conv")


def dryrun_step(world: int = 1, rank: int = 0) -> float:
    """One data-parallel train step on the CPU of a fresh tiny train state
    (seed 0) on rank `rank`'s shard of the fixed global batch, in the
    process group this process joined (none: the whole batch); returns the
    logged global loss, the ranks' mean."""
    from sgtapose_tpu_torch.data import pipeline, synthetic
    from sgtapose_tpu_torch.train import trainer

    cfg = Config(model=TINY)
    state = trainer.create_train_state(cfg, seed=0, max_iters=10, device="cpu")
    raw = synthetic.make_raw_batch(torch.Generator().manual_seed(1), GLOBAL_BATCH, device="cpu")
    batch = pipeline.make_batch_fn(cfg, synthetic.camera_K())(torch.Generator().manual_seed(2), raw)
    b = GLOBAL_BATCH // world
    local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    return trainer.train_step(state, local)["tot"].item()


def run_two_process_dryrun(workdir: str, timeout: int = 900) -> float:
    """Launch the two ranks (their output in `workdir`/rank{i}.log); returns
    the global loss they agree on. Raises AssertionError, with the end of
    its log, when a worker fails, and when the two ranks' losses differ."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    logs = [os.path.join(workdir, f"rank{i}.log") for i in range(2)]
    procs = []
    for i, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen([sys.executable, "-m", __name__, f"localhost:{port}", "2", str(i)],
                                          stdout=f, stderr=subprocess.STDOUT, cwd=root))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            p.kill()
    losses = []
    for i, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            out = f.read()
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
        losses.append(float([line for line in out.splitlines() if "loss=" in line][-1].split("loss=")[1]))
    # both ranks log the same global loss (the ranks' mean)
    assert abs(losses[0] - losses[1]) < 1e-6, losses
    return losses[0]


def _worker(coordinator: str, world: int, rank: int) -> None:
    torch.set_num_threads(2)
    mesh.initialize_multihost(coordinator, world, rank, device="cpu")
    try:
        loss = dryrun_step(world, rank)
    finally:
        mesh.shutdown()
    print(f"rank{rank}: loss={loss!r}", flush=True)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
