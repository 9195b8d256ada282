"""Data-parallel ranks (`sgtapose_tpu_torch/parallel/mesh.py`) against one
process on the global batch: the JAX mesh step is one step over the global
batch, so two ranks of batch 1 must make the step one process makes at
batch 2.

Three CPU processes run one float64 `trainer.train_step` of the tiny model
(64x64, full channel widths, DCN decoder) from the same seeded weights with
dropout on (tests/torch_port_parallel_worker.py): one alone on the batch of
2, and two ranks of a gloo group over tcp://localhost, each on its row.
Float64, as test_torch_port_train_f64.py runs the step: train-mode
BatchNorm amplifies float32 rounding. Bars: the all-reduced gradients, the
BatchNorm running statistics and the Adam moments within 1e-9 of each
tensor's largest value in the one-process run (a tensor at most 1e-9
throughout, rounding where exact arithmetic gives 0, within 1e-9 absolute);
the parameters after the update within 1e-9 absolute (Adam's first update
divides gradients near its eps by their own size, as
test_torch_port_train_f64.py's bar allows); the loss terms within 1e-9
relative; the two ranks' parameters equal bit for bit. The rank helpers are
checked in one process alone.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sgtapose_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-9
DEAD = 1e-9


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    port = _free_port()
    jobs = [(1, 0), (2, 0), (2, 1)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"), str(w),
                               str(r), str(port), str(d / f"w{w}_r{r}.pt")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for w, r in jobs]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return {job: torch.load(d / f"w{job[0]}_r{job[1]}.pt", weights_only=True) for job in jobs}


def _close(got, ref, what):
    """Each tensor within TOL of its largest value; one whose values are all
    at most DEAD (the DCN biases before a BatchNorm have no gradient in exact
    arithmetic, only rounding) within DEAD absolute."""
    assert got.keys() == ref.keys(), what
    for name, r in ref.items():
        scale = r.abs().max().item()
        err = (got[name] - r).abs().max().item()
        assert err <= (TOL * scale if scale > DEAD else DEAD), (what, name, err, scale)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("what", ["grads", "buffers", "exp_avg", "exp_avg_sq"])
def test_two_ranks_equal_one_process_on_the_global_batch(runs, rank, what):
    _close(runs[(2, rank)][what], runs[(1, 0)][what], what)
    if what == "grads":  # the level-0/1 attention parameters get explicit zeros; most are live
        live = [n for n, g in runs[(1, 0)]["grads"].items() if g.abs().max().item() > 0]
        assert len(live) > 200


def test_two_ranks_same_loss_terms_and_parameters(runs):
    ref = runs[(1, 0)]["stats"]
    for rank in (0, 1):
        got = runs[(2, rank)]["stats"]
        for k, r in ref.items():
            assert abs(got[k] - r) <= TOL * abs(r), (rank, k)
    p0, p1 = runs[(2, 0)]["params"], runs[(2, 1)]["params"]
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    for n, r in runs[(1, 0)]["params"].items():
        assert (p0[n] - r).abs().max().item() <= 1e-9, n
    # dropout was on: the step is not the dropout-free one
    assert ref["tot"] > 0


def test_rank_helpers_in_one_process():
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.shard(list(range(7)), 2, 0) == [0, 1, 2] and mesh.shard(list(range(7)), 2, 1) == [3, 4, 5]
    t = torch.arange(4.0)
    mesh.all_reduce_mean_([t])
    assert torch.equal(t, torch.arange(4.0))
    g = torch.Generator().manual_seed(3)
    np.testing.assert_array_equal(mesh.global_rand((2, 3), g, "cpu").numpy(),
                                  torch.rand((2, 3), generator=torch.Generator().manual_seed(3)).numpy())
    assert mesh.local_device("cpu") == torch.device("cpu")
