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

The same in bf16 mixed precision (`train_step(bf16=True)`, float32 masters),
against one bf16 process at batch 2 and with one float32 process for the
gap. bf16 rounds the one process's and the ranks' BatchNorm outputs at
points that their float32 statistics (computed in other orders) place
apart, and train-mode BatchNorm on these small maps amplifies that in its
backward: there the one process's own bf16 gradient is 1.2x the gradients'
norm away from its float32 one. So the statistics and the loss terms are
held in train mode, the gradients with BatchNorm held in eval mode: the
running statistics in L2 within BF16_RANKS_STATS of the gap (measured
0.57x; statistics the step did not update read 27x), the loss terms within
0.5x of the gap (measured 0.006-0.16x); in eval mode the gradients and Adam
moments, where each rank's bf16 weight gradients round before the mean,
within BF16_RANKS_GAP of the gap in L2 (measured 0.028x), the loss terms
likewise (measured <= 0.0015x); the two ranks' parameters equal bit for bit.
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
BF16_RANKS_GAP = 0.05
BF16_RANKS_STATS = 1.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_jobs(d, jobs):
    """One worker process per (world, rank, modes), the ranks of a world on
    one free port; returns their saved results by (world, rank, mode)."""
    ports = {w: _free_port() for w, _, _ in jobs}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"), str(w),
                               str(r), str(ports[w]), str(d), ",".join(modes)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for w, r, modes in jobs]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return {(w, r, m): torch.load(d / f"w{w}_r{r}_{m}.pt", weights_only=True) for w, r, modes in jobs for m in modes}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    res = _run_jobs(tmp_path_factory.mktemp("parallel"), [(1, 0, ("float64",)), (2, 0, ("float64",)),
                                                          (2, 1, ("float64",))])
    return {(w, r): v for (w, r, _), v in res.items()}


@pytest.fixture(scope="module")
def bf16_runs(tmp_path_factory):
    """The bf16 step, BatchNorm in train mode and held in eval mode: one
    process and two ranks, and one float32 process (the gap)."""
    modes = ("bf16", "bf16_bn_eval")
    jobs = [(1, 0, modes + ("float32", "float32_bn_eval")), (2, 0, modes), (2, 1, modes)]
    return _run_jobs(tmp_path_factory.mktemp("parallel_bf16"), jobs)


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


def _l2(got, ref):
    num = sum(((got[n] - r).double() ** 2).sum().item() for n, r in ref.items())
    return (num / sum((r.double() ** 2).sum().item() for r in ref.values())) ** 0.5


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("what", ["grads", "buffers", "exp_avg"])
def test_two_bf16_ranks_match_one_process(bf16_runs, rank, what):
    mode = "bf16" if what == "buffers" else "bf16_bn_eval"
    one, two = bf16_runs[(1, 0, mode)], bf16_runs[(2, rank, mode)]
    f32 = bf16_runs[(1, 0, "float32" + mode[4:])]
    assert all(t.dtype == torch.float32 for t in two[what].values())
    gap = _l2(f32[what], one[what])
    if what == "buffers":  # train mode: the statistics of the global batch
        assert _l2(two[what], one[what]) <= BF16_RANKS_STATS * gap, (_l2(two[what], one[what]), gap)
        assert _l2(one["buffers0"], one[what]) > BF16_RANKS_STATS * gap  # the control: not updated
        return
    assert 1e-3 < gap < 0.5
    assert _l2(two[what], one[what]) <= BF16_RANKS_GAP * gap, (_l2(two[what], one[what]), gap)


def test_two_bf16_ranks_same_loss_terms_and_parameters(bf16_runs):
    for mode, bar in (("bf16", 0.5), ("bf16_bn_eval", BF16_RANKS_GAP)):
        p0, p1 = bf16_runs[(2, 0, mode)]["params"], bf16_runs[(2, 1, mode)]["params"]
        assert all(torch.equal(p0[n], p1[n]) for n in p0)
        one, f32 = bf16_runs[(1, 0, mode)]["stats"], bf16_runs[(1, 0, "float32" + mode[4:])]["stats"]
        for rank in (0, 1):
            got = bf16_runs[(2, rank, mode)]["stats"]
            for k in ("tot", "hm", "reg", "tracking"):
                assert abs(got[k] - one[k]) <= bar * abs(one[k] - f32[k]) + 1e-6 * abs(one[k]), (mode, rank, k)
