"""One whole float64 train step of the ablation variant in each of its three
wirings (the ablation_shared_repro, ablation_shared and ablation_wo_shared
phases), port against JAX's `train_step` body; the bars are
tests/test_torch_port_phases.py's (this file holds its other half, so each
file stays near two minutes on one worker)."""

import pytest
import torch

from torch_port_common import check_phase_train_step


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module: its tests run beside other test
    processes on the machine's cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("phase", ["ablation_shared_repro", "ablation_shared", "ablation_wo_shared"])
def test_train_step_matches_jax(phase, monkeypatch):
    check_phase_train_step(phase, monkeypatch)
