"""Seeding of the host's random generators.

Counterpart of `sgtapose_tpu/utils/seeding.py:set_random_seed` (the
reference's utilities.py set_random_seed): Python's `random`, numpy's global
generator, PYTHONHASHSEED for the subprocesses this process starts, and
torch's generators (every card's too, where there is one). The JAX function
returns the root PRNG key; this one returns a CPU `torch.Generator` seeded
the same way, the port's explicit generator.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seed(seed: int = 317) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    # hash randomisation of this interpreter is fixed at its start; the
    # variable reaches the subprocesses it starts
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)  # the CPU's and, where present, every card's generator
    return torch.Generator().manual_seed(seed)
