"""Data-parallel ranks: one process per card (or per CPU process), each on an
equal shard of the global batch.

Counterpart of `sgtapose_tpu/parallel/mesh.py`. The JAX mesh step is ONE
program over the global batch; here R ranks, each with a local batch of b,
compute what one process computes on the concatenated batch of R*b:
  * BatchNorm (train mode) normalises by the statistics of the global batch:
    `global_moments` all-reduces each channel's mean of x and of x^2 with
    autograd (`torch.distributed.nn.functional.all_reduce`, whose backward
    all-reduces the cotangent), and the variance is flax's fast variance,
    max(0, E[x^2] - E[x]^2);
  * the gradient: each rank's loss is the mean over its equal shard, so the
    global gradient is the mean of the ranks' (`all_reduce_mean_`, one flat
    buffer);
  * dropout draws the mask of the global shape from the same-seeded
    generator on every rank and keeps the rank's rows (`global_rand`);
  * the logged loss terms are the ranks' mean.
With one rank (no process group) every helper is the identity of the
single-process path. Backend: NCCL on CUDA (one card per local rank), gloo
on the CPU.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda") -> None:
    """Join this process to a run: with `coordinator` ("host:port") a
    tcp:// rendezvous of `num_processes` ranks where this one is
    `process_id`; without it, the env:// rendezvous a launcher sets up
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                                rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")


def shutdown() -> None:
    """Leave the run (destroy the process group), if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(device) -> torch.device:
    """The card of this rank (LOCAL_RANK from a launcher, else rank modulo
    the cards of this host); the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or world_size() == 1:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank() % torch.cuda.device_count()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def shard(items: Sequence, world: int, index: int) -> List:
    """Rank `index`'s disjoint slice of `items`, every slice of the common
    length len // world (uneven shards would give ranks different step
    counts and deadlock their collectives; the remainder is dropped)."""
    per = len(items) // world
    return list(items[index * per:(index + 1) * per])


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks, in place, through one
    flat buffer."""
    world = world_size()
    if world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def global_moments(x: torch.Tensor, dims: Sequence[int]):
    """(mean, variance) over `dims` of the global batch, each rank holding an
    equal shard of it, differentiable: flax's fast variance
    max(0, E[x^2] - E[x]^2), as the JAX mesh step computes it, in at least
    float32 (a bf16 x is widened first, as flax's `_compute_stats` promotes)."""
    from torch.distributed.nn.functional import all_reduce

    world = world_size()
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    moments = torch.stack([x.mean(dim=dims), (x * x).mean(dim=dims)])
    moments = all_reduce(moments) / world
    mean, mean_sq = moments[0], moments[1]
    return mean, torch.clamp(mean_sq - mean * mean, min=0.0)


def global_rand(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) of `shape`, this rank's rows of the draw for the global batch
    (rows stacked in rank order): every rank draws the global shape from the
    same-seeded generator."""
    world = world_size()
    if world == 1:
        return torch.rand(shape, generator=generator, device=device)
    b = shape[0]
    full = torch.rand((world * b,) + tuple(shape[1:]), generator=generator, device=device)
    return full[rank() * b:(rank() + 1) * b]
