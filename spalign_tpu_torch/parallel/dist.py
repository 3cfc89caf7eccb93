"""Process group and batch slicing: the port's data-parallel layer.

Counterpart of ``spalign_tpu/parallel/mesh.py``.  The JAX package shards
one global batch over a 1-D ``data`` mesh and pjit inserts the
reductions.  Here one process per device (``torchrun --nproc_per_node
N``) holds rows [r*B/N, (r+1)*B/N) of every global batch, and the
reductions are explicit, each in the module whose arithmetic needs it:

  * gradients: one all-reduce of the flattened gradients a step,
    averaged (``train/trainer.py``);
  * batch norm: the per-channel [sum x, sum x^2, count] in train mode,
    through the differentiable all-reduce (``models/segnet.py``);
  * the ``ce`` loss's valid-pixel count (``train/losses.py``);
  * the evaluator's confusion matrices (``train/evaluator.py``).

At world size 1 nothing is reduced, so a one-card step keeps its
arithmetic bit for bit, with or without a process group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from spalign_tpu_torch.utils.device import resolve_device


def world_size() -> int:
    """Ranks of the default process group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def setup(device="cuda") -> torch.device:
    """This rank's device.

    Joins the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE`` > 1, ``MASTER_ADDR``/``MASTER_PORT`` in the
    environment) when none is set up yet, with NCCL for CUDA and gloo
    for the CPU; a group the caller set up is kept as it is.  Under
    ``torchrun`` a CUDA device without an index becomes
    ``cuda:LOCAL_RANK``, made current.  Raises without CUDA when
    ``device`` names it."""
    dev = resolve_device(device)
    if (not dist.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    if (dev.type == "cuda" and dev.index is None
            and "LOCAL_RANK" in os.environ):
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    return dev


def close():
    """Leave the default process group, if there is one (the end of a
    ``torchrun`` program)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_size(b: int, world: int) -> int:
    """Rows of a global batch of ``b`` that each of ``world`` ranks takes."""
    if b % world:
        raise ValueError(
            f"global batch dim {b} is not divisible by the {world}-device "
            f"process group; pick a batch size that is a multiple of the "
            f"device count")
    return b // world


def rank_slice(batch, rank: int, world: int):
    """Rows [rank*B/world, (rank+1)*B/world) of a global batch (an array
    or tensor with the batch first)."""
    n = shard_size(batch.shape[0], world)
    return batch[rank * n:(rank + 1) * n]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no-op at world size 1)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself at world size 1)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]
