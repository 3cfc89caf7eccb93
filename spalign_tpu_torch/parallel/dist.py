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

Sharded inference (label generation, relabel) takes a process group
explicitly (``group``; None: one rank, no collective): each rank holds
its contiguous shard of a unit's leading axis (``local_rows``), tensors
come back in rank order (``all_gather``) and picklable records go to
rank 0 (``gather_objects``).  With a group every helper runs its
collective, a one-rank group included.
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


def group_size(group=None) -> int:
    """Ranks of ``group``; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank in ``group``; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def default_group():
    """The default process group when one is set up, else None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def local_rows(batch, group=None):
    """This rank's contiguous shard of ``batch``'s leading axis (a
    tensor, array or list) in rank order; ``batch`` itself for None.
    The leading axis must divide by the group's size."""
    if group is None:
        return batch
    world = group_size(group)
    n = shard_size(len(batch), world)
    r = group_rank(group)
    return batch[r * n:(r + 1) * n]


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the leading
    axis in rank order; ``t`` itself for None.  Bool tensors travel as
    uint8."""
    if group is None:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def gather_objects(obj, group=None):
    """The list of every rank's picklable ``obj`` in rank order on rank 0
    and None on the others; ``[obj]`` for None."""
    if group is None:
        return [obj]
    out = [None] * group_size(group) if group_rank(group) == 0 else None
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, 0),
                       group=group)
    return out


def barrier(group=None):
    """Wait for every rank of ``group`` (nothing for None)."""
    if group is not None:
        dist.barrier(group=group)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no-op at world size 1)."""
    if world_size() > 1:
        dist.all_reduce(t)
    return t


def broadcast_object(obj, group=None):
    """Rank 0's ``obj`` on every rank: of ``group``, or of the default
    group when None (``obj`` itself at world size 1)."""
    if group is None:
        if world_size() == 1:
            return obj
        group = dist.group.WORLD
    box = [obj]
    dist.broadcast_object_list(box, dist.get_global_rank(group, 0),
                               group=group)
    return box[0]
