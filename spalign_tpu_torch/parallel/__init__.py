"""Data parallelism over ``torch.distributed`` (counterpart of
``spalign_tpu/parallel``)."""

from spalign_tpu_torch.parallel.dist import (all_gather, all_reduce_sum,
                                             barrier, broadcast_object,
                                             close, default_group,
                                             gather_objects, group_rank,
                                             group_size, local_rows, rank,
                                             rank_slice, setup, shard_size,
                                             world_size)

__all__ = ["all_gather", "all_reduce_sum", "barrier", "broadcast_object",
           "close", "default_group", "gather_objects", "group_rank",
           "group_size", "local_rows", "rank", "rank_slice", "setup",
           "shard_size", "world_size"]
