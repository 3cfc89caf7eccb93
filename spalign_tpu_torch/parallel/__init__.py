"""Data parallelism over ``torch.distributed`` (counterpart of
``spalign_tpu/parallel``)."""

from spalign_tpu_torch.parallel.dist import (all_reduce_sum,
                                             broadcast_object, close, rank,
                                             rank_slice, setup, shard_size,
                                             world_size)

__all__ = ["all_reduce_sum", "broadcast_object", "close", "rank",
           "rank_slice", "setup", "shard_size", "world_size"]
