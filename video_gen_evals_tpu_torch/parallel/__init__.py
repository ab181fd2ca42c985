"""Parallelism: data-parallel ranks on ``torch.distributed`` and the
multi-host split of a work list (``mesh``)."""

from .mesh import (
    Rank,
    RankFailed,
    all_gather_rows,
    all_reduce_sum,
    barrier,
    broadcast_,
    broadcast_object,
    initialize_distributed,
    launch_local,
    rank_device,
    shard_items,
    shutdown,
)

__all__ = [
    "Rank",
    "RankFailed",
    "all_gather_rows",
    "all_reduce_sum",
    "barrier",
    "broadcast_",
    "broadcast_object",
    "initialize_distributed",
    "launch_local",
    "rank_device",
    "shard_items",
    "shutdown",
]
