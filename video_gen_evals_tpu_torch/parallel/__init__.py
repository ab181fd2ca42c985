"""Parallelism: data-parallel ranks and the (data, model) grid on
``torch.distributed`` and the multi-host split of a work list (``mesh``),
and the fusion encoder's tensor-parallel layout and collectives
(``tensor``)."""

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
    make_grid,
    rank_device,
    shard_items,
    shutdown,
    tp_param_spec,
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
    "make_grid",
    "rank_device",
    "shard_items",
    "shutdown",
    "tp_param_spec",
]
