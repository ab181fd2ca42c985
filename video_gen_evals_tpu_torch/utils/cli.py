"""Shared CLI plumbing for the port's entry points.

Multi-process bring-up flags, as in ``video_gen_evals_tpu/utils/cli.py``:
every process of a distributed run invokes the same CLI with the same
``--coordinator`` / ``--num-processes`` plus its own ``--process-id``, and
becomes that rank of one ``torch.distributed`` process group
(``parallel.initialize_distributed``). Afterwards ``--dp`` / ``--mesh-data``
span the group's ranks, one a process, and ``--host-id -1`` resolves to the
rank.
"""

from __future__ import annotations

import argparse
import typing as T


def add_distributed_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--coordinator",
        default=None,
        help="multi-process bring-up: the rendezvous address host:port (rank 0 "
        "listens there); run this CLI on every process with the same flags "
        "plus its own --process-id",
    )
    p.add_argument(
        "--num-processes",
        type=int,
        default=None,
        help="total number of processes in the distributed run",
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="this process's index in [0, --num-processes)",
    )


def maybe_initialize_distributed(args: argparse.Namespace, device: str = "cuda"):
    """Join the process group when --num-processes > 1 and return this
    process's ``parallel.Rank`` (on ``device``'s type, the rank's own
    device); ``None`` for a single-process run. The flags are validated as
    the JAX CLIs validate them."""
    if getattr(args, "num_processes", None) is None or args.num_processes <= 1:
        if args.coordinator is not None or args.process_id is not None:
            raise SystemExit(
                "--coordinator/--process-id require --num-processes > 1 "
                "(without it they would be silently ignored)"
            )
        return None
    if args.process_id is None:
        raise SystemExit(
            "--num-processes > 1 requires --process-id (this process's "
            "index in [0, --num-processes))"
        )
    if args.coordinator is None:
        raise SystemExit(
            "--num-processes > 1 requires --coordinator host:port (the "
            "rendezvous address; without it the ranks have nowhere to meet)"
        )
    from ..parallel import initialize_distributed

    rank = initialize_distributed(
        args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device=device,
    )
    print(f"Joined distributed runtime: process {rank.rank} of {rank.world} "
          f"on {rank.device} ({rank.backend})")
    return rank


def resolve_host_id(p: argparse.ArgumentParser, host_id: int, num_hosts: int,
                    rank: T.Optional[T.Any]) -> int:
    """``--host-id``: an explicit index, or -1 for the rank of a distributed
    run whose process count equals --num-hosts (otherwise every host would
    resolve to 0 and all score the same shard)."""
    if num_hosts <= 1:
        return max(host_id, 0)
    if host_id >= 0:
        return host_id
    world = rank.world if rank is not None else 1
    if world != num_hosts:
        p.error(
            f"--host-id -1 needs the process count == --num-hosts (have "
            f"{world} vs {num_hosts}); pass --host-id explicitly or start the "
            "run with --coordinator/--num-processes/--process-id"
        )
    return rank.rank
