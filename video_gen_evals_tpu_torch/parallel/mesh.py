"""Data and tensor parallelism and multi-host sharding on ``torch.distributed``.

Port of ``video_gen_evals_tpu/parallel/mesh.py``, in PyTorch's idiom: one
process per rank, each rank with one explicit device, and explicit
collectives.

- :func:`shard_items`: the deterministic strided split of a work list over
  hosts, a copy of the JAX function (same errors).
- :func:`initialize_distributed`: joins this process to a process group
  through a ``tcp://`` rendezvous at the coordinator and returns its
  :class:`Rank`; a no-op for one process.
- :func:`launch_local`: spawns n ranks on this host, joins them with a
  deadline, and kills them all if one fails.
- :func:`make_grid`: JAX ``make_mesh``'s ``(data, model)`` grid over the
  ranks of a group: rank r is data index ``r // n_model`` and model index
  ``r % n_model`` (JAX's ``reshape(n_data, n_model)``), and its
  :class:`Rank` gains its data group and its model group.
- :func:`tp_param_spec`: JAX ``tp_param_sharding``'s layout of the fusion
  encoder, by the port's parameter names: which axis of a parameter the
  model axis shards, or None.
- :func:`all_gather_rows`, :func:`all_reduce_sum`, :func:`broadcast_`,
  :func:`barrier`: the collectives the port uses.

**The backend rule.** NCCL when every rank owns its own CUDA device; gloo
when two ranks share a device (as when several ranks run on one card) or
the ranks run on the CPU. NCCL refuses two ranks on one device; gloo carries
CUDA tensors for ``all_reduce``, ``all_gather`` and ``broadcast`` without
staging (``chip_smoke.py`` phase 11 runs them on one card). The ranks
learn whether devices are shared by publishing ``host/device`` in the
rendezvous store before the group exists; nothing else picks the backend,
and it is printed.

The JAX file's ``batch_sharding``, ``replicated_sharding``, ``put_global``
and ``fetch_global`` have no counterpart: under one process per rank every
tensor is simply local to its rank, a "global fetch" is
:func:`all_gather_rows` or :func:`all_reduce_sum`, and a replicated value is
one that every rank computes or receives by :func:`broadcast_`. The model
axis's collectives live in the tensor-parallel forward
(``parallel/tensor.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing.connection
import os
import pickle
import socket
import sys
import time
import traceback
import typing as T

import torch
import torch.distributed as dist

# seconds a collective may wait for its peers before it fails (the group's
# timeout); a deadline given to launch_local lowers it to the deadline
COLLECTIVE_TIMEOUT_S = 1800.0


def shard_items(
    items: T.Sequence, host_id: int, num_hosts: int
) -> T.List:
    """Deterministic strided split of a work list across hosts: multi-host
    sweeps shard the video manifest over hosts and merge the JSON shards.
    Strided (``items[host_id::num_hosts]``) rather than contiguous so
    per-class runs of a sorted manifest spread evenly.

    Every item lands on exactly one host; hosts agree on the split as long as
    they scan the same manifest (same directory contents, same order).
    """
    if num_hosts < 1:
        raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
    if not 0 <= host_id < num_hosts:
        raise ValueError(
            f"host_id must be in [0, {num_hosts}), got {host_id}"
        )
    return list(items[host_id::num_hosts])


@dataclasses.dataclass(frozen=True)
class Rank:
    """One rank of a group: its index, the group's size, its device, the
    process group (``None`` for the default group) and the group's backend.
    On a :func:`make_grid` grid also the model axis's size ``tp`` and the
    process groups of the rank's data and model axes (see :attr:`data` and
    :attr:`model`)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: T.Optional[T.Any] = None
    tp: int = 1
    data_group: T.Optional[T.Any] = None
    model_group: T.Optional[T.Any] = None

    @property
    def is_primary(self) -> bool:
        """Rank 0, the one that writes files."""
        return self.rank == 0

    @property
    def data(self) -> "Rank":
        """This rank within its data axis (the ranks of its model index):
        the group the batch splits over. Off a grid, the rank itself."""
        if self.tp == 1:
            return self
        n_data = self.world // self.tp
        if n_data == 1:
            return Rank(0, 1, self.device, backend="none")
        return Rank(self.rank // self.tp, n_data, self.device, self.backend, self.data_group)

    @property
    def model(self) -> "Rank":
        """This rank within its model axis (the ranks of its data index):
        the group a tensor-parallel forward shards over. Off a grid, a group
        of one."""
        if self.tp == 1:
            return Rank(0, 1, self.device, backend="none")
        return Rank(self.rank % self.tp, self.tp, self.device, self.backend, self.model_group)


def make_grid(rank: Rank, n_model: int = 1, n_data: T.Optional[int] = None) -> Rank:
    """The ``(data, model)`` grid of JAX ``make_mesh`` over ``rank``'s group
    (the default group): rank r is data index ``r // n_model`` and model
    index ``r % n_model``. Every rank of the group calls it, with the same
    arguments; it returns ``rank`` with its data and model groups
    (``dist.new_group``, made only for axes longer than one). The errors are
    JAX's, and the grid must cover every rank of the group, as JAX's mesh
    must in a multi-process runtime: a rank outside it could never join the
    collectives."""
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = rank.world // n_model
    if n_data < 1:
        raise ValueError(f"need at least n_model={n_model} ranks to form a grid, have {rank.world}")
    need = n_data * n_model
    if need != rank.world:
        raise ValueError(f"grid ({n_data} data x {n_model} model) needs {need} ranks, the group has "
                         f"{rank.world}: the grid must span every rank")
    if n_model == 1:
        return rank
    if rank.group is not None:
        raise ValueError("make_grid splits the default group; this rank is of another one")
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    data_groups = ([dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
                   if n_data > 1 else [None] * n_model)
    return dataclasses.replace(rank, tp=n_model, model_group=model_groups[rank.rank // n_model],
                               data_group=data_groups[rank.rank % n_model])


def tp_param_spec(name: str, shape: T.Sequence[int], tp: int) -> T.Optional[int]:
    """The axis of the port's parameter ``name`` (a ``HumanActionScorer``
    state_dict name, shape ``shape``) that a ``tp``-way model axis shards,
    or None where it is replicated: JAX ``parallel/mesh.py``'s
    ``_spec_for_param`` with ``tp_param_sharding``'s rule that a dimension
    ``tp`` does not divide is never sharded. Column-parallel ``in_proj`` and
    ``linear1`` (weight and bias), row-parallel ``out_proj`` and ``linear2``
    weights, the ``state_enc`` / ``motion_enc`` stem and block conv kernels
    on their output channels; everything else replicated. The axes are the
    port's layouts: torch ``Linear.weight`` is ``[out, in]`` where flax's
    kernel is ``[in, out]``, ``Conv1d.weight`` ``[out, in, k]`` where flax's
    is ``[k, in, out]``. At ``tp`` 1 the axis is named as JAX names it (a
    shard of one is the whole)."""
    parts = name.split(".")
    leaf, owner = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf in ("in_proj_weight", "in_proj_bias") or (owner == "linear1" and leaf in ("weight", "bias")):
        axis = 0      # column-parallel: the output features (flax P(None, "model") / P("model"))
    elif owner in ("out_proj", "linear2") and leaf == "weight":
        axis = 1      # row-parallel: the input features (flax P("model", None))
    elif parts[0] in ("state_enc", "motion_enc") and owner in ("stem", "conv1", "conv2") and leaf == "weight":
        axis = 0      # conv stacks: the output channels (flax P(None, None, "model"))
    else:
        return None
    return None if shape[axis] % tp else axis


def rank_device(rank: int, device: T.Union[str, torch.device]) -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}`` for a CUDA
    ``device`` (whatever index it names), the CPU for a CPU one. A CUDA
    device without a card raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"ranks run on cuda or cpu devices, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _split_address(coordinator: str) -> T.Tuple[str, int]:
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator must be host:port, got {coordinator!r}")
    return host, int(port)


def initialize_distributed(
    coordinator_address: T.Optional[str] = None,
    num_processes: T.Optional[int] = None,
    process_id: T.Optional[int] = None,
    device: T.Union[str, torch.device] = "cuda",
    timeout_s: float = COLLECTIVE_TIMEOUT_S,
    join_alone: bool = False,
) -> Rank:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through a ``tcp://`` rendezvous at
    ``coordinator_address`` (``host:port``; rank 0 listens there). The rank
    runs on :func:`rank_device` of ``device``. The backend follows the rule
    in the module docstring. For one process (``num_processes`` None or 1)
    nothing is joined, unless ``join_alone`` asks for a group of one: the
    returned rank is 0 of 1 on ``device`` with backend ``"none"``, and the
    collectives below act on its tensors alone."""
    if not join_alone and (num_processes is None or num_processes <= 1):
        return Rank(0, 1, torch.device(device), backend="none")
    num_processes = num_processes or 1
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id must be in [0, {num_processes}), got {process_id}")
    if coordinator_address is None:
        raise ValueError("a distributed run needs the coordinator's host:port")
    dev = rank_device(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = _split_address(coordinator_address)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, num_processes, is_master=process_id == 0, timeout=timeout)
    # the backend rule: every rank says where it runs before the group exists
    here = f"{socket.gethostname()}/{dev}"
    store.set(f"vge_device/{process_id}", here)
    where = [store.get(f"vge_device/{r}").decode() for r in range(num_processes)]
    if dev.type == "cuda" and len(set(where)) == num_processes:
        backend, why = "nccl", "every rank owns its own CUDA device"
    elif dev.type == "cuda":
        backend, why = "gloo", "ranks share a CUDA device"
    else:
        backend, why = "gloo", "the ranks run on the CPU"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, world_size=num_processes, rank=process_id,
                            timeout=timeout, **kw)
    print(f"[parallel] rank {process_id} of {num_processes} on {dev}: backend {backend} ({why})",
          flush=True)
    return Rank(process_id, num_processes, dev, backend=backend)


def shutdown(rank: Rank) -> None:
    """Leave the process group that :func:`initialize_distributed` joined."""
    if rank.backend != "none" and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, rank: Rank) -> torch.Tensor:
        ctx.lo, ctx.rows = rank.rank * x.shape[0], x.shape[0]
        parts = [torch.empty_like(x) for _ in range(rank.world)]
        dist.all_gather(parts, x.contiguous(), group=rank.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # every rank computes the same loss from the same gathered tensor, so
        # the rows of the incoming gradient that came from this rank are
        # already the true gradient of its rows: no reduction here
        return grad[ctx.lo : ctx.lo + ctx.rows], None


def all_gather_rows(x: torch.Tensor, rank: Rank) -> torch.Tensor:
    """``x`` of every rank, concatenated along dim 0 in rank order; every
    rank passes the same number of rows. The backward returns this rank's
    own rows of the incoming gradient (not a reduce-scatter, as
    ``torch.distributed.nn.functional.all_gather`` does: with the same loss
    on every rank that would multiply the gradient by the world size)."""
    if rank.backend == "none":
        return x
    return _AllGatherRows.apply(x, rank)


def all_reduce_sum(tensors: T.Sequence[torch.Tensor], rank: Rank) -> None:
    """Sum each of ``tensors`` over the ranks, in place, as one collective
    (the tensors share a dtype and a device). Every rank ends with the same
    bits."""
    tensors = list(tensors)
    if not tensors or rank.backend == "none":
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=rank.group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset : offset + n].view_as(t))
        offset += n


def broadcast_(tensors: T.Sequence[torch.Tensor], rank: Rank, src: int = 0) -> None:
    """Overwrite each of ``tensors`` with rank ``src``'s, in place."""
    if rank.backend == "none":
        return
    for t in tensors:
        dist.broadcast(t, src, group=rank.group)


def broadcast_object(obj: T.Any, rank: Rank, src: int = 0) -> T.Any:
    """Rank ``src``'s ``obj`` (picklable), on every rank."""
    if rank.backend == "none":
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src, group=rank.group)
    return box[0]


def barrier(rank: Rank) -> None:
    if rank.backend != "none":
        dist.barrier(group=rank.group)


# ---------------------------------------------------------------------------
# local launch


class RankFailed(RuntimeError):
    """A rank of :func:`launch_local` failed, or the launch ran past its
    deadline; every other rank was killed."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, device, threads: int,
               timeout_s: float, conn, args) -> None:
    torch.set_num_threads(threads)
    status = 1
    try:
        r = initialize_distributed(f"localhost:{port}", world, rank, device, timeout_s, join_alone=True)
        result = fn(r, *args)
        # a rank that raised leaves the group by exiting, after its report
        shutdown(r)
        # plain pickle: tensors travel as bytes, not as shared-memory handles
        # that would die with this process
        conn.send_bytes(pickle.dumps(result))
        status = 0
    except BaseException:   # noqa: BLE001 - reported, then the process fails
        traceback.print_exc()
        sys.stderr.flush()
    finally:
        conn.close()
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(status)   # no interpreter teardown: a daemon thread cannot hold the rank


def _deadline() -> T.Optional[float]:
    value = os.environ.get("VGE_LAUNCH_TIMEOUT", "")
    return float(value) if value else None


def launch_local(n: int, fn: T.Callable[..., T.Any], *args: T.Any,
                 device: T.Union[str, torch.device] = "cuda",
                 threads: T.Optional[int] = None,
                 timeout: T.Optional[float] = None) -> T.List[T.Any]:
    """Run ``fn(rank, *args)`` in ``n`` new processes on this host, one per
    rank of one process group (rendezvous on a free localhost port), and
    return their results in rank order.

    ``fn`` and ``args`` are pickled (the ``spawn`` start method): ``fn`` must
    be a module-level function of a module that imports cleanly in a new
    interpreter. Rank r runs on ``rank_device(r, device)`` with ``threads``
    torch threads (default: this process's threads divided among the
    ranks). If a rank fails, or ``timeout`` seconds pass (default: the
    environment's ``VGE_LAUNCH_TIMEOUT``, else none; every collective still
    fails after the group's timeout), the others are killed and
    :class:`RankFailed` is raised: the launch never goes on with fewer
    ranks."""
    if n < 1:
        raise ValueError(f"launch_local needs at least one rank, got {n}")
    rank_device(0, device)   # a CUDA launch without a card raises here
    timeout = timeout if timeout is not None else _deadline()
    threads = threads or max(1, torch.get_num_threads() // n)
    group_timeout = min(COLLECTIVE_TIMEOUT_S, timeout) if timeout else COLLECTIVE_TIMEOUT_S
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs, readers = [], []
    for r in range(n):
        reader, writer = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, name=f"vge-rank{r}",
                        args=(fn, r, n, port, str(device), threads, group_timeout, writer, args))
        p.start()
        writer.close()
        procs.append(p)
        readers.append(reader)
    results: T.Dict[int, T.Any] = {}
    closed: T.Set[int] = set()   # ranks whose pipe reached its end
    deadline = time.monotonic() + timeout if timeout else None
    failure: T.Optional[str] = None
    try:
        pending = set(range(n))
        while pending and failure is None:
            wait_s = None if deadline is None else max(0.0, deadline - time.monotonic())
            waiting = ([readers[r] for r in pending - closed]
                       + [procs[r].sentinel for r in pending])
            ready = multiprocessing.connection.wait(waiting, timeout=wait_s)
            if not ready:
                failure = f"the deadline of {timeout:g} s passed with ranks {sorted(pending)} running"
                break
            for r in sorted(pending):
                if r not in closed and (readers[r] in ready or procs[r].sentinel in ready):
                    try:
                        if readers[r].poll():
                            results[r] = pickle.loads(readers[r].recv_bytes())
                            pending.discard(r)
                            continue
                    except EOFError:
                        closed.add(r)
                if procs[r].sentinel in ready:
                    procs[r].join(5.0)   # its sentinel fires just before it can be reaped
                    # this rank and any other that has failed so far (a peer
                    # of a failed rank may fail first in its collective)
                    failed = [q for q in range(n)
                              if q == r or (q not in results and procs[q].exitcode not in (None, 0))]
                    failure = "ranks that exited with no result: " + ", ".join(
                        f"rank {q} (exit code {procs[q].exitcode})" for q in failed)
                    break
        for r, p in enumerate(procs):
            if failure is not None:
                break
            p.join(None if deadline is None else max(0.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                failure = f"rank {r} (exit code {p.exitcode}) failed after its result"
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for reader in readers:
            reader.close()
    if failure is not None:
        raise RankFailed(f"launch_local({n} ranks of {getattr(fn, '__qualname__', fn)}): {failure}; "
                         "the other ranks were stopped")
    return [results[r] for r in range(n)]
