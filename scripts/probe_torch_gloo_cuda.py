"""Does gloo carry CUDA tensors on this machine's torch, and does NCCL run a
group of one?

Two processes on card 0 join a gloo group (NCCL refuses two ranks on one
card) and run ``all_reduce``, ``all_gather``, ``all_gather_into_tensor``,
``broadcast`` and a 12 MB ``all_reduce`` on CUDA tensors, each printing
what it got and the milliseconds of each call (one cold call each); then
this process runs ``all_reduce`` and ``all_gather`` in an NCCL group of
one. Plain ``torch.distributed``: the port's backend rule
(``video_gen_evals_tpu_torch/parallel/mesh.py``) rests on what this shows.
Needs one NVIDIA GPU.

    python3 scripts/probe_torch_gloo_cuda.py
"""

from __future__ import annotations

import datetime
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, world: int, port: int) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda:0")

    def all_reduce(x):
        dist.all_reduce(x)
        return x

    def all_gather(x):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def all_gather_into_tensor(x):
        out = x.new_empty(world * x.numel())
        dist.all_gather_into_tensor(out, x)
        return out

    def broadcast(x):
        dist.broadcast(x, 0)
        return x

    cases = (
        ("all_reduce", all_reduce, torch.full((5,), float(rank + 1), device=dev)),
        ("all_gather", all_gather, torch.full((3,), float(rank + 1), device=dev)),
        ("all_gather_into_tensor", all_gather_into_tensor, torch.full((3,), float(rank + 1), device=dev)),
        ("broadcast", broadcast, torch.full((4,), float(rank + 7), device=dev)),
        ("all_reduce 12 MB", all_reduce, torch.ones(3_000_000, device=dev)),
    )
    out = {}
    for name, fn, x in cases:
        try:
            t0 = time.perf_counter()
            got = fn(x)
            torch.cuda.synchronize()
            out[name] = f"ok {got[:6].cpu().tolist()} {1e3 * (time.perf_counter() - t0):.2f} ms"
        except Exception as e:   # noqa: BLE001 - what fails is the finding
            out[name] = f"FAIL {type(e).__name__}: {str(e)[:300]}"
    dist.barrier()
    print(f"gloo rank {rank}: {out}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    mp.spawn(worker, args=(2, free_port()), nprocs=2, join=True)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda:0"))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty(4, device="cuda")]
    dist.all_gather(parts, x)
    torch.cuda.synchronize()
    print(f"nccl group of one: all_reduce {x.tolist()}, all_gather {parts[0].tolist()}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
