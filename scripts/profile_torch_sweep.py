"""Where a scoring sweep of the PyTorch + CUDA port spends device time.

Runs the ``WindowEncoder`` sweep of ``chip_smoke.py``'s throughput phase
(flagship width, seeded weights, a 64-video x 120-frame bank already on the
device) under ``torch.profiler`` and prints, as one JSON line: device time
per kernel name (averaged over the profiled sweeps), the share of the
sweep's wall time the device was busy, and the card's name and power limit.
Needs one NVIDIA GPU.

    python scripts/profile_torch_sweep.py [--precision high] [--batch-size 512]
        [--encoder-impl auto|module|block_kernel|chain_kernel]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_summary(prof, repeats: int, wall_us: float):
    """From a finished ``torch.profiler`` run over ``repeats`` repeats taking
    ``wall_us``: device microseconds per repeat by kernel name, the share of
    the wall time the device was busy, and the card's name and power limit."""
    from torch.autograd import DeviceType

    # device-side events only (kernels, memcpys): the CPU-side aten ops also
    # carry their children's device time and would count it twice
    kernels = {
        ev.key: ev.self_device_time_total / repeats
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    }
    busy = round(sum(kernels.values()) * repeats / wall_us, 4) if kernels else "not measured"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return kernels, busy, card


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import CLIP, sweep_inputs
    from video_gen_evals_tpu_torch.pipelines.score import ENCODER_IMPLS, WindowEncoder

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--precision", default="high", choices=["high", "highest"])
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--sweeps", type=int, default=3)
    p.add_argument("--encoder-impl", default="auto", choices=list(ENCODER_IMPLS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_sweep: no CUDA device", file=sys.stderr)
        return 1

    bank, windows, seg, model = sweep_inputs(torch)
    V = bank.num_videos
    enc = WindowEncoder(model, args.batch_size, CLIP, args.precision, "cuda", args.encoder_impl)
    dev_bank = enc.upload(bank)
    enc.encode_bank_segsum(bank, windows, seg, V, bank_dev=dev_bank)   # warm

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.sweeps):
            enc.encode_bank_segsum(bank, windows, seg, V, bank_dev=dev_bank)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy_share, card = device_summary(prof, args.sweeps, wall_us)
    top = {k[:90]: round(v, 1) for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]}
    print(json.dumps({
        "precision": args.precision, "batch_size": args.batch_size,
        "encoder_impl": args.encoder_impl,
        "windows_per_sweep": len(windows), "sweep_ms": round(wall_us / args.sweeps / 1e3, 3),
        "device_busy_share": busy_share,
        "device_us_per_sweep_by_kernel": top, "card": card,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
