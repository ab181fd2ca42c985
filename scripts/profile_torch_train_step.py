"""Where a training step of the PyTorch + CUDA port spends device time.

Runs ``TrainStep`` at the flagship width (2596-d input, d_model 256, 4 layers,
clip 32, P x K = 240 windows, so 960 stacked windows and 40 trainable
conv-stage forward and backward calls a step) on a seeded batch that is
already on the device, under ``torch.profiler``, and prints as one JSON line:
device time per kernel name (averaged over the profiled steps), the step's
wall time, the share of it the device was busy, and the card's name and
power limit. Needs one NVIDIA GPU.

    python scripts/profile_torch_train_step.py [--precision default] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import CLIP, DIMS_DIFF, DIMS_RAW, SEED
    from profile_torch_sweep import device_summary
    from video_gen_evals_tpu_torch.core.config import TrainConfig
    from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
    from video_gen_evals_tpu_torch.train.step import TrainStep

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--precision", default="default", choices=["default", "highest"])
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 1

    cfg = TrainConfig()
    gen = torch.Generator().manual_seed(SEED)
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF, dropout=cfg.dropout),
                              generator=gen).to("cuda")
    step = TrainStep(model, cfg.lr, 1000, eta_min=cfg.eta_min,
                     hard_weight=cfg.hard_negative_weight, precision=args.precision, seed=cfg.seed)
    feats = torch.randn(cfg.batch_size, CLIP, model.config.input_dim, generator=gen).to("cuda")
    labels = (torch.arange(cfg.batch_size) // cfg.K).to("cuda")
    for _ in range(2):   # warm: kernels built, allocator filled, Adam state made
        step(feats, labels)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            metrics = step(feats, labels)   # ends in the fetch of the loss components
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy_share, card = device_summary(prof, args.steps, wall_us)
    top = {k[:90]: round(v, 1) for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:16]}
    print(json.dumps({
        "precision": args.precision, "stacked_windows": 4 * cfg.batch_size,
        "step_ms": round(wall_us / args.steps / 1e3, 3),
        "clips_per_sec": round(4 * cfg.batch_size * args.steps / (wall_us * 1e-6), 1),
        "device_busy_share": busy_share, "last_total": metrics["total"],
        "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "device_us_per_step_by_kernel": top, "card": card,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
