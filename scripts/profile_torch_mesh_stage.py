"""Where one chunk of the mesh-recovery stage of the PyTorch + CUDA port
spends device time.

Builds ``chip_smoke.py``'s mesh stage at full width (ViT-H depth 32 and the
SMPL token head at its published geometry, weights drawn on the card from a
seed), runs warm 32-frame chunks of its synthetic 360 x 640 video through
``Extractor.mesh_forward`` under ``torch.profiler`` and prints, as one JSON
line: device time per kernel name (averaged over the profiled chunks), the
share of the wall time the device was busy, peak memory, and the card's name
and power limit. Needs one NVIDIA GPU. ``--matmul-precision`` and
``--param-dtype`` pick one of the JAX package's six numerics pairs
(``ExtractorConfig``); ``--matmul-precision default --param-dtype bfloat16``
is its bf16 mode.

    python scripts/profile_torch_mesh_stage.py [--attention-impl core] [--matmul-precision highest]
        [--param-dtype float32] [--depth 32]
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

    from chip_smoke import SEED, mesh_config, mesh_video
    from profile_torch_sweep import device_summary
    from video_gen_evals_tpu_torch.models.vit import ATTENTION_IMPLS
    from video_gen_evals_tpu_torch.ops.precision import PARAM_DTYPES, PRECISIONS
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--attention-impl", default="core", choices=ATTENTION_IMPLS)
    p.add_argument("--matmul-precision", default="highest", choices=PRECISIONS)
    p.add_argument("--param-dtype", default="float32", choices=sorted(PARAM_DTYPES))
    p.add_argument("--depth", type=int, default=32)
    p.add_argument("--chunks", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_mesh_stage: no CUDA device", file=sys.stderr)
        return 1

    ex = Extractor(mesh_config(depth=args.depth, impl=args.attention_impl,
                               pair=(args.matmul_precision, args.param_dtype)), seed=SEED)
    frames, boxes, _large = mesh_video(32)
    frames_dev, boxes_dev = torch.from_numpy(frames).cuda(), torch.from_numpy(boxes).cuda()
    ex.mesh_forward(frames_dev, boxes_dev)   # warm (builds the kernels on first use)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            ex.mesh_forward(frames_dev, boxes_dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy_share, card = device_summary(prof, args.chunks, wall_us)
    top = {k[:90]: round(v, 1) for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:14]}
    attention = sum(v for k, v in kernels.items()
                    if any(name in k for name in ("attention_fma", "flash_attention", "attention_resident")))
    print(json.dumps({
        "attention_impl": args.attention_impl, "matmul_precision": args.matmul_precision,
        "param_dtype": args.param_dtype,
        "depth": args.depth, "frames_per_chunk": 32,
        "chunk_ms": round(wall_us / args.chunks / 1e3, 3),
        "frames_per_s": round(32 * args.chunks / (wall_us / 1e6), 1),
        "device_busy_share": busy_share,
        "attention_kernels_us_per_chunk": round(attention, 1),
        "device_us_per_chunk_by_kernel": top,
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3), "card": card,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
