#!/usr/bin/env python3
"""Time ``ops/precision.py``'s card routes on one NVIDIA GPU beside the
library calls they were chosen from, at the extraction's shapes, and hold
each against a float64 oracle of the same operands.

    python3 scripts/profile_torch_precision.py [--iters 20] [--stage]

No kernel is built: these are cuBLAS and cuDNN calls, as the JAX package
leaves its dense products and convolutions to XLA. One line a shape and
route: max |route - oracle|, ms a call (CUDA events, warm), the output's
type, with the card's name and power limit. At ``"default"`` the oracle is
the float64 product of the bf16-rounded operands; a route that writes bf16
shows that rounding in its error. The shapes: ViT-H's four linears on a
32-frame chunk (6144 rows), YOLOX-L- and DWPose-L-like convolutions (3x3,
1x1, depthwise 5x5) and the X101's grouped 3x3, and a GAU-like batched
product. Then ``precision.linear`` and ``precision.conv2d`` themselves at
each class.

``--stage`` instead runs the mesh stage (ViT-H at depth 2, the SMPL head)
on 4 of ``chip_smoke.py``'s blurred frames at ``"default"``, on the card
and on the CPU with the same weights, and says where the two part (``chip_smoke._product_layers``): each
product layer (``precision.Linear`` / ``Conv2d``) fed the CPU run's own
input on both devices, against the float64 product of the rounded
operands and beside the unrounded product; and every module's output,
card run against CPU run, in the order the forward reaches them.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    from chip_smoke import _card, _time_ms
    from video_gen_evals_tpu_torch.ops import precision as P

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--stage", action="store_true", help="where the card and the CPU part on the mesh stage")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_precision: no CUDA device", file=sys.stderr)
        return 1
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.stage:
        return stage_parts(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    r = P.round_bf16
    bf16 = torch.bfloat16

    def tf32(fn):
        def run():
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                return fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        return run

    def report(what, routes, oracle):
        print(f"{what}: max |oracle| {oracle.abs().max().item():.3f} on {card}")
        for name, fn in routes.items():
            out = fn()
            err = (out.float() - oracle).abs().max().item()
            print(f"   {name:32s} max |d| {err:.3e}  {_time_ms(fn, args.iters):.4f} ms  out {str(out.dtype)[6:]}")

    for M, K, N in ((6144, 1280, 3840), (6144, 1280, 1280), (6144, 1280, 5120), (6144, 5120, 1280)):
        x = torch.randn(M, K, device=dev, generator=gen)
        w = (torch.randn(N, K, device=dev, generator=gen) / K ** 0.5).to(bf16)
        b = torch.randn(N, device=dev, generator=gen).to(bf16)
        oracle = (r(x).double() @ w.double().t() + b.double()).float()
        report(f"linear [{M}, {K}] x [{K}, {N}], bf16 weights, default", {
            "addmm bf16, fp32 out (the route)": lambda: torch.addmm(b.float(), x.to(bf16), w.t(),
                                                                    out_dtype=torch.float32),
            "fp32 TF32 on rounded operands": tf32(lambda: F.linear(r(x), w.float(), b.float())),
            "bf16, bf16 out": lambda: F.linear(x.to(bf16), w, b),
            "fp32 on rounded, TF32 off": lambda: F.linear(r(x), w.float(), b.float()),
        }, oracle)
    for name, (B, C, H, W, Co, k, groups, stride) in {
            "3x3 (YOLOX-L-like)": (32, 128, 80, 80, 128, 3, 1, 1),
            "1x1 (YOLOX-L-like)": (32, 256, 80, 80, 256, 1, 1, 1),
            "depthwise 5x5 (DWPose-L-like)": (32, 256, 24, 18, 256, 5, 256, 1),
            "grouped 3x3 (X101-like)": (8, 256, 200, 336, 256, 3, 32, 1)}.items():
        x = torch.randn(B, C, H, W, device=dev, generator=gen)
        w = (torch.randn(Co, C // groups, k, k, device=dev, generator=gen) / (C // groups * k * k) ** 0.5).to(bf16)
        pad = k // 2
        oracle = F.conv2d(r(x).double(), w.double(), None, stride, pad, 1, groups).float()
        report(f"conv {name} {(B, C, H, W)} -> {Co}, bf16 weights, default", {
            "fp32 TF32 on rounded (the route)": tf32(lambda: F.conv2d(r(x), w.float(), None, stride, pad, 1, groups)),
            "bf16, bf16 out": lambda: F.conv2d(x.to(bf16), w, None, stride, pad, 1, groups),
            "fp32 on rounded, TF32 off": lambda: F.conv2d(r(x), w.float(), None, stride, pad, 1, groups),
        }, oracle)
    a = torch.randn(256, 133, 128, device=dev, generator=gen)
    m = torch.randn(256, 128, 133, device=dev, generator=gen) / 11
    report("batched matmul [256, 133, 128] x [256, 128, 133], default", {
        "fp32 TF32 on rounded (the route)": tf32(lambda: torch.matmul(r(a), r(m))),
        "bmm bf16, fp32 out": lambda: torch.bmm(a.to(bf16), m.to(bf16), out_dtype=torch.float32),
    }, (r(a).double() @ r(m).double()).float())

    x = torch.randn(6144, 1280, device=dev, generator=gen)
    img = torch.randn(32, 128, 80, 80, device=dev, generator=gen)
    for wdtype in (torch.float32, bf16):
        w = (torch.randn(5120, 1280, device=dev, generator=gen) / 36).to(wdtype)
        b = torch.randn(5120, device=dev, generator=gen).to(wdtype)
        k = (torch.randn(128, 128, 3, 3, device=dev, generator=gen) / 34).to(wdtype)
        for prec in P.PRECISIONS:
            lin = _time_ms(lambda: P.linear(x, w, b, prec), args.iters)
            conv = _time_ms(lambda: P.conv2d(img, k, None, 1, 1, 1, 1, prec), args.iters)
            print(f"precision.linear [6144, 1280] x [1280, 5120] {lin:.4f} ms, precision.conv2d 3x3 [32, 128, 80, 80] "
                  f"{conv:.4f} ms: weights {str(wdtype)[6:]}, {prec} on {card}")
    flags_off = not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    print(f"TF32 flags off after the routes: {flags_off}")
    return 0 if flags_off else 1


def stage_parts(card) -> int:
    import numpy as np
    import torch

    from chip_smoke import SEED, _product_layers, mesh_config, mesh_video
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor

    frames, boxes, large = mesh_video()
    idx = np.where(large)[0][:4]
    src = Extractor(mesh_config(depth=2, frame_batch=4), seed=SEED, device="cpu")
    weights = {"vit": src.backbone.state_dict(), "head": src.head.state_dict()}
    del src
    for dtype in ("float32", "bfloat16"):
        pair = ("default", dtype)
        _a, _b, layers, outputs = _product_layers(torch, pair, weights, frames[idx], boxes[idx])
        print(f"stage {pair}, depth 2, 4 frames, on {card}: {len(layers)} product layers on the CPU run's "
              "inputs, max |layer - float64 of the rounded operands| / max |oracle| for the card route and the "
              "CPU plain version, and the card route's distance from the unrounded product:")
        for name, shape, e_card, e_cpu, e_fp32 in layers:
            print(f"    {name:52s} {str(shape):22s} card {e_card:.3e}  cpu {e_cpu:.3e}  unrounded {e_fp32:.3e}")
        print("  module outputs, card run against CPU run (max |d| / max |CPU|), in forward order:")
        for name, e in outputs:
            print(f"    {name:52s} {e:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
