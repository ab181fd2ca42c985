#!/usr/bin/env python3
"""Time the fused conv-stage kernels of the PyTorch + CUDA port (K3
``fused_temporal_block``, K9 ``fused_temporal_block_stacked``, K10
``fused_temporal_chain``, K4
``fused_temporal_block_train`` forward and backward) on one NVIDIA GPU,
alone. It builds only ``csrc/temporal_block.cu``, ``csrc/temporal_chain.cu``
and ``csrc/temporal_block_train.cu`` (``cuda_lib.load_library`` with a
subset of the sources).

    python3 scripts/profile_torch_conv.py [--root DIR] [--iters 20] [--build-only]

``--root`` imports ``video_gen_evals_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive`` under the ignored
``_checkout/``), so that two versions are timed in one call on one card:
run parent, change, change, parent (``--build-only`` first, for both roots at
once, so that the timed runs build nothing). The kernels are held against
their plain versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 2; this script only times them.

The run that builds prints the ptxas line (registers, spills) of every conv
kernel the build instantiated; ``--build-only`` also the number of HMMA, FFMA
and LDS instructions in each conv kernel's SASS (``cuobjdump``). The
measurement helpers come from this checkout's ``chip_smoke.py``, the package
from ``--root``. A timed run prints,
at the main paths' shapes ([512, 32, 256] for K3 and K10, [10, 512, 32,
256] for K9 beside ten K3 ``"high"`` launches, [960, 32, 256]
with a keep mask for K4; dilations 1, 2, 4, 8 and their mean, as phase 2
reports it; K10 over 4 stages and over chain2's two halves, as phase 6 does):
ms a call from CUDA events, the bound and the kernel's share of it; K3 at
``"high"``, K10 and the backward split into their launches by
``torch.profiler`` (K9 too; device ms a call of each kernel, the weight
preparation's small launches included; K3 at both precisions, K4's backward
at "highest" at every dilation); K10's error at 1 to 4 stages
against its plain version beside K3 ``"high"`` run once a stage (and
whether the two agree bitwise); what the weight preparation costs a call;
and K4's forward at ``"default"`` and ``"highest"`` at 528, 960 and 1056
windows (one full wave of 132 blocks of 4 windows, the training step's 1.8
waves, two full waves), which shows what the step's tail wave costs. Every line
carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import math
import os
import re
import shutil
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CONV_KERNELS = ("temporal_block", "temporal_chain", "fma_block", "train_", "tap_grad", "reduce_partials")


def _sass_counts(path: str):
    """(kernel, {HMMA, FFMA, LDS: count}) for each conv kernel in the
    library's SASS: tensor-core products, fp32 FMAs and shared-memory loads."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(("HMMA", "FFMA", "LDS"), 0)
        elif name:
            op = re.search(r"\b(HMMA|FFMA|LDS)\b", line)
            if op:
                counts[name][op.group(1)] += 1
    return [(n, c) for n, c in counts.items() if any(k in n for k in _CONV_KERNELS)]


def timing(torch, ck, ckc, ckt, iters, card):
    from chip_smoke import (BATCH, CLIP, PEAK_BF16, PEAK_FP32, TRAIN_WINDOWS, _bound, _conv_fmas,
                            _conv_stage_bound, _device_split, _time_ms)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    C = 256
    fmt = lambda v: ", ".join(f"{m:.4f}" for m in v)   # noqa: E731

    def weights():
        w1, w2 = ((torch.randn(5, C, C, generator=gen) / math.sqrt(5 * C)).to(dev) for _ in range(2))
        gs = (1.0 + 0.1 * torch.randn(C, generator=gen)).to(dev)
        gb = (0.1 * torch.randn(C, generator=gen)).to(dev)
        return w1, w2, gs, gb

    # K3 at [512, 32, 256]
    x = torch.randn(BATCH, CLIP, C, generator=gen).to(dev)
    w1, w2, gs, gb = weights()
    for precision in ("high", "highest"):
        ms = [_time_ms(lambda: ck.fused_temporal_block(x, w1, w2, gs, gb, d, precision), iters)
              for d in (1, 2, 4, 8)]
        bound, by = (_conv_stage_bound(BATCH, CLIP, C, 2, 2, 2, 6, PEAK_BF16) if precision == "high"
                     else _conv_stage_bound(BATCH, CLIP, C, 2, 2, 2, 2, PEAK_FP32))
        mean = sum(ms) / 4
        print(f"K3 {precision} [{BATCH}, {CLIP}, {C}] d=1/2/4/8: {fmt(ms)} ms, mean {mean:.4f}; "
              f"bound {bound:.4f} ms ({by}, {bound / mean:.1%} of it) on {card}")
    print(f"K3 high weight preparation (high_weight_planes): "
          f"{_time_ms(lambda: ck.high_weight_planes(w1, w2), iters):.4f} ms a call on {card}")
    for precision in ("high", "highest"):
        for ms, n, key in _device_split(torch, lambda: ck.fused_temporal_block(
                x, w1, w2, gs, gb, 2, precision), iters)[:6]:
            print(f"  K3 {precision} d=2 device split: {ms:.4f} ms, {n:g} launches a call: {key[:90]}")

    # K9 at [10, 512, 32, 256]: the scorer's 10 chains in one launch, beside
    # K3 "high" launched once a chain
    S = 10
    xs = torch.randn(S, BATCH, CLIP, C, generator=gen).to(dev)
    w1s, w2s = ((torch.randn(S, 5, C, C, generator=gen) / math.sqrt(5 * C)).to(dev) for _ in range(2))
    gss = (1.0 + 0.1 * torch.randn(S, C, generator=gen)).to(dev)
    gbs = (0.1 * torch.randn(S, C, generator=gen)).to(dev)
    k9_ms, k3_ms, bounds = [], [], []
    for d in (1, 2, 4, 8):
        k9_ms.append(_time_ms(lambda: ck.fused_temporal_block_stacked(xs, w1s, w2s, gss, gbs, d), iters))
        k3_ms.append(_time_ms(lambda: [ck.fused_temporal_block(xs[i], w1s[i], w2s[i], gss[i], gbs[i], d, "high")
                                       for i in range(S)], iters))
        # xs in, out; each conv's fp32 weights once; three bf16 products a term
        bounds.append(_bound(4 * (2 * S * BATCH * CLIP * C + 2 * S * 5 * C * C),
                             6 * 2 * S * _conv_fmas(BATCH, CLIP, C, d), PEAK_BF16))
    mean, bound = sum(k9_ms) / 4, sum(b[0] for b in bounds) / 4
    print(f"K9 [{S}, {BATCH}, {CLIP}, {C}] d=1/2/4/8: {fmt(k9_ms)} ms, mean {mean:.4f}; bound {bound:.4f} ms "
          f"({bounds[0][1]}, {bound / mean:.1%} of it); {S} K3 high launches {fmt(k3_ms)} ms, mean "
          f"{sum(k3_ms) / 4:.4f}, K9 / {S} K3 {mean / (sum(k3_ms) / 4):.3f} on {card}")
    print(f"K9 weight preparation (high_weight_planes on {S} chains): "
          f"{_time_ms(lambda: ck.high_weight_planes(w1s, w2s), iters):.4f} ms a call on {card}")
    for ms, n, key in _device_split(torch, lambda: ck.fused_temporal_block_stacked(
            xs, w1s, w2s, gss, gbs, 2), iters)[:6]:
        print(f"  K9 d=2 device split: {ms:.4f} ms, {n:g} launches a call: {key[:90]}")
    del xs

    # K10 at [512, 32, 256]: one chain's 4 stages, and chain2's two halves
    S = 4
    w1s, w2s = ((torch.randn(S, 5, C, C, generator=gen) / math.sqrt(5 * C)).to(dev) for _ in range(2))
    gss = (1.0 + 0.1 * torch.randn(S, C, generator=gen)).to(dev)
    gbs = (0.1 * torch.randn(S, C, generator=gen)).to(dev)
    for name, groups in (("4 stages", ((1, 2, 4, 8),)), ("chain2", ((1, 2), (4, 8)))):
        ms, bounds = [], []
        for dil in groups:
            n = len(dil)
            w = (w1s[:n], w2s[:n], gss[:n], gbs[:n])
            ms.append(_time_ms(lambda: ckc.fused_temporal_chain(x, *w, dil), iters))
            # x in, out; each conv's fp32 weights once; three bf16 products a term
            bounds.append(_bound(4 * (2 * BATCH * CLIP * C + 2 * n * 5 * C * C),
                                 6 * 2 * sum(_conv_fmas(BATCH, CLIP, C, d) for d in dil), PEAK_BF16))
        mean, bound = sum(ms) / len(ms), sum(b[0] for b in bounds) / len(bounds)
        print(f"K10 {name} [{BATCH}, {CLIP}, {C}] dilations {' and '.join(map(str, groups))}: {fmt(ms)} ms, "
              f"mean {mean:.4f}; bound {bound:.4f} ms ({bounds[0][1]}, {bound / mean:.1%} of it) on {card}")
    for ms, n, key in _device_split(torch, lambda: ckc.fused_temporal_chain(
            x, w1s, w2s, gss, gbs, (1, 2, 4, 8)), iters)[:6]:
        print(f"  K10 4 stages device split: {ms:.4f} ms, {n:g} launches a call: {key[:90]}")
    # K10's error at 1 to 4 stages against its plain version, beside K3 "high"
    # run once a stage: whether the kernel or the order of its sums sets it
    y = x
    for n in range(1, S + 1):
        dil, w = (1, 2, 4, 8)[:n], (w1s[:n], w2s[:n], gss[:n], gbs[:n])
        got, want = ckc.fused_temporal_chain(x, *w, dil), ckc.fused_temporal_chain_plain(x, *w, dil)
        y = ck.fused_temporal_block(y, w1s[n - 1], w2s[n - 1], gss[n - 1], gbs[n - 1], dil[-1], "high")
        print(f"K10 {n} stage(s): max |K10 - plain| {(got - want).abs().max().item():.3e}, "
              f"|K3 run {n} times - plain| {(y - want).abs().max().item():.3e}, "
              f"K10 bitwise K3's: {torch.equal(got, y)} on {card}")
    del x

    # K4 at [960, 32, 256] with a keep mask, as the training step calls it
    B = TRAIN_WINDOWS
    x = torch.randn(B, CLIP, C, generator=gen).to(dev)
    dy = torch.randn(B, CLIP, C, generator=gen).to(dev)
    w1, w2, gs, gb = weights()
    mask = ((torch.rand(B, CLIP, C, generator=gen) < 0.9).float() / 0.9).to(dev)
    for precision in ("default", "highest"):
        peak = PEAK_FP32 if precision == "highest" else PEAK_BF16
        f_ms, b_ms, splits = [], [], {}
        for d in (1, 2, 4, 8):
            f_ms.append(_time_ms(
                lambda: ckt.fused_temporal_block_train(x, w1, w2, gs, gb, mask, d, precision), iters))
            leaves = [t.detach().requires_grad_() for t in (x, w1, w2, gs, gb)]
            out = ckt.fused_temporal_block_train(*leaves, mask, d, precision)
            b_ms.append(_time_ms(lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True), iters))
            if d == 2 or precision == "highest":
                splits[d] = _device_split(torch, lambda: torch.autograd.grad(out, leaves, dy, retain_graph=True),
                                          iters)
        fb = _conv_stage_bound(B, CLIP, C, 2, 3, 2, 2, peak)
        bb = _conv_stage_bound(B, CLIP, C, 6, 4, 4, 2, peak)
        f_mean, b_mean = sum(f_ms) / 4, sum(b_ms) / 4
        print(f"K4 forward {precision} [{B}, {CLIP}, {C}] d=1/2/4/8: {fmt(f_ms)} ms, mean {f_mean:.4f}; "
              f"bound {fb[0]:.4f} ms ({fb[1]}, {fb[0] / f_mean:.1%} of it) on {card}")
        print(f"K4 backward {precision} [{B}, {CLIP}, {C}] d=1/2/4/8: {fmt(b_ms)} ms, mean {b_mean:.4f}; "
              f"bound {bb[0]:.4f} ms ({bb[1]}, {bb[0] / b_mean:.1%} of it) on {card}")
        for d, split in splits.items():
            for ms, n, key in split[:8]:
                print(f"  K4 backward {precision} d={d} device split: {ms:.4f} ms, {n:g} launches a call: "
                      f"{key[:90]}")
    # the forward's tail wave: 960 windows are 240 blocks, 1.8 waves of 132
    xt = torch.randn(1056, CLIP, C, generator=gen).to(dev)
    mt = ((torch.rand(1056, CLIP, C, generator=gen) < 0.9).float() / 0.9).to(dev)
    for precision in ("default", "highest"):
        tail = {n: _time_ms(lambda: ckt.fused_temporal_block_train(
            xt[:n], w1, w2, gs, gb, mt[:n], 2, precision), iters) for n in (528, 960, 1056)}
        print(f"K4 forward {precision} d=2 by windows: "
              + ", ".join(f"{n}: {ms:.4f} ms" for n, ms in tail.items()) + f" on {card}")
    del xt, mt
    print(f"K4 backward default weight preparation (train_weight_planes): "
          f"{_time_ms(lambda: ckt.train_weight_planes(w1, w2), iters):.4f} ms a call on {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_REPO, help="checkout whose video_gen_evals_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--build-only", action="store_true", help="build the three sources and stop")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_conv: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, _REPO)
    from chip_smoke import _card, _ptxas_summary   # this checkout's measurement helpers
    sys.path.insert(0, os.path.abspath(args.root))   # the root's package
    from video_gen_evals_tpu_torch.ops import chain_kernel as ckc
    from video_gen_evals_tpu_torch.ops import conv_kernel as ck
    from video_gen_evals_tpu_torch.ops import conv_kernel_train as ckt
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library

    card = _card()
    lib = load_library(sources=("temporal_block.cu", "temporal_chain.cu", "temporal_block_train.cu"))
    print(f"root {os.path.abspath(args.root)}: build {lib.build_seconds:.1f} s on {card}, "
          f"torch {torch.__version__}")
    for line in _ptxas_summary(lib.build_log):   # empty when an earlier run built the library
        if line.startswith(_CONV_KERNELS):
            print(f"  ptxas {line}")
    if args.build_only:
        for name, n in _sass_counts(lib.path) or []:
            print(f"  SASS HMMA {n['HMMA']:5d} FFMA {n['FFMA']:6d} LDS {n['LDS']:5d} in {name}")
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py sets it
    timing(torch, ck, ckc, ckt, args.iters, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
