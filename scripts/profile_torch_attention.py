#!/usr/bin/env python3
"""Time the attention kernels of the PyTorch + CUDA port (K6
``mha_core``, K7 ``mha_head_batched``, K8 ``flash_attention``) on one NVIDIA
GPU, alone. It builds only ``csrc/attention.cu`` (``cuda_lib.load_library``
with a subset of the sources), so nvcc takes seconds, not minutes.

    python3 scripts/profile_torch_attention.py [--root DIR] [--iters 50] [--precision P ...]

``--root`` imports ``video_gen_evals_tpu_torch`` from another checkout (for
example the parent commit unpacked with ``git archive`` under the ignored
``_checkout/``), so that two versions are timed in one call on one card:
run parent, change, change, parent. The kernels are held against their plain
versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 6; the
timing, the bound and the card's line are that script's.

First the ptxas line (registers, spills) of every attention kernel the
build instantiated, then one line a kernel and shape: ms a call, SDPA's ms
on the same tensors (cast to bf16 for ``default``; a yardstick used nowhere
in the port), the bound and the kernel's share of it, with the card's name
and power limit. K6 at ``high`` (bf16x3) is set beside SDPA on the fp32
tensors (3xTF32, within ``high``'s tolerance of it); its bound is the bytes,
as for ``default``. Last, SDPA on the fp32 tensors with its
memory-efficient backend forced, beside the unforced call, which shows the
backend PyTorch picks for fp32.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timing(torch, att, core, iters, card, precisions):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from chip_smoke import PEAK_BF16, PEAK_FP32, _attn_bound, _time_ms

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    for (B, N, H, hd), label in (((32, 192, 16, 80), "ViT-H"), ((512, 33, 8, 32), "scorer")):
        D = H * hd
        for dtype, precision in ((torch.bfloat16, "default"), (torch.float32, "default"),
                                 (torch.float32, "highest"), (torch.float32, "high")):
            if precision not in precisions:
                continue
            qkv = torch.randn(B, N, 3 * D, generator=gen).to(dev).to(dtype)
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
            q4, k4, v4 = qkv.reshape(B, N, 3, H, hd).unbind(dim=2)
            sd = [t.transpose(1, 2) for t in (q4, k4, v4)]
            if precision == "default":
                sd = [t.to(torch.bfloat16) for t in sd]
            sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(*sd), iters)
            bound, by = _attn_bound(B, N, H, hd, qkv.element_size(), 2,
                                    PEAK_FP32 if precision == "highest" else PEAK_BF16)
            what = f"{label} [{B}, {N}, {H}, {hd}] {str(dtype)[6:]} {precision}"
            kernels = [("K6", lambda: core.mha_core(q, k, v, H, precision=precision))]
            if precision != "high":
                kernels += [("K7", lambda: core.mha_head_batched(q, k, v, H, precision=precision)),
                            ("K8", lambda: att.flash_attention(q4, k4, v4, precision=precision))]
            for name, fn in kernels:
                ms = _time_ms(fn, iters)
                print(f"{name} {what}: {ms:.4f} ms, SDPA {sdpa_ms:.4f} ms ({ms / sdpa_ms:.2f}x), bound {bound:.4f} ms ({by}, "
                      f"{bound / ms:.1%} of it) on {card}")
            if dtype == torch.float32 and precision == "highest":
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    eff_ms = _time_ms(lambda: F.scaled_dot_product_attention(*sd), iters)
                print(f"SDPA {label} float32: {sdpa_ms:.4f} ms unforced, {eff_ms:.4f} ms with "
                      f"EFFICIENT_ATTENTION forced on {card}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=_REPO, help="checkout whose video_gen_evals_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--precision", action="append", choices=("default", "highest", "high"),
                    help="time only these precisions (repeatable; default all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_attention: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.abspath(args.root), _REPO]
    from chip_smoke import _card, _ptxas_summary
    from video_gen_evals_tpu_torch.ops import attention as att
    from video_gen_evals_tpu_torch.ops import attention_core as core
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library

    card = _card()
    lib = load_library(sources=("attention.cu",))
    print(f"root {os.path.abspath(args.root)}: build {lib.build_seconds:.1f} s on {card}, torch {torch.__version__}")
    for line in _ptxas_summary(lib.build_log):
        if "hd=" in line:
            print(f"  ptxas {line}")
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py sets it
    with torch.inference_mode():
        timing(torch, att, core, args.iters, card, args.precision or ("default", "highest", "high"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
