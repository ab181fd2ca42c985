"""Whole-chain fused conv kernel of the scoring encoder (K10), a CUDA kernel
for Hopper: S consecutive residual dilated-conv stages of one chain in one
launch.

Replaces ``video_gen_evals_tpu/ops/chain_kernel.py::fused_temporal_chain``.
Kernel source: ``csrc/temporal_chain.cu``.

Stage ``s`` is K3's ``"high"`` stage (:func:`.conv_kernel.fused_temporal_block`)
with ``w1s[s]``, ``w2s[s]``, ``gn_scales[s]``, ``gn_biases[s]`` and
``dilations[s]``, applied to the previous stage's output: 4 stages for the
``chain`` forward, 2 for ``chain2``. ``"high"`` (bf16x3) only, as in JAX.
``variant`` (``"slice"`` or ``"mm_first"``) is validated as in JAX; the two
JAX bodies differ only in the order in which taps are summed, so one kernel
serves both.

Bound on the H100: the bf16 tensor-core rate, S times K3's. Design: K3
``"high"``'s tensor-core stage (mma.sync, W = 128 / T windows a block,
:func:`~.conv_kernel.tc_plan` ``"block_high"``) run S times in one block.
Every stage's hi and lo weight planes (:func:`~.conv_kernel.high_weight_planes`,
``[S, 2, 2, K, C, C]`` bf16, 10.5 MB for 4 stages at C = 256) are laid out
once a call and read from L2 once per W windows. A stage's output is the next
stage's exact fp32 residual and does not fit on chip beside the planes, so it
waits in ``out`` (in L2) and the next stage reads it back. Each conv sums the
two small products of every term before the large one: in K3's interleaved
order the tensor cores' rounding compounds over 4 stages to 1.4e-4 from the
plain version, in this one to ~6e-5 (details in the source).

:func:`fused_temporal_chain` launches the kernel for CUDA tensors and runs
:func:`fused_temporal_chain_plain` for CPU tensors;
``fused_temporal_chain.launches`` counts kernel launches. The kernel has no
backward.
"""

from __future__ import annotations

import ctypes
import typing as T

import torch

from .conv_kernel import (
    aligned,
    check_launchable,
    fused_temporal_block_plain,
    high_weight_planes,
    tc_plan,
    validate_stage_args,
)
from .cuda_lib import check, load_library, stream_handle

_DILATIONS = (1, 2, 4, 8)
_VARIANTS = ("slice", "mm_first")
_MAX_STAGES = 4   # the kernel's limit


def _validate(x, w1s, w2s, gn_scales, gn_biases, dilations, variant) -> None:
    if variant not in _VARIANTS:
        raise ValueError(f"variant must be 'slice' or 'mm_first', got {variant!r}")
    S = len(dilations)
    if not 1 <= S <= _MAX_STAGES:
        raise ValueError(f"fused_temporal_chain runs 1 to {_MAX_STAGES} stages, got {S}")
    if w1s.ndim >= 1 and w1s.shape[0] != S:
        raise ValueError(f"expected {S} stage weights, got {w1s.shape[0]}")
    validate_stage_args("fused_temporal_chain", x, w1s, w2s, gn_scales, gn_biases, lead=(S,))


def fused_temporal_chain_plain(
    x: torch.Tensor,
    w1s: torch.Tensor,
    w2s: torch.Tensor,
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    dilations: T.Sequence[int] = _DILATIONS,
) -> torch.Tensor:
    """Plain PyTorch version of K10: K3's plain version at ``"high"``, stage
    after stage."""
    for s, dil in enumerate(dilations):
        x = fused_temporal_block_plain(x, w1s[s], w2s[s], gn_scales[s], gn_biases[s], dil, "high")
    return x


def fused_temporal_chain(
    x: torch.Tensor,           # [B, T, C] float32 post-stem activations
    w1s: torch.Tensor,         # [S, K, C, C] float32 (conv1 per stage), [S, K, Cin, Cout]
    w2s: torch.Tensor,         # [S, K, C, C] float32 (conv2 per stage)
    gn_scales: torch.Tensor,   # [S, C]
    gn_biases: torch.Tensor,   # [S, C]
    dilations: T.Sequence[int] = _DILATIONS,
    variant: str = "slice",
) -> torch.Tensor:
    """All S residual conv stages of one chain in one launch, at ``"high"``."""
    dilations = tuple(int(d) for d in dilations)
    _validate(x, w1s, w2s, gn_scales, gn_biases, dilations, variant)
    if x.device.type == "cpu":
        return fused_temporal_chain_plain(x, w1s, w2s, gn_scales, gn_biases, dilations)
    check_launchable("fused_temporal_chain", x, w1s, w2s, gn_scales, gn_biases)
    B, t_len, C = x.shape
    S = len(dilations)
    plan = tc_plan(t_len, C, B, "block_high")
    x = aligned(x)
    wk = high_weight_planes(w1s, w2s)
    gs, gb = aligned(gn_scales), aligned(gn_biases)
    out = torch.empty_like(x)
    lib = load_library().lib
    code = lib.vge_temporal_chain(
        x.device.index, x.data_ptr(), wk.data_ptr(), gs.data_ptr(), gb.data_ptr(),
        out.data_ptr(), B, t_len, C, S, (ctypes.c_int * S)(*dilations),
        plan.windows_per_block, plan.smem_bytes, stream_handle(x.device),
    )
    check(code, "fused_temporal_chain launch")
    fused_temporal_chain.launches += 1
    return out


fused_temporal_chain.launches = 0
