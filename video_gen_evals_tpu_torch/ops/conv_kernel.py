"""Fused residual dilated-conv stage of the scoring encoder (K3), and the same
stage over S stacked chains in one launch (K9), CUDA kernels for Hopper.

Replaces ``video_gen_evals_tpu/ops/conv_kernel.py::fused_temporal_block``
(its ``"highest"`` body ``_block_kernel_f32`` and its ``"high"`` body
``_block_kernel_high_mm``) and ``::fused_temporal_block_stacked``
(``_block_kernel_high_stacked``). Kernel source: ``csrc/temporal_block.cu``.

One stage on ``x [B, T, C]`` with weights ``[K, Cin, Cout]`` (ref
``model.py:21-40``): conv1 (k=5, dilation d, zero padding inside each window,
no bias) -> exact GELU -> conv2 -> + x -> GELU -> GroupNorm(1) per window
over T x C (eps 1e-5, affine).

Precision:
- ``"highest"``: fp32 products and sums.
- ``"high"``: bf16x3, the class of :func:`split_bf16` / the JAX
  ``_block_kernel_high_mm``. Weights are split into round-to-nearest-even
  bf16 (hi, lo) once per call, here in the wrapper; each conv's input is
  split the same way; each tap adds ``hi*whi + hi*wlo + lo*whi`` in fp32.

Bound on the H100: fp32 FMA issue (21 M FMAs per window at T = 32, C = 256;
three times that at ``"high"``); the 2.6 MB of weights all blocks share stay
in L2. Design: one block per window owns its [T, C] tile, so GroupNorm is a
block reduction over registers; each thread keeps 4 output channels (2 at
``"high"``) for all T rows in registers; one shared tile holds the current
conv input, read as broadcasts; the next weights are loaded before the
current ones are used. The kernel is built for T in {8, 16, 32}
and C in {64, 128, 256}. Details in the source.

:func:`fused_temporal_block_stacked` (K9) runs the ``"high"`` stage on
``xs [S, B, T, C]`` with per-chain weights ``[S, K, C, C]`` and norms
``[S, C]``: one launch for all S chains (4 a scoring batch instead of K3's
40), a grid of (window, chain) blocks each running K3's body on its chain's
slices. Bound: S times K3's. ``"high"`` only, as in JAX.

:func:`fused_temporal_block` and :func:`fused_temporal_block_stacked` launch
their kernel for CUDA tensors and run their plain versions for CPU tensors;
``fused_temporal_block.launches`` and ``fused_temporal_block_stacked.launches``
count kernel launches. Neither kernel has a backward: the wrappers refuse
CUDA inputs that require grad.
"""

from __future__ import annotations

import typing as T

import torch
import torch.nn.functional as F

from .cuda_lib import check, load_library, stream_handle

_K = 5  # kernel taps (ref model.py:24: kernel_size=5)
_PRECISIONS = ("high", "highest")
_KERNEL_T = (8, 16, 32)      # window lengths the kernel is instantiated for
_KERNEL_C = (64, 128, 256)   # channel counts the kernel is instantiated for


def split_bf16(w: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi, lo) bf16 halves, ``hi + lo ~= w`` to bf16x3 accuracy
    (``torch`` rounds to nearest even, as JAX's ``astype`` does)."""
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return hi, lo


def _conv_taps(a: torch.Tensor, w: torch.Tensor, dilation: int, split: bool) -> torch.Tensor:
    """Dilated k=5 conv as per-tap matmuls plus shifted adds, zero outside
    each window: ``y[t] += (a @ w[j])[t + o_j]`` with ``o_j = (j - 2) * d``."""
    t_len = a.shape[1]
    acc = torch.zeros(a.shape[:2] + (w.shape[-1],), dtype=a.dtype, device=a.device)
    if split:
        a_hi, a_lo = (p.float() for p in split_bf16(a))
        w_hi, w_lo = (p.float() for p in split_bf16(w))
    for j in range(w.shape[0]):
        o = (j - w.shape[0] // 2) * dilation
        if abs(o) >= t_len:
            continue  # the tap lies wholly outside the window
        if split:
            z = a_hi @ w_hi[j] + a_hi @ w_lo[j] + a_lo @ w_hi[j]
        else:
            z = a @ w[j]
        if o >= 0:
            acc[:, : t_len - o] += z[:, o:]
        else:
            acc[:, -o:] += z[:, : t_len + o]
    return acc


def fused_temporal_block_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    gn_scale: torch.Tensor,
    gn_bias: torch.Tensor,
    dilation: int,
    precision: str = "high",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments and result)."""
    split = precision == "high"
    h = F.gelu(_conv_taps(x, w1, dilation, split))
    y = F.gelu(_conv_taps(h, w2, dilation, split) + x)
    mu = y.mean(dim=(1, 2), keepdim=True)
    var = ((y - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    return (y - mu) * torch.rsqrt(var + 1e-5) * gn_scale + gn_bias


def split_pairs(w: torch.Tensor) -> torch.Tensor:
    """``[..., Cin, Cout]`` fp32 -> ``[..., Cin, Cout, 2]`` fp32 holding each
    weight's (hi, lo) bf16 pair: the layout the ``"high"`` kernels read."""
    return torch.stack([p.float() for p in split_bf16(w)], dim=-1)


def validate_stage_args(name: str, x, w1, w2, gn_scale, gn_bias, lead: T.Tuple[int, ...] = (),
                        x_dims: str = "B, T, C") -> None:
    """Shapes, dtype and device of a conv stage's arguments: ``x`` of the
    named dims, weights ``lead + [K, C, C]``, norm parameters ``lead + [C]``."""
    if x.ndim != len(x_dims.split(",")):
        raise ValueError(f"{name}: x must be [{x_dims}], got {tuple(x.shape)}")
    C = x.shape[-1]
    for arg, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != lead + (_K, C, C):
            raise ValueError(f"{arg} must be {list(lead + (_K, C, C))}, got {tuple(w.shape)}")
    for arg, g in (("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        if tuple(g.shape) != lead + (C,):
            raise ValueError(f"{arg} must be {list(lead + (C,))}, got {tuple(g.shape)}")
    tensors = (x, w1, w2, gn_scale, gn_bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 tensors")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got {devices}")


def check_launchable(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the conv-stage kernels take on the card: CUDA tensors, T and C of
    the built instantiations, no gradient."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    t_len, C = x.shape[-2:]
    if t_len not in _KERNEL_T:
        raise ValueError(f"the kernel is built for T in {_KERNEL_T}, got T={t_len}")
    if C not in _KERNEL_C:
        raise ValueError(f"the kernel is built for C in {_KERNEL_C}, got C={C}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x,) + tensors):
        raise RuntimeError(
            f"{name} has no backward on CUDA: run it under "
            "torch.no_grad() / torch.inference_mode()"
        )


def fused_temporal_block(
    x: torch.Tensor,          # [B, T, C] float32
    w1: torch.Tensor,         # [K, C, C] float32, [K, Cin, Cout]
    w2: torch.Tensor,         # [K, C, C] float32
    gn_scale: torch.Tensor,   # [C]
    gn_bias: torch.Tensor,    # [C]
    dilation: int,
    precision: str = "high",
) -> torch.Tensor:
    """One fused residual dilated-conv stage over a window batch."""
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be 'high' or 'highest', got {precision!r} "
            "(a silent fallback would change numerics)"
        )
    validate_stage_args("fused_temporal_block", x, w1, w2, gn_scale, gn_bias)
    if x.device.type == "cpu":
        return fused_temporal_block_plain(x, w1, w2, gn_scale, gn_bias, dilation, precision)
    check_launchable("fused_temporal_block", x, w1, w2, gn_scale, gn_bias)
    B, t_len, C = x.shape
    split = precision == "high"
    if split:
        w1k, w2k = split_pairs(w1), split_pairs(w2)
    else:
        w1k, w2k = w1.contiguous(), w2.contiguous()
    x = x.contiguous()
    gs, gb = gn_scale.contiguous(), gn_bias.contiguous()
    out = torch.empty_like(x)
    lib = load_library().lib
    code = lib.vge_temporal_block(
        x.device.index, x.data_ptr(), w1k.data_ptr(), w2k.data_ptr(),
        gs.data_ptr(), gb.data_ptr(), out.data_ptr(), B, t_len, C,
        int(dilation), int(split), stream_handle(x.device),
    )
    check(code, "fused_temporal_block launch")
    fused_temporal_block.launches += 1
    return out


fused_temporal_block.launches = 0


def fused_temporal_block_stacked_plain(
    xs: torch.Tensor,
    w1s: torch.Tensor,
    w2s: torch.Tensor,
    gn_scales: torch.Tensor,
    gn_biases: torch.Tensor,
    dilation: int,
) -> torch.Tensor:
    """Plain PyTorch version of K9: K3's plain version at ``"high"`` per chain."""
    return torch.stack([
        fused_temporal_block_plain(x, w1, w2, gs, gb, dilation, "high")
        for x, w1, w2, gs, gb in zip(xs, w1s, w2s, gn_scales, gn_biases)
    ])


def fused_temporal_block_stacked(
    xs: torch.Tensor,          # [S, B, T, C] float32 stacked chain activations
    w1s: torch.Tensor,         # [S, K, C, C] float32, [S, K, Cin, Cout]
    w2s: torch.Tensor,         # [S, K, C, C] float32
    gn_scales: torch.Tensor,   # [S, C]
    gn_biases: torch.Tensor,   # [S, C]
    dilation: int,
) -> torch.Tensor:
    """One residual stage for all S chains in one launch, at ``"high"``."""
    validate_stage_args("fused_temporal_block_stacked", xs, w1s, w2s, gn_scales, gn_biases,
                        lead=tuple(xs.shape[:1]), x_dims="S, B, T, C")
    if xs.device.type == "cpu":
        return fused_temporal_block_stacked_plain(xs, w1s, w2s, gn_scales, gn_biases, dilation)
    check_launchable("fused_temporal_block_stacked", xs, w1s, w2s, gn_scales, gn_biases)
    S, B, t_len, C = xs.shape
    xs = xs.contiguous()
    w1k, w2k = split_pairs(w1s), split_pairs(w2s)
    gs, gb = gn_scales.contiguous(), gn_biases.contiguous()
    out = torch.empty_like(xs)
    lib = load_library().lib
    code = lib.vge_temporal_block_stacked(
        xs.device.index, xs.data_ptr(), w1k.data_ptr(), w2k.data_ptr(),
        gs.data_ptr(), gb.data_ptr(), out.data_ptr(), S, B, t_len, C,
        int(dilation), stream_handle(xs.device),
    )
    check(code, "fused_temporal_block_stacked launch")
    fused_temporal_block_stacked.launches += 1
    return out


fused_temporal_block_stacked.launches = 0
