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
- ``"default"``: each conv's input and weights rounded to bf16 (nearest
  even), one product a term, fp32 sums: the class of the JAX module forward
  at ``default`` (single-pass bf16 on the TPU). It runs K4's forward body at
  ``"default"`` (``train_fwd_tc_kernel``, ``vge_temporal_block_train_fwd_tc``
  in ``csrc/temporal_block_train.cu``) with no dropout mask, as K3 at
  ``"highest"`` shares ``fma_block_kernel`` with K4's forward; the plain
  version is K4's at ``"default"`` without a mask.

``"high"`` runs on the tensor cores (mma.sync, bf16 operands, fp32 sums),
bound by their bf16 rate (``"default"``: the same with one product): 3 products of 2 convs * 5 taps * T * C * C a window,
64.4 GFLOP at [512, 32, 256] (0.065 ms at the H100's data-sheet 989
TFLOP/s). A block owns W = 128 / T windows (:func:`tc_plan`), so the 2.6 MB of
hi and lo weight planes (:func:`high_weight_planes`, laid out once a call)
are read from L2 once per W windows: 0.34 GB a 512-window launch instead of
1.34 GB at one window a block. ``"highest"`` runs on the CUDA cores (the FMA
body), bound by the fp32 FMA rate (21 M FMAs per window at T = 32, C = 256):
a block owns the same W windows (:func:`fma_plan`), holds the conv input
in shared memory, streams the fp32 weights through a ring and
keeps an 8 x 16 tile of (rows, output channels) a thread in registers. In
both, a block owns whole windows, so GroupNorm is a reduction inside the
block. The kernels are built for T in {8, 16, 32} and C in {64, 128, 256}.
Details in the source.

:func:`fused_temporal_block_stacked` (K9) runs the ``"high"`` stage on
``xs [S, B, T, C]`` with per-chain weights ``[S, K, C, C]`` and norms
``[S, C]``: one launch for all S chains (4 a scoring batch instead of K3's
40), a grid of (window, chain) blocks each running the CUDA-core body on its
chain's slices, with bf16x3 products on :func:`split_pairs` weights. Bound:
S times K3's. ``"high"`` only, as in JAX.

:func:`fused_temporal_block` and :func:`fused_temporal_block_stacked` launch
their kernel for CUDA tensors and run their plain versions for CPU tensors;
``fused_temporal_block.launches`` and ``fused_temporal_block_stacked.launches``
count kernel launches. Neither kernel has a backward: the wrappers refuse
CUDA inputs that require grad.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.nn.functional as F

from .cuda_lib import check, load_library, stream_handle

_K = 5  # kernel taps (ref model.py:24: kernel_size=5)
_PRECISIONS = ("default", "high", "highest")
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
    rnd = (lambda t: t.to(torch.bfloat16).float()) if precision == "default" else (lambda t: t)   # noqa: E731
    w1, w2 = rnd(w1), rnd(w2)
    h = F.gelu(_conv_taps(rnd(x), w1, dilation, split))
    y = F.gelu(_conv_taps(rnd(h), w2, dilation, split) + x)
    mu = y.mean(dim=(1, 2), keepdim=True)
    var = ((y - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    return (y - mu) * torch.rsqrt(var + 1e-5) * gn_scale + gn_bias


def split_pairs(w: torch.Tensor) -> torch.Tensor:
    """``[..., Cin, Cout]`` fp32 -> ``[..., Cin, Cout, 2]`` fp32 holding each
    weight's (hi, lo) bf16 pair: the layout K9's CUDA-core body reads."""
    return torch.stack([p.float() for p in split_bf16(w)], dim=-1)


def high_weight_planes(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The weights as the ``"high"`` tensor-core kernels read them: ``[..., 2
    convs, 2 planes, K, Cin, Cout]`` bf16, the planes the (hi, lo) of
    :func:`split_bf16`. ``[K, C, C]`` weights give K3's ``[2, 2, K, C, C]``,
    ``[S, K, C, C]`` ones K10's ``[S, 2, 2, K, C, C]``, stage after stage."""
    ws = torch.stack([w1, w2], dim=-4)
    hi = ws.to(torch.bfloat16)
    lo = (ws - hi).to(torch.bfloat16)   # hi promotes to fp32 exactly
    return torch.stack([hi, lo], dim=-4)


# The tensor-core conv body's geometry (csrc/conv_tile.cuh TcConv, and
# GradTc in csrc/temporal_block_train.cu); the C side refuses a plan that
# differs from its own.
_TC_ROWS = 128          # rows a block: W = 128 / T windows
# (input channels a weight stage, stages): P = 3 ("high") and P = 1 ("default")
_TC_RING = {"block_high": (16, 5), "train_fwd": (64, 4), "train_bwd": (64, 4)}
_GRAD_ROWS = 64         # rows a stage of the weight-gradient kernel
_GRAD_STAGES = 3
_MAX_GRAD_SPLITS = 16   # row ranges of the weight-gradient kernel
SMEM_LIMIT = 232_448    # shared memory a block may use on Hopper (227 KB)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    """Launch geometry of a tensor-core (:func:`tc_plan`) or FMA
    (:func:`fma_plan`) conv kernel, from the shape alone."""

    windows_per_block: int   # W
    blocks: int              # ceil(B / W)
    smem_bytes: int          # dynamic shared memory a block
    slabs: int = 0           # backward at "default": dgamma, dbeta partial rows a window
    splits: int = 0          # backward: row ranges of the weight gradients
    grad_smem_bytes: int = 0  # backward: the weight-gradient kernel's shared memory


def tc_plan(t_len: int, channels: int, batch: int, kind: str) -> TcPlan:
    """The plan of K3 and K10 at ``"high"`` (``kind="block_high"``, three bf16
    products on hi and lo planes), K4's forward at ``"default"``
    (``"train_fwd"``, one product on a rounded plane) or K4's backward at
    ``"default"`` (``"train_bwd"``, the same, then the ten weight-gradient
    GEMMs over ``splits`` row ranges). Depends on ``t_len``, ``channels``,
    ``batch`` and ``kind`` only."""
    if kind not in _TC_RING:
        raise ValueError(f"kind must be one of {tuple(_TC_RING)}, got {kind!r}")
    if t_len not in _KERNEL_T or channels not in _KERNEL_C or batch < 1:
        raise ValueError(f"no tensor-core plan for T={t_len}, C={channels}, B={batch}")
    planes = 2 if kind == "block_high" else 1
    k_chunk, stages = _TC_RING[kind]
    ld = channels + 8                     # bf16 a shared row, padded against bank conflicts
    smem = 2 * (planes * (_TC_ROWS + 1) * ld + stages * planes * k_chunk * ld) + 4 * 8   # + a float a warp
    W = _TC_ROWS // t_len
    blocks = -(-batch // W)
    if kind != "train_bwd":
        return TcPlan(W, blocks, smem)
    tile = 128 if channels >= 128 else 64
    rows = batch * t_len
    return TcPlan(
        W, blocks, smem,
        slabs=max(1, 8 * t_len // channels),   # threads of a window (2T) that share a channel
        splits=max(1, min(_MAX_GRAD_SPLITS, rows // 2048)),
        grad_smem_bytes=2 * _GRAD_STAGES * 2 * _GRAD_ROWS * (tile + 8),
    )


# The FMA conv body's geometry (csrc/conv_tile.cuh FmaConv, and GradFma in
# csrc/temporal_block_train.cu); the C side refuses a plan that differs.
_FMA_ROWS = 128         # rows a block: W = 128 / T windows
_FMA_RING = (16, 4)     # input channels a weight stage, stages
_FMA_GRAD_ROWS = 32     # rows a stage of the weight-gradient kernel
_FMA_GRAD_STAGES = 3
_FMA_GRAD_ROWS_PER_SPLIT = 2304   # 13 row ranges at [960, 32, C]: 520 blocks, 2 waves of 2 an SM
_FMA_KINDS = ("block", "train_fwd", "train_bwd")


def fma_plan(t_len: int, channels: int, batch: int, kind: str) -> TcPlan:
    """The plan of K3 at ``"highest"`` (``kind="block"``), K4's forward at
    ``"highest"`` (``"train_fwd"``, the same kernel with the dropout mask) or
    K4's backward at ``"highest"`` (``"train_bwd"``: the window kernel, then
    the ten fp32 weight-gradient products over ``splits`` row ranges), on the
    FMA body:
    W = 128 / T windows a block, the conv input in shared memory (129 rows
    of C + 1 floats) beside a ring of 4 stages of 16 input channels and a
    float for each of 8 warps. Depends on ``t_len``, ``channels``, ``batch``
    and ``kind`` only."""
    if kind not in _FMA_KINDS:
        raise ValueError(f"kind must be one of {_FMA_KINDS}, got {kind!r}")
    if t_len not in _KERNEL_T or channels not in _KERNEL_C or batch < 1:
        raise ValueError(f"no FMA plan for T={t_len}, C={channels}, B={batch}")
    k_chunk, stages = _FMA_RING
    W = _FMA_ROWS // t_len
    tile = -(-(_FMA_ROWS + 1) * (channels + 1) // 4) * 4   # rows of C + 1 floats, to 16 bytes
    smem = 4 * (tile + stages * k_chunk * channels + 8)   # + a float a warp
    blocks = -(-batch // W)
    if kind != "train_bwd":
        return TcPlan(W, blocks, smem)
    grad_tile = 128 if channels >= 128 else 64
    return TcPlan(
        W, blocks, smem,
        splits=max(1, min(_MAX_GRAD_SPLITS, batch * t_len // _FMA_GRAD_ROWS_PER_SPLIT)),
        grad_smem_bytes=4 * _FMA_GRAD_STAGES * 2 * _FMA_GRAD_ROWS * grad_tile,
    )


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


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on 16 bytes, as the tensor-core kernels read it
    (a copy holds the same values)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
            f"precision must be one of {_PRECISIONS}, got {precision!r} "
            "(a silent fallback would change numerics)"
        )
    validate_stage_args("fused_temporal_block", x, w1, w2, gn_scale, gn_bias)
    if x.device.type == "cpu":
        return fused_temporal_block_plain(x, w1, w2, gn_scale, gn_bias, dilation, precision)
    check_launchable("fused_temporal_block", x, w1, w2, gn_scale, gn_bias)
    B, t_len, C = x.shape
    x = aligned(x)
    gs, gb = aligned(gn_scale), aligned(gn_bias)
    out = torch.empty_like(x)
    lib = load_library().lib
    if precision == "high":
        plan = tc_plan(t_len, C, B, "block_high")
        wk = high_weight_planes(w1, w2)
        code = lib.vge_temporal_block_high(
            x.device.index, x.data_ptr(), wk.data_ptr(), gs.data_ptr(), gb.data_ptr(),
            out.data_ptr(), B, t_len, C, int(dilation), plan.windows_per_block,
            plan.smem_bytes, stream_handle(x.device),
        )
    elif precision == "default":
        # K4's forward body at "default" with no mask: bf16 weight planes of
        # the two convs, [2, K, Cin, Cout]
        plan = tc_plan(t_len, C, B, "train_fwd")
        wk = torch.stack([w1, w2]).to(torch.bfloat16)
        code = lib.vge_temporal_block_train_fwd_tc(
            x.device.index, x.data_ptr(), wk.data_ptr(), gs.data_ptr(), gb.data_ptr(), None,
            out.data_ptr(), B, t_len, C, int(dilation), plan.windows_per_block, plan.smem_bytes,
            stream_handle(x.device),
        )
    else:
        plan = fma_plan(t_len, C, B, "block")
        w1c, w2c = aligned(w1), aligned(w2)   # held until the launch has read them
        code = lib.vge_temporal_block(
            x.device.index, x.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), gs.data_ptr(),
            gb.data_ptr(), out.data_ptr(), B, t_len, C, int(dilation), plan.windows_per_block,
            plan.smem_bytes, stream_handle(x.device),
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
