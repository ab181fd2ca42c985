"""Trainable fused residual dilated-conv stage (K4): forward and backward
CUDA kernels for Hopper behind one ``torch.autograd.Function``.

Replaces ``video_gen_evals_tpu/ops/conv_kernel_train.py::fused_temporal_block_train``
(its forward body ``_fwd_kernel``, its backward body ``_bwd_kernel`` and the
``jax.custom_vjp`` that joins them). Kernel source:
``csrc/temporal_block_train.cu``.

The stage is the scoring stage of ``ops/conv_kernel.py`` with the
reference's dropout between GELU(conv1) and conv2 (ref ``model.py:30-36``),
given as a scaled keep mask (0 or 1/keep) that the caller draws::

    d1  = GELU(conv(x, w1)) * mask
    out = GroupNorm1(GELU(conv(d1, w2) + x)) * gamma + beta

The backward saves only x, the weights, gamma and the mask, recomputes the
forward, and returns dx, dw1, dw2, dgamma, dbeta (the formulas stand in
:func:`fused_temporal_block_train_bwd_plain`). On the card it is
``LAUNCHES_PER_BACKWARD`` launches: a window kernel for dx and the per-row
cotangents, a tiled weight-gradient kernel over row ranges, and a
fixed-order sum of the partials. No atomics: two calls on the same inputs
give the same bits.

Precision:
- ``"highest"``: fp32 products and sums.
- ``"default"``: the two operands of every product are rounded to bf16
  (nearest even) and multiplied and summed in fp32, the class of the JAX
  kernel's single bf16 pass with f32 accumulation. Rounded are each conv's
  input and weights and, in the backward, ``dr``, ``dh1`` and the shifted
  ``d1`` and ``x`` of the weight gradients. The plain versions round at the
  same places.

At ``"highest"`` the forward and the backward run on the CUDA cores, bound by
the fp32 FMA rate: 20.1 G FMA forward and 60.4 G backward at ``[960, 32,
256]``. The forward kernel (K3's at ``"highest"``, with the dropout mask) and
the backward's window kernel own W = 128 / T windows a block on the FMA body
(:func:`~.conv_kernel.fma_plan`), which streams the convs' fp32 weights
through a shared-memory ring; the backward's writes d1, dr and dh1 in fp32
for the ten fp32 weight-gradient products, which visit only the rows whose
shifted row stays inside its window. At ``"default"`` both run on the tensor cores
(mma.sync, bf16 operands, fp32 sums), bound by their bf16 rate: 20.1 G and
60.4 G multiply-adds, 0.04 and 0.12 ms at the H100's data-sheet 989 TFLOP/s.
The forward kernel and the backward's window kernel own W = 128 / T windows
a block (:func:`~.conv_kernel.tc_plan`; 4 at T = 32), so the convs' bf16
weights (:func:`train_weight_planes`, laid out once a call: two convs' 1.3
MB for the forward, four convs' 2.6 MB for the backward) are read from L2
once per W windows: 0.31 and 0.63 GB a 960-window launch instead of 1.3 and
2.5 GB. The backward stores x, d1, dr and dh1 as bf16, the only values the
weight-gradient kernel reads, which runs the ten ``dw[j]`` products as
tensor-core GEMMs over ``B * T`` rows. The kernels are built for T in {8, 16,
32} and C in {64, 128, 256}.

:func:`fused_temporal_block_train` launches the kernels for CUDA tensors and
runs the two plain versions for CPU tensors, through the same
``autograd.Function``. ``fused_temporal_block_train.launches`` counts forward
launches, ``fused_temporal_block_train.launches_bwd`` backward launches.
"""

from __future__ import annotations

import math
import typing as T

import torch
import torch.nn.functional as F

from .conv_kernel import _K, _KERNEL_C, _KERNEL_T, _conv_taps, aligned, fma_plan, tc_plan
from .cuda_lib import check, load_library, stream_handle

_PRECISIONS = ("default", "highest")
LAUNCHES_PER_BACKWARD = 3   # window kernel, weight-gradient kernel, fixed-order sums


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    """bf16-rounded values held in fp32 at ``"default"``, ``t`` at ``"highest"``."""
    return t.to(torch.bfloat16).float() if precision == "default" else t


def _conv(a: torch.Tensor, w: torch.Tensor, dilation: int, precision: str) -> torch.Tensor:
    return _conv_taps(_round(a, precision), _round(w, precision), dilation, False)


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du GELU(u) = Phi(u) + u * phi(u) (exact-erf GELU)."""
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return 0.5 * (1.0 + torch.erf(u / math.sqrt(2.0))) + u * phi


def _transposed(w: torch.Tensor) -> torch.Tensor:
    """The transposed conv's weights: taps reversed, Cin and Cout swapped."""
    return w.flip(0).transpose(1, 2).contiguous()


def train_weight_planes(w1: torch.Tensor, w2: torch.Tensor, convs: int = 4) -> torch.Tensor:
    """The weights as the ``"default"`` tensor-core kernels read them, in the
    order of their convs: the first ``convs`` of ``[w1, w2, w2t, w1t]``
    rounded to bf16, ``[convs, K, Cin, Cout]`` (``w2t``, ``w1t`` as
    :func:`_transposed`). The forward reads two, the backward's window kernel
    four."""
    ws = (w1, w2, w2.flip(0).transpose(1, 2), w1.flip(0).transpose(1, 2))[:convs]
    return torch.stack(ws).to(torch.bfloat16)


def _tap_grads(a: torch.Tensor, g: torch.Tensor, dilation: int, precision: str) -> torch.Tensor:
    """``dw[j] = shift_j(a)^T g`` over all windows and rows, ``shift_j(a)[t] =
    a[t + (j - 2) * dilation]`` and zero outside the window: ``[K, C, C]``."""
    t_len, C = a.shape[1], a.shape[2]
    a, g = _round(a, precision), _round(g, precision)
    dw = torch.zeros((_K, C, C), dtype=a.dtype, device=a.device)
    for j in range(_K):
        o = (j - _K // 2) * dilation
        if abs(o) >= t_len:
            continue
        a_s, g_s = (a[:, o:], g[:, : t_len - o]) if o >= 0 else (a[:, : t_len + o], g[:, -o:])
        dw[j] = a_s.reshape(-1, C).t() @ g_s.reshape(-1, C)
    return dw


def _recompute(x, w1, w2, mask, dilation, precision):
    h1 = _conv(x, w1, dilation, precision)
    d1 = F.gelu(h1)
    if mask is not None:
        d1 = d1 * mask
    r = _conv(d1, w2, dilation, precision) + x
    h = F.gelu(r)
    mu = h.mean(dim=(1, 2), keepdim=True)
    var = ((h - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt(var + 1e-5)
    return h1, d1, r, (h - mu) * rstd, rstd


def fused_temporal_block_train_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    gn_scale: torch.Tensor,
    gn_bias: torch.Tensor,
    mask: T.Optional[torch.Tensor],
    dilation: int,
    precision: str = "default",
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel (same arguments and result)."""
    *_, hn, _rstd = _recompute(x, w1, w2, mask, dilation, precision)
    return hn * gn_scale + gn_bias


def fused_temporal_block_train_bwd_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    w2: torch.Tensor,
    gn_scale: torch.Tensor,
    mask: T.Optional[torch.Tensor],
    dy: torch.Tensor,
    dilation: int,
    precision: str = "default",
) -> T.Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward kernels: ``(dx, dw1, dw2, dgamma,
    dbeta)`` from the saved inputs and ``dy``, the forward recomputed."""
    h1, d1, r, hn, rstd = _recompute(x, w1, w2, mask, dilation, precision)
    dbeta = dy.sum(dim=(0, 1))
    dgamma = (dy * hn).sum(dim=(0, 1))
    dhn = dy * gn_scale
    m1 = dhn.mean(dim=(1, 2), keepdim=True)
    m2 = (dhn * hn).mean(dim=(1, 2), keepdim=True)
    dr = rstd * (dhn - m1 - hn * m2) * _gelu_grad(r)
    dw2 = _tap_grads(d1, dr, dilation, precision)
    dd1 = _conv(dr, _transposed(w2), dilation, precision)
    if mask is not None:
        dd1 = dd1 * mask
    dh1 = dd1 * _gelu_grad(h1)
    dw1 = _tap_grads(x, dh1, dilation, precision)
    dx = dr + _conv(dh1, _transposed(w1), dilation, precision)
    return dx, dw1, dw2, dgamma, dbeta


def _validate(x, w1, w2, gn_scale, gn_bias, mask, precision) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be 'default' or 'highest', got {precision!r} "
            "(a silent fallback would change numerics)"
        )
    if x.ndim != 3:
        raise ValueError(f"x must be [B, T, C], got {tuple(x.shape)}")
    C = x.shape[2]
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (_K, C, C):
            raise ValueError(f"{name} must be [{_K}, {C}, {C}], got {tuple(w.shape)}")
    for name, g in (("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        if tuple(g.shape) != (C,):
            raise ValueError(f"{name} must be [{C}], got {tuple(g.shape)}")
    tensors = [x, w1, w2, gn_scale, gn_bias]
    if mask is not None:
        if mask.shape != x.shape:
            raise ValueError(f"mask must have x's shape {tuple(x.shape)}, got {tuple(mask.shape)}")
        tensors.append(mask)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("fused_temporal_block_train takes float32 tensors")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_temporal_block_train runs on CUDA or CPU tensors, not {x.device}")
    if x.device.type == "cuda":
        if x.shape[1] not in _KERNEL_T:
            raise ValueError(f"the kernel is built for T in {_KERNEL_T}, got T={x.shape[1]}")
        if C not in _KERNEL_C:
            raise ValueError(f"the kernel is built for C in {_KERNEL_C}, got C={C}")
        if x.shape[0] == 0:
            raise ValueError("the kernel takes at least one window")


def _forward_cuda(x, w1, w2, gs, gb, mask, dilation, precision) -> torch.Tensor:
    out = torch.empty_like(x)
    B, t_len, C = x.shape
    lib = load_library().lib
    x, gs, gb = aligned(x), aligned(gs), aligned(gb)
    mask = None if mask is None else aligned(mask)
    mask_ptr = None if mask is None else mask.data_ptr()
    if precision == "default":
        plan = tc_plan(t_len, C, B, "train_fwd")
        wk = train_weight_planes(w1, w2, convs=2)
        code = lib.vge_temporal_block_train_fwd_tc(
            x.device.index, x.data_ptr(), wk.data_ptr(), gs.data_ptr(), gb.data_ptr(), mask_ptr,
            out.data_ptr(), B, t_len, C, int(dilation), plan.windows_per_block, plan.smem_bytes,
            stream_handle(x.device),
        )
    else:
        plan = fma_plan(t_len, C, B, "train_fwd")
        w1, w2 = aligned(w1), aligned(w2)   # held until the launch has read them
        code = lib.vge_temporal_block_train_fwd(
            x.device.index, x.data_ptr(), w1.data_ptr(), w2.data_ptr(), gs.data_ptr(),
            gb.data_ptr(), mask_ptr, out.data_ptr(), B, t_len, C, int(dilation),
            plan.windows_per_block, plan.smem_bytes, stream_handle(x.device),
        )
    check(code, "fused_temporal_block_train forward launch")
    fused_temporal_block_train.launches += 1
    return out


def _backward_cuda(x, w1, w2, gs, mask, dy, dilation, precision):
    if precision == "default":
        return _backward_cuda_tc(x, w1, w2, gs, mask, dy, dilation)
    B, t_len, C = x.shape
    plan = fma_plan(t_len, C, B, "train_bwd")
    w1t, w2t = _transposed(w1), _transposed(w2)
    x, w1, w2, gs, dy = (aligned(t) for t in (x, w1, w2, gs, dy))
    mask = None if mask is None else aligned(mask)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)   # noqa: E731
    dx, d1, dr, dh1 = (torch.empty_like(x) for _ in range(4))
    pgamma, pbeta = new(B, C), new(B, C)
    partial = new(2, plan.splits, _K, C, C)
    dw1, dw2, dgamma, dbeta = new(_K, C, C), new(_K, C, C), new(C), new(C)
    code = load_library().lib.vge_temporal_block_train_bwd(
        x.device.index, x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w1t.data_ptr(),
        w2t.data_ptr(), gs.data_ptr(), dy.data_ptr(),
        None if mask is None else mask.data_ptr(), dx.data_ptr(), d1.data_ptr(),
        dr.data_ptr(), dh1.data_ptr(), pgamma.data_ptr(), pbeta.data_ptr(),
        partial.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), B, t_len, C, int(dilation), plan.windows_per_block, plan.smem_bytes,
        plan.splits, plan.grad_smem_bytes, stream_handle(x.device),
    )
    check(code, "fused_temporal_block_train backward launch")
    fused_temporal_block_train.launches_bwd += LAUNCHES_PER_BACKWARD
    return dx, dw1, dw2, dgamma, dbeta


def _backward_cuda_tc(x, w1, w2, gs, mask, dy, dilation):
    """The backward at ``"default"`` on the tensor cores."""
    B, t_len, C = x.shape
    plan = tc_plan(t_len, C, B, "train_bwd")
    wk = train_weight_planes(w1, w2)
    x, gs, dy = aligned(x), aligned(gs), aligned(dy)
    mask = None if mask is None else aligned(mask)
    new = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=x.device)  # noqa: E731
    xb, d1, dr, dh1 = (new(B, t_len, C, dtype=torch.bfloat16) for _ in range(4))
    dx, dr32 = torch.empty_like(x), torch.empty_like(x)
    pgamma, pbeta = new(B * plan.slabs, C), new(B * plan.slabs, C)
    partial = new(2, plan.splits, _K, C, C)
    dw1, dw2, dgamma, dbeta = new(_K, C, C), new(_K, C, C), new(C), new(C)
    code = load_library().lib.vge_temporal_block_train_bwd_tc(
        x.device.index, x.data_ptr(), wk.data_ptr(), gs.data_ptr(), dy.data_ptr(),
        None if mask is None else mask.data_ptr(), dx.data_ptr(), xb.data_ptr(), d1.data_ptr(),
        dr.data_ptr(), dh1.data_ptr(), dr32.data_ptr(), pgamma.data_ptr(), pbeta.data_ptr(),
        partial.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        B, t_len, C, int(dilation), plan.windows_per_block, plan.smem_bytes, plan.slabs,
        plan.splits, plan.grad_smem_bytes, stream_handle(x.device),
    )
    check(code, "fused_temporal_block_train backward launch")
    fused_temporal_block_train.launches_bwd += LAUNCHES_PER_BACKWARD
    return dx, dw1, dw2, dgamma, dbeta


class _FusedTemporalBlockTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, gn_scale, gn_bias, mask, dilation, precision):
        # the weights arrive as permuted views of [Cout, Cin, K] parameters;
        # autograd carries their gradients back through the permute
        x, w1, w2, gs, gb = (t.contiguous() for t in (x, w1, w2, gn_scale, gn_bias))
        mask = None if mask is None else mask.contiguous()
        ctx.save_for_backward(x, w1, w2, gs, mask)
        ctx.dilation, ctx.precision = dilation, precision
        if x.device.type == "cuda":
            return _forward_cuda(x, w1, w2, gs, gb, mask, dilation, precision)
        return fused_temporal_block_train_plain(x, w1, w2, gs, gb, mask, dilation, precision)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, gs, mask = ctx.saved_tensors
        dy = dy.contiguous()
        impl = _backward_cuda if x.device.type == "cuda" else fused_temporal_block_train_bwd_plain
        dx, dw1, dw2, dgamma, dbeta = impl(x, w1, w2, gs, mask, dy, ctx.dilation, ctx.precision)
        return dx, dw1, dw2, dgamma, dbeta, None, None, None


def fused_temporal_block_train(
    x: torch.Tensor,                  # [B, T, C] float32
    w1: torch.Tensor,                 # [K, C, C] float32, [K, Cin, Cout]
    w2: torch.Tensor,                 # [K, C, C] float32
    gn_scale: torch.Tensor,           # [C]
    gn_bias: torch.Tensor,            # [C]
    mask: T.Optional[torch.Tensor],   # [B, T, C] scaled keep mask (0 or 1/keep), or None
    dilation: int,
    precision: str = "default",
) -> torch.Tensor:
    """One trainable fused residual conv stage over a window batch.
    Differentiable in ``x, w1, w2, gn_scale, gn_bias``; the mask gets no
    gradient."""
    _validate(x, w1, w2, gn_scale, gn_bias, mask, precision)
    return _FusedTemporalBlockTrain.apply(x, w1, w2, gn_scale, gn_bias, mask, dilation, precision)


fused_temporal_block_train.launches = 0
fused_temporal_block_train.launches_bwd = 0
