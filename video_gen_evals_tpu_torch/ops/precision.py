"""The extraction networks' numerics: the JAX package's three matmul classes
(``jax.default_matmul_precision``) and its ``param_dtype``, as the layers of
the five extraction nets (ViT-H, the SMPL head, YOLOX, the Faster R-CNN,
RTMPose) run them.

No TPU kernel is ported here: the JAX package computes these products as XLA
dots and convolutions outside any Pallas kernel, and the card route of each
is one library call (cuBLAS, cuDNN).

Activations are float32 in every network at every class; parameters are
float32, or float32 values rounded once to bfloat16 and stored so
(``param_dtype="bfloat16"``, JAX's ``tree_map`` cast of ``params``). What a
product computes:

- ``"highest"``: fp32 operands (bfloat16 weights widened, which is exact),
  fp32 sums, TF32 off for the call whatever the global flags say; the plain
  version is the same call.
- ``"high"``: the same as ``"highest"``. JAX runs bf16x3 on the TPU; a true
  fp32 product is at least as exact.
- ``"default"``: both operands rounded to bfloat16 (round to nearest even),
  the products summed in fp32, the output fp32. The product of two bfloat16
  values is exact in fp32, so the plain version, an fp32 product of the
  rounded operands, differs from the card only in the order of the sums.

The card routes at ``"default"``, each with an fp32 output:

- :func:`linear`: ``torch.addmm`` on bfloat16 operands with
  ``out_dtype=torch.float32`` (cuBLAS, bf16 tensor cores, fp32 sums and
  output, the bias added in the epilogue).
- :func:`conv2d` and :func:`matmul`: the fp32 library call on the rounded
  operands with TF32 allowed for that one call (cuDNN, cuBLAS). A bfloat16
  value is exact in TF32 (10 bits of mantissa against bfloat16's 7), so the
  tensor cores multiply the rounded operands exactly and sum in fp32: the
  class itself, with no rounding of the output (cuDNN's bfloat16 convolutions
  would write bfloat16), at the TF32 rate.

On a CPU tensor every function runs its plain version; an unknown class
raises ``ValueError``. The layers (:class:`Linear`, :class:`Conv2d`,
:class:`LayerNorm`) keep their ``torch.nn`` names, so state_dicts load
unchanged, and take their class from :func:`set_precision_`, so no global
autocast state is needed.
"""

from __future__ import annotations

import contextlib
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("default", "high", "highest")
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_precision(precision: str, what: str = "matmul_precision") -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown {what} {precision!r}: expected one of {PRECISIONS}")
    return precision


def storage_dtype(name: str) -> torch.dtype:
    """The storage type of ``param_dtype``; an unknown name raises."""
    if name not in PARAM_DTYPES:
        raise ValueError(f"unknown param_dtype {name!r}: expected one of {tuple(PARAM_DTYPES)}")
    return PARAM_DTYPES[name]


def kernel_precision(precision: str) -> str:
    """The attention kernels' precision for a class: ``"default"`` stays,
    ``"high"`` and ``"highest"`` run the kernels' fp32 ``"highest"``."""
    return "default" if check_precision(precision) == "default" else "highest"


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, to nearest even, as an fp32 tensor."""
    return t.to(torch.bfloat16).float()


@contextlib.contextmanager
def _tf32(flags, allowed: bool):
    """TF32 allowed (on the bf16-rounded operands of ``"default"``, where it
    is exact) or not (the fp32 products of ``"high"`` and ``"highest"``) for
    one library call, whatever the global flag says; it is put back after."""
    before = flags.allow_tf32
    flags.allow_tf32 = allowed
    try:
        yield
    finally:
        flags.allow_tf32 = before


def _widen(t: T.Optional[torch.Tensor]) -> T.Optional[torch.Tensor]:
    return None if t is None else t.float()


def linear_plain(x, weight, bias=None, precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`linear`: fp32, on bf16-rounded operands at
    ``"default"``."""
    if check_precision(precision) == "default":
        x, weight = round_bf16(x), round_bf16(weight)
    return F.linear(x.float(), weight.float(), _widen(bias))


def linear(x: torch.Tensor, weight: torch.Tensor, bias: T.Optional[torch.Tensor] = None,
           precision: str = "highest") -> torch.Tensor:
    """``x @ weight^T + bias`` at ``precision``, fp32 out (weights float32
    or bfloat16)."""
    if x.device.type != "cuda":
        return linear_plain(x, weight, bias, precision)
    if check_precision(precision) != "default":
        with _tf32(torch.backends.cuda.matmul, False):
            return linear_plain(x, weight, bias, precision)
    lead, k = x.shape[:-1], x.shape[-1]
    a = x.reshape(-1, k).to(torch.bfloat16)
    w = weight.to(torch.bfloat16).t()
    out = (torch.mm(a, w, out_dtype=torch.float32) if bias is None
           else torch.addmm(bias.float(), a, w, out_dtype=torch.float32))
    return out.reshape(*lead, weight.shape[0])


def conv2d_plain(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
                 precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`conv2d`."""
    if check_precision(precision) == "default":
        x, weight = round_bf16(x), round_bf16(weight)
    return F.conv2d(x.float(), weight.float(), _widen(bias), stride, padding, dilation, groups)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: T.Optional[torch.Tensor] = None, stride=1,
           padding=0, dilation=1, groups=1, precision: str = "highest") -> torch.Tensor:
    """``F.conv2d`` at ``precision`` on NCHW input, fp32 out."""
    if x.device.type != "cuda":
        return conv2d_plain(x, weight, bias, stride, padding, dilation, groups, precision)
    with _tf32(torch.backends.cudnn, check_precision(precision) == "default"):
        return conv2d_plain(x, weight, bias, stride, padding, dilation, groups, precision)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """Plain version of :func:`matmul`."""
    if check_precision(precision) == "default":
        a, b = round_bf16(a), round_bf16(b)
    return torch.matmul(a.float(), b.float())


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``torch.matmul(a, b)`` at ``precision`` (any broadcast shapes), fp32 out."""
    if a.device.type != "cuda":
        return matmul_plain(a, b, precision)
    with _tf32(torch.backends.cuda.matmul, check_precision(precision) == "default"):
        return matmul_plain(a, b, precision)


class Precise:
    """A module whose products run at ``self.precision`` (one of
    :data:`PRECISIONS`), set by :func:`set_precision_`. A module may
    override :meth:`set_precision` to give its children other classes: it
    runs after theirs."""

    precision = "highest"

    def set_precision(self, precision: str) -> None:
        self.precision = precision


def set_precision_(module: nn.Module, precision: str) -> nn.Module:
    """Every product under ``module`` at ``precision``: the JAX package's
    ``jax.default_matmul_precision`` around an apply. ``nn.Module.apply``
    visits children before their parent, so a parent's
    :meth:`Precise.set_precision` refines what its children were given (the
    ViT's per-block schedule, the pose head's fp32 products)."""
    check_precision(precision)
    module.apply(lambda m: m.set_precision(precision) if isinstance(m, Precise) else None)
    return module


class Linear(Precise, nn.Linear):
    """``nn.Linear`` at the module's class, fp32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.precision)


class Conv2d(Precise, nn.Conv2d):
    """``nn.Conv2d`` (zero padding) at the module's class, fp32 out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation, self.groups,
                      self.precision)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` on fp32 activations with fp32 or bf16-rounded
    parameters, widened (the norm has no product, so no class)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, _widen(self.weight), _widen(self.bias), self.eps)
