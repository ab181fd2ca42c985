"""Multi-head attention for short sequences in the layout the model already
has (K6, K7), CUDA kernels for Hopper.

Replaces ``video_gen_evals_tpu/ops/attention_core.py``: :func:`mha_core`
(``_mha_kernel``) and :func:`mha_head_batched` (``_mha_hb_kernel``). Kernel
source: ``csrc/attention.cu``.

Both compute ``softmax(q k^T * scale) v`` per head on ``[B, N, H * hd]``
inputs, with a one-pass fp32 softmax whose p is divided by its row sum
before the second product, and return ``[B, N, H * hd]`` in the inputs'
dtype (float32 or bfloat16).

- :func:`mha_core` reads q, k and v in place: they may be column slices of
  the qkv projection's ``[B, N, 3 * H * hd]`` output (any batch and row
  stride, unit stride along the last axis), so no copy is made on the way in
  and the output is ready for the next projection.
- :func:`mha_head_batched` is the JAX package's head-batched schedule. The
  JAX function packs q, k and v to ``[B * H, N, hd]`` pairs and unpacks the
  result, a bet that one bulk transpose each way is cheaper than XLA's
  per-op relayouts on the TPU. On the card the kernel reads strided slices
  in place, so the wrapper launches K6's kernel through the same strides
  and makes no copy: the two give the same bits. Its plain version packs
  like the JAX function.

Precision (what is computed, on either device):
- ``"highest"``: inputs widened to fp32, fp32 products and sums.
- ``"default"``: q, k, v rounded to bf16 (a no-op for bf16 inputs), products
  summed in fp32, p rounded to bf16 before ``p v``: the arithmetic of the JAX
  kernels' input-dtype dots on bf16 tensors.
- ``"high"`` (:func:`mha_core` only, float32 inputs): bf16x3, each product
  as ``a_hi b_hi + a_hi b_lo + a_lo b_hi`` of round-to-nearest-even bf16
  parts, the class of :func:`..conv_kernel.split_bf16`.

Bound on the H100: the fp32 FMA rate at ``"highest"`` and ``"high"`` (4 N^2
hd operations per pair against four [N, hd] tiles moved); the bytes at
``"default"``, where both products run on the tensor cores at head widths
80, 64 and 32 (96 operations a byte at N = 192, under the card's bf16 ridge
of about 295). The ``"default"`` design reads each pair's keys and values
from device memory once, by asynchronous copy, into a block that owns all of
the pair's query rows, and keeps scores, p and the output in registers; see
the source. The FMA kernel (``"highest"``, ``"high"``, and ``"default"`` at
other widths) keeps a pair's keys and values in shared memory as fp32 words
(at ``"high"`` the two bf16 parts packed in one word), so each is read from
device memory once a pair, and walks the query rows in sub-tiles of at most
64 rows, each with a [rows, N] score tile; short sequences pack several
pairs into a block (4 at the scorer's 33 tokens). Where a row's keys fit in
32 lanes (N <= 192) the softmax runs in the registers of the score phase.
On an NVIDIA H100 80GB HBM3 at 700.00 W it reads 0.26 ms at ViT-H
``"highest"`` against SDPA's 0.27 (the copies, 0.04 ms, and the phase
barriers are not hidden) and 0.115 ms at the scorer's shape (SDPA 0.15).
N is therefore bounded by one head's keys and values and 8 query rows: 324
at hd = 80, 396 at 64, 720 at 32 (192 / 256 / 384 before that design); the
wrapper refuses more, at every precision, and longer sequences belong to
:func:`..attention.flash_attention`. Where two buffers of the tensor-core
plan of ``"default"`` do not fit, the FMA kernel runs it, however the
inputs are aligned, so a shape gives the same bits on every route.

Each wrapper launches the kernel for CUDA tensors and runs its plain version
(``mha_core_plain``, ``mha_head_batched_plain``) for CPU tensors;
``mha_core.launches`` and ``mha_head_batched.launches`` count kernel
launches. Neither kernel has a backward.
"""

from __future__ import annotations

import math
import typing as T

import torch

from .conv_kernel import split_bf16
from .cuda_lib import check, load_library, stream_handle

PRECISION_CODES = {"highest": 0, "default": 1, "high": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` on fp32 tensors; at ``"high"`` as three products of bf16 parts."""
    if precision != "high":
        return a @ b
    (a_hi, a_lo), (b_hi, b_lo) = ((p.float() for p in split_bf16(t)) for t in (a, b))
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def widen(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "default":
        t = t.to(torch.bfloat16)
    return t.float()


def attention_onepass_plain(q, k, v, scale: float, precision: str) -> torch.Tensor:
    """The kernels' arithmetic on ``[..., N, hd]`` tensors, result in fp32:
    scores scaled after the product, p divided by its sum, then ``p v``."""
    q, k, v = (widen(t, precision) for t in (q, k, v))
    s = _product(q, k.transpose(-1, -2), precision) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    if precision == "default":
        p = p.to(torch.bfloat16).float()
    return _product(p, v, precision)


def _heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, N, D = t.shape
    return t.reshape(B, N, heads, D // heads).permute(0, 2, 1, 3)


def mha_core_plain(q, k, v, heads: int, scale: T.Optional[float] = None,
                   precision: str = "default") -> torch.Tensor:
    """Plain PyTorch version of :func:`mha_core` (same arguments and result)."""
    B, N, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D // heads)
    ctx = attention_onepass_plain(*(_heads_first(t, heads) for t in (q, k, v)), scale, precision)
    return ctx.permute(0, 2, 1, 3).reshape(B, N, D).to(q.dtype)


def pack_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, N, H * d]`` -> contiguous ``[B * H, N, d]``."""
    B, N, D = t.shape
    return _heads_first(t, heads).reshape(B * heads, N, D // heads).contiguous()


def unpack_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    BH, N, d = t.shape
    return t.reshape(BH // heads, heads, N, d).permute(0, 2, 1, 3).reshape(BH // heads, N, heads * d)


def mha_head_batched_plain(q, k, v, heads: int, scale: T.Optional[float] = None,
                           precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of :func:`mha_head_batched`."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1] // heads)
    out = attention_onepass_plain(*(pack_heads(t, heads) for t in (q, k, v)), scale, precision)
    return unpack_heads(out.to(q.dtype), heads)


def _validate(name, q, k, v, heads, precision, allowed) -> None:
    if precision not in allowed:
        raise ValueError(f"{name}: unknown precision {precision!r}, expected one of {allowed}")
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, N, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] % heads:
        raise ValueError(f"D={q.shape[-1]} not divisible by heads={heads}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if precision == "high" and q.dtype != torch.float32:
        raise TypeError(f"{name}: precision 'high' splits float32 inputs, got {q.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError(f"{name}: q, k, v must be on one device")


def refuse_grad(name, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward on CUDA: run it under "
                           "torch.no_grad() / torch.inference_mode()")


def check_shared_memory(name: str, lib, need: int, what: str) -> None:
    """Raise if a block would need more shared memory than the card gives."""
    limit = lib.vge_attention_max_smem()
    if need > limit:
        raise ValueError(f"{name}: {what} needs {need} bytes of shared memory a block, "
                         f"the card gives {limit}")


def _launch_core(name: str, q, k, v, heads: int, scale: float, precision: str) -> torch.Tensor:
    """K6's kernel on CUDA ``[B, N, H * hd]`` tensors read through their strides."""
    refuse_grad(name, q, k, v)
    B, N, D = q.shape
    hd = D // heads
    # read in place where rows are dense along the last axis; else copy
    q, k, v = (t if t.stride(2) == 1 else t.contiguous() for t in (q, k, v))
    lib = load_library().lib
    check_shared_memory(name, lib, lib.vge_mha_smem_bytes(N, hd),
                        f"N={N} at head width {hd} (use flash_attention for long sequences)")
    out = torch.empty((B, N, D), dtype=q.dtype, device=q.device)
    code = lib.vge_mha_core(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        B, N, heads, hd, float(scale), int(q.dtype == torch.bfloat16),
        PRECISION_CODES[precision], stream_handle(q.device),
    )
    check(code, f"{name} launch")
    return out


def mha_core(
    q: torch.Tensor,   # [B, N, D] (D = heads * hd), float32 or bfloat16
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: T.Optional[float] = None,
    precision: str = "default",
) -> torch.Tensor:
    """Layout-preserving fused multi-head attention: [B, N, D] -> [B, N, D]."""
    _validate("mha_core", q, k, v, heads, precision, ("default", "high", "highest"))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1] // heads)
    if q.device.type == "cpu":
        return mha_core_plain(q, k, v, heads, scale, precision)
    if q.device.type != "cuda":
        raise ValueError(f"mha_core runs on CUDA or CPU tensors, not {q.device}")
    out = _launch_core("mha_core", q, k, v, heads, scale, precision)
    mha_core.launches += 1
    return out


mha_core.launches = 0


def mha_head_batched(
    q: torch.Tensor,   # [B, N, D]
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: T.Optional[float] = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Head-batched schedule, [B, N, D] -> [B, N, D]: on the CPU heads packed
    to ``[B * H, N, d]`` pairs and unpacked, as the JAX function does; on the
    card K6's kernel on the same strides, with no copy."""
    _validate("mha_head_batched", q, k, v, heads, precision, ("default", "highest"))
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1] // heads)
    if q.device.type == "cpu":
        return mha_head_batched_plain(q, k, v, heads, scale, precision)
    if q.device.type != "cuda":
        raise ValueError(f"mha_head_batched runs on CUDA or CPU tensors, not {q.device}")
    out = _launch_core("mha_head_batched", q, k, v, heads, scale, precision)
    mha_head_batched.launches += 1
    return out


mha_head_batched.launches = 0
