"""Multi-head attention on ``[B, N, H, D]`` with a flash-attention kernel
(K8), a CUDA kernel for Hopper.

Replaces ``video_gen_evals_tpu/ops/attention.py``: :func:`flash_attention`
(``_flash_kernel``), :func:`attention_plain` (there ``attention_xla``, the
einsum reference) and :func:`multihead_attention`. Kernel source:
``csrc/attention.cu``.

:func:`flash_attention` walks keys and values in blocks of ``block_kv``
with a running max and sum (online softmax), so the ``[N, N]`` scores never
reach device memory and N is unbounded. Keys past N are masked inside the
kernel and q, k, v are read through their strides (they may be views of the
qkv projection's output), so the JAX wrapper's pad and two transposes have no
counterpart here. The accumulator is divided by ``max(l, 1e-30)`` at the end.
``block_q`` is how many query rows share one pass over the keys; rows are
independent, so it changes no value, and the kernel picks its own row
blocking. ``block_kv`` sets where the online softmax rescales and so the last
bits; on the card it is a multiple of 64.

Precision: ``"highest"`` (inputs widened to fp32, fp32 products) or
``"default"`` (q, k, v rounded to bf16, fp32 sums, p rounded to bf16 before
``p v``; the row sum l adds the unrounded p, as the JAX kernel does).

Bound on the H100: the fp32 FMA rate at ``"highest"``; the bytes at
``"default"``, where both products run on the tensor cores at head widths
80, 64 and 32. There a warp owns 16 query rows and keeps its scores, p, m, l
and output in registers; a block holds all query rows of a pair (several
pairs for short sequences, such as the scorer's 33 tokens), so each key is
read once a pair. Where a pair's keys fit in shared memory they stay there
and the next pair's q, k and v are copied in asynchronously while the
current pair computes; longer sequences stream key blocks through two
buffers, the next block in flight while the current one computes. fp32
inputs, as the scorer's ``pallas_bf16`` arm hands them, are rounded to bf16
on the way into shared memory. At ``"highest"`` (and ``"default"`` at other
widths) K8 shares K6's FMA body: a block keeps its pairs' keys and values
in shared memory as fp32, read once a pair, and walks the query rows in
sub-tiles of at most 64; the online softmax runs over the block_kv blocks
of the held keys, and p v rescales its sums at each block's first key.
Where the keys do not fit beside 32 query rows a sub-tile (more than 272 at
hd = 80 and 540 at hd = 32, with block_kv 128), key blocks stream through
shared memory one at a time. On an NVIDIA H100 80GB HBM3 at 700.00 W the
fp32 kernel reads 0.34 ms at ViT-H against SDPA's 0.27 (its online softmax,
a maximum and a sum for each key block of a row, and the copies cost 0.05
ms each) and 0.14 ms at the scorer's shape against SDPA's 0.15.

The wrapper launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` (the same block loop, mask and rescaling
order) for CPU tensors; ``flash_attention.launches`` counts kernel
launches and ``flash_attention.launches_by_precision`` splits them by
precision. The kernel has no backward.
"""

from __future__ import annotations

import math
import typing as T

import torch

from .attention_core import PRECISION_CODES, check_shared_memory, refuse_grad, widen
from .cuda_lib import check, load_library, stream_handle

_PRECISIONS = ("highest", "default")
_KERNEL_BLOCK = 64   # block_kv granularity of the kernel


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: T.Optional[float] = None) -> torch.Tensor:
    """Reference einsum attention. q/k/v: [B, N, H, D] -> [B, N, H, D]."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)


def _effective_block_kv(n: int, block_q: int, block_kv: int) -> int:
    """Keys per streamed block: ``block_kv``, or the whole padded sequence
    when that is shorter (the JAX wrapper's ``min(block_kv, n_pad)``)."""
    n_pad = -(-n // max(block_q, block_kv)) * max(block_q, block_kv)
    return min(block_kv, n_pad)


def flash_attention_plain(q, k, v, scale: T.Optional[float] = None, block_q: int = 128,
                          block_kv: int = 128, precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: the same loop over
    key blocks, with the kernel's order of max, rescale, sum and product."""
    B, N, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    bkv = _effective_block_kv(N, block_q, block_kv)
    qh, kh, vh = (widen(t, precision).permute(0, 2, 1, 3) for t in (q, k, v))   # [B, H, N, D]
    acc = torch.zeros_like(qh)
    m = torch.full(qh.shape[:-1] + (1,), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for lo in range(0, N, bkv):
        # keys past N are masked to -inf in the kernel: p = 0 there, so they
        # are simply not part of the block here
        kb, vb = kh[:, :, lo:lo + bkv], vh[:, :, lo:lo + bkv]
        s = (qh @ kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if precision == "default":
            p = p.to(torch.bfloat16).float()
        acc = acc * alpha + p @ vb
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(
    q: torch.Tensor,   # [B, N, H, D], float32 or bfloat16
    k: torch.Tensor,
    v: torch.Tensor,
    scale: T.Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 128,
    precision: str = "highest",
) -> torch.Tensor:
    """Fused attention with streamed keys. q/k/v: [B, N, H, D] -> [B, N, H, D]."""
    if precision not in _PRECISIONS:
        raise ValueError(f"flash_attention: unknown precision {precision!r}, expected one of {_PRECISIONS}")
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention: q, k, v must share one [B, N, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 tensors of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if block_q < 1 or block_kv < 1:
        raise ValueError(f"block_q and block_kv must be positive, got {block_q}, {block_kv}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_attention: q, k, v must be on one device")
    B, N, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, block_q, block_kv, precision)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    refuse_grad("flash_attention", q, k, v)
    bkv = _effective_block_kv(N, block_q, block_kv)
    if bkv % _KERNEL_BLOCK:
        raise ValueError(f"flash_attention on CUDA takes block_q and block_kv in multiples of "
                         f"{_KERNEL_BLOCK}, got {block_q}, {block_kv}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    lib = load_library().lib
    check_shared_memory("flash_attention", lib, lib.vge_flash_smem_bytes(bkv, D),
                        f"block_kv={bkv} at head width {D}")
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    code = lib.vge_flash_attention(
        q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        B, N, H, D, float(scale), int(q.dtype == torch.bfloat16),
        PRECISION_CODES[precision], bkv, stream_handle(q.device),
    )
    check(code, "flash_attention launch")
    flash_attention.launches += 1
    flash_attention.launches_by_precision[precision] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_precision = dict.fromkeys(_PRECISIONS, 0)


def multihead_attention(q, k, v, scale: T.Optional[float] = None, impl: str = "plain") -> torch.Tensor:
    """Dispatch on [B, N, H, D]: ``"plain"`` (the einsum reference),
    ``"flash"`` (K8, fp32 products) or ``"flash_bf16"`` (K8 at ``"default"``,
    for the bf16 extraction path)."""
    if impl == "flash":
        return flash_attention(q, k, v, scale)
    if impl == "flash_bf16":
        return flash_attention(q, k, v, scale, precision="default")
    if impl == "plain":
        return attention_plain(q, k, v, scale)
    raise ValueError(f"unknown attention impl {impl!r}: expected 'plain', 'flash' or 'flash_bf16'")
