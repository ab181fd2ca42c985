"""Fused scoring forwards of the ``HumanActionScorer``.

Port of ``video_gen_evals_tpu/models/fused_apply.py``. Both functions read
the weights of the port's own :class:`~.fusion_encoder.HumanActionScorer`
(one checkpoint format) and compute its deterministic (eval) forward,
returning ``(seq_embed, frame_embeds, tokens)`` as ``model(x)`` does:

- :func:`fused_forward` runs the 2M conv chains (raw and diff stream per
  modality) stacked into ``[S, B, T, C]``, each dilated conv as batched
  matmuls: ``"vmap_conv"`` one product over the K taps unfolded along the
  channels (the counterpart of one vmapped convolution), ``"tap_matmul"`` K
  shifted products (JAX ``_conv_taps``). No kernel stands behind either in
  JAX, so they are ``torch.matmul``.
- :func:`block_kernel_forward` runs the residual conv stages through the
  port's kernels: ``stage_fusion`` ``"stage"`` one stage a launch (K3),
  ``"chain"`` / ``"chain2"`` 4 or 2 stages of a chain a launch (K10),
  ``"stacked"`` one stage of all chains a launch (K9); and the temporal
  transformer's attention through ``attn_impl`` ``"xla"`` (plain) or
  ``"core"`` (K6, ``ops/attention_core.py::mha_core``, at the forward's
  precision).

The input's layout into chains is the module's own
(:meth:`HumanActionScorer.chain_inputs`, each chain's stem and projection its
encoder's), and so is everything after the chains
(:meth:`HumanActionScorer.modality_tokens`, then
:meth:`HumanActionScorer.embed_tokens`: the per-frame fusion, CLS token,
positions and the temporal transformer). So JAX's ``_transformer_layer`` and
``_layer_norm`` have no functions of their own here: ``attn_impl`` picks the
attention function the module's layers are handed, and the modules' layer
norms compute ``_layer_norm``. Both functions compute the eval forward and
refuse a model in training mode. On the card, call them under
``torch.inference_mode()`` (the kernels have no backward).
"""

from __future__ import annotations

import typing as T

import torch
import torch.nn.functional as F

from ..ops.attention_core import mha_core
from ..ops.chain_kernel import fused_temporal_chain
from ..ops.conv_kernel import fused_temporal_block_stacked
from .fusion_encoder import EncoderConfig, HumanActionScorer, TemporalConvBlock

_DILATIONS = (1, 2, 4, 8)
CONV_IMPLS = ("vmap_conv", "tap_matmul")
STAGE_FUSIONS = ("stage", "chain", "chain2", "stacked")
CONV_VARIANTS = ("slice", "mm_first")
ATTN_IMPLS = ("xla", "core")
_CHAIN_GROUPS = {"chain": ((0, 1, 2, 3),), "chain2": ((0, 1), (2, 3))}

Outputs = T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _chains(model: HumanActionScorer, x: torch.Tensor):
    """Stem outputs ``[B, T, C]`` of every chain, its encoder and its modality
    slot, in the module forward's order (``HumanActionScorer.chain_inputs``)."""
    if model.training:
        raise ValueError("the fused forwards compute the eval forward: call model.eval() first")
    chains = model.chain_inputs(x)
    return ([enc.apply_stem(xin) for enc, xin, _slot in chains],
            [enc for enc, _xin, _slot in chains], [slot for _enc, _xin, slot in chains])


def _stage_weights(blocks: T.Sequence[TemporalConvBlock]):
    """``w1s, w2s [S, K, Cin, Cout]`` and ``gn_scales, gn_biases [S, C]`` of
    ``blocks`` (stages of one chain, or one stage of several chains)."""
    return (torch.stack([b.conv1.weight.permute(2, 1, 0) for b in blocks]),
            torch.stack([b.conv2.weight.permute(2, 1, 0) for b in blocks]),
            torch.stack([b.norm.weight for b in blocks]),
            torch.stack([b.norm.bias for b in blocks]))


def _conv_taps(y: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Stacked-chain dilated conv as K shifted batched matmuls (JAX
    ``_conv_taps``): ``y [S, B, T, C]``, ``w [S, K, Cin, Cout]``."""
    t_len, K = y.shape[2], w.shape[1]
    pad = dilation * (K - 1) // 2
    ypad = F.pad(y, (0, 0, pad, pad))
    out = None
    for j in range(K):
        t = ypad[:, :, j * dilation : j * dilation + t_len] @ w[:, j, None]
        out = t if out is None else out + t
    return out


def _conv_unfolded(y: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """The same conv as one batched matmul: the K shifted inputs side by side
    along the channels, ``[S, B, T, K * Cin] @ [S, K * Cin, Cout]``."""
    S, _B, t_len, C = y.shape
    K = w.shape[1]
    pad = dilation * (K - 1) // 2
    ypad = F.pad(y, (0, 0, pad, pad))
    cols = torch.cat([ypad[:, :, j * dilation : j * dilation + t_len] for j in range(K)], dim=-1)
    return cols @ w.reshape(S, 1, K * C, w.shape[-1])


def _group_norm_1(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1) per window of ``[S, B, T, C]``, per-chain ``[S, C]`` affine."""
    mu = h.mean(dim=(2, 3), keepdim=True)
    var = ((h - mu) ** 2).mean(dim=(2, 3), keepdim=True)
    return (h - mu) / torch.sqrt(var + 1e-5) * scale[:, None, None, :] + bias[:, None, None, :]


def fused_forward(cfg: EncoderConfig, model: HumanActionScorer, x: torch.Tensor,
                  conv_impl: str = "vmap_conv") -> Outputs:
    """The module's deterministic forward with all chains stacked, fp32
    throughout. ``conv_impl``: ``"vmap_conv"`` or ``"tap_matmul"``."""
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl must be one of {CONV_IMPLS}, got {conv_impl!r}")
    conv = _conv_taps if conv_impl == "tap_matmul" else _conv_unfolded
    ys, encs, slots = _chains(model, x)
    y = torch.stack(ys)                                   # [S, B, T, C]
    for i, dil in enumerate(_DILATIONS):
        w1s, w2s, gs, gb = _stage_weights([e.blocks[i] for e in encs])
        h = F.gelu(conv(y, w1s, dil))
        h = F.gelu(conv(h, w2s, dil) + y)
        y = _group_norm_1(h, gs, gb)
    proj = torch.stack([e.proj.weight.t() for e in encs])   # [S, C, C]
    y = y @ proj[:, None]
    return model.embed_tokens(model.modality_tokens(list(y), slots))


def block_kernel_forward(
    cfg: EncoderConfig,
    model: HumanActionScorer,
    x: torch.Tensor,
    block_windows: int = 32,
    precision: str = "high",
    stage_fusion: str = "stage",
    conv_variant: str = "slice",
    attn_impl: str = "xla",
) -> Outputs:
    """The module's deterministic forward with the residual conv stages in the
    fused kernels (see the module docstring).

    ``precision``: the conv kernels' (and K6's) arithmetic, ``"high"``
    (bf16x3) or ``"highest"`` (fp32, ``stage`` only). ``conv_variant``:
    ``"slice"`` or ``"mm_first"``, the JAX in-kernel tap formulations; the
    port's kernels sum the taps one way for both. ``block_windows`` is
    validated as a positive int and has no effect: it sized the TPU's blocks,
    and the port's kernels take any batch (one window a block)."""
    if stage_fusion not in STAGE_FUSIONS:
        raise ValueError(f"stage_fusion must be one of {STAGE_FUSIONS}, got {stage_fusion!r}")
    if conv_variant not in CONV_VARIANTS:
        raise ValueError(f"conv_variant must be 'slice' or 'mm_first', got {conv_variant!r}")
    if attn_impl not in ATTN_IMPLS:
        # a typo'd impl fails loudly rather than reporting the plain path's numbers
        raise ValueError(f"unknown attn_impl {attn_impl!r}, expected one of {ATTN_IMPLS}")
    if precision not in ("high", "highest"):
        raise ValueError(f"precision must be 'high' or 'highest', got {precision!r}")
    if stage_fusion != "stage" and precision != "high":
        raise ValueError(f"{stage_fusion} fusion supports precision='high' only")
    if isinstance(block_windows, bool) or not isinstance(block_windows, int) or block_windows < 1:
        raise ValueError(f"block_windows must be a positive int, got {block_windows!r}")
    ys, encs, slots = _chains(model, x)
    if stage_fusion == "stacked":
        y = torch.stack(ys)                               # [S, B, T, C]
        for i, dil in enumerate(_DILATIONS):
            y = fused_temporal_block_stacked(y, *_stage_weights([e.blocks[i] for e in encs]), dil)
        ys = list(y)
    elif stage_fusion in _CHAIN_GROUPS:
        for c, enc in enumerate(encs):
            for g in _CHAIN_GROUPS[stage_fusion]:
                ys[c] = fused_temporal_chain(
                    ys[c], *_stage_weights([enc.blocks[i] for i in g]),
                    dilations=tuple(_DILATIONS[i] for i in g), variant=conv_variant)
    else:
        for c, enc in enumerate(encs):
            for block in enc.blocks:
                ys[c] = block(ys[c], precision)
    ys = [enc.proj(y) for y, enc in zip(ys, encs)]
    attention = None if attn_impl == "xla" else (
        lambda q, k, v: mha_core(q, k, v, cfg.time_heads, precision=precision))
    return model.embed_tokens(model.modality_tokens(ys, slots), attention=attention)
