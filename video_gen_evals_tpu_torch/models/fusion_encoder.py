"""HumanActionScorer — the human-centric fusion encoder, as ``nn.Module``s.

Port of ``video_gen_evals_tpu/models/fusion_encoder.py`` and of its kernel
forward ``models/fused_apply.py::block_kernel_forward``, joined into one
forward: every residual conv stage runs through a fused kernel wrapper,
which launches the Hopper kernel for CUDA tensors and runs its plain version
for CPU tensors. In eval mode (``model.eval()``) that is the scoring stage
``ops.conv_kernel.fused_temporal_block``; in training mode
(``model.train()``) the trainable stage
``ops.conv_kernel_train.fused_temporal_block_train``, which has a backward.
:meth:`HumanActionScorer.set_conv_impl` ``("module")`` runs the training
stages as that kernel's plain version under autograd instead, on any device
(the train CLI's ``--conv-impl module``).

- :class:`TemporalConvBlock`       <- ref ``model.py:21-40``
- :class:`MovementConvEncoder`     <- ref ``model.py:43-58``
- :class:`PerFrameFusion`          <- ref ``model.py:61-98``
- :class:`TransformerEncoderLayer` <- torch ``nn.TransformerEncoderLayer``
  semantics (post-LN, ReLU, packed qkv), ref ``model.py:145-146``
- :class:`HumanActionScorer`       <- ref ``model.py:102-193``
- :func:`apply_with_attention`     <- the forward and its fusion attention
  map (ref ``model.py:77,94,148,185``)

Activations stay ``[B, T, C]`` throughout, as in JAX; the 1x1 stem is a
matmul. Parameter and buffer names follow the reference's state_dict
(``video_gen_evals_tpu/models/torch_compat.py``), including the
``pos_enc.pe`` buffer ``[1, 5000, d_model]``, so a reference ``.pt`` loads
with ``load_state_dict(strict=True)``. Conv weights keep the reference's
``[Cout, Cin, K]`` layout and are viewed as ``[K, Cin, Cout]`` for the kernel.

``EncoderConfig.attention_impl`` picks the temporal transformer's attention
in eval mode, as in JAX: ``"xla"`` (the default) the plain matmul + softmax,
``"pallas"`` / ``"pallas_bf16"`` the flash-attention kernel (K8,
``ops/attention.py::flash_attention``) at ``"highest"`` / ``"default"``,
``"pallas_interpret"`` its plain version (the reference computation the JAX
name stands for). Training mode keeps the plain attention, whose weights
take dropout.

Training mode applies dropout at the JAX module's places: after GELU(conv1)
inside each conv stage (in the kernel, as a scaled keep mask), on the fusion
attention weights, and on the transformer's attention weights, attention
output, FFN hidden and FFN output. Every mask is drawn from the explicit
``torch.Generator`` handed to ``forward``, which lives on the input's device.
Every masked tensor has the window axis first. A data-parallel rank that
forwards rows ``[lo, lo + B)`` of an ``N``-window batch passes ``rows=(lo,
N)``: each mask is then drawn at the whole batch's shape, in the same order,
and the rank keeps its own rows, so N ranks drop what one rank drops.

Tensor parallelism (:meth:`HumanActionScorer.shard_`, on a grid's model
axis; ``parallel/tensor.py``): the model keeps its rank's blocks of the
sharded parameters, the transformer runs column-parallel ``in_proj`` (by
heads) and ``linear1`` and row-parallel ``out_proj`` and ``linear2``, and
the conv stages gather their kernels and run whole. The dropout masks of the
attention weights and the FFN hidden are drawn at the one-rank shape too and
cut to the rank's heads and columns, so a model axis of any length drops
what one rank drops. :meth:`~HumanActionScorer.full_state_dict` gathers the
whole tree, :meth:`~HumanActionScorer.load_full_state_dict` slices one.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, flash_attention_plain
from ..ops.conv_kernel import fused_temporal_block
from ..ops.conv_kernel_train import fused_temporal_block_train, fused_temporal_block_train_plain
from ..ops.deltas import l2_normalize
from ..parallel.mesh import Rank
from ..parallel.tensor import (
    TensorParallel,
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)

DimsMap = T.Mapping[str, int]

_DILATIONS = (1, 2, 4, 8)
_KERNEL = 5
_PE_MAX_LEN = 5000  # ref model.py:8-16
ATTENTION_IMPLS = ("xla", "pallas", "pallas_bf16", "pallas_interpret")

# q, k, v [B, S, D] column slices of the packed projection -> context [B, S, D]
Attention = T.Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Hyperparameters of the fusion encoder (ref ``model.py:102-110``)."""

    dims_map_raw: T.Tuple[T.Tuple[str, int], ...]
    dims_map_diff: T.Tuple[T.Tuple[str, int], ...]
    d_model: int = 256
    time_layers: int = 4
    time_heads: int = 8
    dropout: float = 0.1   # training mode only
    # the temporal transformer's attention in eval mode (ATTENTION_IMPLS)
    attention_impl: str = "xla"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, "
                             f"got {self.attention_impl!r}")

    @classmethod
    def create(cls, dims_map_raw: DimsMap, dims_map_diff: DimsMap, **kw) -> "EncoderConfig":
        if set(dims_map_raw.keys()) != set(dims_map_diff.keys()):
            raise ValueError(
                "dims_map_raw and dims_map_diff must have the same modality keys."
            )
        return cls(
            dims_map_raw=tuple((m, int(d)) for m, d in dims_map_raw.items()),
            dims_map_diff=tuple((m, int(dims_map_diff[m])) for m, _ in dims_map_raw.items()),
            **kw,
        )

    @property
    def modalities(self) -> T.Tuple[str, ...]:
        return tuple(m for m, _ in self.dims_map_raw)

    @property
    def one_pass_raw(self) -> int:
        return sum(d for _, d in self.dims_map_raw)

    @property
    def one_pass_diff(self) -> int:
        return sum(d for _, d in self.dims_map_diff)

    @property
    def has_diff(self) -> bool:
        return any(d > 0 for _, d in self.dims_map_diff)

    @property
    def input_dim(self) -> int:
        return self.one_pass_raw + (self.one_pass_diff if self.has_diff else 0)

    def has_motion(self, modality: str) -> bool:
        return self.has_diff and dict(self.dims_map_diff)[modality] > 0


def sinusoidal_positional_embedding(length: int, d_model: int) -> torch.Tensor:
    """Fixed sin/cos table ``[length, d_model]``: even dims sin, odd dims cos
    (ref ``model.py:8-19``). Computed exactly as the reference buffer that
    ``torch_compat.flax_params_to_torch_state_dict`` emits."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class Dropout:
    """What one training forward needs to drop activations: the rate, the
    generator its masks come from and, for a data-parallel rank, its rows
    ``(lo, total)`` of the whole batch. ``None`` in its place means no
    dropout. A tensor-parallel layer passes its ``split`` ``(dim, lo,
    total)``: the mask is drawn at ``total`` along ``dim`` and cut to the
    rank's block from ``lo``."""

    def __init__(self, rate: float, generator: torch.Generator,
                 rows: T.Optional[T.Tuple[int, int]] = None):
        self.keep = 1.0 - rate
        self.generator = generator
        self.rows = rows

    def mask(self, like: torch.Tensor, split: T.Optional[T.Tuple[int, int, int]] = None) -> torch.Tensor:
        """Scaled keep mask of ``like``'s shape: 0 or 1/keep. With ``rows``
        drawn at the whole batch's shape (``like``'s window axis, the first,
        at ``total``) and cut to ``like``'s rows; with ``split`` likewise
        along its axis."""
        shape = list(like.shape)
        if self.rows is not None:
            shape[0] = self.rows[1]
        if split is not None:
            shape[split[0]] = split[2]
        u = torch.rand(shape, generator=self.generator, device=like.device)
        if self.rows is not None:
            u = u[self.rows[0] : self.rows[0] + like.shape[0]]
        if split is not None:
            u = u.narrow(split[0], split[1], like.shape[split[0]])
        return (u < self.keep).to(like.dtype) / self.keep

    def __call__(self, x: torch.Tensor, split: T.Optional[T.Tuple[int, int, int]] = None) -> torch.Tensor:
        return x * self.mask(x, split)


def _drop(x: torch.Tensor, dropout: T.Optional[Dropout],
          split: T.Optional[T.Tuple[int, int, int]] = None) -> torch.Tensor:
    return x if dropout is None else dropout(x, split)


class _ConvWeight(nn.Module):
    """A bias-free Conv1d's parameter, ``weight [Cout, Cin, K]``; the forward
    is the caller's (a matmul for the stem, the fused kernel for the blocks).
    Under tensor parallelism it may hold the rank's output channels only,
    and :meth:`full` gathers the whole kernel."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel_size))
        self.tp: T.Optional[TensorParallel] = None   # set where the weight is sharded

    def full(self) -> torch.Tensor:
        return self.weight if self.tp is None else gather_from_model(self.weight, self.tp, 0)


class _Affine(nn.Module):
    """GroupNorm's affine parameters, ``weight [C]`` and ``bias [C]``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class TemporalConvBlock(nn.Module):
    """Residual dilated conv pair, GELU, GroupNorm(1) (ref ``model.py:21-40``),
    as one fused call: the scoring kernel in eval mode (``precision``
    "default", "high" or "highest"), the trainable kernel with its dropout
    mask in training mode (``precision`` "default" or "highest"), or with
    ``train_impl = "module"`` that kernel's plain version under autograd."""

    def __init__(self, channels: int, dilation: int = 1, kernel_size: int = _KERNEL):
        super().__init__()
        self.dilation = dilation
        self.train_impl = "kernel"
        self.conv1 = _ConvWeight(channels, channels, kernel_size)
        self.conv2 = _ConvWeight(channels, channels, kernel_size)
        self.norm = _Affine(channels)

    def forward(self, x: torch.Tensor, precision: str = "highest",
                dropout: T.Optional[Dropout] = None) -> torch.Tensor:
        w1 = self.conv1.full().permute(2, 1, 0)   # [K, Cin, Cout]
        w2 = self.conv2.full().permute(2, 1, 0)
        if self.training:
            mask = None if dropout is None else dropout.mask(x)
            train = fused_temporal_block_train_plain if self.train_impl == "module" else fused_temporal_block_train
            return train(x, w1, w2, self.norm.weight, self.norm.bias, mask, self.dilation, precision)
        return fused_temporal_block(
            x, w1, w2, self.norm.weight, self.norm.bias, self.dilation, precision)


class MovementConvEncoder(nn.Module):
    """Per-modality temporal encoder: 1x1 stem -> dilated blocks -> linear proj
    (ref ``model.py:43-58``)."""

    def __init__(self, d_in: int, d_out: int, dilations: T.Sequence[int] = _DILATIONS):
        super().__init__()
        self.stem = _ConvWeight(d_in, d_out, 1)
        self.blocks = nn.ModuleList(TemporalConvBlock(d_out, d) for d in dilations)
        self.proj = nn.Linear(d_out, d_out, bias=False)

    def apply_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 stem: ``[B, T, d_in] -> [B, T, d_out]``."""
        return x @ self.stem.full()[:, :, 0].t()

    def forward(self, x: torch.Tensor, precision: str = "highest",
                dropout: T.Optional[Dropout] = None) -> torch.Tensor:
        y = self.apply_stem(x)
        for block in self.blocks:
            y = block(y, precision, dropout)
        return self.proj(y)


class PerFrameFusion(nn.Module):
    """One learned latent query cross-attends over the M modality tokens of
    each frame, with per-modality learned temperature and logit bias
    (ref ``model.py:61-98``)."""

    def __init__(self, d_model: int, n_modalities: int):
        super().__init__()
        self.latent = nn.Parameter(torch.empty(1, 1, d_model))
        self.q_ln = nn.LayerNorm(d_model, eps=1e-5)
        self.kv_ln = nn.LayerNorm(d_model, eps=1e-5)
        self.Wq = nn.Linear(d_model, d_model, bias=False)
        self.Wk = nn.Linear(d_model, d_model, bias=False)
        self.Wv = nn.Linear(d_model, d_model, bias=False)
        self.Wo = nn.Linear(d_model, d_model, bias=False)
        self.logit_temp = nn.Parameter(torch.zeros(n_modalities))
        self.logit_bias = nn.Parameter(torch.zeros(n_modalities))

    def forward(self, m_tokens: torch.Tensor,                    # [B, T, M, D]
                dropout: T.Optional[Dropout] = None) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """``(fused frame tokens [B, T, D], attention map [B, T, M])``; the
        map is the softmax before dropout (the reference's ``last_attn``)."""
        D = m_tokens.shape[-1]
        kv = self.kv_ln(m_tokens)
        q = self.Wq(self.q_ln(self.latent))[0, 0]                 # [D], same for every frame
        K = self.Wk(kv)
        V = self.Wv(kv)
        logits = (K @ q) / math.sqrt(D)                           # [B, T, M]
        tau = F.softplus(self.logit_temp) + 1e-3
        A = torch.softmax(logits / tau + self.logit_bias, dim=-1)
        fused = (_drop(A, dropout).unsqueeze(-2) @ V).squeeze(-2)  # [B, T, D]
        return self.Wo(fused), A


class _SelfAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed q, k, v projection)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)


def flash_attend(heads: int, impl: str) -> Attention:
    """The attention of ``EncoderConfig.attention_impl`` ``impl`` (not
    ``"xla"``) on ``[B, S, D]`` slices, through ``[B, S, H, hd]`` views."""
    def attend(q, k, v):
        B, S, D = q.shape
        q4, k4, v4 = (t.reshape(B, S, heads, D // heads) for t in (q, k, v))
        if impl == "pallas_interpret":
            ctx = flash_attention_plain(q4, k4, v4)
        else:
            ctx = flash_attention(q4, k4, v4, precision="default" if impl == "pallas_bf16" else "highest")
        return ctx.reshape(B, S, D)
    return attend


class TransformerEncoderLayer(nn.Module):
    """``nn.TransformerEncoderLayer`` semantics: post-LN, ReLU FFN, packed
    qkv; attention is a plain matmul + softmax, as the JAX einsum path, unless
    the caller hands an ``attention`` function of the q, k, v slices. Under
    tensor parallelism (``tp`` set) the sharded projections hold the rank's
    blocks."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.tp: T.Optional[TensorParallel] = None
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, dropout: T.Optional[Dropout] = None,
                attention: T.Optional[Attention] = None) -> torch.Tensor:
        """Under tensor parallelism the layer runs Megatron's way
        (``parallel/tensor.py``): the same function, with the masks of the
        one-rank forward cut to this rank's heads and FFN columns. A
        projection is sharded where its weight's shape is a block's."""
        tp = self.tp
        B, S, D = x.shape
        H = self.n_heads
        hd = D // H
        sa = self.self_attn
        if sa.in_proj_weight.shape[0] != 3 * D:            # column-parallel
            qkv = F.linear(copy_to_model(x, tp), sa.in_proj_weight, sa.in_proj_bias)
            if not tp.by_heads:                            # a block of rows: gathered, attended whole
                qkv = gather_from_model(qkv, tp, 2)
        else:
            qkv = F.linear(x, sa.in_proj_weight, sa.in_proj_bias)
        hl = qkv.shape[-1] // (3 * hd)                     # this rank's heads
        local = hl != H
        if attention is not None:
            ctx = attention(*qkv.chunk(3, dim=-1))
        else:
            q, k, v = (t.reshape(B, S, hl, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            attn = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
            attn = _drop(attn, dropout, (1, tp.index * hl, H) if local else None)
            ctx = (attn @ v).transpose(1, 2).reshape(B, S, hl * hd)
        if sa.out_proj.weight.shape[1] != D:               # row-parallel
            if not local:
                ctx = scatter_to_model(ctx, tp, 2)
            out = reduce_from_model(F.linear(ctx, sa.out_proj.weight), tp) + sa.out_proj.bias
        else:
            out = sa.out_proj(ctx)
        x = self.norm1(x + _drop(out, dropout))
        if self.linear1.weight.shape[0] != self.d_ff:     # column- then row-parallel
            h = F.relu(F.linear(copy_to_model(x, tp), self.linear1.weight, self.linear1.bias))
            h = _drop(h, dropout, (2, tp.index * h.shape[-1], self.d_ff))
            h = reduce_from_model(F.linear(h, self.linear2.weight), tp) + self.linear2.bias
        else:
            h = self.linear2(_drop(F.relu(self.linear1(x)), dropout))
        h = _drop(h, dropout)
        return self.norm2(x + h)


class _TemporalStack(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, n_heads, 4 * d_model) for _ in range(n_layers)
        )


class _PositionalEncoding(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.register_buffer("pe", sinusoidal_positional_embedding(_PE_MAX_LEN, d_model)[None])


class HumanActionScorer(nn.Module):
    """Fusion encoder over concatenated raw || diff multi-modal features
    (ref ``model.py:102-193``).

    Input ``x``: ``[B, T, D]``, raw block first, modalities in the order of
    the dims map. Returns ``(seq_embed [B, d_model], frame_embeds
    [B, T+1, d_model], tokens [B, T+1, d_model])``, both embeds L2-normalized.
    ``precision`` selects the conv-stage kernel's arithmetic: in eval mode
    "default" (bf16 operands, fp32 sums), "high" (bf16x3) or "highest"
    (fp32), in training mode "default" or "highest"; every other matmul runs
    in fp32.
    In training mode with ``config.dropout > 0`` the masks come from
    ``generator``, which must live on ``x``'s device; ``rows`` (a
    data-parallel rank's ``(lo, total)``) draws them at the whole batch's
    shape (:class:`Dropout`). A new model is in eval mode.
    """

    def __init__(self, config: EncoderConfig, generator: T.Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        d = config.d_model
        self.state_enc = nn.ModuleDict(
            {m: MovementConvEncoder(rd, d) for m, rd in config.dims_map_raw}
        )
        self.motion_enc = nn.ModuleDict(
            {m: MovementConvEncoder(dd, d) for m, dd in config.dims_map_diff
             if config.has_motion(m)}
        )
        self.fusion = PerFrameFusion(d, len(config.modalities))
        self.cls = nn.Parameter(torch.empty(1, 1, d))
        self.temporal = _TemporalStack(d, config.time_heads, config.time_layers)
        self.pos_enc = _PositionalEncoding(d)
        self.tp: T.Optional[TensorParallel] = None
        self.reset_parameters(generator)
        # a new model scores: the trainer switches to training mode itself
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: T.Optional[torch.Generator] = None) -> None:
        """Seeded random init: weight matrices and conv kernels N(0, 1/fan_in),
        latent and cls N(0, 1), norm scales 1, biases and logit params 0."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ("cls", "fusion.latent"):
                p.copy_(torch.randn(p.shape, generator=generator))
            elif p.ndim >= 2:
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            elif leaf == "weight":   # LayerNorm / GroupNorm scales
                p.fill_(1.0)
            else:
                p.zero_()

    def shard_(self, rank: Rank) -> "HumanActionScorer":
        """Keep only ``rank``'s blocks of the parameters that a model axis of
        ``rank.world`` ranks shards (``rank``: the rank within the axis,
        ``parallel.Rank.model``), and run the forward tensor-parallel over
        its group from now on. Call it on the whole model, the same on every
        rank of the axis, before an optimizer is built."""
        if self.tp is not None:
            raise ValueError("the model is sharded already")
        if rank.world == 1:
            return self
        tp = TensorParallel(rank, self.config.time_heads, {n: tuple(p.shape) for n, p in self.named_parameters()})
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.data = tp.shard(name, p.data)
        for name, m in self.named_modules():
            if isinstance(m, TransformerEncoderLayer) or (isinstance(m, _ConvWeight) and tp.sharded(f"{name}.weight")):
                m.tp = tp
        self.tp = tp
        return self

    def full_state_dict(self) -> T.Dict[str, torch.Tensor]:
        """The whole state_dict: the sharded parameters gathered over the
        model axis (a collective under tensor parallelism: every rank of the
        axis calls it), in the reference's names and layouts."""
        sd = self.state_dict()
        if self.tp is None:
            return sd
        return {k: self.tp.gather(k, v) for k, v in sd.items()}

    def load_full_state_dict(self, state_dict: T.Mapping[str, torch.Tensor], strict: bool = True):
        """Load a whole state_dict (as :meth:`full_state_dict` gives it, or a
        reference checkpoint), each sharded parameter cut to this rank's block."""
        if self.tp is not None:
            state_dict = {k: self.tp.shard(k, v) for k, v in state_dict.items()}
        return self.load_state_dict(state_dict, strict=strict)

    def attention_heads(self) -> int:
        """The heads this rank attends over: all of them, or under tensor
        parallelism by heads its share."""
        if self.tp is not None and self.tp.by_heads:
            return self.config.time_heads // self.tp.size
        return self.config.time_heads

    def set_conv_impl(self, impl: str) -> None:
        """The training conv stages: ``"kernel"`` (K4 through its autograd
        Function; its plain version for CPU tensors) or ``"module"`` (K4's
        plain version under autograd on any device)."""
        if impl not in ("kernel", "module"):
            raise ValueError(f"conv impl must be 'kernel' or 'module', got {impl!r}")
        for m in self.modules():
            if isinstance(m, TemporalConvBlock):
                m.train_impl = impl

    def forward(self, x: torch.Tensor, precision: str = "highest",
                generator: T.Optional[torch.Generator] = None,
                rows: T.Optional[T.Tuple[int, int]] = None, with_attention: bool = False):
        """``(seq_embed [B, D], frame_embeds [B, T+1, D], tokens [B, T+1, D])``
        of the windows ``x [B, T, input_dim]``; with ``with_attention``,
        ``(those, fusion attention map [B, T, M])`` (:func:`apply_with_attention`)."""
        cfg = self.config
        dropout = None
        if self.training and cfg.dropout > 0.0:
            if generator is None:
                raise ValueError("training mode with dropout needs a torch.Generator")
            dropout = Dropout(cfg.dropout, generator, rows)
        chains = self.chain_inputs(x)
        m_tokens = self.modality_tokens(
            (enc(xin, precision, dropout) for enc, xin, _slot in chains),   # one chain at a time
            [slot for _enc, _xin, slot in chains])
        attention = (None if self.training or cfg.attention_impl == "xla"
                     else flash_attend(self.attention_heads(), cfg.attention_impl))
        return self.embed_tokens(m_tokens, dropout, attention, with_attention)

    def chain_inputs(self, x: torch.Tensor
                     ) -> T.List[T.Tuple[MovementConvEncoder, torch.Tensor, int]]:
        """The conv chains of the input ``x [B, T, input_dim]`` in the forward's
        order (per modality its raw chain, then its diff chain where it has
        motion): ``(encoder, its input slice [B, T, d_in], modality slot)``."""
        cfg = self.config
        if x.shape[-1] != cfg.input_dim:
            raise ValueError(f"expected input dim {cfg.input_dim}, got {x.shape[-1]}")
        opr = cfg.one_pass_raw
        diff_dims = dict(cfg.dims_map_diff)
        chains = []
        r_off = d_off = 0
        for slot, (m, rd) in enumerate(cfg.dims_map_raw):
            chains.append((self.state_enc[m], x[:, :, r_off : r_off + rd], slot))
            r_off += rd
            dd = diff_dims[m]
            if cfg.has_motion(m):
                chains.append((self.motion_enc[m], x[:, :, opr + d_off : opr + d_off + dd], slot))
            d_off += dd
        return chains

    def modality_tokens(self, ys: T.Iterable[torch.Tensor], slots: T.Sequence[int]) -> torch.Tensor:
        """The chains' outputs ``ys`` summed per modality slot (raw + diff, in
        that order), each through a non-affine layer norm over the feature dim
        (ref ``model.py:175``), as ``[B, T, M, D]``."""
        sums: T.List[T.Optional[torch.Tensor]] = [None] * len(self.config.modalities)
        for y, slot in zip(ys, slots):
            sums[slot] = y if sums[slot] is None else sums[slot] + y
        per_mod = []
        for s in sums:
            mu = s.mean(dim=-1, keepdim=True)
            var = ((s - mu) ** 2).mean(dim=-1, keepdim=True)
            per_mod.append((s - mu) / torch.sqrt(var + 1e-5))
        return torch.stack(per_mod, dim=2)

    def embed_tokens(self, m_tokens: torch.Tensor, dropout: T.Optional[Dropout] = None,
                     attention: T.Optional[Attention] = None, with_attention: bool = False):
        """The forward after the conv chains: per-frame fusion of the modality
        tokens ``[B, T, M, D]``, the CLS token, positions and the temporal
        transformer (its attention ``attention``, plain when None). With
        ``with_attention``, ``(outputs, the fusion's attention map)``."""
        B, Tlen = m_tokens.shape[:2]
        frame_tok, attn = self.fusion(m_tokens, dropout)          # [B, T, D], [B, T, M]
        tokens = torch.cat([self.cls.expand(B, 1, self.config.d_model), frame_tok], dim=1)
        tokens = tokens + self.pos_enc.pe[:, : Tlen + 1]
        for layer in self.temporal.layers:
            tokens = layer(tokens, dropout, attention)
        seq_embed = l2_normalize(tokens[:, 0, :], axis=-1)
        frame_embeds = l2_normalize(tokens, axis=-1)
        outputs = (seq_embed, frame_embeds, tokens)
        return (outputs, attn) if with_attention else outputs


def apply_with_attention(model: HumanActionScorer, x: torch.Tensor, precision: str = "highest"):
    """``((seq_embed, frame_embeds, tokens), attn [B, T, M])``: the forward in
    eval mode under ``torch.no_grad()`` and the per-frame fusion attention
    map, the softmax before dropout. The reference keeps the map on the
    module as ``last_attn`` (ref ``model.py:77,94,148,185``); here it comes
    out of the same single pass, and nothing is left on the module. The
    module's training mode is restored after the call."""
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(x, precision, with_attention=True)
    finally:
        model.train(training)
