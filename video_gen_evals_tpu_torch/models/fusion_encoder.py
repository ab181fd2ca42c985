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
    dropout."""

    def __init__(self, rate: float, generator: torch.Generator,
                 rows: T.Optional[T.Tuple[int, int]] = None):
        self.keep = 1.0 - rate
        self.generator = generator
        self.rows = rows

    def mask(self, like: torch.Tensor) -> torch.Tensor:
        """Scaled keep mask of ``like``'s shape: 0 or 1/keep. With ``rows``
        drawn at the whole batch's shape (``like``'s window axis, the first,
        at ``total``) and cut to ``like``'s rows."""
        shape = like.shape if self.rows is None else (self.rows[1], *like.shape[1:])
        u = torch.rand(shape, generator=self.generator, device=like.device)
        if self.rows is not None:
            u = u[self.rows[0] : self.rows[0] + like.shape[0]]
        return (u < self.keep).to(like.dtype) / self.keep

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.mask(x)


def _drop(x: torch.Tensor, dropout: T.Optional[Dropout]) -> torch.Tensor:
    return x if dropout is None else dropout(x)


class _ConvWeight(nn.Module):
    """A bias-free Conv1d's parameter, ``weight [Cout, Cin, K]``; the forward
    is the caller's (a matmul for the stem, the fused kernel for the blocks)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel_size))


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
        w1 = self.conv1.weight.permute(2, 1, 0)   # [K, Cin, Cout]
        w2 = self.conv2.weight.permute(2, 1, 0)
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
        return x @ self.stem.weight[:, :, 0].t()

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
                dropout: T.Optional[Dropout] = None) -> torch.Tensor:
        D = m_tokens.shape[-1]
        kv = self.kv_ln(m_tokens)
        q = self.Wq(self.q_ln(self.latent))[0, 0]                 # [D], same for every frame
        K = self.Wk(kv)
        V = self.Wv(kv)
        logits = (K @ q) / math.sqrt(D)                           # [B, T, M]
        tau = F.softplus(self.logit_temp) + 1e-3
        A = _drop(torch.softmax(logits / tau + self.logit_bias, dim=-1), dropout)
        fused = (A.unsqueeze(-2) @ V).squeeze(-2)                 # [B, T, D]
        return self.Wo(fused)


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
    the caller hands an ``attention`` function of the q, k, v slices."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.n_heads = n_heads
        self.self_attn = _SelfAttention(d_model)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, dropout: T.Optional[Dropout] = None,
                attention: T.Optional[Attention] = None) -> torch.Tensor:
        B, S, D = x.shape
        H = self.n_heads
        hd = D // H
        qkv = F.linear(x, self.self_attn.in_proj_weight, self.self_attn.in_proj_bias)
        if attention is not None:
            ctx = attention(*qkv.chunk(3, dim=-1))
        else:
            q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            attn = _drop(torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1), dropout)
            ctx = (attn @ v).transpose(1, 2).reshape(B, S, D)
        x = self.norm1(x + _drop(self.self_attn.out_proj(ctx), dropout))
        h = _drop(F.relu(self.linear1(x)), dropout)
        h = _drop(self.linear2(h), dropout)
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
                rows: T.Optional[T.Tuple[int, int]] = None):
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
                     else flash_attend(cfg.time_heads, cfg.attention_impl))
        return self.embed_tokens(m_tokens, dropout, attention)

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
                     attention: T.Optional[Attention] = None):
        """The forward after the conv chains: per-frame fusion of the modality
        tokens ``[B, T, M, D]``, the CLS token, positions and the temporal
        transformer (its attention ``attention``, plain when None)."""
        B, Tlen = m_tokens.shape[:2]
        frame_tok = self.fusion(m_tokens, dropout)                # [B, T, D]
        tokens = torch.cat([self.cls.expand(B, 1, self.config.d_model), frame_tok], dim=1)
        tokens = tokens + self.pos_enc.pe[:, : Tlen + 1]
        for layer in self.temporal.layers:
            tokens = layer(tokens, dropout, attention)
        seq_embed = l2_normalize(tokens[:, 0, :], axis=-1)
        frame_embeds = l2_normalize(tokens, axis=-1)
        return seq_embed, frame_embeds, tokens
