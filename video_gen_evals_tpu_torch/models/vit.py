"""ViT backbone (ViTPose/ViT-H style) of the TokenHMR-equivalent mesh recovery.

Port of ``video_gen_evals_tpu/models/vit.py``. The reference's backbone is an
external torch ViT-H (patch 16, width 1280, depth 32, 16 heads, 256x192 input
-> a 16x12 patch grid, no class token; ref ``modifications/mesh_generator.py:46-56``).
The modules here carry that checkpoint's own parameter names
(``patch_embed.proj``, ``pos_embed``, ``blocks.{i}.norm1``,
``blocks.{i}.attn.qkv``, ``blocks.{i}.attn.proj``, ``blocks.{i}.norm2``,
``blocks.{i}.mlp.fc1``, ``blocks.{i}.mlp.fc2``, ``norm``), so a published
state_dict loads with ``load_state_dict`` and no renaming.

Pre-LN blocks (LayerNorm eps 1e-6) with exact-GELU MLPs. The entry takes the
``[B, H, W, 3]`` crops the JAX module takes and returns the ``[B, h*w, C]``
tokens and the channel-first ``[B, C, h, w]`` map.

``ViTConfig.attention_impl`` picks the attention of every block:

- ``"core"`` (the default): :func:`..ops.attention_core.mha_core` (K6) on the
  three column slices of the qkv projection, read in place;
- ``"head_batched"``: :func:`..ops.attention_core.mha_head_batched` (K7);
- ``"flash"`` / ``"flash_bf16"``: :func:`..ops.attention.flash_attention` (K8);
- ``"plain"``: the einsum of the JAX module's default branch.

The JAX module defaults to its einsum branch because XLA fuses it on the
TPU; PyTorch runs eagerly, and the JAX package's own answer for this regime
is the layout-preserving kernel. The kernels run at ``"highest"`` on float32
activations and at ``"default"`` on bfloat16 ones (``"flash_bf16"`` asks for
``"default"`` whatever the dtype); on CPU tensors they run their plain
versions. The JAX module's per-block ``block_precision`` schedule is not
ported.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.attention_core import mha_core, mha_head_batched

ATTENTION_IMPLS = ("core", "head_batched", "flash", "flash_bf16", "plain")
_LN_EPS = 1e-6   # the ViT's LayerNorms; the SMPL head uses torch's 1e-5


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: T.Tuple[int, int] = (256, 192)
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    use_cls_token: bool = False
    final_norm: bool = True
    attention_impl: str = "core"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}: "
                             f"expected one of {ATTENTION_IMPLS}")

    @property
    def grid(self) -> T.Tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        h, w = self.grid
        return h * w


def _kernel_precision(x: torch.Tensor) -> str:
    return "default" if x.dtype == torch.bfloat16 else "highest"


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attention_impl: str):
        super().__init__()
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x)
        impl = self.attention_impl
        if impl in ("core", "head_batched"):
            # the qkv weight's columns are head-major inside each third, so
            # the three slices are [B, N, H * hd] as the kernels take them
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
            fn = mha_core if impl == "core" else mha_head_batched
            ctx = fn(q, k, v, heads=H, precision=_kernel_precision(x))
        else:
            q, k, v = qkv.reshape(B, N, 3, H, D // H).unbind(dim=2)
            if impl == "plain":
                attn = torch.softmax(
                    torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D // H), dim=-1)
                ctx = torch.einsum("bhqk,bkhd->bqhd", attn, v)
            else:
                if impl == "flash" and x.dtype == torch.bfloat16:
                    impl = "flash_bf16"
                ctx = multihead_attention(q, k, v, impl=impl)
            ctx = ctx.reshape(B, N, D)
        return self.proj(ctx)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attention_impl: str = "core"):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.attn = _Attention(dim, num_heads, attention_impl)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ViTBackbone(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = cfg = config
        self.patch_embed = _PatchEmbed(cfg.patch_size, cfg.embed_dim)
        n_pos = cfg.num_patches + (1 if cfg.use_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, cfg.embed_dim))
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.attention_impl)
            for _ in range(cfg.depth))
        if cfg.final_norm:
            self.norm = nn.LayerNorm(cfg.embed_dim, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """``x``: [B, H, W, 3] normalised crops ->
        (tokens [B, h*w, C], feature map [B, C, h, w])."""
        cfg = self.config
        fmap = self.patch_embed(x.permute(0, 3, 1, 2))            # [B, C, h, w]
        B, C, h, w = fmap.shape
        tokens = fmap.flatten(2).transpose(1, 2)                   # [B, h*w, C]
        if cfg.use_cls_token:
            tokens = torch.cat([self.cls_token.expand(B, 1, C), tokens], dim=1)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for blk in self.blocks:
            tokens = blk(tokens)
        if cfg.final_norm:
            tokens = self.norm(tokens)
        if cfg.use_cls_token:
            tokens = tokens[:, 1:]
        return tokens, tokens.reshape(B, h, w, C).permute(0, 3, 1, 2)
