"""SMPL token decoder head: the TokenHMR-equivalent mesh/pose/feature head.

Port of ``video_gen_evals_tpu/models/smpl_head.py`` (ref
``modifications/token_head.py:131-247``):

1. a zero input token cross-attends over the ViT patch tokens through a
   TransformerDecoder (dim 1024), yielding ``token_out [B, 1024]``, which is
   the "vit" modality stored per frame in the extraction npz;
2. linear readouts with iterative-error-feedback residual adds: global
   orientation as 6d (``decpose_grot``), body pose via a token classifier over
   a frozen VQ codebook (``decpose``), hands 12d, shape 10, cam 3;
3. rot6d -> rotation matrices and the global/body split.

Outputs match the extraction contract: ``body_pose [B,23,3,3]``,
``betas [B,10]``, ``global_orient [B,1,3,3]``, ``cam [B,3]``,
``token_out [B,1024]``.

The modules carry the upstream checkpoint's own names, the ones the JAX
package's ``torch_head_to_flax`` reads: ``transformer.to_token_embedding``,
``transformer.pos_embedding``, ``transformer.transformer.layers.{i}.{0,1,2}``
(self-attention, cross-attention, feed-forward, each a pre-norm wrapper with
``.norm`` and ``.fn``), ``decpose.*``, ``decpose_grot``, ``decpose_hands``,
``decshape``, ``deccam`` and the ``init_*`` buffers. Upstream checkpoints nest
the tokenizer decoder under varying prefixes; :func:`canonical_head_state_dict`
strips them by key suffix, as the JAX converter does, and any key that is
still unknown makes ``load_state_dict`` fail. LayerNorm eps is torch's 1e-5
here (1e-6 in the ViT), GELU is exact, and the decoder has no final norm.

The decoder's own attention has one query token; it is an einsum outside
any kernel in the JAX package and plain PyTorch here. Numerics
(``ops/precision.py``): activations float32, parameters float32 or
bfloat16-rounded, every product (the linear layers, both attention
products, the codebook's soft lookup) at the head's class
(:func:`..ops.precision.set_precision_`); the rotation matrices are
orthonormalised in float32, as at every class.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
from torch import nn

from ..ops.precision import LayerNorm, Linear, Precise, matmul
from ..ops.so3 import rot6d_to_rotmat


@dataclasses.dataclass(frozen=True)
class SMPLHeadConfig:
    dim: int = 1024
    context_dim: int = 1280
    depth: int = 6
    heads: int = 8
    dim_head: int = 64
    mlp_dim: int = 1024
    num_body_joints: int = 23       # SMPL body joints (pose output [23,3,3])
    # TokenClassfier geometry (ref token_head.py:160-164; the tokenizer decoder
    # follows the public PCT 'parts' layout). Real checkpoints carry their own:
    # see classifier_config_from_state_dict().
    token_num: int = 160            # VQ tokens for body pose
    token_class_num: int = 2048     # codebook size
    token_code_dim: int = 32        # codebook embedding dim
    dec_num_blocks: int = 1         # tokenizer-decoder MixerLayer count
    dec_hidden_dim: int = 32        # tokenizer-decoder channel width
    dec_token_inter_dim: int = 64   # token-mixing MLP inner width
    dec_hidden_inter_dim: int = 64  # channel MLP inner width
    ief_iters: int = 1

    @property
    def npose(self) -> int:
        return 6 * (self.num_body_joints + 1)  # 144: grot + 21 body + 2 hands

    @property
    def n_parts(self) -> int:
        return self.num_body_joints - 2  # 21 tokenized (non-hand) body joints


def _attend(q, k, v, heads: int, dim_head: int, precision: str) -> torch.Tensor:
    """softmax(q k^T * dim_head^-0.5) v on [B, N, heads * dim_head] tensors,
    both products at ``precision``."""
    B, Nq, inner = q.shape
    q, k, v = (t.reshape(B, t.shape[1], heads, dim_head).transpose(1, 2) for t in (q, k, v))
    attn = torch.softmax(matmul(q, k.transpose(-1, -2), precision) * dim_head ** -0.5, dim=-1)
    return matmul(attn, v, precision).transpose(1, 2).reshape(B, Nq, inner)


class _SelfAttention(Precise, nn.Module):
    """Upstream ``pose_transformer.Attention``: fused bias-free ``to_qkv``,
    scale ``dim_head**-0.5``, ``to_out`` with bias. The inner width
    (heads * dim_head, 512) need not equal ``dim`` (1024)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = Linear(dim, heads * dim_head * 3, bias=False)
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(_attend(q, k, v, self.heads, self.dim_head, self.precision))


class _CrossAttention(Precise, nn.Module):
    """Upstream ``pose_transformer.CrossAttention``: ``to_q`` from the token
    stream, fused ``to_kv`` from the context (both bias-free), ``to_out``."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, heads * dim_head, bias=False)
        self.to_kv = Linear(context_dim, heads * dim_head * 2, bias=False)
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(_attend(self.to_q(x), k, v, self.heads, self.dim_head, self.precision))


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 Linear(hidden, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fn = fn

    def forward(self, x: torch.Tensor, *args) -> torch.Tensor:
        return self.fn(self.norm(x), *args)


class _DecoderLayers(nn.Module):
    def __init__(self, cfg: SMPLHeadConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([
                _PreNorm(cfg.dim, _SelfAttention(cfg.dim, cfg.heads, cfg.dim_head)),
                _PreNorm(cfg.dim, _CrossAttention(cfg.dim, cfg.context_dim, cfg.heads, cfg.dim_head)),
                _PreNorm(cfg.dim, _FeedForward(cfg.dim, cfg.mlp_dim)),
            ]) for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        for self_attn, cross_attn, ff in self.layers:
            x = self_attn(x) + x
            x = cross_attn(x, context) + x
            x = ff(x) + x
        return x


class CrossAttentionDecoder(nn.Module):
    """The upstream ``TransformerDecoder`` the reference head instantiates
    (ref ``modifications/token_head.py:151-153``):

      x = to_token_embedding(token) + pos_embedding
      per layer: x = SA(LN(x)) + x ; x = CA(LN(x), ctx) + x ; x = FF(LN(x)) + x

    with no final layer norm."""

    def __init__(self, config: SMPLHeadConfig):
        super().__init__()
        self.to_token_embedding = Linear(1, config.dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, config.dim))
        self.transformer = _DecoderLayers(config)

    def forward(self, token: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.to_token_embedding(token)
        x = x + self.pos_embedding[:, : x.shape[1]]
        return self.transformer(x, context)


class _MixerMlp(nn.Module):
    def __init__(self, dim: int, inter: int):
        super().__init__()
        self.ff = nn.Sequential(Linear(dim, inter), nn.GELU(), nn.Dropout(0.0),
                                Linear(inter, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(x)


class _MixerLayer(nn.Module):
    """PCT's ``MixerLayer`` (Geng et al., CVPR 2023 ``models/modules.py``):
    token-mixing MLP then channel MLP, with the three-way residual
    ``out = x + y + z``."""

    def __init__(self, hidden_dim: int, hidden_inter_dim: int, token_dim: int, token_inter_dim: int):
        super().__init__()
        self.layernorm1 = LayerNorm(hidden_dim)
        self.MLP_token = _MixerMlp(token_dim, token_inter_dim)
        self.layernorm2 = LayerNorm(hidden_dim)
        self.MLP_channel = _MixerMlp(hidden_dim, hidden_inter_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.MLP_token(self.layernorm1(x).transpose(1, 2)).transpose(1, 2)   # over joints
        z = self.MLP_channel(self.layernorm2(x + y))
        return x + y + z


class TokenClassifier(Precise, nn.Module):
    """Body-pose token classifier over a frozen VQ tokenizer decoder (upstream
    TokenHMR ``TokenClassfier``; ref ``token_head.py:160-164,217``): a linear
    ``cls_head`` gives per-token class logits ``[B, token_num, classes]``; the
    softmax-expected codebook embedding feeds the PCT 'parts' decoder
    (``decoder_token_mlp`` mixes the tokens down to the 21 non-hand joints,
    ``decoder_start`` lifts the codes, MixerLayers, LayerNorm,
    ``recover_embed`` reads out 6d rotations) -> ``[B, 126]`` pose residuals."""

    def __init__(self, config: SMPLHeadConfig):
        super().__init__()
        self.config = cfg = config
        self.cls_head = Linear(cfg.dim, cfg.token_num * cfg.token_class_num)
        self.codebook = nn.Parameter(torch.zeros(cfg.token_class_num, cfg.token_code_dim))
        self.decoder_token_mlp = Linear(cfg.token_num, cfg.n_parts)
        self.decoder_start = Linear(cfg.token_code_dim, cfg.dec_hidden_dim)
        self.decoder = nn.ModuleList(
            _MixerLayer(cfg.dec_hidden_dim, cfg.dec_hidden_inter_dim, cfg.n_parts, cfg.dec_token_inter_dim)
            for _ in range(cfg.dec_num_blocks))
        self.decoder_layer_norm = LayerNorm(cfg.dec_hidden_dim)
        self.recover_embed = Linear(cfg.dec_hidden_dim, 6)

    def forward(self, token_out: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        B = token_out.shape[0]
        logits = self.cls_head(token_out).reshape(B, cfg.token_num, cfg.token_class_num)
        probs = torch.softmax(logits, dim=-1)
        codes = matmul(probs, self.codebook, self.precision)                # soft lookup
        x = self.decoder_token_mlp(codes.transpose(1, 2)).transpose(1, 2)   # [B, 21, C]
        x = self.decoder_start(x)
        for layer in self.decoder:
            x = layer(x)
        j6 = self.recover_embed(self.decoder_layer_norm(x))                 # [B, 21, 6]
        return j6.reshape(B, cfg.n_parts * 6), probs


class SMPLTokenDecoderHead(nn.Module):
    """Cross-attention SMPL decoder head with ``token_out`` exposed."""

    def __init__(self, config: SMPLHeadConfig):
        super().__init__()
        self.config = cfg = config
        self.transformer = CrossAttentionDecoder(cfg)
        self.decpose = TokenClassifier(cfg)
        self.decpose_grot = Linear(cfg.dim, 6)
        self.decpose_hands = Linear(cfg.dim, 12)
        self.decshape = Linear(cfg.dim, 10)
        self.deccam = Linear(cfg.dim, 3)
        self.register_buffer("init_body_pose", torch.zeros(1, cfg.npose))
        self.register_buffer("init_betas", torch.zeros(1, 10))
        self.register_buffer("init_cam", torch.zeros(1, 3))

    def forward(self, context_tokens: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """``context_tokens``: [B, N, context_dim] ViT patch tokens ->
        dict with body_pose / betas / global_orient / cam / token_out."""
        cfg = self.config
        B = context_tokens.shape[0]
        if context_tokens.shape[-1] != cfg.context_dim:
            raise ValueError(f"context tokens width {context_tokens.shape[-1]} != "
                             f"config.context_dim {cfg.context_dim}")
        pred_body_pose = self.init_body_pose.expand(B, -1)
        pred_betas = self.init_betas.expand(B, -1)
        pred_cam = self.init_cam.expand(B, -1)
        token_out = None
        for _ in range(cfg.ief_iters):
            token = context_tokens.new_zeros(B, 1, 1, dtype=torch.float32)   # zero input token
            token_out = self.transformer(token, context_tokens)[:, 0, :]
            body_6d, _probs = self.decpose(token_out)
            pred_body_pose = torch.cat(
                [self.decpose_grot(token_out), body_6d, self.decpose_hands(token_out)], dim=-1
            ) + pred_body_pose
            pred_betas = self.decshape(token_out) + pred_betas
            pred_cam = self.deccam(token_out) + pred_cam
        R = rot6d_to_rotmat(pred_body_pose.reshape(B, cfg.num_body_joints + 1, 6))
        return {
            "global_orient": R[:, :1],          # [B, 1, 3, 3]
            "body_pose": R[:, 1:],              # [B, 23, 3, 3]
            "betas": pred_betas,                # [B, 10]
            "cam": pred_cam,                    # [B, 3]
            "token_out": token_out,             # [B, 1024], the "vit" modality
        }


# tokenizer-decoder keys, recognised by suffix whatever prefix nests them
_DECPOSE_STEMS = ("codebook", "decoder_token_mlp", "decoder_start", "decoder_layer_norm",
                  "recover_embed")


def _decpose_canonical(key: str) -> T.Optional[str]:
    """The module's own name for a ``decpose.`` sub-key, or None."""
    parts = key.split(".")
    for i, part in enumerate(parts):
        if part in _DECPOSE_STEMS:
            return ".".join(parts[i:])
        if part == "decoder" and i + 1 < len(parts) and parts[i + 1].isdigit():
            return ".".join(parts[i:])
    return None


def canonical_head_state_dict(sd: T.Mapping[str, T.Any]) -> T.Dict[str, T.Any]:
    """An upstream head state_dict with the ``decpose.*`` keys renamed to the
    module's names: the tokenizer decoder by key suffix (``tokenizer.decoder_start``
    and ``decoder_start`` both become ``decpose.decoder_start``), and the one
    remaining 2-d ``.weight`` with its bias as ``decpose.cls_head``. Keys it
    does not recognise are passed through, so ``load_state_dict`` names them."""
    out: T.Dict[str, T.Any] = {}
    rest: T.Dict[str, T.Any] = {}
    for key, val in sd.items():
        if not key.startswith("decpose."):
            out[key] = val
            continue
        canon = _decpose_canonical(key[len("decpose."):])
        if canon is None:
            rest[key] = val
        elif f"decpose.{canon}" in out:
            raise ValueError(f"decpose: ambiguous keys for '{canon}'")
        else:
            out[f"decpose.{canon}"] = val
    heads = [k for k, v in rest.items() if k.endswith(".weight") and v.ndim == 2]
    if len(heads) == 1:
        stem = heads[0][: -len("weight")]
        out["decpose.cls_head.weight"] = rest.pop(heads[0])
        if stem + "bias" in rest:
            out["decpose.cls_head.bias"] = rest.pop(stem + "bias")
    out.update(rest)
    return out


def classifier_config_from_state_dict(sd: T.Mapping[str, T.Any], cfg: SMPLHeadConfig) -> SMPLHeadConfig:
    """The TokenClassfier geometry of ``cfg`` from a checkpoint's ``decpose.*``
    shapes (codebook [V, C], token MLP [J, N], decoder widths), so the module
    is built to match before the state_dict is loaded."""
    sub = {k[len("decpose."):]: v for k, v in sd.items() if k.startswith("decpose.")}
    if not sub:
        return cfg
    upd: T.Dict[str, int] = {}

    def shape(suffix):
        hits = [k for k in sub if k == suffix or k.endswith("." + suffix)]
        return tuple(sub[hits[0]].shape) if hits else None

    for suffix, fields in (
        ("codebook", ("token_class_num", "token_code_dim")),
        ("decoder_token_mlp.weight", (None, "token_num")),
        ("decoder_start.weight", ("dec_hidden_dim",)),
        ("decoder.0.MLP_token.ff.0.weight", ("dec_token_inter_dim",)),
        ("decoder.0.MLP_channel.ff.0.weight", ("dec_hidden_inter_dim",)),
    ):
        s = shape(suffix)
        if s is not None:
            upd.update({f: int(d) for f, d in zip(fields, s) if f is not None})
    n = 0
    while shape(f"decoder.{n}.layernorm1.weight") is not None:
        n += 1
    if n:
        upd["dec_num_blocks"] = n
    return dataclasses.replace(cfg, **upd)
