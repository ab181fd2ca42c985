"""DWPose's whole-body 2D pose net (RTMPose) and the conv blocks of the
extraction networks, with DWPose's postprocessing, batched over frames.

Port of ``video_gen_evals_tpu/models/pose2d.py``. The building blocks
(:class:`BatchNormInference`, :class:`ConvBN`, :class:`SPPBottleneck`) are
shared with the Faster R-CNN and YOLOX. :class:`RTMPoseNet` is RTMPose's
published architecture: the CSPNeXt backbone (a 3-conv stem, CSP stages of
CSPNeXt blocks with channel attention, SPP on the last stage) and the RTMCC
head (a 7x7 conv to per-keypoint token maps, ScaleNorm and a linear token
MLP, one gated attention unit, bias-free SimCC classifiers), decoded as
mmpose's ``get_simcc_maximum``. The module tree carries mmpose's state_dict
names (``backbone.stem.0.conv.weight``, ``backbone.stage4.1.conv1...`` for the
SPP, ``...blocks.0.conv2.depthwise_conv...``, ``head.gau.res_scale.scale``),
so a published DWPose ``dwpose_l`` checkpoint loads with
``load_state_dict(strict=True)``; ``models/torch_compat.py::
pose_state_dict_from_jax_tree`` carries the JAX package's tree across. The
JAX modules work on NHWC; these on NCHW, which flattens the token map as
JAX's ``[B, h, w, K] -> [B, K, h * w]`` does with no transpose. JAX runs the
convolutions and the GAU's two products as XLA ops outside any Pallas
kernel, as ``ops/precision.py``'s library calls run them here: activations
float32, parameters float32 or bfloat16-rounded, every product at the net's
class (:func:`..ops.precision.set_precision_`), except that
:class:`RTMPoseNet` keeps its head and channel-attention gates at fp32
products at every class.

:func:`wholebody_to_openpose`, :func:`dwpose_postprocess` and
:func:`flatten_first_person` are DWPose's conversion and the reference's
120-d flatten (ref ``dwpose_init.py:42-64``, ``process_video.py:23-57``),
taking any leading axes before the person axis where JAX takes one frame.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import Conv2d, Linear, Precise, matmul, set_precision_


class BatchNormInference(nn.Module):
    """detectron2's ``FrozenBatchNorm2d`` on NCHW input: ``(x - mean) *
    (weight * rsqrt(var + eps)) + bias``, the statistics fixed buffers
    with detectron2's names (``weight``, ``bias``, ``running_mean``,
    ``running_var``). The JAX module computes the same affine map on NHWC."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_statistics(self) -> None:
        """The identity map: weight and variance one, bias and mean zero."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # each op of the scale in fp32, rounded to the statistics' type
        dt = self.running_var.dtype
        var = (self.running_var.float() + self.eps).to(dt).float()
        scale = (self.weight.float() * torch.rsqrt(var).to(dt).float()).to(dt)
        return (x - self.running_mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class TrackedBatchNorm(BatchNormInference):
    """:class:`BatchNormInference` under ``nn.BatchNorm2d``'s state_dict
    names, which include the training counter ``num_batches_tracked``
    (loaded, never read), so that mmcv and Megvii checkpoints load strictly."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps)
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))


class ConvBN(nn.Module):
    """mmcv ``ConvModule`` / Megvii ``BaseConv``: ``Conv2d(bias=False)``, the
    frozen norm, SiLU; padding ``kernel // 2``. Names ``conv.*`` and ``bn.*``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = TrackedBatchNorm(cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling: a 1x1 conv to half the channels, max pools of
    ``kernel_sizes`` at stride 1 (padded with -inf, as flax's ``max_pool``
    pads), the input and the pools concatenated, a 1x1 conv to ``cout``.
    Megvii's names: ``conv1``, ``conv2`` (its ``m`` pools hold no weights)."""

    def __init__(self, cin: int, cout: int, kernel_sizes: T.Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        mid = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvBN(cin, mid, kernel=1)
        self.conv2 = ConvBN(mid * (len(self.kernel_sizes) + 1), cout, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, stride=1, padding=k // 2) for k in self.kernel_sizes]
        return self.conv2(torch.cat([x, *pools], dim=1))


def calibrate_norms_(model: nn.Module, norms: T.Sequence[BatchNormInference], *inputs,
                     var_floor: float = 0.0) -> None:
    """Set each frozen norm, in the order ``model(*inputs)`` reaches it, to the
    mean and variance of its input over the batch, so that its output has
    zero mean and unit variance on that batch. Each variance is at least
    ``var_floor`` times the mean of the norm's variances: a channel that is
    near constant on the batch would otherwise be scaled up without bound."""

    def calibrate(norm, args):
        x = args[0].float()
        var = x.var(dim=(0, 2, 3))
        norm.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        norm.running_var.copy_(var.clamp_min(var_floor * var.mean().item()))

    hooks = [norm.register_forward_pre_hook(calibrate) for norm in norms]
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()


# ---------------------------------------------------------------------------
# RTMPose (DWPose's wholebody net)

NUM_WHOLEBODY_KPTS = 133    # COCO-wholebody
NUM_OPENPOSE_KPTS = 134     # after the neck is inserted

# mmpose -> openpose body order (DWPose's Wholebody conversion)
_MMPOSE_IDX = (17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3)
_OPENPOSE_IDX = (1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17)


@dataclasses.dataclass(frozen=True)
class PoseNetConfig:
    """RTMPose / CSPNeXt hyperparameters. ``deepen_factor`` and
    ``widen_factor`` scale the P5 arch table as mmpose does; :meth:`dwpose_l`
    is the layout of DWPose's wholebody model (384 x 288, widen 1.0)."""

    input_hw: T.Tuple[int, int] = (256, 192)   # (H, W) of the person crops
    num_keypoints: int = NUM_WHOLEBODY_KPTS
    deepen_factor: float = 0.33
    widen_factor: float = 0.5
    simcc_ratio: float = 2.0
    gau_dim: int = 256
    gau_s: int = 128
    gau_expansion: int = 2
    final_kernel: int = 7

    # the CSPNeXt-P5 arch: (in, out, num_blocks, add_identity, use_spp)
    _ARCH: T.ClassVar[T.Tuple] = (
        (64, 128, 3, True, False),
        (128, 256, 6, True, False),
        (256, 512, 6, True, False),
        (512, 1024, 3, False, True),
    )

    def width(self, c: int) -> int:
        return max(1, int(c * self.widen_factor))

    def depth(self, n: int) -> int:
        return max(1, round(n * self.deepen_factor))

    @property
    def feature_hw(self) -> T.Tuple[int, int]:
        """The backbone's output size: five stride-2 3x3 convs with padding 1."""
        h, w = self.input_hw
        for _ in range(5):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        return h, w

    @property
    def simcc_bins(self) -> T.Tuple[int, int]:
        """(x bins, y bins) of the SimCC classifiers."""
        h, w = self.input_hw
        return int(w * self.simcc_ratio), int(h * self.simcc_ratio)

    @classmethod
    def dwpose_l(cls) -> "PoseNetConfig":
        return cls(input_hw=(384, 288), deepen_factor=1.0, widen_factor=1.0)


class DepthwiseSeparableConv(nn.Module):
    """mmcv ``DepthwiseSeparableConvModule``: a depthwise ``ConvBN`` and a 1x1
    ``ConvBN``, each with SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.depthwise_conv = ConvBN(cin, cin, kernel=kernel, groups=cin)
        self.pointwise_conv = ConvBN(cin, cout, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    """A 3x3 conv, then a 5x5 depthwise-separable conv, with a residual."""

    def __init__(self, channels: int, add_identity: bool = True):
        super().__init__()
        self.conv1 = ConvBN(channels, channels, kernel=3)
        self.conv2 = DepthwiseSeparableConv(channels, channels, 5)
        self.add_identity = add_identity

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        return x + h if self.add_identity else h


class ChannelAttention(nn.Module):
    """A global mean, a 1x1 conv with bias (``fc``, mmdet's layout), a hard
    sigmoid gate (the conv at fp32 products in :class:`RTMPoseNet`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * F.hardsigmoid(self.fc(x.mean(dim=(2, 3), keepdim=True)))


class CSPLayer(nn.Module):
    """The CSP split: a main branch (1x1, then the CSPNeXt ``blocks``) beside a
    short one (1x1), concatenated, channel attention, a 1x1 merge."""

    def __init__(self, cin: int, cout: int, n_blocks: int, add_identity: bool = True):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvBN(cin, mid, kernel=1)
        self.short_conv = ConvBN(cin, mid, kernel=1)
        self.final_conv = ConvBN(2 * mid, cout, kernel=1)
        self.blocks = nn.Sequential(*(CSPNeXtBlock(mid, add_identity) for _ in range(n_blocks)))
        self.attention = ChannelAttention(2 * mid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        both = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], dim=1)
        return self.final_conv(self.attention(both))


class CSPNeXt(nn.Module):
    """The CSPNeXt-P5 backbone, last stage only (``out_indices=(4,)``):
    ``stem`` and ``stage1..4``, each stage a stride-2 ``ConvBN``, the SPP on
    the last, and a :class:`CSPLayer`."""

    def __init__(self, cfg: PoseNetConfig):
        super().__init__()
        stem_c = cfg.width(cfg._ARCH[0][0])
        half = max(1, stem_c // 2)
        self.stem = nn.Sequential(ConvBN(3, half, stride=2), ConvBN(half, half), ConvBN(half, stem_c))
        cin = stem_c
        for s, (_, out_c, n, add_id, use_spp) in enumerate(cfg._ARCH, start=1):
            out = cfg.width(out_c)
            mods = [ConvBN(cin, out, stride=2)]
            if use_spp:
                mods.append(SPPBottleneck(out, out))
            mods.append(CSPLayer(out, out, cfg.depth(n), add_id))
            self.add_module(f"stage{s}", nn.Sequential(*mods))
            cin = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for s in range(1, len(PoseNetConfig._ARCH) + 1):
            x = getattr(self, f"stage{s}")(x)
        return x


class ScaleNorm(nn.Module):
    """``x / max(||x|| * d^-0.5, eps) * g`` over the last axis, ``g`` a scalar."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * (x.shape[-1] ** -0.5)
        return x / norm.clamp_min(self.eps) * self.g


class Scale(nn.Module):
    """A learned per-channel scale (mmpose's ``Scale``: ``scale``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class GatedAttentionUnit(Precise, nn.Module):
    """mmpose's ``RTMCCBlock`` as RTMPose configures it (self-attention, no
    relative bias or position encoding, dropout 0)::

        shortcut = x * res_scale
        u, v, base = split(SiLU(ScaleNorm(x) @ Wuv), [e, e, s])
        q, k = base * gamma[0] + beta[0], base * gamma[1] + beta[1]
        return shortcut + (u * (relu(q k^T / sqrt(s))^2 @ v)) @ Wo
    """

    def __init__(self, dim: int, expansion: int = 2, s: int = 128):
        super().__init__()
        self.e, self.s = dim * expansion, s
        self.ln = ScaleNorm()
        self.uv = Linear(dim, 2 * self.e + s, bias=False)
        self.o = Linear(self.e, dim, bias=False)
        self.gamma = nn.Parameter(torch.ones(2, s))
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.res_scale = Scale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.res_scale(x)
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        q = base * self.gamma[0] + self.beta[0]
        k = base * self.gamma[1] + self.beta[1]
        qk = matmul(q, k.transpose(-1, -2), self.precision) / math.sqrt(self.s)
        out = u * matmul(torch.square(F.relu(qk)), v, self.precision)
        return shortcut + self.o(out)


class RTMCCHead(nn.Module):
    """The SimCC head: ``final_layer`` (k x k conv, bias) to one token map per
    keypoint, ``mlp`` (ScaleNorm, bias-free linear), ``gau``, and the
    bias-free ``cls_x`` / ``cls_y`` classifiers."""

    def __init__(self, cfg: PoseNetConfig):
        super().__init__()
        fk = cfg.final_kernel
        fh, fw = cfg.feature_hw
        nx, ny = cfg.simcc_bins
        self.final_layer = Conv2d(cfg.width(cfg._ARCH[-1][1]), cfg.num_keypoints, fk, padding=fk // 2)
        self.mlp = nn.Sequential(ScaleNorm(), Linear(fh * fw, cfg.gau_dim, bias=False))
        self.gau = GatedAttentionUnit(cfg.gau_dim, cfg.gau_expansion, cfg.gau_s)
        self.cls_x = Linear(cfg.gau_dim, nx, bias=False)
        self.cls_y = Linear(cfg.gau_dim, ny, bias=False)

    def forward(self, feats: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        tok = self.final_layer(feats).flatten(2)                                   # [B, K, h * w]
        tok = self.gau(self.mlp(tok))
        return self.cls_x(tok), self.cls_y(tok)


class RTMPoseNet(Precise, nn.Module):
    """RTMPose top-down pose net: ``backbone`` (CSPNeXt) and ``head`` (RTMCC).
    ``forward(crops [B, H, W, 3])`` (normalised) -> ``(keypoints [B, K, 2]`` in
    crop pixels, ``scores [B, K])``, float32.

    Activations are float32, whatever the weights' storage type. The
    backbone's products run at the net's class. The channel attentions'
    gates and the whole head (ScaleNorm, GAU, SimCC classifiers) run fp32
    products on the (possibly bf16-rounded) weights at every class
    (:meth:`set_precision`), finer than JAX's ``"default"``: an argmax over
    logits from single-pass bf16 products ties often, and a tie moves a
    keypoint by whole bins."""

    def __init__(self, config: PoseNetConfig):
        super().__init__()
        self.config = config
        self.backbone = CSPNeXt(config)
        self.head = RTMCCHead(config)

    def set_precision(self, precision: str) -> None:
        """The backbone at ``precision``; the head and the gates at fp32."""
        self.precision = precision
        set_precision_(self.head, "highest")
        for m in self.backbone.modules():
            if isinstance(m, ChannelAttention):
                set_precision_(m, "highest")

    def logits(self, crops: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """The SimCC logits ``(x [B, K, nx], y [B, K, ny])``, float32."""
        return self.head(self.backbone(crops.permute(0, 3, 1, 2).contiguous().float()))

    def forward(self, crops: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        x_logits, y_logits = self.logits(crops)
        return simcc_decode(x_logits, y_logits, self.config.simcc_ratio)


def simcc_decode(x_logits: torch.Tensor, y_logits: torch.Tensor,
                 simcc_ratio: float) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """mmpose ``get_simcc_maximum``: the argmax bin over ``simcc_ratio`` on
    each axis (the first maximum, as ``jnp.argmax`` takes), the score
    ``min(max_x, max_y)``, and location ``-1`` where the score is <= 0."""
    xs = torch.argmax(x_logits, dim=-1).to(torch.float32) / simcc_ratio
    ys = torch.argmax(y_logits, dim=-1).to(torch.float32) / simcc_ratio
    scores = torch.minimum(x_logits.amax(dim=-1), y_logits.amax(dim=-1))
    kp = torch.stack([xs, ys], dim=-1)
    return torch.where(scores[..., None] > 0, kp, torch.full_like(kp, -1.0)), scores


# the seeded net's norm gains, and the extra gain of each CSPNeXt block's
# residual branch (see init_pose_weights_)
_NORM_GAIN, _BRANCH_GAIN = 0.25, 0.25


def init_pose_weights_(model: RTMPoseNet, generator: torch.Generator) -> None:
    """Seeded weights on the model's device, for runs without a checkpoint.
    Conv and linear weights are normal with std ``fan_in ** -0.5``, biases
    zero, the ScaleNorm gains and the residual scale one, the GAU's ``gamma``
    normal with std 0.02 and ``beta`` zero (the JAX module's initialisers).
    Each frozen norm's gain is 1/4, and 1/16 at the end of each CSPNeXt
    block's residual branch; its statistics are then set to those of its
    input over four smooth random crops, normalised as DWPose's are, with
    pixel noise of std 16 over them (:func:`calibrate_norms_`, each variance
    at least a tenth of its norm's mean: the last stages' maps are small).
    So the signal reaches the head at a steady scale, and the net stays near
    its linear regime, where rounding accumulates over its ~90 convolutions
    instead of growing: at gain 1 the random DWPose-L is chaotic, and its bf16
    mode moves the SimCC logits by about half their L2 norm."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "weight" and p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)
            elif leaf in ("g", "scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        norms = [m for m in model.modules() if isinstance(m, TrackedBatchNorm)]
        for norm in norms:
            norm.reset_statistics()
            norm.weight.fill_(_NORM_GAIN)
            norm.num_batches_tracked.zero_()
        for m in model.modules():
            if isinstance(m, CSPNeXtBlock) and m.add_identity:
                m.conv2.pointwise_conv.bn.weight.fill_(_NORM_GAIN * _BRANCH_GAIN)
        h, w = model.config.input_hw
        dev = model.head.cls_x.weight.device
        coarse = torch.rand(4, 3, max(1, h // 32), max(1, w // 32), generator=generator, device=dev)
        smooth = F.interpolate(coarse * 255.0, size=(h, w), mode="bilinear")
        noise = torch.randn(smooth.shape, generator=generator, device=dev) * 16.0
        crops = (smooth + noise - 120.0) / 58.0
    calibrate_norms_(model, norms, crops.permute(0, 2, 3, 1), var_floor=0.1)


def wholebody_to_openpose(kpts: torch.Tensor, scores: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """COCO-wholebody ``[..., 133, 2]`` / ``[..., 133]`` -> openpose's 134:
    the neck (mean of the shoulders, scored min of theirs where both exceed
    0.3, else 0) inserted at 17, then the body block reordered, every moved
    entry read from the tensor before the reorder (JAX's ``.at[op].set(x[mm])``)."""
    neck_xy = (kpts[..., 5, :] + kpts[..., 6, :]) / 2.0
    both = (scores[..., 5] > 0.3) & (scores[..., 6] > 0.3)
    neck_sc = torch.where(both, torch.minimum(scores[..., 5], scores[..., 6]), torch.zeros_like(scores[..., 5]))
    k134 = torch.cat([kpts[..., :17, :], neck_xy[..., None, :], kpts[..., 17:, :]], dim=-2)
    s134 = torch.cat([scores[..., :17], neck_sc[..., None], scores[..., 17:]], dim=-1)
    mm = torch.tensor(_MMPOSE_IDX, device=kpts.device)
    op = torch.tensor(_OPENPOSE_IDX, device=kpts.device)
    k_out, s_out = k134.clone(), s134.clone()
    k_out[..., op, :] = k134[..., mm, :]
    s_out[..., op] = s134[..., mm]
    return k_out, s_out


def dwpose_postprocess(kpts134: torch.Tensor, scores: torch.Tensor, frame_wh: T.Tuple[float, float],
                       vis_thresh: float = 0.3) -> T.Dict[str, torch.Tensor]:
    """``dwpose_init.py``'s postprocess on ``[..., P, 134, 2]`` frame-pixel
    keypoints and ``[..., P, 134]`` scores: coordinates divided by ``(W, H)``,
    keypoints scored at or below ``vis_thresh`` set to -1, and the split into
    body, foot, faces and hands (left hands of every person, then right hands:
    ``[..., 2P, 21, 2]``)."""
    W, H = frame_wh
    cand = kpts134 / torch.tensor([W, H], dtype=kpts134.dtype, device=kpts134.device)
    visible = scores > vis_thresh
    cand = torch.where(visible[..., None], cand, torch.full_like(cand, -1.0))
    return {
        "candidate": cand,
        "body": cand[..., :18, :],
        "foot": cand[..., 18:24, :],
        "faces": cand[..., 24:92, :],
        "hands": torch.cat([cand[..., 92:113, :], cand[..., 113:134, :]], dim=-3),
        "visible": visible,
        "raw_score": scores[..., :18],
    }


def flatten_first_person(post: T.Dict[str, torch.Tensor],
                         visibility_rule: bool = False) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """The reference's 120-d flatten (ref ``process_video.py:23-57``): person
    0's 18 body keypoints, then rows 0 and 1 of the hands stack (for P = 1 that
    person's left and right hands; for P > 1 the reference's pairing of
    persons 0's and 1's LEFT hands). Returns ``(kp120 [..., 120], valid [...])``.

    The reference's shape checks always hold once a person is posed, so valid
    is True; ``visibility_rule=True`` asks instead that all 18 body keypoints
    and at least one keypoint of each of person 0's hands be visible (no
    reference counterpart)."""
    body = post["body"][..., 0, :, :]
    lhand, rhand = post["hands"][..., 0, :, :], post["hands"][..., 1, :, :]
    lead = body.shape[:-2]
    kp120 = torch.cat([body.reshape(*lead, -1), lhand.reshape(*lead, -1), rhand.reshape(*lead, -1)], dim=-1)
    if not visibility_rule:
        return kp120, torch.ones(lead, dtype=torch.bool, device=kp120.device)
    vis = post["visible"][..., 0, :]
    return kp120, vis[..., :18].all(-1) & vis[..., 92:113].any(-1) & vis[..., 113:134].any(-1)
