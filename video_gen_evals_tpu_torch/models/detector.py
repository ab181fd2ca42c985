"""YOLOX person detector and its postprocessing, batched over frames.

Port of ``video_gen_evals_tpu/models/detector.py``: Megvii's published YOLOX
(CSPDarknet with a Focus stem, the YOLOPAFPN neck, decoupled heads, the
exact grid / ``exp`` decode), the net DWPose's person-detection graph is
exported from. The module tree carries Megvii's state_dict names
(``backbone.backbone.stem.conv.conv.weight``, ..., ``head.stems.0.bn.running_var``),
so a published ``yolox_l.pth`` loads with ``load_state_dict(strict=True)``;
``models/torch_compat.py::yolox_state_dict_from_jax_tree`` carries the JAX
package's tree across.

Layouts: frames in and predictions out are JAX's (``[B, H, W, 3]``; boxes
``[B, N, 4]``, ``obj [B, N]``, ``cls [B, N, C]`` with the locations of each
stride row-major, strides in order); inside, NCHW. The convolutions are
``ops/precision.py``'s ``conv2d``: JAX runs them as XLA convolutions,
outside any Pallas kernel. Activations are float32 at every class, the
weights float32 or bfloat16-rounded, every convolution at the net's class
(:func:`..ops.precision.set_precision_`); the predictions are decoded in
float32.

The postprocessing (:func:`nms_xla_indexed`, :func:`dwpose_person_detections`,
...) is batched over the leading axes where JAX ``vmap``s one frame: a
stable sort stands for ``lax.top_k`` (ties keep the lower index first), and
the greedy suppression (:func:`nms_masked`, which the R-CNN shares) is one
loop over the candidates for every frame of the batch at once.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import Conv2d
from .pose2d import ConvBN, SPPBottleneck, TrackedBatchNorm, calibrate_norms_


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """YOLOX hyperparameters: ``depth`` and ``width`` scale as Megvii's
    ``yolox_base`` does; the defaults are JAX's lite net, :meth:`yolox_l`
    the layout of DWPose's detector."""

    input_hw: T.Tuple[int, int] = (416, 416)
    depth: float = 0.33
    width: float = 0.25
    strides: T.Tuple[int, ...] = (8, 16, 32)
    num_classes: int = 80
    max_detections: int = 16

    @property
    def base_channels(self) -> int:
        return int(64 * self.width)

    @property
    def base_depth(self) -> int:
        return max(round(3 * self.depth), 1)

    def ch(self, mult: int) -> int:
        return int(64 * mult * self.width)

    @classmethod
    def yolox_l(cls) -> "DetectorConfig":
        return cls(input_hw=(640, 640), depth=1.0, width=1.0)


class Bottleneck(nn.Module):
    """Megvii Bottleneck: 1x1 -> 3x3, with an optional residual."""

    def __init__(self, channels: int, shortcut: bool = True):
        super().__init__()
        self.conv1 = ConvBN(channels, channels, kernel=1)
        self.conv2 = ConvBN(channels, channels, kernel=3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return x + y if self.shortcut else y


class CSPLayerYX(nn.Module):
    """Megvii CSPLayer: conv1 -> n bottlenecks (``m``) || conv2, concatenated,
    conv3."""

    def __init__(self, cin: int, cout: int, n_blocks: int, shortcut: bool = True):
        super().__init__()
        hidden = cout // 2
        self.conv1 = ConvBN(cin, hidden, kernel=1)
        self.conv2 = ConvBN(cin, hidden, kernel=1)
        self.conv3 = ConvBN(2 * hidden, cout, kernel=1)
        self.m = nn.Sequential(*(Bottleneck(hidden, shortcut) for _ in range(n_blocks)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv3(torch.cat([self.m(self.conv1(x)), self.conv2(x)], dim=1))


class Focus(nn.Module):
    """Space-to-depth stem: the 2x2 patch split concatenated on channels in
    Megvii's order (top-left, bottom-left, top-right, bottom-right), then a
    3x3 conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBN(4 * cin, cout, kernel=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tl, tr = x[..., ::2, ::2], x[..., ::2, 1::2]
        bl, br = x[..., 1::2, ::2], x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class CSPDarknet(nn.Module):
    """YOLOX backbone; returns the dark3, dark4 and dark5 features."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        base, bd = cfg.base_channels, cfg.base_depth
        self.stem = Focus(3, base)
        self.dark2 = nn.Sequential(ConvBN(base, base * 2, stride=2), CSPLayerYX(base * 2, base * 2, bd))
        self.dark3 = nn.Sequential(ConvBN(base * 2, base * 4, stride=2), CSPLayerYX(base * 4, base * 4, bd * 3))
        self.dark4 = nn.Sequential(ConvBN(base * 4, base * 8, stride=2), CSPLayerYX(base * 8, base * 8, bd * 3))
        self.dark5 = nn.Sequential(ConvBN(base * 8, base * 16, stride=2), SPPBottleneck(base * 16, base * 16),
                                   CSPLayerYX(base * 16, base * 16, bd, shortcut=False))

    def forward(self, x: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d3 = self.dark3(self.dark2(self.stem(x)))
        d4 = self.dark4(d3)
        return d3, d4, self.dark5(d4)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of an NCHW map (Megvii's ``nn.Upsample``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOPAFPN(nn.Module):
    """YOLOX neck: top-down FPN and bottom-up PAN over dark3/4/5."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        bd = cfg.base_depth
        c256, c512, c1024 = cfg.ch(4), cfg.ch(8), cfg.ch(16)
        self.backbone = CSPDarknet(cfg)
        self.lateral_conv0 = ConvBN(c1024, c512, kernel=1)
        self.C3_p4 = CSPLayerYX(2 * c512, c512, bd, shortcut=False)
        self.reduce_conv1 = ConvBN(c512, c256, kernel=1)
        self.C3_p3 = CSPLayerYX(2 * c256, c256, bd, shortcut=False)
        self.bu_conv2 = ConvBN(c256, c256, stride=2)
        self.C3_n3 = CSPLayerYX(2 * c256, c512, bd, shortcut=False)
        self.bu_conv1 = ConvBN(c512, c512, stride=2)
        self.C3_n4 = CSPLayerYX(2 * c512, c1024, bd, shortcut=False)

    def forward(self, x: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x2, x1, x0 = self.backbone(x)
        fpn_out0 = self.lateral_conv0(x0)
        f_out0 = self.C3_p4(torch.cat([_upsample2(fpn_out0), x1], dim=1))
        fpn_out1 = self.reduce_conv1(f_out0)
        pan_out2 = self.C3_p3(torch.cat([_upsample2(fpn_out1), x2], dim=1))        # /8
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2), fpn_out1], dim=1))  # /16
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1), fpn_out0], dim=1))  # /32
        return pan_out2, pan_out1, pan_out0


class YOLOXHead(nn.Module):
    """Megvii's decoupled head, one branch a stride: a 1x1 stem, two 3x3
    convs each for classes and for boxes, and the 1x1 predictors."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        hidden = cfg.ch(4)
        in_chs = (cfg.ch(4), cfg.ch(8), cfg.ch(16))
        self.stems = nn.ModuleList(ConvBN(c, hidden, kernel=1) for c in in_chs)
        self.cls_convs = nn.ModuleList(nn.Sequential(ConvBN(hidden, hidden), ConvBN(hidden, hidden)) for _ in in_chs)
        self.reg_convs = nn.ModuleList(nn.Sequential(ConvBN(hidden, hidden), ConvBN(hidden, hidden)) for _ in in_chs)
        self.cls_preds = nn.ModuleList(Conv2d(hidden, cfg.num_classes, 1) for _ in in_chs)
        self.reg_preds = nn.ModuleList(Conv2d(hidden, 4, 1) for _ in in_chs)
        self.obj_preds = nn.ModuleList(Conv2d(hidden, 1, 1) for _ in in_chs)


class YOLOXDetector(nn.Module):
    """YOLOX: PAFPN and decoupled heads with Megvii's inference decode.
    ``forward(frames [B, H, W, 3])`` -> ``{"boxes": [B, N, 4] xyxy,
    "obj": [B, N], "cls": [B, N, C]}``, float32, N the locations of every
    stride."""

    def __init__(self, config: DetectorConfig):
        super().__init__()
        self.config = config
        self.backbone = YOLOPAFPN(config)
        self.head = YOLOXHead(config)

    def forward(self, frames: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        feats = self.backbone(frames.permute(0, 3, 1, 2).contiguous().float())
        head = self.head
        boxes, objs, clss = [], [], []
        for i, (stride, f) in enumerate(zip(self.config.strides, feats)):
            h = head.stems[i](f)
            r = head.reg_convs[i](h)
            cls = head.cls_preds[i](head.cls_convs[i](h))
            reg = head.reg_preds[i](r)
            obj = head.obj_preds[i](r)
            B, _, fh, fw = reg.shape
            gy = torch.arange(fh, dtype=torch.float32, device=reg.device)[:, None]
            gx = torch.arange(fw, dtype=torch.float32, device=reg.device)[None, :]
            # Megvii decode: centre (pred_xy + grid) * stride, size exp(pred_wh) * stride
            px = (gx + reg[:, 0]) * stride
            py = (gy + reg[:, 1]) * stride
            pw = torch.exp(reg[:, 2].clamp(-8, 8)) * stride
            ph = torch.exp(reg[:, 3].clamp(-8, 8)) * stride
            boxes.append(torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2], dim=-1)
                         .reshape(B, fh * fw, 4))
            objs.append(torch.sigmoid(obj).reshape(B, fh * fw))
            clss.append(torch.sigmoid(cls).permute(0, 2, 3, 1).reshape(B, fh * fw, -1))
        return {"boxes": torch.cat(boxes, 1), "obj": torch.cat(objs, 1), "cls": torch.cat(clss, 1)}


# the JAX package's round-1 name
YOLOXLiteDetector = YOLOXDetector

# Megvii's prior for the class and objectness biases: sigmoid(b) = 0.01
_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def init_yolox_weights_(model: YOLOXDetector, generator: torch.Generator) -> None:
    """Seeded weights on the model's device, for runs without a checkpoint.
    Conv weights are normal with std ``fan_in ** -0.5``. Each frozen norm is
    then set, in the order the forward reaches it, to the mean and variance
    of its input over a calibration batch (two smooth random canvases of the
    input size, bilinear over a 32-pixel grid of uniform 0..255 values from
    ``generator``), so that every layer's output is near unit scale: with
    identity norms the signal dies within YOLOX-L's depth and every location
    scores alike. The class biases take Megvii's prior (sigmoid 0.01), the
    objectness and the person class bias 0 (sigmoid 0.5), so that person
    boxes near 0.5 are common and the person rule has work to do."""
    head = model.head
    norms = [m for m in model.modules() if isinstance(m, TrackedBatchNorm)]
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        for norm in norms:
            norm.reset_statistics()
            norm.num_batches_tracked.zero_()
        for cls_pred, obj_pred in zip(head.cls_preds, head.obj_preds):
            cls_pred.bias.fill_(_PRIOR_BIAS)
            cls_pred.bias[0] = 0.0
            obj_pred.bias.zero_()
        dev, hw = head.obj_preds[0].weight.device, model.config.input_hw
        coarse = torch.rand(2, 3, hw[0] // 32, hw[1] // 32, generator=generator, device=dev)
        smooth = F.interpolate(coarse * 255.0, size=hw, mode="bilinear")
    calibrate_norms_(model, norms, smooth.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# postprocessing, batched over the leading axes

def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix ``[..., Na, Nb]`` of xyxy boxes ``[..., Na, 4]`` and ``[..., Nb, 4]``."""
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * (b[..., 3] - b[..., 1]).clamp_min(0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def nms_masked(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Exact greedy NMS keep-mask over score-sorted candidates ``[..., N, 4]``
    with ``valid [..., N]``, batched over the leading axes: the IoU matrix
    once, then a loop over ``i`` in which a kept ``i`` drops every later box
    above the threshold. The loop runs on the device with no host sync (two
    launches a step). Both detectors' NMS (JAX's ``nms_masked`` in
    ``models/rcnn.py`` and the loop of ``nms_xla_indexed`` here)."""
    n = boxes.shape[-2]
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(diagonal=1)
    over = (box_iou(boxes, boxes) > iou_thresh) & later
    keep = valid.clone()
    for i in range(n):
        keep.masked_fill_(over[..., i, :] & keep[..., i:i + 1], False)
    return keep


def nms_xla_indexed(
    boxes: torch.Tensor,    # [..., N, 4]
    scores: torch.Tensor,   # [..., N]
    iou_thresh: float = 0.5,
    max_out: int = 16,
) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's static-shape NMS with the original indices of the kept boxes:
    the top ``k = min(4 * max_out, N)`` by score (ties in index order), a
    greedy pass in which a kept candidate drops every later one above
    ``iou_thresh`` (only candidates scoring above 0 start kept), the kept
    ones moved to the front in score order. Returns (boxes ``[..., max_out,
    4]``, scores ``[..., max_out]`` (0 where not kept), keep, indices)."""
    k = min(max_out * 4, boxes.shape[-2])
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    top_boxes = torch.take_along_dim(boxes, top_idx[..., None], dim=-2)
    keep = nms_masked(top_boxes, top_scores > 0, iou_thresh)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)[..., :max_out]
    kept = torch.take_along_dim(keep, order, dim=-1)
    out_scores = torch.where(kept, torch.take_along_dim(top_scores, order, dim=-1), 0.0)
    return (torch.take_along_dim(top_boxes, order[..., None], dim=-2), out_scores, kept,
            torch.take_along_dim(top_idx, order, dim=-1))


def nms_xla(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float = 0.5,
            max_out: int = 16) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`nms_xla_indexed` without the indices: (boxes, scores, keep)."""
    return nms_xla_indexed(boxes, scores, iou_thresh, max_out)[:3]


def person_detections(raw: T.Dict[str, torch.Tensor], score_thresh: float = 0.5, iou_thresh: float = 0.5,
                      max_out: int = 16, person_class: int = 0
                      ) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Person score ``obj * cls[person]``, NMS, then ``score > score_thresh``:
    (boxes ``[B, max_out, 4]``, scores ``[B, max_out]``, valid ``[B, max_out]``)."""
    scores = raw["obj"] * raw["cls"][..., person_class]
    boxes, scores, keep = nms_xla(raw["boxes"], scores, iou_thresh, max_out)
    return boxes, scores, keep & (scores > score_thresh)


def dwpose_person_detections(raw: T.Dict[str, torch.Tensor], prefilter_thresh: float = 0.1,
                             iou_thresh: float = 0.45, max_out: int = 16, person_class: int = 0
                             ) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DWPose's (Megvii onnxdet's) postprocess: each location's class is the
    argmax of ``obj * cls``; candidates scoring above ``prefilter_thresh`` go
    through class-agnostic NMS at ``iou_thresh``. Returns (boxes ``[B,
    max_out, 4]``, scores ``[B, max_out]``, person ``[B, max_out]``) in
    descending score order; the caller applies its score rule."""
    cls_scores = raw["obj"][..., None] * raw["cls"]
    best_score = cls_scores.amax(dim=-1)
    best_cls = torch.argmax(cls_scores, dim=-1)     # the first of equal maxima, as JAX's argmax
    s = torch.where(best_score > prefilter_thresh, best_score, 0.0)
    boxes, scores, keep, idx = nms_xla_indexed(raw["boxes"], s, iou_thresh, max_out)
    return boxes, scores, keep & (torch.take_along_dim(best_cls, idx, dim=-1) == person_class)


def single_person_mask(valid: torch.Tensor) -> torch.Tensor:
    """``[B, max_out]`` validity -> ``[B]`` "exactly one person" (ref
    ``mesh_generator.py:103-111``)."""
    return valid.to(torch.int32).sum(dim=-1) == 1


def video_is_single_person(frame_mask: torch.Tensor, min_ratio: float = 0.8) -> torch.Tensor:
    """A video is kept when at least ``min_ratio`` of its frames hold a single
    person (ref ``mesh_generator.py:113-117``)."""
    return frame_mask.to(torch.float32).mean() >= min_ratio
