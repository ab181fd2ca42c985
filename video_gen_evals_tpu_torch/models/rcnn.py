"""Faster R-CNN X101-32x8d-FPN, the reference's mesh-path person detector.

Port of ``video_gen_evals_tpu/models/rcnn.py``. The reference builds
detectron2's ``COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x`` predictor and
keeps, a frame, the person boxes scoring above 0.5 (ref
``modifications/mesh_generator.py:69-74``, ``:103-111``). The modules here
carry detectron2's module tree and state_dict names, so the published
``.pkl`` loads with ``load_state_dict`` (:func:`canonical_rcnn_state_dict`
drops its anchor and pixel-statistics buffers); ``models/torch_compat.py``
carries the JAX package's tree across.

As in JAX, a batch of frames runs as one forward with fixed shapes: a
per-level top-k, greedy NMS as a loop over candidates batched across frames
and levels (:func:`nms_masked`), and ROIAlignV2 over a packed pyramid
(``ops/roi_align.py``), on CUDA tensors through K5. Layouts: images in are
JAX's ``[B, H, W, 3]``; the backbone and the RPN work in NCHW, and the RPN's
outputs are put in JAX's ``(h, w, a)`` order before anything is ranked.
Where JAX's ``top_k`` and ``argsort`` decide what is kept, the port sorts
stably, so ties keep JAX's order.

The grouped 3x3 convs are ``F.conv2d(groups=32)``; the JAX package's
``grouped_conv_impl``, ``grouped_conv_width``, ``roi_chunk`` and
``roi_rois_per_step`` are TPU lowering choices and are not carried over.
Only the float32 pyramid is ported: ``RCNNConfig.fast()`` (bfloat16 pyramid,
window 32) raises (ROADMAP.md, Queue 1).

On a CUDA device every entry point sets and checks TF32 off
(``utils/device.py::disable_tf32``): cuDNN would run a float32 convolution in
TF32 otherwise.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import typing as T

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import resize_pil_matmul
from ..ops.roi_align import assign_fpn_levels, pack_pyramid, roi_align_pyramid, roi_align_pyramid_dma
from ..utils.device import disable_tf32
from .pose2d import BatchNormInference

_NOT_PORTED = "{what} is not ported (ROADMAP.md, Queue 1: the R-CNN's fast mode)"


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    """The fields of the JAX package's ``RCNNConfig`` that define what is
    computed; defaults are the published X101-32x8d-FPN test settings."""

    stage_blocks: T.Tuple[int, ...] = (3, 4, 23, 3)
    groups: int = 32
    width_per_group: int = 8
    stem_channels: int = 64
    stage_out: T.Tuple[int, ...] = (256, 512, 1024, 2048)
    stride_in_1x1: bool = False
    fpn_channels: int = 256
    anchor_sizes: T.Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    anchor_ratios: T.Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_pre_nms_topk: int = 1000
    rpn_post_nms_topk: int = 1000
    rpn_nms_thresh: float = 0.7
    roi_resolution: int = 7
    fc_dim: int = 1024
    num_classes: int = 80
    box_reg_weights: T.Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    test_score_thresh: float = 0.25   # the reference's override (d2 default .05)
    test_nms_thresh: float = 0.5
    detections_per_image: int = 100
    min_size_test: int = 800
    max_size_test: int = 1333
    second_stage_candidates: int = 1000
    roi_window: int = 48
    # "auto": K5 (the DMA pool) on CUDA, the matmul pool on the CPU, as JAX
    # picks per backend; "dma" pins K5 (its plain version on the CPU);
    # "matmul" pins the matmul pool, on the CPU only
    roi_impl: str = "auto"
    roi_dtype: str = "float32"

    def __post_init__(self):
        if self.roi_dtype != "float32":
            raise NotImplementedError(_NOT_PORTED.format(what=f"roi_dtype={self.roi_dtype!r}"))
        if self.roi_impl not in ("auto", "dma", "matmul"):
            raise ValueError(f"unknown roi_impl {self.roi_impl!r}")

    @property
    def strides(self) -> T.Tuple[int, ...]:
        return (4, 8, 16, 32, 64)   # p2..p6

    @classmethod
    def x101_32x8d(cls) -> "RCNNConfig":
        return cls()

    @classmethod
    def fast(cls) -> "RCNNConfig":
        raise NotImplementedError(_NOT_PORTED.format(what="RCNNConfig.fast() (bfloat16 pyramid, window 32)"))

    @classmethod
    def small(cls) -> "RCNNConfig":
        """Tiny geometry for tests (the JAX package's ``small()``)."""
        return cls(stage_blocks=(1, 1, 1, 1), groups=2, width_per_group=4, stem_channels=8,
                   stage_out=(16, 32, 64, 128), fpn_channels=16, fc_dim=32, rpn_pre_nms_topk=64,
                   rpn_post_nms_topk=32, min_size_test=48, max_size_test=80, second_stage_candidates=64)


class ConvFrozenBN(nn.Conv2d):
    """detectron2's ``Conv2d(..., bias=False, norm=FrozenBatchNorm2d)``: the
    norm is an attribute of the conv, so its names are ``<conv>.norm.*``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, kernel, stride, (kernel - 1) // 2, groups=groups, bias=False)
        self.norm = BatchNormInference(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BottleneckX(nn.Module):
    """detectron2 ``BottleneckBlock``, ResNeXt form: grouped 3x3, the stride
    in conv2 when ``stride_in_1x1`` is False (the X101 setting)."""

    def __init__(self, cin: int, cout: int, bottleneck: int, stride: int, groups: int,
                 stride_in_1x1: bool, has_shortcut: bool):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvFrozenBN(cin, bottleneck, 1, s1)
        self.conv2 = ConvFrozenBN(bottleneck, bottleneck, 3, s2, groups=groups)
        self.conv3 = ConvFrozenBN(bottleneck, cout, 1)
        self.shortcut = ConvFrozenBN(cin, cout, 1, stride) if has_shortcut else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        return F.relu(y + (self.shortcut(x) if self.shortcut is not None else x))


class _Stem(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = ConvFrozenBN(3, channels, 7, 2)


class _BottomUp(nn.Module):
    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        self.stem = _Stem(cfg.stem_channels)
        width = cfg.groups * cfg.width_per_group
        cin = cfg.stem_channels
        for si, (n, cout) in enumerate(zip(cfg.stage_blocks, cfg.stage_out)):
            blocks = []
            for bi in range(n):
                blocks.append(BottleneckX(cin, cout, width * 2 ** si, 2 if (si > 0 and bi == 0) else 1,
                                          cfg.groups, cfg.stride_in_1x1, has_shortcut=bi == 0))
                cin = cout
            setattr(self, f"res{si + 2}", nn.Sequential(*blocks))


class ResNeXtFPN(nn.Module):
    """Bottom-up ResNeXt and top-down FPN; returns (p2, p3, p4, p5, p6), NCHW."""

    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        self.config = cfg
        self.bottom_up = _BottomUp(cfg)
        for i, cout in enumerate(cfg.stage_out):
            setattr(self, f"fpn_lateral{i + 2}", nn.Conv2d(cout, cfg.fpn_channels, 1))
            setattr(self, f"fpn_output{i + 2}", nn.Conv2d(cfg.fpn_channels, cfg.fpn_channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> T.List[torch.Tensor]:
        bu = self.bottom_up
        x = F.relu(bu.stem.conv1(x))
        x = F.max_pool2d(x, 3, 2, 1)
        res = []
        for si in range(len(self.config.stage_blocks)):
            x = getattr(bu, f"res{si + 2}")(x)
            res.append(x)
        lats = [getattr(self, f"fpn_lateral{i + 2}")(r) for i, r in enumerate(res)]
        outs = [None] * 4
        prev = outs[3] = lats[3]
        for i in (2, 1, 0):
            th, tw = lats[i].shape[2:]
            prev = lats[i] + F.interpolate(prev, scale_factor=2, mode="nearest")[:, :, :th, :tw]
            outs[i] = prev
        ps = [getattr(self, f"fpn_output{i + 2}")(o) for i, o in enumerate(outs)]
        return ps + [ps[3][:, :, ::2, ::2]]   # LastLevelMaxPool: stride-2 subsample of p5


class RPNHead(nn.Module):
    """Shared 3x3 conv, then 1x1 objectness ``[B, A, H, W]`` and anchor
    deltas ``[B, 4A, H, W]`` (channel ``4a + k``) a level, detectron2's layout."""

    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        A = len(cfg.anchor_ratios)
        self.conv = nn.Conv2d(cfg.fpn_channels, cfg.fpn_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(cfg.fpn_channels, A, 1)
        self.anchor_deltas = nn.Conv2d(cfg.fpn_channels, A * 4, 1)

    def forward(self, feats: T.Sequence[torch.Tensor]):
        outs = []
        for f in feats:
            h = F.relu(self.conv(f))
            outs.append((self.objectness_logits(h), self.anchor_deltas(h)))
        return outs


# ---------------------------------------------------------------------------
# anchors, box coding, NMS and the two proposal stages (JAX order throughout)

def cell_anchors(size: float, ratios: T.Sequence[float]) -> np.ndarray:
    """d2 ``generate_cell_anchors``: area-preserving ratios around (0, 0)."""
    out = []
    for r in ratios:
        w = float(np.sqrt(size * size / r))
        h = w * r
        out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, np.float32)


def level_anchors(hw: T.Tuple[int, int], stride: int, size: float, ratios: T.Sequence[float]) -> np.ndarray:
    """``[H * W * A, 4]`` anchors of one level in d2's order: row-major cells,
    then anchor index; centres at ``i * stride``."""
    H, W = hw
    cell = cell_anchors(size, ratios)
    sx = np.arange(W, dtype=np.float32) * stride
    sy = np.arange(H, dtype=np.float32) * stride
    shift = np.stack([*np.meshgrid(sx, sy), *np.meshgrid(sx, sy)], axis=-1).reshape(H * W, 1, 4)
    return (shift + cell[None]).reshape(-1, 4)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights: T.Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """d2 ``Box2BoxTransform.apply_deltas`` (dw, dh clamped at log(1000/16))."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    clamp = float(np.log(1000.0 / 16.0))
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp_max(deltas[..., 2] / ww, clamp)
    dh = torch.clamp_max(deltas[..., 3] / wh, clamp)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes(boxes: torch.Tensor, hw: T.Tuple) -> torch.Tensor:
    h, w = hw
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def nms_masked(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Exact greedy NMS keep-mask over score-sorted candidates ``[..., N, 4]``
    with ``valid [..., N]``, batched over the leading axes: the IoU matrix
    once, then a loop over ``i`` in which a kept ``i`` drops every later box
    above the threshold. The loop runs on the device with no host sync (two
    launches a step)."""
    n = boxes.shape[-2]
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp_min(area[..., :, None] + area[..., None, :] - inter, 1e-9)
    later = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(diagonal=1)
    over = (iou > iou_thresh) & later
    del lt, rb, wh, inter, iou
    keep = valid.clone()
    for i in range(n):
        keep.masked_fill_(over[..., i, :] & keep[..., i:i + 1], False)
    return keep


def _top_k(x: torch.Tensor, k: int) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rpn_proposals(rpn_outs, anchors: T.Sequence[torch.Tensor], image_hw: T.Tuple,
                  cfg: RCNNConfig) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """d2 ``find_top_rpn_proposals`` (test mode): a level's top
    ``pre_nms_topk`` by logit, decoded and clipped, NMS(0.7) within each
    level, then the top ``post_nms_topk`` across levels.

    ``rpn_outs``: per level (objectness ``[B, A, H, W]``, deltas ``[B, 4A, H, W]``),
    put in JAX's ``(h, w, a)`` order here. Returns (proposals ``[B, K, 4]``,
    valid ``[B, K]``)."""
    k = cfg.rpn_pre_nms_topk
    B = rpn_outs[0][0].shape[0]
    lvl_scores, lvl_boxes, lvl_valid = [], [], []
    for (obj, deltas), anc in zip(rpn_outs, anchors):
        logits = obj.permute(0, 2, 3, 1).reshape(B, -1)
        d = deltas.permute(0, 2, 3, 1).reshape(B, -1, 4)
        kk = min(k, logits.shape[1])
        top, idx = _top_k(logits, kk)
        db = torch.take_along_dim(d, idx[..., None], dim=1)
        boxes = clip_boxes(apply_deltas(db, anc[idx]), image_hw)
        ok = (boxes[..., 2] - boxes[..., 0] > 0) & (boxes[..., 3] - boxes[..., 1] > 0) & torch.isfinite(top)
        if kk < k:   # a level with fewer anchors than k: pad with never-kept entries
            top = torch.cat([top, top.new_full((B, k - kk), -math.inf)], dim=1)
            boxes = torch.cat([boxes, boxes.new_zeros((B, k - kk, 4))], dim=1)
            ok = torch.cat([ok, ok.new_zeros((B, k - kk))], dim=1)
        lvl_scores.append(top)
        lvl_boxes.append(boxes)
        lvl_valid.append(ok)
    L = len(lvl_scores)
    scores = torch.stack(lvl_scores, 1).reshape(B * L, k)
    boxes = torch.stack(lvl_boxes, 1).reshape(B * L, k, 4)
    keep = nms_masked(boxes, torch.stack(lvl_valid, 1).reshape(B * L, k), cfg.rpn_nms_thresh)
    scores = torch.where(keep, scores, -math.inf).reshape(B, L * k)
    top, idx = _top_k(scores, min(cfg.rpn_post_nms_topk, L * k))
    return torch.take_along_dim(boxes.reshape(B, L * k, 4), idx[..., None], dim=1), torch.isfinite(top)


def fast_rcnn_postprocess(cls_logits: torch.Tensor, box_deltas: torch.Tensor, proposals: torch.Tensor,
                          prop_valid: torch.Tensor, image_hw: T.Tuple, cfg: RCNNConfig) -> T.Dict[str, torch.Tensor]:
    """d2 ``fast_rcnn_inference``: class-specific deltas (``bbox_pred`` is
    class-major; background is the last logit), clip, score threshold,
    class-wise NMS(0.5) through per-class offsets, top
    ``detections_per_image``, over a ``second_stage_candidates`` cap."""
    B, K, C1 = cls_logits.shape
    C = C1 - 1
    scores = torch.softmax(cls_logits, dim=-1)[..., :C]
    deltas = box_deltas.reshape(B, K, C, 4)
    boxes = clip_boxes(apply_deltas(deltas, proposals[:, :, None, :], cfg.box_reg_weights), image_hw)
    passed = (scores > cfg.test_score_thresh) & prop_valid[..., None]
    flat_scores = torch.where(passed, scores, -math.inf).reshape(B, K * C)
    flat_boxes = boxes.reshape(B, K * C, 4)
    flat_cls = torch.arange(C, dtype=torch.int32, device=cls_logits.device).repeat(B, K)
    top, idx = _top_k(flat_scores, min(cfg.second_stage_candidates, K * C))
    cand_boxes = torch.take_along_dim(flat_boxes, idx[..., None], dim=1)
    cand_cls = torch.take_along_dim(flat_cls, idx, dim=1)
    span = max(float(image_hw[0]), float(image_hw[1])) + 2.0
    keep = nms_masked(cand_boxes + cand_cls.to(torch.float32)[..., None] * span, torch.isfinite(top),
                      cfg.test_nms_thresh)
    kept = torch.where(keep, top, -math.inf)
    D = min(cfg.detections_per_image, top.shape[1])
    order = torch.argsort(-kept, dim=1, stable=True)[:, :D]
    fs = torch.take_along_dim(kept, order, dim=1)
    valid = torch.isfinite(fs)
    return {"boxes": torch.take_along_dim(cand_boxes, order[..., None], dim=1),
            "scores": torch.where(valid, fs, 0.0),
            "classes": torch.take_along_dim(cand_cls, order, dim=1),
            "valid": valid}


# ---------------------------------------------------------------------------

class _ProposalGenerator(nn.Module):
    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        self.rpn_head = RPNHead(cfg)


class _BoxHead(nn.Module):
    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.fpn_channels * cfg.roi_resolution ** 2, cfg.fc_dim)
        self.fc2 = nn.Linear(cfg.fc_dim, cfg.fc_dim)


class _BoxPredictor(nn.Module):
    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        self.cls_score = nn.Linear(cfg.fc_dim, cfg.num_classes + 1)
        self.bbox_pred = nn.Linear(cfg.fc_dim, cfg.num_classes * 4)


class _ROIHeads(nn.Module):
    def __init__(self, cfg: RCNNConfig):
        super().__init__()
        self.box_head = _BoxHead(cfg)
        self.box_predictor = _BoxPredictor(cfg)


class FasterRCNN(nn.Module):
    """Batched test-time Faster R-CNN: a BGR, pixel-mean-subtracted,
    zero-padded canvas ``[B, H, W, 3]`` in (H and W divisible by 32), boxes,
    scores, classes and a valid mask (``[B, 100]``) out. Module names are
    detectron2's ``GeneralizedRCNN``'s."""

    def __init__(self, config: RCNNConfig):
        super().__init__()
        self.config = config
        self.backbone = ResNeXtFPN(config)
        self.proposal_generator = _ProposalGenerator(config)
        self.roi_heads = _ROIHeads(config)
        self._anchors: T.Dict[T.Tuple, torch.Tensor] = {}

    @staticmethod
    def _prepare(images: torch.Tensor) -> torch.Tensor:
        if images.is_cuda:
            disable_tf32()
        return images.permute(0, 3, 1, 2).contiguous()

    def backbone_features(self, images: torch.Tensor) -> T.List[torch.Tensor]:
        """p2..p6, each ``[B, C, H_l, W_l]``."""
        return self.backbone(self._prepare(images))

    def rpn_raw(self, images: torch.Tensor):
        return self.proposal_generator.rpn_head(self.backbone_features(images))

    def anchors(self, feats: T.Sequence[torch.Tensor]) -> T.List[torch.Tensor]:
        cfg = self.config
        out = []
        for i, f in enumerate(feats):
            key = (i, *f.shape[2:4], f.device)
            if key not in self._anchors:
                self._anchors[key] = torch.from_numpy(level_anchors(
                    tuple(f.shape[2:4]), cfg.strides[i], cfg.anchor_sizes[i], cfg.anchor_ratios)).to(f.device)
            out.append(self._anchors[key])
        return out

    def proposals(self, feats: T.Sequence[torch.Tensor], image_hw: T.Tuple):
        """RPN head and :func:`rpn_proposals` on the backbone's levels."""
        rpn_outs = self.proposal_generator.rpn_head(feats)
        return rpn_proposals(rpn_outs, self.anchors(feats), image_hw, self.config)

    def pool(self, feats: T.Sequence[torch.Tensor], boxes: torch.Tensor,
             levels: T.Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[B, N, 7, 7, C]`` ROIAlignV2 of ``boxes [B, N, 4]`` from p2..p5,
        at ``levels`` or at the canonical FPN level of each box; one pool
        call for the whole batch. ``roi_impl="auto"`` pools with K5 on
        CUDA tensors and with the matmul form on the CPU, as JAX picks per
        backend; ``"matmul"`` on CUDA tensors raises."""
        cfg = self.config
        if levels is None:
            levels = assign_fpn_levels(boxes)
        buf, offs, hw = pack_pyramid(feats[:4])
        impl = cfg.roi_impl if cfg.roi_impl != "auto" else ("dma" if buf.is_cuda else "matmul")
        if impl == "matmul" and buf.is_cuda:
            raise ValueError('roi_impl="matmul" is the CPU\'s pool: on CUDA tensors the detector pools with K5')
        pool = roi_align_pyramid_dma if impl == "dma" else roi_align_pyramid
        return pool(buf, offs, hw, cfg.strides[:4], boxes, levels, out_size=cfg.roi_resolution,
                    window=cfg.roi_window)

    def box_head(self, pooled: torch.Tensor) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """``pooled [N, 7, 7, C]`` -> (class logits, class-major deltas).
        fc1 keeps torch's weight layout, so the pool is flattened channel
        first, as detectron2 flattens its NCHW pool."""
        rh = self.roi_heads
        x = pooled.permute(0, 3, 1, 2).reshape(pooled.shape[0], -1)
        x = F.relu(rh.box_head.fc1(x))
        x = F.relu(rh.box_head.fc2(x))
        return rh.box_predictor.cls_score(x), rh.box_predictor.bbox_pred(x)

    def box_forward(self, images: torch.Tensor, boxes: torch.Tensor, levels: torch.Tensor):
        """Pool the fixed ``boxes [B, N, 4]`` at ``levels [B, N]`` and run the
        box head, bypassing the proposals: ``([B, N, C+1], [B, N, 4C])``."""
        pooled = self.pool(self.backbone_features(images), boxes, levels)
        B, N = pooled.shape[:2]
        cls, deltas = self.box_head(pooled.reshape(B * N, *pooled.shape[2:]))
        return cls.reshape(B, N, -1), deltas.reshape(B, N, -1)

    def forward(self, images: torch.Tensor, image_hw: T.Optional[T.Tuple] = None) -> T.Dict[str, torch.Tensor]:
        """``images``: ``[B, H, W, 3]`` canvas. ``image_hw``: the true resized
        size the boxes are clipped to (default: the canvas)."""
        hw = tuple(image_hw) if image_hw is not None else tuple(images.shape[1:3])
        feats = self.backbone_features(images)
        proposals, prop_valid = self.proposals(feats, hw)
        pooled = self.pool(feats, proposals)
        B, K = pooled.shape[:2]
        cls, deltas = self.box_head(pooled.reshape(B * K, *pooled.shape[2:]))
        return fast_rcnn_postprocess(cls.reshape(B, K, -1), deltas.reshape(B, K, -1), proposals,
                                     prop_valid, hw, self.config)


def init_rcnn_weights_(model: FasterRCNN, generator: torch.Generator) -> None:
    """Seeded weights on the model's device, for runs without a checkpoint:
    conv and linear weights normal with std ``fan_in ** -0.5`` and biases
    zero, but the RPN's two predictors normal 0.01 and the box predictor's
    class and box layers 0.01 and 0.001 (detectron2's own initialisation of
    those layers). Every frozen BatchNorm is the identity, except that the
    stem's divides by 64 (pixel-range input, mean subtracted, enters at unit
    scale) and the last norm of each residual branch scales by 0.2, so the
    stream stays near unit scale over 33 blocks and the proposals stay boxes
    inside the image, as a trained detector's do."""
    std = {model.proposal_generator.rpn_head.objectness_logits: 0.01,
           model.proposal_generator.rpn_head.anchor_deltas: 0.01,
           model.roi_heads.box_predictor.cls_score: 0.01,
           model.roi_heads.box_predictor.bbox_pred: 0.001}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, std.get(m, 1.0 / math.sqrt(m.weight[0].numel())), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            if isinstance(m, BatchNormInference):
                m.reset_statistics()
            if isinstance(m, BottleneckX):
                m.conv3.norm.weight.fill_(0.2)
        model.backbone.bottom_up.stem.conv1.norm.running_var.fill_(64.0 ** 2)


# ---------------------------------------------------------------------------
# preprocessing and detectron2 checkpoints

def resize_shortest_edge(hw: T.Tuple[int, int], short: int = 800, max_size: int = 1333) -> T.Tuple[int, int]:
    """d2 ``ResizeShortestEdge.get_output_shape`` incl. its +0.5 rounding."""
    h, w = hw
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def pad_to_divisible(hw: T.Tuple[int, int], div: int = 32) -> T.Tuple[int, int]:
    h, w = hw
    return ((h + div - 1) // div * div, (w + div - 1) // div * div)


# BGR pixel means of the published config (PIXEL_STD = 1, 1, 1)
PIXEL_MEAN_BGR = np.array([103.530, 116.280, 123.675], np.float32)


def predictor_canvas(frames: torch.Tensor, cfg: RCNNConfig) -> T.Tuple[torch.Tensor, T.Tuple[int, int]]:
    """detectron2's DefaultPredictor preprocessing of ``frames [B, H, W, 3]``
    (RGB 0..255): PIL-bilinear resize to the shortest-edge size, BGR, pixel
    mean subtracted, zero-padded to a 32-divisible canvas. Returns the
    float32 canvas ``[B, H', W', 3]`` and the resized ``(h, w)``."""
    f = frames.to(torch.float32)
    rh, rw = resize_shortest_edge(tuple(f.shape[1:3]), cfg.min_size_test, cfg.max_size_test)
    ch, cw = pad_to_divisible((rh, rw))
    bgr = resize_pil_matmul(f, (rh, rw)).flip(-1) - torch.from_numpy(PIXEL_MEAN_BGR).to(f.device)
    return F.pad(bgr, (0, 0, 0, cw - rw, 0, ch - rh)), (rh, rw)


def load_detectron2_pkl(path: str) -> T.Dict[str, torch.Tensor]:
    """A detectron2 model-zoo ``.pkl``: a pickled ``{"model": {name:
    ndarray}, ...}`` of plain numpy arrays, read without detectron2."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    model = data.get("model", data) if isinstance(data, dict) else data
    return {k: torch.from_numpy(np.array(v)) for k, v in model.items() if isinstance(v, np.ndarray)}


def canonical_rcnn_state_dict(sd: T.Mapping[str, T.Any]) -> T.Dict[str, torch.Tensor]:
    """A detectron2 ``GeneralizedRCNN`` state_dict in :class:`FasterRCNN`'s
    names (they are the same), without the buffers the port recomputes
    (``pixel_mean``, ``pixel_std``, the anchor generator's cell anchors)."""
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v for k, v in sd.items()
            if k not in ("pixel_mean", "pixel_std") and not k.startswith("proposal_generator.anchor_generator")}
