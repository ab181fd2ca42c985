"""Feature extraction: video frames -> SMPL mesh parameters, ``token_out``
(the "vit" modality) and DWPose's 120-d whole-body keypoints (``kp2d``),
batched on the device.

Port of ``video_gen_evals_tpu/pipelines/extract.py`` (ref ``extract_mesh.py``,
``modifications/{mesh_generator,process_video,dwpose_init}.py``). Per video,
in fixed chunks of ``frame_batch`` frames on the device:

  detect (YOLOX, or the Faster R-CNN for the mesh boxes) -> ViTDet crops ->
  ViT-H -> SMPL token head                              (the mesh branch)
  YOLOX's pose boxes -> mmpose top-down crops -> RTMPose -> SimCC decode ->
  back to the frame -> openpose order -> DWPose's postprocess -> 120-d
                                                        (the keypoint branch)

The mesh output is the extraction contract the scoring path reads: ``pose
[T,23,3,3]``, ``betas [T,10]``, ``global_orient [T,1,3,3]``, ``vit [T,1024]``
and ``frame_idx [T]``; the keypoint output ``kp120 [T,120]`` and ``valid [T]``.

The detect stage: with the default ``mesh_detector="yolox"`` one pass of the
YOLOX person detector on Megvii's letterbox canvas with DWPose's
postprocessing (``models/detector.py``) gives both branches their boxes;
with ``"rcnn"`` the Faster R-CNN X101-32x8d-FPN (``models/rcnn.py``, the
reference's mesh-path detector, ref ``mesh_generator.py:69-74``), in its
exact configuration or JAX's ``fast()``, gives the mesh boxes and the
single-person rule, and YOLOX still gives the keypoint branch its pose boxes
(DWPose's own detector). A mesh frame is kept iff exactly one person box
scores above ``det_score_thresh``, and a video is rejected when fewer than
``min_single_ratio`` of its frames are kept (ref ``:103-117``);
``keep_all_frames`` turns the rule off. The keypoint branch poses the full
frame where YOLOX finds no person (onnxpose's fallback), so no keypoint frame
is dropped for lack of a detection.

:meth:`Extractor.run_tree` extracts an ``<action>/<video>`` tree resumably
(per-action JSON ledgers, ref ``extract_mesh.py:121-194``), decoding and
uploading on host threads ahead of the device, and ``python -m
video_gen_evals_tpu_torch.pipelines.extract`` is its CLI. A multi-host sweep
(``--num-hosts N --host-id I``) extracts the strided shard I of each
action's sorted videos, with per-host ledgers ``<action>.host<I>of<N>.json``
and ``RUN_CONFIG.host<I>of<N>.json``; outputs are per-video files, so hosts
may share one output root. ``--mesh-data N`` runs N local ranks, each on its
own device (``parallel.launch_local``), and each rank is one shard of the
sweep as a host is (rank r of host h: shard ``h * N + r`` of ``H * N``).
JAX shards the frames of each chunk over its mesh instead; both write the
same per-video files.

``preproc="legacy"`` keeps JAX's home-grown geometry of its first rounds,
which matches no published weight pipeline: the detector sees the
ImageNet-normalised frame stretched to its input (``person_detections``:
``obj * cls[person]``, NMS, ``det_score_thresh`` for both branches, no
full-frame pose fallback), and the mesh and pose crops are
``ops/image.py::batched_person_crops`` (boxes scaled by ``crop_scale`` and
expanded to the crop's aspect, ImageNet-normalised); the keypoints are mapped
back through the inverse of that crop, and a frame with no person is dropped
from the keypoints.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import sys
import typing as T

import numpy as np
import torch
from torch import nn

from ..models.detector import (
    DetectorConfig,
    YOLOXDetector,
    dwpose_person_detections,
    init_yolox_weights_,
    person_detections,
    single_person_mask,
)
from ..models.pose2d import (
    PoseNetConfig,
    RTMPoseNet,
    dwpose_postprocess,
    flatten_first_person,
    init_pose_weights_,
    wholebody_to_openpose,
)
from ..models.rcnn import (
    FasterRCNN,
    RCNNConfig,
    canonical_rcnn_state_dict,
    clip_boxes,
    init_rcnn_weights_,
    predictor_canvas,
)
from ..models.smpl_head import SMPLHeadConfig, SMPLTokenDecoderHead
from ..models.vit import ViTBackbone, ViTConfig
from ..ops.image import batched_person_crops, crop_resize_matmul, expand_to_aspect, true_div
from ..ops.upstream_crops import dwpose_backmap, dwpose_topdown_crop, vitdet_mesh_crop, yolox_letterbox
from ..parallel import Rank, shard_items
from ..utils.device import disable_tf32, resolve_device
from ..utils.io import ResumableLedger, load_all_frames, save_video_npz

# (matmul_precision, param_dtype) -> the dtype the networks work in
_WORKING_DTYPE = {
    ("highest", "float32"): torch.float32,
    ("high", "float32"): torch.float32,
    ("default", "bfloat16"): torch.bfloat16,
}
# the legacy crops' and detector canvas's ImageNet normalisation (0..255 scale)
_MEAN = (123.675, 116.28, 103.53)
_STD = (58.395, 57.12, 57.375)
_MESH_KEYS = (("pose", "body_pose"), ("betas", "betas"), ("global_orient", "global_orient"), ("vit", "token_out"))


@dataclasses.dataclass
class ExtractorConfig:
    """The JAX package's ``ExtractorConfig``. ``preproc``: ``"upstream"``
    (the published preprocessing each net's weights expect) or ``"legacy"``
    (JAX's home-grown crops and detector canvas, ``crop_scale``; see the
    module docstring).

    Numerics, named by what is computed: ``matmul_precision="highest"`` runs
    every product in true fp32 (TF32 off) and the attention kernels at
    ``"highest"``. ``"high"`` (the JAX default, bf16x3 on the TPU) runs the
    same fp32 path here, which is at least as exact. ``"default"`` with
    ``param_dtype="bfloat16"`` is the fast mode: bf16 parameters and
    activations in every network (both detectors and the pose backbone too),
    fp32 sums, the attention kernels at ``"default"``, the rotation matrices
    orthonormalised in fp32, boxes decoded, ranked and suppressed in fp32, and
    the pose net's channel-attention gates, its whole RTMCC head (ScaleNorm,
    GAU, SimCC classifiers) and the SimCC decode in fp32 on the bf16-rounded
    weights: an argmax over bf16 logits ties often, and a tie moves a
    keypoint by whole bins. Other pairs are refused. (JAX's bf16 mode casts
    the parameters only: flax promotes the detectors' and the pose net's fp32
    activations, so there they run in fp32 on bf16-rounded weights.)"""

    det: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    head: SMPLHeadConfig = dataclasses.field(default_factory=SMPLHeadConfig)
    pose: PoseNetConfig = dataclasses.field(default_factory=PoseNetConfig)
    frame_batch: int = 32
    preproc: str = "upstream"
    crop_scale: float = 1.2        # legacy-mode crop expansion only
    vitdet_rescale: float = 2.5    # ViTDetDataset rescale_factor
    vitdet_antialias: bool = True  # hmr2 gaussian pre-blur (df > 1.1)
    pose_padding: float = 1.25     # mmpose bbox_xyxy2cs padding
    # the reference's keypoint frame dropping: only valid rows are saved
    kp_bug_compat: bool = True
    matmul_precision: str = "high"
    param_dtype: str = "float32"   # "float32" | "bfloat16"
    # mesh-path box provenance when process_video gets no boxes: "yolox" is the
    # YOLOX detector that also gives the keypoint branch its boxes; "rcnn" the
    # Faster R-CNN X101-FPN (the reference's mesh detector)
    mesh_detector: str = "yolox"
    rcnn: T.Optional[RCNNConfig] = None   # None: RCNNConfig.x101_32x8d()
    # the detect stage's canvas is ~70x a crop's pixel area, so it chunks smaller
    rcnn_frame_batch: int = 8
    det_score_thresh: float = 0.5
    min_single_ratio: float = 0.8
    # DWPose onnxdet thresholds: candidates > 0.1 before NMS, class-agnostic
    # NMS at 0.45, the keypoint branch's person boxes > 0.3
    pose_det_prefilter: float = 0.1
    pose_det_iou: float = 0.45
    pose_det_score_thresh: float = 0.3
    # onnxpose poses the full frame where no person is detected
    pose_fullframe_fallback: bool = True
    # every frame counts as single-person: the detector still runs, but the
    # reference's rule neither drops frames nor rejects the video
    keep_all_frames: bool = False

    def __post_init__(self):
        if self.preproc not in ("upstream", "legacy"):
            raise ValueError(f"unknown preproc {self.preproc!r}")
        if (self.matmul_precision, self.param_dtype) not in _WORKING_DTYPE:
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r} with param_dtype={self.param_dtype!r} "
                f"is not a mode of the port; the modes are {sorted(_WORKING_DTYPE)}")
        if self.rcnn is None:
            self.rcnn = RCNNConfig.x101_32x8d()
        if self.mesh_detector not in ("yolox", "rcnn"):
            raise ValueError(f"unknown mesh_detector {self.mesh_detector!r}")
        if self.preproc == "upstream" and self.det.input_hw[0] != self.det.input_hw[1]:
            raise ValueError(f"the letterbox needs a square detector input, not {self.det.input_hw}")
        if self.frame_batch < 1 or self.rcnn_frame_batch < 1:
            raise ValueError(f"frame_batch {self.frame_batch} and rcnn_frame_batch "
                             f"{self.rcnn_frame_batch} must be positive")

    @property
    def working_dtype(self) -> torch.dtype:
        return _WORKING_DTYPE[(self.matmul_precision, self.param_dtype)]

    @classmethod
    def parity(cls, **kw) -> "ExtractorConfig":
        """The reference-reproduction preset (``--parity`` on the CLI): the
        Faster R-CNN X101-FPN mesh boxes with the exact RCNNConfig (ref
        ``mesh_generator.py:69-74``), upstream preprocessing, matmul
        ``"high"``, fp32 parameters, the reference's keypoint frame dropping,
        the anti-aliased ViTDet crops and the full-frame pose fallback."""
        kw.setdefault("mesh_detector", "rcnn")
        kw.setdefault("preproc", "upstream")
        kw.setdefault("matmul_precision", "high")
        kw.setdefault("param_dtype", "float32")
        kw.setdefault("kp_bug_compat", True)
        kw.setdefault("vitdet_antialias", True)
        kw.setdefault("pose_fullframe_fallback", True)
        return cls(**kw)   # rcnn=None resolves to the exact x101_32x8d()

    def is_parity(self) -> bool:
        """True iff every knob that changes the features' provenance is
        :meth:`parity`'s (``matmul_precision`` may also be ``"highest"``).
        Recorded in each run's ``RUN_CONFIG.json``."""
        return (self.mesh_detector == "rcnn" and self.preproc == "upstream"
                and self.matmul_precision in ("high", "highest") and self.param_dtype == "float32"
                and self.kp_bug_compat and self.vitdet_antialias and self.pose_fullframe_fallback
                and self.rcnn == RCNNConfig.x101_32x8d())


def _is_device_fault(err: BaseException) -> bool:
    """A kernel build or launch failure, or a CUDA error: never one video's
    fault, so :meth:`Extractor.run_tree` raises it instead of recording it."""
    msg = str(err)
    return isinstance(err, RuntimeError) and ("CUDA error" in msg or "nvcc" in msg)


def seeded_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from ``generator`` (which lives on the module's
    device), in the scheme of the JAX modules' initialisers: projection and
    conv weights normal with std ``fan_in ** -0.5``, LayerNorm scales one,
    biases zero, the ViT's position table normal 0.02 cut at two sigma, the
    decoder's normal 1.0, the codebook normal 0.02; buffers zero."""
    norm_weights = {f"{name}.weight" for name, m in module.named_modules()
                    if isinstance(m, nn.LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in norm_weights:
                p.fill_(1.0)
            elif leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator).clamp_(-0.04, 0.04)
            elif leaf == "pos_embedding":
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf == "codebook":
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "weight" and p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=generator)
            else:
                p.zero_()
        for buf in module.buffers():
            buf.zero_()


def _build_net(factory, config, state_dict, generator, device, dtype) -> nn.Module:
    """The module on ``device`` in ``dtype``, its weights from ``state_dict``
    or, without one, drawn from ``generator`` on the device. It is built
    without storage first, so full-width weights never exist on the host."""
    with torch.device("meta"):
        net = factory(config)
    net.to_empty(device=device)
    if state_dict is None:
        seeded_init_(net, generator)
    else:
        for buf in net.buffers():
            buf.zero_()
        result = net.load_state_dict(state_dict, strict=False)
        buffers = {name for name, _ in net.named_buffers()}
        missing = [k for k in result.missing_keys if k not in buffers]
        if missing or result.unexpected_keys:
            raise ValueError(
                f"{type(net).__name__}: the state_dict does not match the module "
                f"(missing {missing[:5]}, unexpected {result.unexpected_keys[:5]}): "
                "refusing a half-loaded network")
    return net.to(dtype).eval()


def _build_detector(factory, config, state_dict, init_, generator, device, dtype) -> nn.Module:
    """A detector on ``device`` in ``dtype``, its weights from a checkpoint's
    state_dict in its published names (every key used, none missing) or
    drawn from ``generator`` by ``init_``."""
    with torch.device("meta"):
        net = factory(config)
    net.to_empty(device=device)
    if state_dict is None:
        init_(net, generator)
    else:
        net.load_state_dict(state_dict, strict=True)
    return net.to(dtype).eval()


class Extractor:
    """The detect stage, the mesh branch (crops, ViT backbone, SMPL head) and
    the keypoint branch (pose crops, RTMPose, DWPose's postprocess), in fixed
    chunks on the device.

    The YOLOX net is built in both modes, as in JAX (in rcnn mode the
    keypoint branch takes its pose boxes). ``state_dicts`` may hold ``"vit"``
    and ``"head"`` (state_dicts in the modules' own names), ``"det"``
    (Megvii's names), ``"pose"`` (mmpose's names) and, in rcnn mode,
    ``"rcnn"`` (detectron2's names). A net without one is drawn on the
    device: the ViT and then the head from a generator seeded with ``seed``,
    YOLOX from one seeded with ``seed + 1``, the R-CNN from one seeded with
    ``seed + 2`` and the pose net from one seeded with ``seed + 3``, so that
    no net's weights depend on another's size or on the mode. ``device=None``
    means the card and raises without one."""

    def __init__(self, config: T.Optional[ExtractorConfig] = None,
                 state_dicts: T.Optional[T.Mapping[str, T.Mapping[str, torch.Tensor]]] = None,
                 seed: int = 0, device: T.Union[None, str, torch.device] = None):
        self.cfg = cfg = config or ExtractorConfig()
        self.device = resolve_device("cuda" if device is None else device)
        disable_tf32()
        state_dicts = dict(state_dicts or {})
        nets = {"vit", "head", "det", "pose"} | ({"rcnn"} if cfg.mesh_detector == "rcnn" else set())
        unknown = set(state_dicts) - nets
        if unknown:
            raise ValueError(f"state_dicts holds nets this configuration does not have: {sorted(unknown)}")
        if cfg.head.context_dim != cfg.vit.embed_dim:
            raise ValueError(f"head.context_dim {cfg.head.context_dim} != vit.embed_dim {cfg.vit.embed_dim}")

        def generator(offset):
            return torch.Generator(device=self.device).manual_seed(seed + offset)

        dtype = cfg.working_dtype
        mesh_gen = generator(0)
        self.backbone = _build_net(ViTBackbone, cfg.vit, state_dicts.get("vit"), mesh_gen, self.device, dtype)
        self.head = _build_net(SMPLTokenDecoderHead, cfg.head, state_dicts.get("head"), mesh_gen, self.device, dtype)
        self.detector = _build_detector(YOLOXDetector, cfg.det, state_dicts.get("det"), init_yolox_weights_,
                                        generator(1), self.device, dtype)
        rcnn_sd = state_dicts.get("rcnn")
        self.rcnn = (_build_detector(FasterRCNN, cfg.rcnn, None if rcnn_sd is None else canonical_rcnn_state_dict(rcnn_sd),
                                     init_rcnn_weights_, generator(2), self.device, dtype)
                     if cfg.mesh_detector == "rcnn" else None)
        self.pose_net = _build_detector(RTMPoseNet, cfg.pose, state_dicts.get("pose"), init_pose_weights_,
                                        generator(3), self.device, dtype).fp32_head_()

    @classmethod
    def from_checkpoints(cls, config: T.Optional[ExtractorConfig] = None, *,
                         tokenhmr: T.Optional[str] = None, dwpose: T.Optional[str] = None,
                         yolox: T.Optional[str] = None, rcnn: T.Optional[str] = None,
                         seed: int = 0, device=None) -> "Extractor":
        """An Extractor with the published weights: TokenHMR (a ``.ckpt``,
        ``.pt`` or ``.npz`` whose ``backbone.*`` and ``smpl_head.*`` keys are
        the two networks'; the head's classifier geometry is read from the
        file), DWPose's RTMPose (an mmpose ``dwpose_l`` checkpoint; a default
        ``pose`` becomes ``dwpose_l()``), Megvii's YOLOX (``yolox_l.pth``; a
        default ``det`` becomes ``yolox_l()``) and the detectron2 Faster
        R-CNN (``.pkl`` or ``.pt``), which selects ``mesh_detector="rcnn"``.
        Nets without a file are drawn from ``seed``."""
        from .weights import extraction_params_from_checkpoints, load_torch_state_dict, published_config

        tokenhmr = load_torch_state_dict(tokenhmr) if tokenhmr else None
        cfg = published_config(config or ExtractorConfig(), tokenhmr=tokenhmr, dwpose=dwpose,
                               yolox=yolox, rcnn=rcnn)
        converted = extraction_params_from_checkpoints(cfg, tokenhmr=tokenhmr, dwpose=dwpose, yolox=yolox,
                                                       rcnn=rcnn)
        return cls(cfg, state_dicts=converted, seed=seed, device=device)

    def set_attention_impl(self, impl: str) -> None:
        """Switch every backbone block to another ``attention_impl`` on the
        same weights (the impls share their parameters)."""
        self.cfg = dataclasses.replace(self.cfg, vit=dataclasses.replace(self.cfg.vit, attention_impl=impl))
        self.backbone.config = self.cfg.vit
        for blk in self.backbone.blocks:
            blk.attn.attention_impl = impl

    # ------------------------------------------------------------------
    # the stages, on one chunk on the device

    def _legacy_crops(self, frames: torch.Tensor, boxes_xyxy: torch.Tensor,
                      out_hw: T.Tuple[int, int]) -> torch.Tensor:
        """The legacy mode's ImageNet-normalised ``batched_person_crops``."""
        mean, std = (torch.tensor(v, device=frames.device) for v in (_MEAN, _STD))
        return batched_person_crops(frames.to(torch.float32), boxes_xyxy.to(torch.float32), out_hw=out_hw,
                                    scale=self.cfg.crop_scale, mean=mean, std=std)

    def crops(self, frames: torch.Tensor, boxes_xyxy: torch.Tensor) -> torch.Tensor:
        """Normalised mesh crops ``[B, h, w, 3]`` (fp32) of ``frames``
        (``[B, H, W, 3]``, uint8 or float, RGB 0..255): ViTDet's, or in the
        legacy mode ``batched_person_crops``."""
        cfg = self.cfg
        if cfg.preproc == "legacy":
            return self._legacy_crops(frames, boxes_xyxy, cfg.vit.img_size)
        return vitdet_mesh_crop(frames.to(torch.float32), boxes_xyxy.to(torch.float32),
                                out_hw=cfg.vit.img_size, rescale_factor=cfg.vitdet_rescale,
                                antialias=cfg.vitdet_antialias)

    @torch.inference_mode()
    def mesh_forward(self, frames: torch.Tensor, boxes_xyxy: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """One chunk on the device: crops -> backbone -> head. Returns the
        head's dict (``body_pose``, ``betas``, ``global_orient``, ``cam``,
        ``token_out``) as fp32 tensors on the device."""
        crops = self.crops(frames, boxes_xyxy).to(self.cfg.working_dtype)
        tokens, _fmap = self.backbone(crops)
        return {k: v.float() for k, v in self.head(tokens).items()}

    @torch.inference_mode()
    def pose_forward(self, frames: torch.Tensor, boxes_xyxy: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """One chunk of the keypoint branch (JAX's ``pose_forward``):
        DWPose's top-down crops of the pose boxes (``batched_person_crops`` in
        the legacy mode), RTMPose and its SimCC decode, the keypoints mapped
        back to the frame and put in openpose's order. Returns ``kps [B, 134,
        2]`` (frame pixels) and ``scores [B, 134]``, fp32."""
        cfg = self.cfg
        if cfg.preproc == "legacy":
            return self._legacy_pose_forward(frames, boxes_xyxy)
        crops, center, scale = dwpose_topdown_crop(frames.to(torch.float32), boxes_xyxy.to(torch.float32),
                                                   input_hw=cfg.pose.input_hw, padding=cfg.pose_padding)
        kps_crop, scores = self.pose_net(crops)
        kps, scores = wholebody_to_openpose(dwpose_backmap(kps_crop, center, scale, cfg.pose.input_hw), scores)
        return {"kps": kps, "scores": scores}

    def _legacy_pose_forward(self, frames: torch.Tensor, boxes_xyxy: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """JAX's legacy ``pose_forward``: the crops, RTMPose, and each crop
        pixel mapped back through the inverse of the crop's sampling
        (``x0 + (x + 0.5) * w / pw - 0.5`` on the scaled, aspect-expanded box)."""
        cfg = self.cfg
        ph, pw = cfg.pose.input_hw
        boxes = boxes_xyxy.to(torch.float32)
        kps_crop, scores = self.pose_net(self._legacy_crops(frames, boxes, (ph, pw)))
        x0, y0, x1, y1 = boxes.unbind(-1)
        w_e, h_e = expand_to_aspect((x1 - x0) * cfg.crop_scale, (y1 - y0) * cfg.crop_scale, pw / ph)
        bx0 = (x0 + x1) / 2 - w_e / 2
        by0 = (y0 + y1) / 2 - h_e / 2
        xf = bx0[:, None] + (kps_crop[..., 0] + 0.5) * true_div(w_e, pw)[:, None] - 0.5
        yf = by0[:, None] + (kps_crop[..., 1] + 0.5) * true_div(h_e, ph)[:, None] - 0.5
        kps, scores = wholebody_to_openpose(torch.stack([xf, yf], dim=-1), scores)
        return {"kps": kps, "scores": scores}

    @staticmethod
    def kp_post(kps134: torch.Tensor, sc134: torch.Tensor,
                frame_wh: T.Tuple[float, float]) -> T.Tuple[torch.Tensor, torch.Tensor]:
        """DWPose's postprocess and the 120-d flatten over all frames at once,
        each frame holding its one posed person (P = 1): ``(kp120 [T, 120],
        valid [T])``. Replaces the reference's per-frame host loop (ref
        ``process_video.py:63-86``)."""
        return flatten_first_person(dwpose_postprocess(kps134[:, None], sc134[:, None], frame_wh))

    @torch.inference_mode()
    def detect_yolox(self, frames: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """The YOLOX detect stage on one chunk ``[B, H, W, 3]`` (RGB 0..255),
        JAX's ``detect``. Upstream: Megvii's letterbox, the detector, DWPose's
        postprocess (:func:`dwpose_person_detections`), boxes divided by the
        letterbox ratio (unclipped); the mesh rule keeps person boxes above
        ``det_score_thresh``, the keypoint rule those above
        ``pose_det_score_thresh``. Legacy: the frame stretched to the
        detector's input (``crop_resize_matmul`` of the whole frame) and
        ImageNet-normalised, :func:`person_detections` above
        ``det_score_thresh`` for both rules, boxes scaled back by ``W / dw``
        and ``H / dh``. Returns ``box_mesh [B, 4]`` (the best mesh person box,
        or slot 0's box where there is none), ``box_pose [B, 4]`` (the best
        pose box, or, upstream, the full frame where there is none and
        ``pose_fullframe_fallback``), ``single [B]`` (exactly one mesh
        person) and ``present [B]`` (at least one pose person)."""
        cfg = self.cfg
        H, W = frames.shape[1:3]
        upstream = cfg.preproc == "upstream"
        if upstream:
            canvas, ratio = yolox_letterbox(frames.to(torch.float32), size=cfg.det.input_hw[0])
            boxes, scores, person = dwpose_person_detections(
                self.detector(canvas), prefilter_thresh=cfg.pose_det_prefilter, iou_thresh=cfg.pose_det_iou,
                max_out=cfg.det.max_detections)
            boxes = boxes * (1.0 / ratio)
            mesh_valid = person & (scores > cfg.det_score_thresh)
            pose_valid = person & (scores > cfg.pose_det_score_thresh)
        else:
            dh, dw = cfg.det.input_hw
            full = torch.tensor([W / 2.0, H / 2.0, float(W), float(H)], device=frames.device)
            canvas = crop_resize_matmul(frames.to(torch.float32), full.expand(frames.shape[0], 4), (dh, dw))
            mean, std = (torch.tensor(v, device=frames.device) for v in (_MEAN, _STD))
            boxes, scores, mesh_valid = person_detections(self.detector((canvas - mean) / std),
                                                          score_thresh=cfg.det_score_thresh)
            boxes = boxes * torch.tensor([W / dw, H / dh, W / dw, H / dh], dtype=boxes.dtype, device=boxes.device)
            pose_valid = mesh_valid
        present = pose_valid.any(dim=-1)
        best_m = torch.argmax(torch.where(mesh_valid, scores, -1.0), dim=-1)
        best_p = torch.argmax(torch.where(pose_valid, scores, -1.0), dim=-1)
        box_pose = torch.take_along_dim(boxes, best_p[:, None, None], dim=1)[:, 0]
        if upstream and cfg.pose_fullframe_fallback:   # onnxpose: no detection -> pose on [0, 0, W, H]
            full = torch.tensor([0.0, 0.0, float(W), float(H)], device=boxes.device)
            box_pose = torch.where(present[:, None], box_pose, full)
        return {"box_mesh": torch.take_along_dim(boxes, best_m[:, None, None], dim=1)[:, 0],
                "box_pose": box_pose, "single": single_person_mask(mesh_valid), "present": present}

    @torch.inference_mode()
    def detect_rcnn(self, frames: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """The R-CNN detect stage on one chunk ``[B, H, W, 3]`` (RGB 0..255):
        detectron2's DefaultPredictor preprocessing (``predictor_canvas``),
        the detector, boxes rescaled and clipped to the
        frame, then the reference's rule: the person boxes (class 0) scoring
        above ``det_score_thresh``. Returns ``box_mesh [B, 4]`` (the best
        person box, or the top detection where there is none), ``single [B]``
        (exactly one person box) and ``present [B]`` (at least one)."""
        cfg = self.cfg
        H, W = frames.shape[1:3]
        canvas, (rh, rw) = predictor_canvas(frames, cfg.rcnn)
        det = self.rcnn(canvas, image_hw=(rh, rw))
        sx, sy = W / rw, H / rh
        boxes = clip_boxes(det["boxes"] * torch.tensor([sx, sy, sx, sy], device=canvas.device), (H, W))
        person = (det["classes"] == 0) & (det["scores"] > cfg.det_score_thresh) & det["valid"]
        best = torch.argmax(torch.where(person, det["scores"], -1.0), dim=-1)
        return {"box_mesh": torch.take_along_dim(boxes, best[:, None, None], dim=1)[:, 0],
                "single": single_person_mask(person), "present": person.any(dim=-1)}

    # ------------------------------------------------------------------
    # whole videos

    def detect_stage(self, frames: torch.Tensor, with_keypoints: bool = False) -> T.Dict[str, torch.Tensor]:
        """The mode's detect stage over a video on the device, the results
        kept there. yolox mode: :meth:`detect_yolox` in chunks of
        ``frame_batch``, one pass for both branches. rcnn mode:
        :meth:`detect_rcnn` in chunks of ``min(rcnn_frame_batch,
        frame_batch)`` gives ``box_mesh`` and ``single``; with keypoints,
        ``box_pose`` and ``present`` come from a YOLOX pass (DWPose's own
        boxes)."""
        if self.rcnn is None:
            return self._batched(self.detect_yolox, frames, fetch=False)
        det = self._batched(self.detect_rcnn, frames, batch=min(self.cfg.rcnn_frame_batch, self.cfg.frame_batch),
                            fetch=False)
        if with_keypoints:
            pose = self._batched(self.detect_yolox, frames, fetch=False)
            det["box_pose"], det["present"] = pose["box_pose"], pose["present"]
        return det

    def _batched(self, fn, frames: torch.Tensor, *extra: torch.Tensor, batch: T.Optional[int] = None,
                 fetch: bool = True) -> T.Dict[str, T.Any]:
        """Run ``fn`` on fixed chunks of ``batch`` (default ``frame_batch``)
        frames: the tail is padded by repeating its last frame and cut again,
        chunk outputs stay on the device, and with ``fetch`` the whole result
        is fetched once at the end."""
        B = batch or self.cfg.frame_batch
        n = frames.shape[0]
        outs = []
        for lo in range(0, n, B):
            chunk = [t[lo:lo + B] for t in (frames, *extra)]
            pad = B - chunk[0].shape[0]
            if pad:
                chunk = [torch.cat([c, c[-1:].expand(pad, *c.shape[1:])]) for c in chunk]
            out = fn(*chunk)
            outs.append({k: v[:B - pad] for k, v in out.items()} if pad else out)
        joined = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return {k: v.cpu().numpy() for k, v in joined.items()} if fetch else joined

    def _upload(self, frames: T.Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """``[T, H, W, 3]`` frames (uint8 RGB) on the device, uploaded once in
        their own type and cast chunk by chunk there; a tensor already on the
        device (a prefetch thread's upload) passes through."""
        t = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frames))
        t = t.to(self.device)
        if t.ndim != 4 or t.shape[-1] != 3:
            raise ValueError(f"frames must be [T, H, W, 3], got {tuple(t.shape)}")
        if t.shape[0] == 0:
            raise ValueError("a video needs at least one frame")
        return t

    def _kept(self, single: np.ndarray) -> T.Optional[np.ndarray]:
        """The mesh frames kept by the reference's rule (every frame with
        ``keep_all_frames``), or None for a rejected video."""
        if self.cfg.keep_all_frames:
            return np.arange(len(single))
        if single.sum() == 0 or single.mean() < self.cfg.min_single_ratio:
            return None
        return np.flatnonzero(single)

    def _kp_frame_mask(self, valid: np.ndarray, present: np.ndarray) -> np.ndarray:
        """The keypoint frames kept: with onnxpose's full-frame fallback
        (upstream only) no frame is dropped for lack of a detection, without
        it a frame with no pose person is; ``keep_all_frames`` keeps every
        frame."""
        if self.cfg.keep_all_frames:
            return np.ones_like(valid, dtype=bool)
        if self.cfg.preproc == "upstream" and self.cfg.pose_fullframe_fallback:
            return valid
        return valid & present

    @staticmethod
    def _mesh_dict(out: T.Mapping[str, T.Any], keep: np.ndarray) -> T.Dict[str, T.Any]:
        """The extraction contract of the kept frames of ``out`` (numpy
        arrays, or tensors left on the device)."""
        rows = out["token_out"]
        if isinstance(rows, torch.Tensor):
            keep_rows = torch.from_numpy(keep).to(rows.device)
            mesh = {key: out[src][keep_rows] for key, src in _MESH_KEYS}
        else:
            mesh = {key: out[src][keep] for key, src in _MESH_KEYS}
        mesh["frame_idx"] = keep.astype(np.int32)
        return mesh

    def _keypoints(self, frames_dev: torch.Tensor, det: T.Mapping[str, torch.Tensor],
                   fetch: bool = True) -> T.Dict[str, T.Any]:
        """The keypoint branch over a video on its detect stage's pose boxes:
        ``kp120 [T, 120]`` (fp32; left on the device unless ``fetch``) and the
        frame mask ``valid [T]``."""
        kp = self._batched(self.pose_forward, frames_dev, det["box_pose"], fetch=False)
        H, W = frames_dev.shape[1:3]
        kp120, valid = self.kp_post(kp["kps"], kp["scores"], (float(W), float(H)))
        valid = self._kp_frame_mask(valid.cpu().numpy(), det["present"].cpu().numpy())
        return {"kp120": kp120.cpu().numpy() if fetch else kp120, "valid": valid}

    def process_video_full(self, frames: T.Union[None, np.ndarray, torch.Tensor], with_keypoints: bool = False,
                           frames_dev: T.Optional[torch.Tensor] = None
                           ) -> T.Tuple[T.Optional[T.Dict[str, np.ndarray]], T.Optional[T.Dict[str, np.ndarray]]]:
        """Mesh (and keypoint) extraction of one video on one upload and one
        detect pass shared by both branches. ``frames``: ``[T, H, W, 3]``
        uint8 RGB, or None with ``frames_dev`` (the frames already on the
        device, e.g. from a prefetch thread).

        Returns ``(mesh, kp)``: ``mesh`` as :meth:`process_video` gives it,
        ``kp`` None without keypoints, else ``{"kp120": [T, 120], "valid":
        [T]}`` over every frame of the video. A video that fails the
        single-person ratio test (ref ``mesh_generator.py:113-117``) gives
        ``(None, None)``; its mask is read before the mesh and pose work, so a
        rejected video costs neither."""
        frames_dev = self._upload(frames if frames_dev is None else frames_dev)
        det = self.detect_stage(frames_dev, with_keypoints)
        keep = self._kept(det["single"].cpu().numpy())
        if keep is None:
            return None, None
        mesh = self._mesh_dict(self._batched(self.mesh_forward, frames_dev, det["box_mesh"]), keep)
        return mesh, (self._keypoints(frames_dev, det) if with_keypoints else None)

    def process_video(self, frames: T.Union[np.ndarray, torch.Tensor],
                      boxes_xyxy: T.Union[None, np.ndarray, torch.Tensor] = None
                      ) -> T.Optional[T.Dict[str, np.ndarray]]:
        """Mesh extraction for one video. ``frames``: ``[T, H, W, 3]`` uint8
        RGB, uploaded once and cast on the device chunk by chunk.

        With ``boxes_xyxy`` (``[T, 4]``, one person box a frame in frame
        pixels) every frame is kept. Without, the mode's detect stage gives
        the boxes and the single-person mask (:meth:`process_video_full`):
        unless ``keep_all_frames``, the video is rejected (``None``) when no
        frame, or fewer than ``min_single_ratio`` of them, hold exactly one
        person, and otherwise only those frames are returned
        (``frame_idx``)."""
        if boxes_xyxy is None:
            return self.process_video_full(frames)[0]
        frames_dev = self._upload(frames)
        n = frames_dev.shape[0]
        boxes_dev = torch.as_tensor(boxes_xyxy, dtype=torch.float32).to(self.device)
        if tuple(boxes_dev.shape) != (n, 4):
            raise ValueError(f"boxes must be [{n}, 4], got {tuple(boxes_dev.shape)}")
        return self._mesh_dict(self._batched(self.mesh_forward, frames_dev, boxes_dev), np.arange(n))

    def process_video_keypoints(self, frames: T.Union[np.ndarray, torch.Tensor]) -> T.Dict[str, np.ndarray]:
        """Whole-body keypoints of one video (ref ``process_video.py``) on
        YOLOX's pose boxes, in either mode: ``{"kp120": [T, 120], "valid":
        [T]}``. With ``kp_bug_compat`` a caller keeps only the valid rows, as
        the reference drops frames."""
        frames_dev = self._upload(frames)
        return self._keypoints(frames_dev, self._batched(self.detect_yolox, frames_dev, fetch=False))

    def process_videos_streamed(self, items: T.Sequence[T.Tuple[str, T.Union[np.ndarray, torch.Tensor]]],
                                with_keypoints: bool = False, upload_threads: int = 2,
                                max_stream_frames: int = 2048, fetch_arrays: bool = True):
        """Cross-video streamed extraction: the frames of a same-resolution
        group of videos run through detect -> mesh [-> pose] as one chunked
        stream, then the results are split per video. Per-video results are
        :meth:`process_video_full`'s (the single-person rule and the keypoint
        mask apply per video); what changes is the execution shape: full
        ``frame_batch`` chunks whatever the videos' lengths, and a fetch per
        stage per super-batch of at most ``max_stream_frames`` frames. The
        uploads run on ``upload_threads`` host threads.

        ``fetch_arrays=False`` leaves the ``[T, D]`` outputs on the device
        (only the masks are fetched, for the keep indices).

        Returns ``(mesh_by_name, kp_by_name)``; a rejected video maps to None
        in both, and without keypoints every ``kp`` is None."""
        mesh_by_name: T.Dict[str, T.Any] = {}
        kp_by_name: T.Dict[str, T.Any] = {}
        groups: T.Dict[T.Tuple[int, int], T.List] = {}
        for name, frames in items:
            groups.setdefault(tuple(frames.shape[1:3]), []).append((name, frames))
        with concurrent.futures.ThreadPoolExecutor(max_workers=upload_threads) as pool:
            for group in groups.values():
                batches: T.List[T.List] = [[]]
                nf = 0
                for name, frames in group:
                    if nf + frames.shape[0] > max_stream_frames and batches[-1]:
                        batches.append([])
                        nf = 0
                    batches[-1].append((name, frames))
                    nf += frames.shape[0]
                for batch in batches:
                    self._stream_one_batch(batch, with_keypoints, pool, mesh_by_name, kp_by_name, fetch_arrays)
        return mesh_by_name, kp_by_name

    def _stream_one_batch(self, batch, with_keypoints, pool, mesh_by_name, kp_by_name, fetch_arrays) -> None:
        devs = list(pool.map(lambda item: self._upload(item[1]), batch))
        stream = torch.cat(devs) if len(devs) > 1 else devs[0]
        del devs
        det = self.detect_stage(stream, with_keypoints)
        out = self._batched(self.mesh_forward, stream, det["box_mesh"], fetch=fetch_arrays)
        kp = self._keypoints(stream, det, fetch=fetch_arrays) if with_keypoints else None
        single = det["single"].cpu().numpy()
        lo = 0
        for name, frames in batch:
            hi = lo + frames.shape[0]
            keep = self._kept(single[lo:hi])
            if keep is None:
                mesh_by_name[name] = kp_by_name[name] = None
            else:
                mesh_by_name[name] = self._mesh_dict({k: v[lo:hi] for k, v in out.items()}, keep)
                kp_by_name[name] = (None if kp is None else
                                    {"kp120": kp["kp120"][lo:hi], "valid": kp["valid"][lo:hi]})
            lo = hi

    # ------------------------------------------------------------------
    # extraction runs over a tree

    def _write_run_config(self, log_dir: str, num_hosts: int = 1, host_id: int = 0) -> str:
        """Publish the run's provenance knobs to
        ``<log_dir>/RUN_CONFIG[.host<I>of<N>].json`` (atomic, one a host):
        detector family and crop preprocessing are part of the feature
        definition, so a scorer or a later resume can tell parity features
        from fast-mode ones. The port's ``rcnn`` entry lacks the four fields
        of JAX's ``RCNNConfig`` that only lay the work out on the TPU
        (``grouped_conv_impl``, ``grouped_conv_width``, ``roi_chunk``,
        ``roi_rois_per_step``)."""
        cfg = self.cfg
        os.makedirs(log_dir, exist_ok=True)
        name = f"RUN_CONFIG.host{host_id}of{num_hosts}.json" if num_hosts > 1 else "RUN_CONFIG.json"
        path = os.path.join(log_dir, name)
        payload = {
            "parity": cfg.is_parity(),
            "mesh_detector": cfg.mesh_detector,
            "preproc": cfg.preproc,
            "matmul_precision": cfg.matmul_precision,
            "param_dtype": cfg.param_dtype,
            "kp_bug_compat": cfg.kp_bug_compat,
            "vitdet_antialias": cfg.vitdet_antialias,
            "pose_fullframe_fallback": cfg.pose_fullframe_fallback,
            "rcnn": dataclasses.asdict(cfg.rcnn),
            "keep_all_frames": cfg.keep_all_frames,
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    def run_tree(self, video_tree: str, out_root: str, log_dir: str, kp_out_root: T.Optional[str] = None,
                 actions: T.Optional[T.List[str]] = None,
                 frame_loader: T.Optional[T.Callable[[str], np.ndarray]] = None,
                 prefetch: int = 2, stream_group: int = 8, num_hosts: int = 1, host_id: int = 0
                 ) -> T.Dict[str, int]:
        """Resumable extraction over ``<video_tree>/<action>/*.{mp4,avi,mkv,npy}``
        (ref ``extract_mesh.py:150-241``): one npz a kept video under
        ``out_root/<action>/``, its keypoints (the valid rows with
        ``kp_bug_compat``) as ``kp_out_root/<action>/<stem>/keypoints.npy``,
        and a record in ``log_dir``'s per-action ledgers; a video the ledgers
        hold as single or not single is skipped. Returns the counts of
        ``single``, ``not_single``, ``errors`` and ``skipped`` videos.

        Decoding (``frame_loader``, default :func:`load_all_frames`) and the
        upload run ``prefetch`` videos ahead on host threads. With
        ``stream_group > 1`` and prefetch on, groups of that many videos run
        through :meth:`process_videos_streamed`, the next group decoding
        ahead; ``stream_group=1`` or ``prefetch=0`` runs one video at a time.
        A video that fails to decode, or to extract, is recorded as an error
        and the run goes on (a failed streamed group is retried video by
        video), except for a kernel or CUDA failure, which is raised: that is
        the device's fault, not the video's.

        ``num_hosts`` / ``host_id``: a multi-host sweep, as in JAX
        (``extract.py:885-999``). This process extracts only its strided
        shard of each action's sorted video list (``parallel.shard_items``;
        the assignment does not depend on progress, so resume is stable) and
        records to per-host ledgers ``<action>.host<I>of<N>.json``."""
        shard_items([], host_id, num_hosts)   # a bad host index is refused before anything is written
        self._write_run_config(log_dir, num_hosts, host_id)
        loader = frame_loader or load_all_frames
        all_actions = sorted(d for d in os.listdir(video_tree) if os.path.isdir(os.path.join(video_tree, d)))
        if actions:
            missing = [a for a in actions if a not in all_actions]
            if missing:
                raise ValueError(f"Actions not found under {video_tree}: {missing}")
            all_actions = list(actions)

        counts = {"single": 0, "not_single": 0, "errors": 0, "skipped": 0}
        exts = (".mp4", ".avi", ".mkv", ".npy")
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=prefetch) if prefetch > 0 else None
        try:
            for action in all_actions:
                action_dir = os.path.join(video_tree, action)
                ledger = ResumableLedger(
                    log_dir, f"{action}.host{host_id}of{num_hosts}" if num_hosts > 1 else action)
                processed = ledger.processed()
                videos = sorted(f for f in os.listdir(action_dir) if f.lower().endswith(exts))
                if num_hosts > 1:
                    videos = shard_items(videos, host_id, num_hosts)
                pending = [v for v in videos if v not in processed]
                counts["skipped"] += len(videos) - len(pending)

                def load_and_upload(video):
                    return self._upload(loader(os.path.join(action_dir, video)))

                def record_error(video, err):
                    if _is_device_fault(err):
                        raise err
                    ledger.record(video, "errors", str(err))
                    counts["errors"] += 1

                def save_and_record(video, mesh, kp):
                    if mesh is None:
                        ledger.record(video, "not_single")
                        counts["not_single"] += 1
                        return
                    stem = os.path.splitext(video)[0]
                    save_video_npz(out_root, os.path.join(action, stem), mesh["pose"], mesh["betas"],
                                   mesh["global_orient"], mesh["vit"], mesh["frame_idx"],
                                   meta={"action": action, "video": video})
                    if kp is not None:
                        rows = kp["kp120"][kp["valid"]] if self.cfg.kp_bug_compat else kp["kp120"]
                        kp_dir = os.path.join(kp_out_root, action, stem)
                        os.makedirs(kp_dir, exist_ok=True)
                        kp_path = os.path.join(kp_dir, "keypoints.npy")
                        tmp = f"{kp_path}.{os.getpid()}.tmp.npy"
                        np.save(tmp, rows.astype(np.float32))
                        os.replace(tmp, kp_path)   # atomic publish
                    ledger.record(video, "single")
                    counts["single"] += 1

                def extract_one(video, frames_dev):
                    try:
                        if frames_dev is None:
                            frames_dev = load_and_upload(video)
                        save_and_record(video, *self.process_video_full(
                            None, with_keypoints=kp_out_root is not None, frames_dev=frames_dev))
                    except Exception as err:   # per-video fault isolation (ref :232-236)
                        record_error(video, err)

                if pool is not None and stream_group > 1:
                    groups = [pending[lo:lo + stream_group] for lo in range(0, len(pending), stream_group)]
                    futures = {}

                    def submit(group):
                        for v in group:
                            futures[v] = pool.submit(load_and_upload, v)

                    if groups:
                        submit(groups[0])
                    for gi, group in enumerate(groups):
                        if gi + 1 < len(groups):
                            submit(groups[gi + 1])
                        items = []
                        for v in group:
                            try:
                                items.append((v, futures.pop(v).result()))
                            except Exception as err:   # a decode fault, per video
                                record_error(v, err)
                        if not items:
                            continue
                        try:
                            mesh_by, kp_by = self.process_videos_streamed(
                                items, with_keypoints=kp_out_root is not None)
                        except Exception as err:
                            if _is_device_fault(err):
                                raise
                            for v, frames_dev in items:   # retry video by video
                                extract_one(v, frames_dev)
                            continue
                        for v, _ in items:
                            try:
                                save_and_record(v, mesh_by[v], kp_by[v])
                            except Exception as err:
                                record_error(v, err)
                else:
                    futures = {}
                    for i, video in enumerate(pending):
                        if pool is not None:
                            for nxt in pending[i:i + 1 + prefetch]:
                                if nxt not in futures:
                                    futures[nxt] = pool.submit(load_and_upload, nxt)
                            try:
                                frames_dev = futures.pop(video).result()
                            except Exception as err:
                                record_error(video, err)
                                continue
                            extract_one(video, frames_dev)
                        else:
                            extract_one(video, None)
        finally:
            if pool is not None:
                pool.shutdown(wait=True)
        return counts


def rank_shard(host_id: int, num_hosts: int, rank: int, ranks: int) -> T.Tuple[int, int]:
    """``(shard, shards)`` of rank ``rank`` of ``ranks`` local ranks on host
    ``host_id`` of ``num_hosts``: each rank is one shard of the sweep, as a
    host is, and host h's ranks together cover host h's videos."""
    return host_id * ranks + rank, num_hosts * ranks


def _run_cli(args, ex_cfg: ExtractorConfig, device, num_hosts: int, host_id: int,
             warn: bool = True) -> T.Dict[str, int]:
    ex = Extractor.from_checkpoints(ex_cfg, tokenhmr=args.tokenhmr_ckpt, dwpose=args.dwpose_ckpt,
                                    yolox=args.yolox_ckpt, rcnn=args.rcnn_ckpt, device=device)
    if warn and not ex.cfg.is_parity():
        # fast-mode features are not the reference's feature definition
        print(f"[extract] throughput mode (mesh boxes: {ex.cfg.mesh_detector}, preproc: {ex.cfg.preproc}): not "
              "the reference-reproduction configuration; pass --parity to reproduce the reference's scores "
              f"(provenance recorded in {args.log_dir}/RUN_CONFIG*.json)", file=sys.stderr)
    return ex.run_tree(args.videos, args.out_meshes, args.log_dir, kp_out_root=args.out_kps,
                       actions=[args.action] if args.action else None, prefetch=args.prefetch,
                       stream_group=args.stream_group, num_hosts=num_hosts, host_id=host_id)


def _cli_rank(rank: Rank, args, ex_cfg: ExtractorConfig, host_id: int, num_hosts: int) -> T.Dict[str, T.Any]:
    """One rank of ``--mesh-data``: its shard of the sweep on its own device."""
    from ..ops import launch_counts

    shard, shards = rank_shard(host_id, num_hosts, rank.rank, rank.world)
    counts = _run_cli(args, ex_cfg, rank.device, shards, shard, warn=rank.is_primary)
    launches = launch_counts()
    print(f"[extract] rank {rank.rank} of {rank.world} on {rank.device}: shard {shard} of {shards}: {counts}; "
          f"kernel launches {launches}", flush=True)
    return {"rank": rank.rank, "shard": shard, "shards": shards, "counts": counts, "launches": launches}


def main(argv: T.Optional[T.Sequence[str]] = None) -> T.Dict[str, T.Any]:
    """The extract CLI. Returns the run's counts (summed over the ranks of
    ``--mesh-data``, whose own results are under ``"ranks"``)."""
    import argparse

    from ..parallel import launch_local, shutdown
    from ..utils.cli import add_distributed_args, maybe_initialize_distributed, resolve_host_id

    p = argparse.ArgumentParser(description="Batched mesh and keypoint extraction, PyTorch + CUDA")
    p.add_argument("--videos", required=True, help="root of the <action>/<video> tree")
    p.add_argument("--out-meshes", default="real_meshes")
    p.add_argument("--out-kps", default=None)
    p.add_argument("--log-dir", default="EXTRACTION_LOGS")
    p.add_argument("--action", default=None)
    p.add_argument("--bug-compat", dest="bug_compat", action="store_true", default=True,
                   help="reproduce the reference's keypoint frame dropping (the mesh/kp misalignment quirk)")
    p.add_argument("--no-bug-compat", dest="bug_compat", action="store_false")
    p.add_argument("--stream-group", type=int, default=8,
                   help="videos per cross-video streamed device batch (1 = one video at a time)")
    p.add_argument("--prefetch", type=int, default=2, help="decode + upload threads running ahead (0 = off)")
    p.add_argument("--parity", action="store_true",
                   help="the reference-reproduction preset (ExtractorConfig.parity()): R-CNN X101-FPN mesh "
                        "boxes with the exact RCNNConfig, upstream preprocessing, matmul 'high', fp32 "
                        "parameters, bug-compat on; overrides --mesh-detector")
    p.add_argument("--mesh-detector", choices=["yolox", "rcnn"], default="yolox",
                   help="mesh-path box provenance: 'rcnn' = Faster R-CNN X101-FPN (the reference's detector "
                        "family, ref mesh_generator.py:69-74); 'yolox' = the shared DWPose detector")
    p.add_argument("--preproc", choices=["upstream", "legacy"], default="upstream",
                   help="input preprocessing: 'upstream' = the published pipelines the weights expect; "
                        "'legacy' = the home-grown crop_scale crops and stretched, ImageNet-normalised "
                        "detector canvas (matches no published weights)")
    p.add_argument("--tokenhmr-ckpt", default=None,
                   help="TokenHMR checkpoint (tokenhmr_model_latest.ckpt / .pt / .npz): ViT-H + SMPL token head")
    p.add_argument("--dwpose-ckpt", default=None,
                   help="DWPose wholebody pose net, mmpose dwpose_l layout (.pth / .npz)")
    p.add_argument("--yolox-ckpt", default=None,
                   help="DWPose person detector, Megvii yolox_l layout (.pth / .npz)")
    p.add_argument("--rcnn-ckpt", default=None,
                   help="Faster R-CNN X101-FPN detectron2 checkpoint (.pkl / .pt); implies --mesh-detector rcnn")
    p.add_argument("--rcnn-fast", action="store_true",
                   help="the R-CNN throughput preset (RCNNConfig.fast(): a bf16 ROIAlign pyramid and window "
                        "32); not parity-exact")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel extraction over N ranks: N local processes, rank r on "
                        "cuda:{r %% device count}, each extracting its shard of every action's videos "
                        "(per-rank ledgers, as per-host ones); under --num-processes, the processes' "
                        "group (N must equal it). 0 = one device")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host sweep: total hosts sharding each action's video list; outputs are "
                        "per-video, so hosts may share one output root (no merge step)")
    p.add_argument("--host-id", type=int, default=-1,
                   help="this host's shard index; -1 = the rank under --num-processes")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda, cuda:1, cpu")
    add_distributed_args(p)
    args = p.parse_args(argv)

    if args.parity and args.rcnn_fast:
        p.error("--parity pins the exact RCNNConfig; drop --rcnn-fast")
    if args.rcnn_fast and args.mesh_detector != "rcnn" and not args.rcnn_ckpt:
        p.error("--rcnn-fast requires the R-CNN mesh detector (--mesh-detector rcnn or --rcnn-ckpt)")
    if args.mesh_data < 0 or args.num_hosts < 1:
        p.error("--mesh-data must be >= 0 and --num-hosts >= 1")
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        p.error(f"--device: {e}")

    if args.parity:
        ex_cfg = ExtractorConfig.parity(kp_bug_compat=args.bug_compat)
    else:
        ex_cfg = ExtractorConfig(kp_bug_compat=args.bug_compat, mesh_detector=args.mesh_detector,
                                 rcnn=RCNNConfig.fast() if args.rcnn_fast else None, preproc=args.preproc)
    rank = maybe_initialize_distributed(args, args.device)
    try:
        world = rank.world if rank is not None else 1
        if args.mesh_data > 0 and world > 1:
            if args.num_hosts > 1:
                # per-host video shards and the group's shards would overlap
                p.error("--num-hosts video sharding cannot combine with a cross-process --mesh-data "
                        "group: run one single-process CLI per host")
            if args.mesh_data != world:
                p.error(f"--mesh-data {args.mesh_data} under --num-processes {world}: one rank a "
                        f"process, so --mesh-data must be {world}")
        host_id = resolve_host_id(p, args.host_id, args.num_hosts, rank)
        if world > 1 and args.mesh_data > 0:
            counts = _cli_rank(rank, args, ex_cfg, 0, 1)["counts"]
        elif args.mesh_data > 1:
            ranks = launch_local(args.mesh_data, _cli_rank, args, ex_cfg, host_id, args.num_hosts,
                                 device=args.device)
            counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
            counts["ranks"] = ranks
        else:
            counts = _run_cli(args, ex_cfg, args.device, args.num_hosts, host_id)
    finally:
        if rank is not None:
            shutdown(rank)
    print({k: v for k, v in counts.items() if k != "ranks"})
    return counts


if __name__ == "__main__":
    main()
