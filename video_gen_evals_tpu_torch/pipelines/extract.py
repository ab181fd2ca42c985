"""Mesh-recovery stage of the feature extraction: video frames and one person
box a frame -> SMPL mesh parameters and ``token_out`` (the "vit" modality).

Port of the mesh half of ``video_gen_evals_tpu/pipelines/extract.py``
(``Extractor._mesh_forward`` driven through ``_batched`` and
``process_video_full``; ref ``extract_mesh.py`` +
``modifications/mesh_generator.py``): upstream-exact ViTDet crops on the
device, the ViT-H backbone, and the SMPL token decoder head, in fixed chunks
of ``frame_batch`` frames. The output is the extraction contract the scoring
path reads: ``pose [T,23,3,3]``, ``betas [T,10]``, ``global_orient
[T,1,3,3]``, ``vit [T,1024]`` and ``frame_idx [T]``.

The boxes come from the caller, or, with ``mesh_detector="rcnn"``, from the
Faster R-CNN X101-32x8d-FPN detect stage (``models/rcnn.py``, the reference's
mesh-path detector, ref ``mesh_generator.py:69-74``): a frame is kept iff
exactly one person box scores above ``det_score_thresh``, and a video is
rejected when fewer than ``min_single_ratio`` of its frames are kept (ref
``:103-117``). The YOLOX detector and the 2D pose net (the keypoint branch)
are not ported yet (ROADMAP.md, Queue 1, items 1 and 2): the default
``mesh_detector="yolox"`` without boxes, the keypoint entry, ``run_tree`` and
the CLI raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import numpy as np
import torch
from torch import nn

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
from ..ops.upstream_crops import vitdet_mesh_crop
from ..utils.device import disable_tf32, resolve_device

_NEEDS_YOLOX = ("{what} needs the YOLOX person detector, which is not ported yet "
                "(ROADMAP.md, Queue 1, item 1): use mesh_detector='rcnn' or pass one box a "
                "frame to Extractor.process_video")
_NEEDS_POSE = ("{what} needs the YOLOX detector and the 2D pose net of the keypoint branch, "
               "which are not ported yet (ROADMAP.md, Queue 1, items 1 to 3)")
# (matmul_precision, param_dtype) -> the dtype the two networks work in
_WORKING_DTYPE = {
    ("highest", "float32"): torch.float32,
    ("high", "float32"): torch.float32,
    ("default", "bfloat16"): torch.bfloat16,
}


@dataclasses.dataclass
class ExtractorConfig:
    """The fields of the JAX package's ``ExtractorConfig`` that the mesh stage
    reads.

    Numerics, named by what is computed: ``matmul_precision="highest"`` runs
    every product in true fp32 (TF32 off) and the attention kernels at
    ``"highest"``. ``"high"`` (the JAX default, bf16x3 on the TPU) runs the
    same fp32 path here, which is at least as exact. ``"default"`` with
    ``param_dtype="bfloat16"`` is the fast mode: bf16 parameters and
    activations, fp32 sums, the attention kernels at ``"default"``, and the
    rotation matrices orthonormalised in fp32. Other pairs are refused."""

    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    head: SMPLHeadConfig = dataclasses.field(default_factory=SMPLHeadConfig)
    frame_batch: int = 32
    preproc: str = "upstream"
    vitdet_rescale: float = 2.5    # ViTDetDataset rescale_factor
    vitdet_antialias: bool = True  # hmr2 gaussian pre-blur (df > 1.1)
    matmul_precision: str = "high"
    param_dtype: str = "float32"   # "float32" | "bfloat16"
    # mesh-path box provenance when process_video gets no boxes: "rcnn" is the
    # Faster R-CNN X101-FPN; "yolox" (JAX's default) is not ported yet
    mesh_detector: str = "yolox"
    rcnn: T.Optional[RCNNConfig] = None   # None: RCNNConfig.x101_32x8d()
    # the detect stage's canvas is ~70x a crop's pixel area, so it chunks smaller
    rcnn_frame_batch: int = 8
    det_score_thresh: float = 0.5
    min_single_ratio: float = 0.8
    # every frame counts as single-person (the JAX package defaults to False).
    # False applies the reference's rule to the R-CNN's boxes; without a
    # detector there is no mask, so it is refused there
    keep_all_frames: bool = True

    def __post_init__(self):
        if self.preproc == "legacy":
            raise NotImplementedError(
                "preproc='legacy' (batched_person_crops, ops/image.py) is not ported: "
                "ROADMAP.md, Queue 1, 'left out of the mesh stage'")
        if self.preproc != "upstream":
            raise ValueError(f"unknown preproc {self.preproc!r}")
        if (self.matmul_precision, self.param_dtype) not in _WORKING_DTYPE:
            raise ValueError(
                f"matmul_precision={self.matmul_precision!r} with param_dtype={self.param_dtype!r} "
                f"is not a mode of the port; the modes are {sorted(_WORKING_DTYPE)}")
        if self.rcnn is None:
            self.rcnn = RCNNConfig.x101_32x8d()
        if self.mesh_detector not in ("yolox", "rcnn"):
            raise ValueError(f"unknown mesh_detector {self.mesh_detector!r}")
        if not self.keep_all_frames and self.mesh_detector != "rcnn":
            raise NotImplementedError(_NEEDS_YOLOX.format(what="keep_all_frames=False"))
        if self.mesh_detector == "rcnn" and self.param_dtype != "float32":
            raise NotImplementedError(
                "the bfloat16 extraction mode with the R-CNN detector is not ported: "
                "ROADMAP.md, Queue 1, item 0")
        if self.frame_batch < 1 or self.rcnn_frame_batch < 1:
            raise ValueError(f"frame_batch {self.frame_batch} and rcnn_frame_batch "
                             f"{self.rcnn_frame_batch} must be positive")

    @property
    def working_dtype(self) -> torch.dtype:
        return _WORKING_DTYPE[(self.matmul_precision, self.param_dtype)]


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


def _build_rcnn(config: RCNNConfig, state_dict, generator, device) -> FasterRCNN:
    """The detector on ``device`` in float32, its weights from a detectron2
    state_dict (every key used, none missing) or drawn from ``generator``."""
    with torch.device("meta"):
        net = FasterRCNN(config)
    net.to_empty(device=device)
    if state_dict is None:
        init_rcnn_weights_(net, generator)
    else:
        net.load_state_dict(canonical_rcnn_state_dict(state_dict), strict=True)
    return net.eval()


class Extractor:
    """Detect stage (with ``mesh_detector="rcnn"``), crops, ViT backbone and
    SMPL head of the mesh stage, in fixed chunks.

    ``state_dicts`` may hold ``"vit"`` and ``"head"`` (state_dicts in the
    modules' own names) and, in rcnn mode, ``"rcnn"`` (detectron2's names);
    a net without one is drawn from a generator seeded with ``seed`` (the
    detector last, so the other two do not depend on the mode).
    ``device=None`` means the card and raises without one."""

    def __init__(self, config: T.Optional[ExtractorConfig] = None,
                 state_dicts: T.Optional[T.Mapping[str, T.Mapping[str, torch.Tensor]]] = None,
                 seed: int = 0, device: T.Union[None, str, torch.device] = None):
        self.cfg = cfg = config or ExtractorConfig()
        self.device = resolve_device("cuda" if device is None else device)
        disable_tf32()
        state_dicts = dict(state_dicts or {})
        nets = {"vit", "head"} | ({"rcnn"} if cfg.mesh_detector == "rcnn" else set())
        unknown = set(state_dicts) - nets
        if unknown:
            raise ValueError(f"state_dicts holds nets this configuration does not have: {sorted(unknown)}")
        if cfg.head.context_dim != cfg.vit.embed_dim:
            raise ValueError(f"head.context_dim {cfg.head.context_dim} != vit.embed_dim {cfg.vit.embed_dim}")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        dtype = cfg.working_dtype
        self.backbone = _build_net(ViTBackbone, cfg.vit, state_dicts.get("vit"), generator, self.device, dtype)
        self.head = _build_net(SMPLTokenDecoderHead, cfg.head, state_dicts.get("head"), generator,
                               self.device, dtype)
        self.rcnn = (_build_rcnn(cfg.rcnn, state_dicts.get("rcnn"), generator, self.device)
                     if cfg.mesh_detector == "rcnn" else None)

    @classmethod
    def from_checkpoints(cls, config: T.Optional[ExtractorConfig] = None, *,
                         tokenhmr: T.Optional[str] = None, dwpose: T.Optional[str] = None,
                         yolox: T.Optional[str] = None, rcnn: T.Optional[str] = None,
                         seed: int = 0, device=None) -> "Extractor":
        """An Extractor with the published weights: TokenHMR (a ``.ckpt``,
        ``.pt`` or ``.npz`` whose ``backbone.*`` and ``smpl_head.*`` keys are
        the two networks'; the head's classifier geometry is read from the
        file) and the detectron2 Faster R-CNN (``.pkl`` or ``.pt``), which
        selects ``mesh_detector="rcnn"``. The DWPose and YOLOX checkpoints
        belong to networks not ported yet."""
        from .weights import extraction_params_from_checkpoints, load_torch_state_dict, published_config

        tokenhmr = load_torch_state_dict(tokenhmr) if tokenhmr else None
        cfg = published_config(config or ExtractorConfig(), tokenhmr=tokenhmr, dwpose=dwpose,
                               yolox=yolox, rcnn=rcnn)
        converted = extraction_params_from_checkpoints(cfg, tokenhmr=tokenhmr, rcnn=rcnn)
        return cls(cfg, state_dicts=converted, seed=seed, device=device)

    def set_attention_impl(self, impl: str) -> None:
        """Switch every backbone block to another ``attention_impl`` on the
        same weights (the impls share their parameters)."""
        self.cfg = dataclasses.replace(self.cfg, vit=dataclasses.replace(self.cfg.vit, attention_impl=impl))
        self.backbone.config = self.cfg.vit
        for blk in self.backbone.blocks:
            blk.attn.attention_impl = impl

    # ------------------------------------------------------------------
    def crops(self, frames: torch.Tensor, boxes_xyxy: torch.Tensor) -> torch.Tensor:
        """Normalised ViTDet crops ``[B, h, w, 3]`` (fp32) of ``frames``
        (``[B, H, W, 3]``, uint8 or float, RGB 0..255)."""
        cfg = self.cfg
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
    def detect_rcnn(self, frames: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """The R-CNN detect stage on one chunk ``[B, H, W, 3]`` (RGB 0..255):
        detectron2's DefaultPredictor preprocessing (``predictor_canvas``),
        the detector, boxes rescaled and clipped to the
        frame, then the reference's rule: the person boxes (class 0) scoring
        above ``det_score_thresh``. Returns ``box [B, 4]`` (the best person
        box, or the top detection where there is none), ``single [B]``
        (exactly one person box) and ``present [B]`` (at least one)."""
        cfg = self.cfg
        H, W = frames.shape[1:3]
        canvas, (rh, rw) = predictor_canvas(frames, cfg.rcnn)
        det = self.rcnn(canvas, image_hw=(rh, rw))
        sx, sy = W / rw, H / rh
        boxes = clip_boxes(det["boxes"] * torch.tensor([sx, sy, sx, sy], device=canvas.device), (H, W))
        person = (det["classes"] == 0) & (det["scores"] > cfg.det_score_thresh) & det["valid"]
        best = torch.argmax(torch.where(person, det["scores"], -1.0), dim=-1)
        return {"box": torch.take_along_dim(boxes, best[:, None, None], dim=1)[:, 0],
                "single": person.sum(dim=-1) == 1, "present": person.any(dim=-1)}

    def detect_stage(self, frames: torch.Tensor) -> T.Dict[str, torch.Tensor]:
        """:meth:`detect_rcnn` over a video on the device, in chunks of
        ``min(rcnn_frame_batch, frame_batch)``; the results stay there."""
        return self._batched(self.detect_rcnn, frames,
                             batch=min(self.cfg.rcnn_frame_batch, self.cfg.frame_batch), fetch=False)

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

    def process_video(self, frames: T.Union[np.ndarray, torch.Tensor],
                      boxes_xyxy: T.Union[None, np.ndarray, torch.Tensor] = None
                      ) -> T.Optional[T.Dict[str, np.ndarray]]:
        """Mesh extraction for one video. ``frames``: ``[T, H, W, 3]`` uint8
        RGB, uploaded once and cast on the device chunk by chunk.

        With ``boxes_xyxy`` (``[T, 4]``, one person box a frame in frame
        pixels) every frame is kept. Without, the R-CNN detect stage
        (``mesh_detector="rcnn"``) gives the boxes and the single-person
        mask: with ``keep_all_frames=False`` the video is rejected (``None``)
        when no frame, or fewer than ``min_single_ratio`` of them, hold
        exactly one person, and otherwise only those frames are returned
        (``frame_idx``), as JAX's ``process_video_full`` does. The mask is
        read before the mesh forward, so a rejected video costs no mesh
        work."""
        frames_dev = torch.as_tensor(frames).to(self.device)
        if frames_dev.ndim != 4 or frames_dev.shape[-1] != 3:
            raise ValueError(f"frames must be [T, H, W, 3], got {tuple(frames_dev.shape)}")
        n = frames_dev.shape[0]
        if n == 0:
            raise ValueError("process_video needs at least one frame")
        keep = np.ones(n, dtype=bool)
        if boxes_xyxy is not None:
            boxes_dev = torch.as_tensor(boxes_xyxy, dtype=torch.float32).to(self.device)
            if tuple(boxes_dev.shape) != (n, 4):
                raise ValueError(f"boxes must be [{n}, 4], got {tuple(boxes_dev.shape)}")
        elif self.rcnn is None:
            raise NotImplementedError(_NEEDS_YOLOX.format(what="process_video without boxes"))
        else:
            det = self.detect_stage(frames_dev)
            boxes_dev = det["box"]
            if not self.cfg.keep_all_frames:
                keep = det["single"].cpu().numpy()
                if keep.sum() == 0 or keep.mean() < self.cfg.min_single_ratio:
                    return None
        out = self._batched(self.mesh_forward, frames_dev, boxes_dev)
        idx = np.flatnonzero(keep)
        return {
            "pose": out["body_pose"][idx],
            "betas": out["betas"][idx],
            "global_orient": out["global_orient"][idx],
            "vit": out["token_out"][idx],
            "frame_idx": idx.astype(np.int32),
        }

    def process_video_keypoints(self, *args, **kwargs):
        raise NotImplementedError(_NEEDS_POSE.format(what="process_video_keypoints"))

    def run_tree(self, *args, **kwargs):
        raise NotImplementedError(_NEEDS_POSE.format(what="run_tree"))


def main(argv: T.Optional[T.Sequence[str]] = None) -> int:
    raise NotImplementedError(_NEEDS_POSE.format(what="the extract CLI"))
