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

The person detectors and the 2D pose net are not ported yet (ROADMAP.md,
Queue 1). Until they are, the boxes are the caller's and every frame counts
as single-person, which is the JAX package's own ``keep_all_frames`` mode;
every entry that needs a detector raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import numpy as np
import torch
from torch import nn

from ..models.smpl_head import SMPLHeadConfig, SMPLTokenDecoderHead
from ..models.vit import ViTBackbone, ViTConfig
from ..ops.upstream_crops import vitdet_mesh_crop
from ..utils.device import disable_tf32, resolve_device

_NEEDS_DETECTOR = ("{what} needs the person detector, which is not ported yet "
                   "(ROADMAP.md, Queue 1, items 1.1 and 1.2): pass one box a frame to "
                   "Extractor.process_video")
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
    # every frame counts as single-person; the reference's >= 80% rule needs
    # the detector's mask, so False is refused until the detectors are ported
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
        if not self.keep_all_frames:
            raise NotImplementedError(_NEEDS_DETECTOR.format(what="keep_all_frames=False"))
        if self.frame_batch < 1:
            raise ValueError(f"frame_batch must be positive, got {self.frame_batch}")

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


class Extractor:
    """Crops, ViT backbone and SMPL head of the mesh stage, in fixed chunks.

    ``state_dicts`` may hold ``"vit"`` and ``"head"`` (state_dicts in the
    modules' own names); a net without one is drawn from a generator seeded
    with ``seed``. ``device=None`` means the card and raises without one."""

    def __init__(self, config: T.Optional[ExtractorConfig] = None,
                 state_dicts: T.Optional[T.Mapping[str, T.Mapping[str, torch.Tensor]]] = None,
                 seed: int = 0, device: T.Union[None, str, torch.device] = None):
        self.cfg = cfg = config or ExtractorConfig()
        self.device = resolve_device("cuda" if device is None else device)
        disable_tf32()
        state_dicts = dict(state_dicts or {})
        unknown = set(state_dicts) - {"vit", "head"}
        if unknown:
            raise ValueError(f"state_dicts holds nets the mesh stage does not have: {sorted(unknown)}")
        if cfg.head.context_dim != cfg.vit.embed_dim:
            raise ValueError(f"head.context_dim {cfg.head.context_dim} != vit.embed_dim {cfg.vit.embed_dim}")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        dtype = cfg.working_dtype
        self.backbone = _build_net(ViTBackbone, cfg.vit, state_dicts.get("vit"), generator, self.device, dtype)
        self.head = _build_net(SMPLTokenDecoderHead, cfg.head, state_dicts.get("head"), generator,
                               self.device, dtype)

    @classmethod
    def from_checkpoints(cls, config: T.Optional[ExtractorConfig] = None, *,
                         tokenhmr: T.Optional[str] = None, dwpose: T.Optional[str] = None,
                         yolox: T.Optional[str] = None, rcnn: T.Optional[str] = None,
                         seed: int = 0, device=None) -> "Extractor":
        """An Extractor with the published TokenHMR weights (a ``.ckpt``,
        ``.pt`` or ``.npz`` whose ``backbone.*`` and ``smpl_head.*`` keys are
        the two networks'); the head's classifier geometry is read from the
        file. The other three checkpoints belong to networks not ported yet."""
        from .weights import extraction_params_from_checkpoints, load_torch_state_dict, published_config

        tokenhmr = load_torch_state_dict(tokenhmr) if tokenhmr else None
        cfg = published_config(config or ExtractorConfig(), tokenhmr=tokenhmr, dwpose=dwpose,
                               yolox=yolox, rcnn=rcnn)
        converted = extraction_params_from_checkpoints(cfg, tokenhmr=tokenhmr)
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

    def _batched(self, fn, frames: torch.Tensor, *extra: torch.Tensor) -> T.Dict[str, np.ndarray]:
        """Run ``fn`` on fixed chunks of ``frame_batch`` frames: the tail is
        padded by repeating its last frame and cut again, chunk outputs stay
        on the device, and the whole result is fetched once at the end."""
        B = self.cfg.frame_batch
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
        return {k: v.cpu().numpy() for k, v in joined.items()}

    def process_video(self, frames: T.Union[np.ndarray, torch.Tensor],
                      boxes_xyxy: T.Union[None, np.ndarray, torch.Tensor] = None
                      ) -> T.Dict[str, np.ndarray]:
        """Mesh extraction for one video. ``frames``: ``[T, H, W, 3]`` uint8
        RGB, uploaded once and cast on the device chunk by chunk;
        ``boxes_xyxy``: ``[T, 4]``, one person box a frame in frame pixels.
        Every frame is kept (``keep_all_frames``)."""
        if boxes_xyxy is None:
            raise NotImplementedError(_NEEDS_DETECTOR.format(what="process_video without boxes"))
        frames_dev = torch.as_tensor(frames).to(self.device)
        boxes_dev = torch.as_tensor(boxes_xyxy, dtype=torch.float32).to(self.device)
        if frames_dev.ndim != 4 or frames_dev.shape[-1] != 3:
            raise ValueError(f"frames must be [T, H, W, 3], got {tuple(frames_dev.shape)}")
        if tuple(boxes_dev.shape) != (frames_dev.shape[0], 4):
            raise ValueError(f"boxes must be [{frames_dev.shape[0]}, 4], got {tuple(boxes_dev.shape)}")
        if frames_dev.shape[0] == 0:
            raise ValueError("process_video needs at least one frame")
        out = self._batched(self.mesh_forward, frames_dev, boxes_dev)
        return {
            "pose": out["body_pose"],
            "betas": out["betas"],
            "global_orient": out["global_orient"],
            "vit": out["token_out"],
            "frame_idx": np.arange(frames_dev.shape[0], dtype=np.int32),
        }

    def process_video_keypoints(self, *args, **kwargs):
        raise NotImplementedError(_NEEDS_DETECTOR.format(what="process_video_keypoints"))

    def run_tree(self, *args, **kwargs):
        raise NotImplementedError(_NEEDS_DETECTOR.format(what="run_tree"))


def main(argv: T.Optional[T.Sequence[str]] = None) -> int:
    raise NotImplementedError(_NEEDS_DETECTOR.format(what="the extract CLI"))
