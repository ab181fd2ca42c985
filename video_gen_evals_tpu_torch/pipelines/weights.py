"""Published-checkpoint loading for the mesh-recovery stage and its detector.

Port of the TokenHMR and Faster R-CNN branches of
``video_gen_evals_tpu/pipelines/weights.py``.
The reference loads ``tokenhmr_model_latest.ckpt`` (ref
``mesh_generator.py:35-78``); its ``backbone.*`` keys are the ViT-H's and its
``smpl_head.*`` keys the head's. The port's modules carry those names, so the
two sub-dicts load with ``load_state_dict`` (the head after
:func:`..models.smpl_head.canonical_head_state_dict` has stripped the
tokenizer decoder's nesting prefixes).

The reference's mesh detector is detectron2's X101-32x8d-FPN (a model-zoo
``.pkl``); the port's ``FasterRCNN`` carries detectron2's names, so its
state_dict loads as it is (``models/rcnn.py::canonical_rcnn_state_dict``).

Accepted containers: torch ``.pt/.pth/.ckpt`` (bare state_dicts or
``state_dict`` / ``model_state_dict`` / ``model`` wrappers), ``.npz`` of
torch-named arrays and detectron2 ``.pkl``. ``module.`` and ``model.``
wrapper prefixes are stripped. The DWPose and YOLOX branches come with their
networks (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import typing as T

import numpy as np
import torch

from ..models.rcnn import canonical_rcnn_state_dict, load_detectron2_pkl
from ..models.smpl_head import canonical_head_state_dict, classifier_config_from_state_dict

__all__ = [
    "load_torch_state_dict",
    "sub_state_dict",
    "extraction_params_from_checkpoints",
    "published_config",
]

StateDict = T.Dict[str, torch.Tensor]
_NOT_PORTED = ("the {net} checkpoint branch is not ported yet: it comes with its "
               "network (ROADMAP.md, Queue 1)")


def load_torch_state_dict(path: str) -> StateDict:
    """Load ``path`` into a flat ``{torch_name: tensor}`` dict on the CPU."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            return {k: torch.from_numpy(f[k]) for k in f.files}
    if path.endswith(".pkl"):
        return load_detectron2_pkl(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for wrapper in ("state_dict", "model_state_dict", "model"):
            inner = obj.get(wrapper)
            if isinstance(inner, dict) and inner:
                obj = inner
                break
    sd: StateDict = {}
    for k, v in obj.items():
        if torch.is_tensor(v):
            sd[k] = v.detach().cpu()
        elif isinstance(v, np.ndarray):
            sd[k] = torch.from_numpy(v)
    if not sd:
        raise ValueError(f"{path}: no tensors found in checkpoint")
    for prefix in ("module.", "model."):
        if all(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()}
    return sd


def _as_state_dict(x) -> StateDict:
    """A path, or a state_dict that was loaded already (a file needed twice,
    for the geometry and for the weights, is read once)."""
    return x if isinstance(x, dict) else load_torch_state_dict(x)


def sub_state_dict(sd: T.Mapping[str, T.Any], prefix: str) -> T.Dict[str, T.Any]:
    """Keys under ``prefix``, stripped. Raises if none match: a wrong file
    must fail, not leave random weights in place."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise ValueError(f"no keys under prefix {prefix!r}; checkpoint has e.g. {sorted(sd)[:5]}")
    return out


def _refuse_unported(**nets) -> None:
    for net, given in nets.items():
        if given is not None:
            raise NotImplementedError(_NOT_PORTED.format(net=net))


def extraction_params_from_checkpoints(cfg, *, tokenhmr=None, dwpose=None, yolox=None,
                                       rcnn=None) -> T.Dict[str, StateDict]:
    """The state_dicts of the nets whose checkpoint was given (each a path
    or a loaded state_dict): ``vit`` and ``head`` from ``tokenhmr``, ``rcnn``
    from a detectron2 checkpoint. ``cfg`` must hold the matching geometry
    already (:func:`published_config`)."""
    _refuse_unported(dwpose=dwpose, yolox=yolox)
    out: T.Dict[str, StateDict] = {}
    if tokenhmr is not None:
        sd = _as_state_dict(tokenhmr)
        out["vit"] = sub_state_dict(sd, "backbone.")
        out["head"] = canonical_head_state_dict(sub_state_dict(sd, "smpl_head."))
    if rcnn is not None:
        out["rcnn"] = canonical_rcnn_state_dict(_as_state_dict(rcnn))
    return out


def published_config(cfg, *, tokenhmr=None, dwpose=None, yolox=None, rcnn=None):
    """``cfg`` with the head's TokenClassfier geometry read from the
    checkpoint's shapes, and ``mesh_detector="rcnn"`` when an R-CNN file is
    given. The ViT-H and X101-FPN defaults are the published geometry."""
    _refuse_unported(dwpose=dwpose, yolox=yolox)
    if tokenhmr is not None:
        head_sd = sub_state_dict(_as_state_dict(tokenhmr), "smpl_head.")
        cfg = dataclasses.replace(cfg, head=classifier_config_from_state_dict(head_sd, cfg.head))
    if rcnn is not None and cfg.mesh_detector != "rcnn":
        cfg = dataclasses.replace(cfg, mesh_detector="rcnn")
    return cfg
