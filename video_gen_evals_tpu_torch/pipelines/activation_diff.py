"""Per-layer activation diff of the port's extraction networks against an
upstream model's dump: one command checks a checkpoint's loading layer by
layer instead of by a single end-to-end pass or fail.

Port of ``scripts/activation_diff.py``, with the port's modules where that
script uses the flax modules:

    python -m video_gen_evals_tpu_torch.pipelines.activation_diff --network vit \\
        --state-dict tokenhmr_model_latest.ckpt --key-prefix backbone. \\
        --input crop.npy --acts upstream_acts.npz [--device cuda|cpu]

``--state-dict`` is the checkpoint in any container ``pipelines/weights.py``
reads (``.pt``, ``.pth``, ``.ckpt``, ``.npz`` of torch names, detectron2
``.pkl``). ``--acts`` is an npz of the upstream torch model's per-module
outputs, keyed by its module names, written by running that model once
through :func:`torch_module_activations` (this module needs only torch and
the upstream model object for that). ``--input`` is the network's input as
``.npy`` in the layout the JAX harness reads (NHWC images, ``[B, N, C]``
token contexts), so one upstream dump serves both tools.

The harness loads the state_dict into the port's module with
``load_state_dict(strict=True)``, replays the input through it on
``--device`` (default the card; fp32 with TF32 off, the extraction's
"highest" path, the ViT's attention in K6), hooks the modules that the
network's anchor table names, and prints a max-abs-diff table in network
order. Activations are compared in the reference's NCHW layout, which the
port's modules share. Each anchor names an upstream torch module (looked up
suffix-tolerantly, so wrapper prefixes like ``model.`` or ``smpl_head.`` in
the dump do not matter) and the port's module: the same name where the port
carries upstream's names, the canonical one for the SMPL head's tokenizer
decoder. Exit code 1 if a compared layer exceeds ``--tol``, if an anchor is
unmatched (``missing-torch`` only without ``--allow-missing-torch``), or if
nothing was compared.

Anchor coverage: ViT-H per block (and patch embed, final norm); the SMPL
head per decoder sub-block (self, cross, feed-forward), the token
classifier's stages and every readout; RTMPose per backbone stage and head
stage; YOLOX per dark stage, every PAFPN node and all 18 head convs and
predictors; Faster R-CNN's stem, every ResNeXt block, the 8 FPN convs and
the RPN predictions (the shared RPN head anchored at its last call, p6, as
torch hooks keep it).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import typing as T

import numpy as np
import torch

from ..models.detector import DetectorConfig, YOLOXDetector
from ..models.pose2d import PoseNetConfig, RTMPoseNet
from ..models.rcnn import FasterRCNN, RCNNConfig, canonical_rcnn_state_dict
from ..models.smpl_head import (SMPLHeadConfig, SMPLTokenDecoderHead, canonical_head_state_dict,
                                classifier_config_from_state_dict)
from ..models.vit import ViTBackbone, ViTConfig
from ..utils.device import disable_tf32, resolve_device
from .weights import load_torch_state_dict, sub_state_dict

Acts = T.Dict[str, np.ndarray]
Anchors = T.List[T.Tuple[str, str]]

# --------------------------------------------------------------------------
# module outputs by forward hooks


def _capture(model: torch.nn.Module, call: T.Callable[[], T.Any],
             names: T.Optional[T.Collection[str]] = None) -> Acts:
    """Run ``call()`` once under ``torch.no_grad()`` with a forward hook on
    every named submodule of ``model`` (only those in ``names`` when given),
    storing each output on the host: a tuple as ``name`` (its first element)
    and ``name#k``; the call's result as ``__output__``."""
    acts: Acts = {}

    def store(name, out):
        if isinstance(out, (tuple, list)):
            for k, o in enumerate(out):
                if torch.is_tensor(o):
                    acts[f"{name}#{k}"] = o.detach().cpu().numpy()
                    if k == 0:
                        acts[name] = acts[f"{name}#0"]
        elif torch.is_tensor(out):
            acts[name] = out.detach().cpu().numpy()

    hooks = [mod.register_forward_hook(lambda m, i, o, name=name: store(name, o))
             for name, mod in model.named_modules() if name and (names is None or name in names)]
    try:
        with torch.no_grad():
            store("__output__", call())
    finally:
        for h in hooks:
            h.remove()
    return acts


def torch_module_activations(model: torch.nn.Module, *inputs, **kw) -> Acts:
    """Run ``model(*inputs, **kw)`` once, capturing every named submodule's
    output. Tuple outputs are stored as ``name`` (first element) plus
    ``name#k`` per element, the model's output as ``__output__``. Save with
    ``np.savez(path, **acts)`` and pass the file as ``--acts``."""
    return _capture(model, lambda: model(*inputs, **kw))


# --------------------------------------------------------------------------
# per-network wiring: config, state_dict, module, anchors


@dataclasses.dataclass
class Spec:
    module: T.Type[torch.nn.Module]   # built as module(config)
    config: T.Any
    state_dict: T.Dict[str, torch.Tensor]
    anchors: Anchors                  # (upstream torch module, the port's module)
    method: T.Optional[str] = None    # the entry to call instead of forward


def _build_cfg(cls, preset, overrides):
    cfg = preset() if preset is not None else cls()
    if overrides:
        fields = {f.name for f in dataclasses.fields(cls)}
        clean = {}
        for k, v in overrides.items():
            if k not in fields:
                raise ValueError(f"unknown config field '{k}' for {cls.__name__}")
            clean[k] = tuple(v) if isinstance(v, list) else v
        cfg = dataclasses.replace(cfg, **clean)
    return cfg


def _same(names: T.Iterable[str]) -> Anchors:
    return [(n, n) for n in names]


def _vit_spec(sd, overrides) -> Spec:
    cfg = _build_cfg(ViTConfig, None, overrides)
    names = ["patch_embed.proj"] + [f"blocks.{i}" for i in range(cfg.depth)] + (["norm"] if cfg.final_norm else [])
    return Spec(ViTBackbone, cfg, sd, _same(names))


def _smpl_head_spec(sd, overrides) -> Spec:
    cfg = classifier_config_from_state_dict(sd, _build_cfg(SMPLHeadConfig, None, overrides))
    anchors = _same(f"transformer.transformer.layers.{i}.{k}" for i in range(cfg.depth) for k in range(3))
    anchors += _same(["transformer", "decpose.cls_head"])
    # upstream nests the tokenizer decoder under decpose.tokenizer; the port's
    # TokenClassifier holds it directly (canonical_head_state_dict)
    stages = ["decoder_token_mlp", "decoder_start"] + [f"decoder.{i}" for i in range(cfg.dec_num_blocks)]
    stages += ["decoder_layer_norm", "recover_embed"]
    anchors += [(f"decpose.tokenizer.{s}", f"decpose.{s}") for s in stages]
    anchors += _same(["decpose", "decpose_grot", "decpose_hands", "decshape", "deccam"])
    return Spec(SMPLTokenDecoderHead, cfg, canonical_head_state_dict(sd), anchors)


def _rtmpose_spec(sd, overrides) -> Spec:
    cfg = _build_cfg(PoseNetConfig, PoseNetConfig.dwpose_l, overrides)
    names = ["backbone.stem"] + [f"backbone.stage{s}" for s in (1, 2, 3, 4)]
    names += [f"head.{n}" for n in ("final_layer", "mlp", "gau", "cls_x", "cls_y")]
    return Spec(RTMPoseNet, cfg, sd, _same(names), "logits")


def _yolox_spec(sd, overrides) -> Spec:
    cfg = _build_cfg(DetectorConfig, DetectorConfig.yolox_l, overrides)
    names = ["backbone.backbone.stem"] + [f"backbone.backbone.dark{k}" for k in (2, 3, 4, 5)]
    names += [f"backbone.{n}" for n in ("lateral_conv0", "C3_p4", "reduce_conv1", "C3_p3",
                                         "bu_conv2", "C3_n3", "bu_conv1", "C3_n4")]
    for i in range(3):
        names += [f"head.{n}.{i}" for n in ("stems", "cls_convs", "reg_convs", "cls_preds", "reg_preds", "obj_preds")]
    return Spec(YOLOXDetector, cfg, sd, _same(names))


def _rcnn_spec(sd, overrides) -> Spec:
    """Faster R-CNN X101-FPN (the reference's mesh detector). Input: the
    normalised BGR canvas, NHWC. The backbone and FPN stage by stage, and
    the RPN's predictions: the proposals, NMS and pooling are weight-free
    and held against their oracles in the tests."""
    cfg = _build_cfg(RCNNConfig, RCNNConfig.x101_32x8d, overrides)
    names = ["backbone.bottom_up.stem.conv1"]
    names += [f"backbone.bottom_up.res{si + 2}.{bi}" for si, n in enumerate(cfg.stage_blocks) for bi in range(n)]
    names += [f"backbone.fpn_{kind}{i}" for i in range(2, 6) for kind in ("lateral", "output")]
    names += [f"proposal_generator.rpn_head.{n}" for n in ("objectness_logits", "anchor_deltas")]
    return Spec(FasterRCNN, cfg, canonical_rcnn_state_dict(sd), _same(names), "rpn_raw")


NETWORKS: T.Dict[str, T.Callable[[T.Dict[str, torch.Tensor], dict], Spec]] = {
    "vit": _vit_spec,
    "smpl_head": _smpl_head_spec,
    "rtmpose": _rtmpose_spec,
    "yolox": _yolox_spec,
    "rcnn": _rcnn_spec,
}


# --------------------------------------------------------------------------
# diffing


@dataclasses.dataclass
class DiffRow:
    torch_name: str
    port_name: str
    status: str            # "ok" | "missing-torch" | "missing-port" | "shape"
    shape: T.Tuple[int, ...] = ()
    max_abs: float = float("nan")
    max_ref: float = float("nan")   # max |reference activation|


def _lookup_torch(acts: Acts, name: str) -> T.Optional[np.ndarray]:
    """Suffix-tolerant lookup: 'transformer' matches 'smpl_head.transformer'."""
    if name in acts:
        return acts[name]
    hits = [k for k in acts if k.endswith("." + name)]
    return acts[hits[0]] if len(hits) == 1 else None


def diff_activations(torch_acts: Acts, port_acts: Acts, anchors: T.Sequence[T.Tuple[str, str]]) -> T.List[DiffRow]:
    rows = []
    for tname, pname in anchors:
        ta = _lookup_torch(torch_acts, tname)
        pa = port_acts.get(pname)
        if ta is None:
            rows.append(DiffRow(tname, pname, "missing-torch"))
        elif pa is None:
            rows.append(DiffRow(tname, pname, "missing-port"))
        elif ta.shape != pa.shape:
            rows.append(DiffRow(tname, pname, "shape", (*ta.shape,)))
        else:
            ref = ta.astype(np.float64)
            rows.append(DiffRow(tname, pname, "ok", tuple(pa.shape),
                                float(np.max(np.abs(ref - pa.astype(np.float64)), initial=0.0)),
                                float(np.max(np.abs(ref), initial=0.0))))
    return rows


def render_table(rows: T.Sequence[DiffRow], tol: float) -> str:
    w = max([len(r.torch_name) for r in rows] + [12])
    wp = max([len(r.port_name) for r in rows] + [11])
    lines = [f"{'torch module':<{w}}  {'port module':<{wp}}  {'shape':<22}  max|diff|  max|ref|"]
    for r in rows:
        if r.status == "ok":
            flag = "" if r.max_abs <= tol else "  <-- EXCEEDS TOL"
            lines.append(f"{r.torch_name:<{w}}  {r.port_name:<{wp}}  {str(r.shape):<22}  "
                         f"{r.max_abs:.3e}  {r.max_ref:.3e}{flag}")
        else:
            lines.append(f"{r.torch_name:<{w}}  {r.port_name:<{wp}}  [{r.status}]")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# running the port's module


def _load_state_dict(path: str, key_prefix: str = "") -> T.Dict[str, torch.Tensor]:
    """The checkpoint through ``pipelines/weights.py``'s loader (which strips
    ``module.`` / ``model.`` wrapper prefixes), under ``key_prefix``. A prefix
    written against the raw keys (``model.backbone.``) is retried without the
    wrapper before it fails."""
    sd = load_torch_state_dict(path)
    if key_prefix:
        try:
            sd = sub_state_dict(sd, key_prefix)
        except ValueError:
            for w in ("module.", "model."):
                if key_prefix.startswith(w):
                    sd = sub_state_dict(sd, key_prefix[len(w):])
                    break
            else:
                raise
    return sd


def run_diff(network: str, sd: T.Mapping[str, T.Any], x: np.ndarray, torch_acts: Acts,
             overrides: T.Optional[dict] = None, device: T.Union[str, torch.device] = "cuda") -> T.List[DiffRow]:
    """The port's module for ``network`` built from ``sd`` on ``device``
    (``load_state_dict(strict=True)``, fp32, TF32 off), run once on ``x``,
    its anchored modules' outputs diffed against ``torch_acts``."""
    device = resolve_device(device)
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v for k, v in sd.items()}
    spec = NETWORKS[network](sd, overrides or {})
    with torch.device(device):   # drawn where it runs: ViT-H's init takes seconds on a host
        model = spec.module(spec.config)
    model.to(device).load_state_dict(spec.state_dict, strict=True)
    model.eval()
    if device.type == "cuda":
        disable_tf32()
    inp = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    call = getattr(model, spec.method) if spec.method else model
    acts = _capture(model, lambda: call(inp), {p for _t, p in spec.anchors})
    return diff_activations(torch_acts, acts, spec.anchors)


# --------------------------------------------------------------------------
# CLI


def main(argv: T.Optional[T.Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--network", required=True, choices=sorted(NETWORKS))
    ap.add_argument("--state-dict", required=True,
                    help=".pt/.pth/.ckpt, .npz of torch parameter names, or detectron2 .pkl")
    ap.add_argument("--input", required=True, help=".npy network input, NHWC images / [B, N, C] tokens")
    ap.add_argument("--acts", required=True, help=".npz of upstream activations from torch_module_activations()")
    ap.add_argument("--key-prefix", default="", help="strip this prefix from state_dict keys (e.g. 'backbone.')")
    ap.add_argument("--config-json", default=None, help="JSON dict of config-field overrides")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--allow-missing-torch", action="store_true",
                    help="tolerate anchors absent from the activation dump (partial dumps); "
                         "missing-port and shape rows always fail")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sd = _load_state_dict(args.state_dict, args.key_prefix)
    x = np.load(args.input)
    with np.load(args.acts, allow_pickle=False) as f:
        torch_acts = {k: f[k] for k in f.files}
    overrides = json.loads(args.config_json) if args.config_json else None

    rows = run_diff(args.network, sd, x, torch_acts, overrides, device)
    print(render_table(rows, args.tol))
    ok = [r for r in rows if r.status == "ok"]
    bad = [r for r in ok if not r.max_abs <= args.tol]
    unmatched = [r for r in rows if r.status != "ok"]
    worst = max((r.max_abs for r in ok), default=float("nan"))
    ref = max((r.max_ref for r in ok), default=float("nan"))
    print(f"\n{len(ok)} layers compared, {len(bad)} over tol {args.tol:g}, {len(unmatched)} unmatched; "
          f"max|diff| {worst:.3e}, max|ref| {ref:.3e}")
    # missing-port and shape rows mean the loading is structurally broken
    # (those layers were never compared); missing-torch means the dump lacks
    # an anchor, fatal unless --allow-missing-torch opts a partial dump in
    fatal = [r for r in unmatched if r.status != "missing-torch" or not args.allow_missing_torch]
    return 1 if bad or fatal or not ok else 0


if __name__ == "__main__":
    sys.exit(main())
