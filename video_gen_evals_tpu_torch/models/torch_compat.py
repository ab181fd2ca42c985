"""Weights between the JAX package's parameter tree and the port's state_dict.

The port's ``HumanActionScorer`` uses the reference's own state_dict names,
so a reference ``.pt`` loads into it directly (:func:`load_torch_checkpoint`).
The two converters here carry the JAX package's flax tree (nested dicts of
numpy arrays) across, without importing jax:

- torch ``Conv1d.weight`` is ``[out, in, k]``; flax ``Conv.kernel`` is ``[k, in, out]``;
- torch ``Linear.weight`` is ``[out, in]``; flax ``Dense.kernel`` is ``[in, out]``;
- ``pos_enc.pe`` is generated (flax recomputes it, so the tree has none).

They mirror ``video_gen_evals_tpu/models/torch_compat.py``'s
``flax_params_to_torch_state_dict`` and ``torch_state_dict_to_flax``.

The mesh-recovery networks cross the same way:
:func:`vit_state_dict_from_jax_tree` and :func:`head_state_dict_from_jax_tree`
map the flax trees of the JAX package's ``ViTBackbone`` and
``SMPLTokenDecoderHead`` to the port's state_dicts, whose names are the
published torch checkpoints' own. They are the inverses of the JAX package's
``torch_vit_to_flax`` and ``torch_head_to_flax``.

Training state crosses the same way: :func:`named_tensors_from_jax_tree` maps
any tree shaped like the params (gradients, Adam moments) to the port's
parameter names and layouts, and :func:`load_optax_adam_state` continues a
JAX run's AdamW moments in a torch optimizer.

The JAX package's multi-process checkpoints are flat ``.npz`` files keyed by
the tree paths (``jax.tree_util.keystr``: ``['fusion']['Wq']['kernel']``);
:func:`tree_from_path_keys` and :func:`path_keys_from_tree` turn such a flat
dict into the nested tree and back.

The detectors cross by :func:`rcnn_state_dict_from_jax_tree` and
:func:`yolox_state_dict_from_jax_tree`, the inverses of the JAX package's
``detectron2_to_flax`` and ``yolox_to_flax``, and the 2D pose net by
:func:`pose_state_dict_from_jax_tree`, the inverse of ``mmpose_to_flax``.
"""

from __future__ import annotations

import re
import typing as T

import numpy as np
import torch

from .detector import DetectorConfig
from .fusion_encoder import _PE_MAX_LEN, EncoderConfig, HumanActionScorer, sinusoidal_positional_embedding
from .pose2d import PoseNetConfig
from .rcnn import RCNNConfig
from .smpl_head import SMPLHeadConfig
from .vit import ViTConfig

FlaxParams = T.Dict[str, T.Any]


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _conv_swap(w) -> np.ndarray:   # [out, in, k] <-> [k, in, out]
    return np.ascontiguousarray(np.transpose(_np(w), (2, 1, 0)))


def _dense_swap(w) -> np.ndarray:  # [out, in] <-> [in, out]
    return np.ascontiguousarray(np.transpose(_np(w), (1, 0)))


def _encoders(config: EncoderConfig) -> T.Iterator[T.Tuple[str, str]]:
    """(flax name, torch prefix) of every MovementConvEncoder."""
    for m, _ in config.dims_map_raw:
        yield f"state_enc_{m}", f"state_enc.{m}"
        if config.has_motion(m):
            yield f"motion_enc_{m}", f"motion_enc.{m}"


def state_dict_from_jax_params(params: FlaxParams, config: EncoderConfig) -> T.Dict[str, torch.Tensor]:
    """The JAX package's ``HumanActionScorer`` params -> the port's state_dict."""
    sd: T.Dict[str, np.ndarray] = {}
    for fname, prefix in _encoders(config):
        if fname not in params:
            continue
        p = params[fname]
        sd[f"{prefix}.stem.weight"] = _conv_swap(p["stem"]["kernel"])
        i = 0
        while f"block{i}" in p:
            b = p[f"block{i}"]
            sd[f"{prefix}.blocks.{i}.conv1.weight"] = _conv_swap(b["conv1"]["kernel"])
            sd[f"{prefix}.blocks.{i}.conv2.weight"] = _conv_swap(b["conv2"]["kernel"])
            sd[f"{prefix}.blocks.{i}.norm.weight"] = _np(b["norm"]["scale"])
            sd[f"{prefix}.blocks.{i}.norm.bias"] = _np(b["norm"]["bias"])
            i += 1
        sd[f"{prefix}.proj.weight"] = _dense_swap(p["proj"]["kernel"])

    f = params["fusion"]
    sd["fusion.latent"] = _np(f["latent"])
    for ln in ("q_ln", "kv_ln"):
        sd[f"fusion.{ln}.weight"] = _np(f[ln]["scale"])
        sd[f"fusion.{ln}.bias"] = _np(f[ln]["bias"])
    for w in ("Wq", "Wk", "Wv", "Wo"):
        sd[f"fusion.{w}.weight"] = _dense_swap(f[w]["kernel"])
    sd["fusion.logit_temp"] = _np(f["logit_temp"])
    sd["fusion.logit_bias"] = _np(f["logit_bias"])
    sd["cls"] = _np(params["cls"])

    for i in range(config.time_layers):
        t = params[f"temporal{i}"]
        p = f"temporal.layers.{i}"
        sd[f"{p}.self_attn.in_proj_weight"] = _dense_swap(t["in_proj"]["kernel"])
        sd[f"{p}.self_attn.in_proj_bias"] = _np(t["in_proj"]["bias"])
        sd[f"{p}.self_attn.out_proj.weight"] = _dense_swap(t["out_proj"]["kernel"])
        sd[f"{p}.self_attn.out_proj.bias"] = _np(t["out_proj"]["bias"])
        for lin in ("linear1", "linear2"):
            sd[f"{p}.{lin}.weight"] = _dense_swap(t[lin]["kernel"])
            sd[f"{p}.{lin}.bias"] = _np(t[lin]["bias"])
        for k, ln in ((f"{p}.norm1", "ln1"), (f"{p}.norm2", "ln2")):
            sd[f"{k}.weight"] = _np(t[ln]["scale"])
            sd[f"{k}.bias"] = _np(t[ln]["bias"])

    sd["pos_enc.pe"] = sinusoidal_positional_embedding(_PE_MAX_LEN, config.d_model).numpy()[None]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


_DICT_KEY_RE = re.compile(r"\['([^']*)'\]")


def tree_from_path_keys(flat: T.Mapping[str, np.ndarray]) -> FlaxParams:
    """A flat ``{keystr path: array}`` dict (a nested-dict tree's leaves, as
    the JAX package's ``_flatten_with_paths`` writes them) -> the nested tree."""
    root: FlaxParams = {}
    for key, val in flat.items():
        parts = _DICT_KEY_RE.findall(key)
        if not parts or "".join(f"['{p}']" for p in parts) != key:
            raise ValueError(f"npz key {key!r} is not a path of dict keys")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def path_keys_from_tree(tree: FlaxParams, prefix: str = "") -> T.Dict[str, np.ndarray]:
    """The inverse of :func:`tree_from_path_keys`: ``{keystr path: leaf}``."""
    out: T.Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(path_keys_from_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def named_tensors_from_jax_tree(tree: FlaxParams, config: EncoderConfig) -> T.Dict[str, torch.Tensor]:
    """A tree with the structure of the JAX package's params (a gradient tree,
    an Adam moment tree; numpy leaves) -> ``{parameter name: tensor}`` in the
    port's names and layouts: the swaps of :func:`state_dict_from_jax_params`,
    without the ``pos_enc.pe`` buffer, which is no parameter."""
    named = state_dict_from_jax_params(tree, config)
    del named["pos_enc.pe"]
    return named


def load_optax_adam_state(
    optimizer: torch.optim.AdamW,
    model: HumanActionScorer,
    mu: FlaxParams,
    nu: FlaxParams,
    count: int,
) -> None:
    """Put optax's ``adamw`` state (first moments ``mu``, second moments
    ``nu``, both trees of numpy arrays, and the update ``count``) into a torch
    ``AdamW`` over ``model``'s parameters as ``exp_avg``, ``exp_avg_sq`` and
    ``step``. With the schedule put at ``count`` as well
    (``train.step.position_cosine_schedule``), the next ``optimizer.step()``
    is the JAX run's next update."""
    exp_avg = named_tensors_from_jax_tree(mu, model.config)
    exp_avg_sq = named_tensors_from_jax_tree(nu, model.config)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }


class _TrackingDict(dict):
    """Records which keys the converter read (strict-mode accounting)."""

    def __init__(self, d):
        super().__init__(d)
        self.used: T.Set[str] = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)


def jax_params_from_state_dict(
    sd: T.Mapping[str, T.Any], config: EncoderConfig, strict: bool = False
) -> FlaxParams:
    """A reference-layout state_dict (tensors or arrays) -> the JAX
    package's param tree. ``strict=True`` raises on keys left unread
    (``pos_enc.pe`` is always exempt: flax recomputes it)."""
    sd = _TrackingDict(sd)
    params: FlaxParams = {}
    for fname, prefix in _encoders(config):
        if fname.startswith("motion_enc_") and f"{prefix}.stem.weight" not in sd:
            continue
        enc: FlaxParams = {"stem": {"kernel": _conv_swap(sd[f"{prefix}.stem.weight"])}}
        i = 0
        while f"{prefix}.blocks.{i}.conv1.weight" in sd:
            b = f"{prefix}.blocks.{i}"
            enc[f"block{i}"] = {
                "conv1": {"kernel": _conv_swap(sd[f"{b}.conv1.weight"])},
                "conv2": {"kernel": _conv_swap(sd[f"{b}.conv2.weight"])},
                "norm": {"scale": _np(sd[f"{b}.norm.weight"]), "bias": _np(sd[f"{b}.norm.bias"])},
            }
            i += 1
        enc["proj"] = {"kernel": _dense_swap(sd[f"{prefix}.proj.weight"])}
        params[fname] = enc

    params["fusion"] = {
        "latent": _np(sd["fusion.latent"]),
        "q_ln": {"scale": _np(sd["fusion.q_ln.weight"]), "bias": _np(sd["fusion.q_ln.bias"])},
        "kv_ln": {"scale": _np(sd["fusion.kv_ln.weight"]), "bias": _np(sd["fusion.kv_ln.bias"])},
        **{w: {"kernel": _dense_swap(sd[f"fusion.{w}.weight"])} for w in ("Wq", "Wk", "Wv", "Wo")},
        "logit_temp": _np(sd["fusion.logit_temp"]),
        "logit_bias": _np(sd["fusion.logit_bias"]),
    }
    params["cls"] = _np(sd["cls"])

    for i in range(config.time_layers):
        p = f"temporal.layers.{i}"
        params[f"temporal{i}"] = {
            "in_proj": {
                "kernel": _dense_swap(sd[f"{p}.self_attn.in_proj_weight"]),
                "bias": _np(sd[f"{p}.self_attn.in_proj_bias"]),
            },
            "out_proj": {
                "kernel": _dense_swap(sd[f"{p}.self_attn.out_proj.weight"]),
                "bias": _np(sd[f"{p}.self_attn.out_proj.bias"]),
            },
            "linear1": {"kernel": _dense_swap(sd[f"{p}.linear1.weight"]), "bias": _np(sd[f"{p}.linear1.bias"])},
            "linear2": {"kernel": _dense_swap(sd[f"{p}.linear2.weight"]), "bias": _np(sd[f"{p}.linear2.bias"])},
            "ln1": {"scale": _np(sd[f"{p}.norm1.weight"]), "bias": _np(sd[f"{p}.norm1.bias"])},
            "ln2": {"scale": _np(sd[f"{p}.norm2.weight"]), "bias": _np(sd[f"{p}.norm2.bias"])},
        }

    if strict:
        leftovers = {k for k in sd if k not in sd.used and "pos_enc.pe" not in k}
        if leftovers:
            raise KeyError(
                f"strict conversion: {len(leftovers)} unconsumed torch keys, "
                f"e.g. {sorted(leftovers)[:5]}"
            )
    return params


def load_torch_checkpoint(path: str, model: HumanActionScorer, strict: bool = False):
    """Load a reference ``.pt`` into ``model``, unwrapping as the reference
    does (ref ``eval.py:136-165``): ``model_state_dict``, else ``state_dict``,
    else the bare dict. ``strict=False`` (``--bug-compat``) tolerates missing
    and extra keys like the reference; ``strict=True`` raises on either.
    Only tensors and plain containers are unpickled (``weights_only``).
    Returns ``load_state_dict``'s missing/unexpected key lists."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    return model.load_state_dict(sd, strict=strict)


def _as_tensors(sd: T.Dict[str, np.ndarray]) -> T.Dict[str, torch.Tensor]:
    """fp32 tensors, whatever the leaves' type (a bf16 tree widens exactly):
    the Extractor rounds once itself under ``param_dtype="bfloat16"``."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _put_dense(sd, prefix: str, p: FlaxParams) -> None:
    sd[f"{prefix}.weight"] = _dense_swap(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def _put_norm(sd, prefix: str, p: FlaxParams) -> None:
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def vit_state_dict_from_jax_tree(params: FlaxParams, config: ViTConfig) -> T.Dict[str, torch.Tensor]:
    """The JAX package's ``ViTBackbone`` params (numpy leaves) -> the port's
    ``ViTBackbone`` state_dict: conv ``[kh, kw, in, out]`` -> ``[out, in, kh,
    kw]``, dense kernels transposed, ``block{i}`` -> ``blocks.{i}``."""
    sd: T.Dict[str, np.ndarray] = {
        "patch_embed.proj.weight": np.ascontiguousarray(
            np.transpose(_np(params["patch_embed"]["kernel"]), (3, 2, 0, 1))),
        "patch_embed.proj.bias": _np(params["patch_embed"]["bias"]),
        "pos_embed": _np(params["pos_embed"]),
    }
    if config.use_cls_token:
        sd["cls_token"] = _np(params["cls_token"])
    for i in range(config.depth):
        blk, b = params[f"block{i}"], f"blocks.{i}"
        _put_norm(sd, f"{b}.norm1", blk["norm1"])
        _put_dense(sd, f"{b}.attn.qkv", blk["qkv"])
        _put_dense(sd, f"{b}.attn.proj", blk["proj"])
        _put_norm(sd, f"{b}.norm2", blk["norm2"])
        _put_dense(sd, f"{b}.mlp.fc1", blk["fc1"])
        _put_dense(sd, f"{b}.mlp.fc2", blk["fc2"])
    if config.final_norm:
        _put_norm(sd, "norm", params["norm"])
    return _as_tensors(sd)


def head_state_dict_from_jax_tree(params: FlaxParams, config: SMPLHeadConfig) -> T.Dict[str, torch.Tensor]:
    """The JAX package's ``SMPLTokenDecoderHead`` params (numpy leaves) -> the
    port's head state_dict, in the upstream checkpoint's names."""
    sd: T.Dict[str, np.ndarray] = {}
    for name in ("decpose_grot", "decpose_hands", "decshape", "deccam"):
        _put_dense(sd, name, params[name])
    for buf in ("init_body_pose", "init_betas", "init_cam"):
        sd[buf] = _np(params[buf])

    dec = params["decoder"]
    _put_dense(sd, "transformer.to_token_embedding", dec["to_token_embedding"])
    sd["transformer.pos_embedding"] = _np(dec["pos_embedding"])
    for i in range(config.depth):
        p = f"transformer.transformer.layers.{i}"
        _put_norm(sd, f"{p}.0.norm", dec[f"sa_ln{i}"])
        _put_dense(sd, f"{p}.0.fn.to_qkv", dec[f"sa{i}"]["to_qkv"])
        _put_dense(sd, f"{p}.0.fn.to_out.0", dec[f"sa{i}"]["to_out"])
        _put_norm(sd, f"{p}.1.norm", dec[f"ca_ln{i}"])
        _put_dense(sd, f"{p}.1.fn.to_q", dec[f"ca{i}"]["to_q"])
        _put_dense(sd, f"{p}.1.fn.to_kv", dec[f"ca{i}"]["to_kv"])
        _put_dense(sd, f"{p}.1.fn.to_out.0", dec[f"ca{i}"]["to_out"])
        _put_norm(sd, f"{p}.2.norm", dec[f"ff_ln{i}"])
        _put_dense(sd, f"{p}.2.fn.net.0", dec[f"ff1_{i}"])
        _put_dense(sd, f"{p}.2.fn.net.3", dec[f"ff2_{i}"])

    cls = params["decpose"]
    _put_dense(sd, "decpose.cls_head", cls["cls_head"])
    sd["decpose.codebook"] = _np(cls["codebook"])
    for name in ("decoder_token_mlp", "decoder_start", "recover_embed"):
        _put_dense(sd, f"decpose.{name}", cls[name])
    _put_norm(sd, "decpose.decoder_layer_norm", cls["decoder_ln"])
    for i in range(config.dec_num_blocks):
        mix, p = cls[f"mixer_{i}"], f"decpose.decoder.{i}"
        _put_norm(sd, f"{p}.layernorm1", mix["ln1"])
        _put_dense(sd, f"{p}.MLP_token.ff.0", mix["token_fc1"])
        _put_dense(sd, f"{p}.MLP_token.ff.3", mix["token_fc2"])
        _put_norm(sd, f"{p}.layernorm2", mix["ln2"])
        _put_dense(sd, f"{p}.MLP_channel.ff.0", mix["channel_fc1"])
        _put_dense(sd, f"{p}.MLP_channel.ff.3", mix["channel_fc2"])
    return _as_tensors(sd)


def rcnn_state_dict_from_jax_tree(params: FlaxParams, config: RCNNConfig) -> T.Dict[str, torch.Tensor]:
    """The JAX package's ``FasterRCNN`` params (numpy leaves) -> the port's
    ``FasterRCNN`` state_dict, whose names are detectron2's: the inverse of
    the JAX package's ``detectron2_to_flax``. Convs ``[kh, kw, in/g, out]`` ->
    ``[out, in/g, kh, kw]``; FrozenBN ``scale``/``mean``/``var`` -> ``weight``/
    ``running_mean``/``running_var``; fc1's rows go back from flax's ``(y, x,
    c)`` flatten order to torch's ``(c, y, x)``."""
    sd: T.Dict[str, np.ndarray] = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(_np(p["kernel"]), (3, 2, 0, 1)))
        if "bias" in p:
            sd[f"{prefix}.bias"] = _np(p["bias"])

    def conv_norm(prefix, p):
        conv(prefix, p["conv"])
        n = p["norm"]
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}.norm.{ours}"] = _np(n[theirs])

    bb, bu = params["backbone"], "backbone.bottom_up"
    conv_norm(f"{bu}.stem.conv1", bb["stem_conv1"])
    for si, n in enumerate(config.stage_blocks):
        for bi in range(n):
            blk = bb[f"res{si + 2}_b{bi}"]
            for name in ("conv1", "conv2", "conv3", "shortcut"):
                if name in blk:
                    conv_norm(f"{bu}.res{si + 2}.{bi}.{name}", blk[name])
    for i in range(2, 6):
        conv(f"backbone.fpn_lateral{i}", bb[f"fpn_lateral{i}"])
        conv(f"backbone.fpn_output{i}", bb[f"fpn_output{i}"])
    for name in ("conv", "objectness_logits", "anchor_deltas"):
        conv(f"proposal_generator.rpn_head.{name}", params["rpn"][name])
    r, f = config.roi_resolution, config.fpn_channels
    fc1 = _np(params["fc1"]["kernel"]).reshape(r, r, f, config.fc_dim)
    sd["roi_heads.box_head.fc1.weight"] = np.ascontiguousarray(
        fc1.transpose(3, 2, 0, 1).reshape(config.fc_dim, f * r * r))
    sd["roi_heads.box_head.fc1.bias"] = _np(params["fc1"]["bias"])
    _put_dense(sd, "roi_heads.box_head.fc2", params["fc2"])
    _put_dense(sd, "roi_heads.box_predictor.cls_score", params["cls_score"])
    _put_dense(sd, "roi_heads.box_predictor.bbox_pred", params["bbox_pred"])
    return _as_tensors(sd)


def _with_counters(sd: T.Dict[str, T.Any]) -> T.Dict[str, torch.Tensor]:
    """float32 tensors, the norms' ``num_batches_tracked`` counters int64."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int64 if k.endswith("num_batches_tracked") else np.float32))
            for k, v in sd.items()}


def yolox_state_dict_from_jax_tree(params: FlaxParams, config: DetectorConfig) -> T.Dict[str, torch.Tensor]:
    """The JAX package's ``YOLOXDetector`` params (numpy leaves) -> the port's
    ``YOLOXDetector`` state_dict in Megvii's names: the inverse of the JAX
    package's ``yolox_to_flax``. Convs ``[kh, kw, in, out]`` -> ``[out, in,
    kh, kw]``; norms ``scale``/``mean``/``var`` -> ``weight``/``running_mean``/
    ``running_var``, with the ``num_batches_tracked`` counter (0) that
    ``nn.BatchNorm2d`` checkpoints carry."""
    sd: T.Dict[str, T.Any] = {}

    def pred(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(_np(p["kernel"]), (3, 2, 0, 1)))
        if "bias" in p:
            sd[f"{prefix}.bias"] = _np(p["bias"])

    def convbn(prefix, p):
        pred(f"{prefix}.conv", p["conv"])
        n = p["bn"]
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}.bn.{ours}"] = _np(n[theirs])
        sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)

    def csp(prefix, p):
        for name in ("conv1", "conv2", "conv3"):
            convbn(f"{prefix}.{name}", p[name])
        i = 0
        while f"m{i}" in p:
            convbn(f"{prefix}.m.{i}.conv1", p[f"m{i}"]["conv1"])
            convbn(f"{prefix}.m.{i}.conv2", p[f"m{i}"]["conv2"])
            i += 1

    neck, bb = params["neck"], "backbone.backbone"
    dark = neck["backbone"]
    convbn(f"{bb}.stem.conv", dark["stem"]["conv"])
    for stage in (2, 3, 4, 5):
        convbn(f"{bb}.dark{stage}.0", dark[f"dark{stage}_conv"])
    for stage in (2, 3, 4):
        csp(f"{bb}.dark{stage}.1", dark[f"dark{stage}_csp"])
    convbn(f"{bb}.dark5.1.conv1", dark["dark5_spp"]["conv1"])
    convbn(f"{bb}.dark5.1.conv2", dark["dark5_spp"]["conv2"])
    csp(f"{bb}.dark5.2", dark["dark5_csp"])
    for name in ("lateral_conv0", "reduce_conv1", "bu_conv2", "bu_conv1"):
        convbn(f"backbone.{name}", neck[name])
    for name in ("C3_p4", "C3_p3", "C3_n3", "C3_n4"):
        csp(f"backbone.{name}", neck[name])
    for i in range(len(config.strides)):
        convbn(f"head.stems.{i}", params[f"stem{i}"])
        for j in range(2):
            convbn(f"head.cls_convs.{i}.{j}", params[f"cls_conv{i}_{j}"])
            convbn(f"head.reg_convs.{i}.{j}", params[f"reg_conv{i}_{j}"])
        for name in ("cls", "reg", "obj"):
            pred(f"head.{name}_preds.{i}", params[f"{name}_pred{i}"])
    return _with_counters(sd)


def pose_state_dict_from_jax_tree(params: FlaxParams, config: PoseNetConfig) -> T.Dict[str, torch.Tensor]:
    """The JAX package's ``RTMPoseNet`` params (numpy leaves) -> the port's
    ``RTMPoseNet`` state_dict in mmpose's names: the inverse of the JAX
    package's ``mmpose_to_flax``. Convs (depthwise ones too) ``[kh, kw, in,
    out]`` -> ``[out, in, kh, kw]``; the channel attention's ``fc`` (a dense
    kernel ``[in, out]`` in JAX) -> a 1x1 conv ``[out, in, 1, 1]``; dense
    kernels ``[in, out]`` -> ``[out, in]``; norms as in
    :func:`yolox_state_dict_from_jax_tree`."""
    sd: T.Dict[str, T.Any] = {}

    def conv(prefix, p):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(_np(p["kernel"]), (3, 2, 0, 1)))
        if "bias" in p:
            sd[f"{prefix}.bias"] = _np(p["bias"])

    def convbn(prefix, p):
        conv(f"{prefix}.conv", p["conv"])
        n = p["bn"]
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}.bn.{ours}"] = _np(n[theirs])
        sd[f"{prefix}.bn.num_batches_tracked"] = np.zeros((), np.int64)

    def csp(prefix, p):
        for name in ("main_conv", "short_conv", "final_conv"):
            convbn(f"{prefix}.{name}", p[name])
        fc = p["attention"]["fc"]
        sd[f"{prefix}.attention.fc.weight"] = np.ascontiguousarray(_dense_swap(fc["kernel"])[:, :, None, None])
        sd[f"{prefix}.attention.fc.bias"] = _np(fc["bias"])
        i = 0
        while f"block{i}" in p:
            blk = p[f"block{i}"]
            convbn(f"{prefix}.blocks.{i}.conv1", blk["conv1"])
            convbn(f"{prefix}.blocks.{i}.conv2.depthwise_conv", blk["conv2_dw"])
            convbn(f"{prefix}.blocks.{i}.conv2.pointwise_conv", blk["conv2_pw"])
            i += 1

    bb = params["backbone"]
    for i in range(3):
        convbn(f"backbone.stem.{i}", bb[f"stem{i}"])
    for s, (_, _, _, _, use_spp) in enumerate(config._ARCH, start=1):
        convbn(f"backbone.stage{s}.0", bb[f"stage{s}_conv"])
        if use_spp:
            convbn(f"backbone.stage{s}.1.conv1", bb[f"stage{s}_spp"]["conv1"])
            convbn(f"backbone.stage{s}.1.conv2", bb[f"stage{s}_spp"]["conv2"])
        csp(f"backbone.stage{s}.{2 if use_spp else 1}", bb[f"stage{s}_csp"])
    conv("head.final_layer", params["final_layer"])
    sd["head.mlp.0.g"] = _np(params["mlp_ln"]["g"]).reshape(1)
    sd["head.mlp.1.weight"] = _dense_swap(params["mlp_fc"]["kernel"])
    gau = params["gau"]
    sd["head.gau.ln.g"] = _np(gau["ln"]["g"]).reshape(1)
    sd["head.gau.uv.weight"] = _dense_swap(gau["uv"]["kernel"])
    sd["head.gau.o.weight"] = _dense_swap(gau["o"]["kernel"])
    sd["head.gau.gamma"] = _np(gau["gamma"])
    sd["head.gau.beta"] = _np(gau["beta"])
    sd["head.gau.res_scale.scale"] = _np(gau["res_scale"])
    for axis in ("x", "y"):
        sd[f"head.cls_{axis}.weight"] = _dense_swap(params[f"cls_{axis}"]["kernel"])
    return _with_counters(sd)
