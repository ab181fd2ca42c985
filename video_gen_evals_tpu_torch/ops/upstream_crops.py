"""Upstream-exact crop preprocessing for the mesh-recovery input.

Port of the mesh half of ``video_gen_evals_tpu/ops/upstream_crops.py``:
:func:`vitdet_mesh_crop` reproduces TokenHMR/hmr2's ``ViTDetDataset`` crops
(consumed at ref ``modifications/mesh_generator.py:122-143``) as device ops:
box -> center + 2.5x rescale, ``expand_to_aspect_ratio`` to ``BBOX_SHAPE``
then ``.max()`` -> a square source window; a gaussian anti-alias pre-blur
when the downsampling factor exceeds 1.1 (scipy/skimage semantics: radius
``int(4 * sigma + 0.5)``, mode "nearest"); ``cv2.warpAffine(INTER_LINEAR,
BORDER_CONSTANT=0)`` to a square ``IMAGE_SIZE`` patch; ImageNet (x255)
normalisation. The model-side width slice (hmr2 feeds ``x[:, :, :, 32:-32]``,
256x256 -> 256x192) is fused into the warp by sampling only the kept
destination columns.

The warp runs as two separable matrix products per frame (row weights, then
column weights) with cv2's sampling conventions: ``warpAffine`` inverse-maps
with continuous float coordinates at integer pixel centres, blends
out-of-range taps with the zero border, and rounds the uint8 path's output.
The blur is composed into the warp weights. Where the JAX function maps one
frame with ``vmap``, the batch axis is written out here. The products run in
true fp32 (callers keep TF32 off).

The DWPose and YOLOX halves of the JAX module come with their networks.
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch

# hmr2/TokenHMR DEFAULT_MEAN/STD (0..255 scale, RGB)
VITDET_MEAN_RGB = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
VITDET_STD_RGB = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def cv2_affine_coords(s_inv: torch.Tensor, t: torch.Tensor, dst_idx: torch.Tensor) -> torch.Tensor:
    """warpAffine's inverse-mapped source coordinates along one axis:
    ``src = M_inv_diag * dst + t`` with integer pixel centres. ``s_inv`` and
    ``t`` are ``[B]``, ``dst_idx`` ``[n_out]``; the result is ``[B, n_out]``."""
    return s_inv[:, None] * dst_idx.to(torch.float32)[None, :] + t[:, None]


def _border0_weights(coords: torch.Tensor, n_in: int, dtype: torch.dtype) -> torch.Tensor:
    """``[B, n_out, n_in]`` linear-tap weights with BORDER_CONSTANT(0)
    semantics: a tap outside ``[0, n_in)`` matches no column and so
    contributes nothing, which is blending with a zero border value."""
    f = torch.floor(coords)
    frac = (coords - f)[..., None]
    i0 = f.to(torch.int32)[..., None]
    idx = torch.arange(n_in, dtype=torch.int32, device=coords.device)
    return ((idx == i0) * (1.0 - frac) + (idx == i0 + 1) * frac).to(dtype)


def _compose_gaussian(
    w_warp: torch.Tensor,    # [B, n_out, n_in] warp weights
    sigma: torch.Tensor,     # [B]
    apply: torch.Tensor,     # [B] bool
    max_radius: int,
) -> torch.Tensor:
    """``w_warp @ G`` per frame, where G is scipy.ndimage's 1-D gaussian
    filter matrix (``radius = int(4 * sigma + 0.5)``, mode "nearest"), without
    building the ``[n_in, n_in]`` G: the banded interior is a sum of shifted
    copies of the warp rows, and edge replication folds the taps that fall off
    either end into the first and last columns. Frames with ``apply`` false
    get the identity."""
    if max_radius <= 0:
        return w_warp
    n_in = w_warp.shape[-1]
    dev = w_warp.device
    xi = torch.arange(-max_radius, max_radius + 1, dtype=torch.int32, device=dev)
    x = xi.to(torch.float32)
    # scipy: lw = int(truncate * sigma + 0.5), weights exp(-x^2 / (2 sigma^2))
    # over |x| <= lw, normalised
    lw = torch.floor(4.0 * sigma + 0.5).to(torch.int32)
    g = torch.exp(-0.5 * torch.square(x)[None, :] / sigma.clamp_min(1e-12)[:, None] ** 2)
    g = torch.where(xi.abs()[None, :] <= lw[:, None], g, torch.zeros_like(g))
    delta = (xi == 0).to(torch.float32)[None, :].expand_as(g)
    g = torch.where(apply[:, None], g / g.sum(dim=1, keepdim=True), delta)   # [B, 2r+1]

    # interior: (w_warp @ G)[o, j] = sum_t g[t] * w_warp[o, j - t]
    out = torch.zeros_like(w_warp)
    for k, t in enumerate(range(-max_radius, max_radius + 1)):
        gk = g[:, k, None, None]
        if t == 0:
            out += gk * w_warp
        elif t > 0:
            out[..., : n_in - t] += gk * w_warp[..., t:]
        else:
            out[..., -t:] += gk * w_warp[..., :t]
    # "nearest" edges: G[i, 0] gains the taps with i + t < 0 and G[i, n_in - 1]
    # those with i + t > n_in - 1
    j = torch.arange(n_in, dtype=torch.int32, device=dev)
    pos = j[:, None] + xi[None, :]                                            # [n_in, 2r+1]
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    lo_extra = torch.where((pos < 0)[None], g[:, None, :], zero).sum(dim=-1)  # [B, n_in]
    hi_extra = torch.where((pos > n_in - 1)[None], g[:, None, :], zero).sum(dim=-1)
    out[..., 0] += torch.matmul(w_warp, lo_extra[..., None])[..., 0]
    out[..., n_in - 1] += torch.matmul(w_warp, hi_extra[..., None])[..., 0]
    return out


def vitdet_square_bbox(
    boxes_xyxy: torch.Tensor,                   # [..., 4]
    rescale_factor: float = 2.5,
    bbox_shape: T.Optional[T.Tuple[int, int]] = (192, 256),
) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ViTDetDataset box geometry: centre, plus the square source-window size
    ``expand_to_aspect_ratio(rescale * wh, BBOX_SHAPE).max()``, which has the
    closed form ``max(w * h_t / w_t, h)``."""
    cx = (boxes_xyxy[..., 0] + boxes_xyxy[..., 2]) * 0.5
    cy = (boxes_xyxy[..., 1] + boxes_xyxy[..., 3]) * 0.5
    w = (boxes_xyxy[..., 2] - boxes_xyxy[..., 0]) * rescale_factor
    h = (boxes_xyxy[..., 3] - boxes_xyxy[..., 1]) * rescale_factor
    if bbox_shape is None:
        size = torch.maximum(w, h)
    else:
        w_t, h_t = bbox_shape
        size = torch.maximum(w * (h_t / w_t), h)
    return cx, cy, size


def _vitdet_warp(
    img: torch.Tensor,         # [B, H, W, C] f32 (values 0..255)
    cx: torch.Tensor,          # [B]
    cy: torch.Tensor,
    size: torch.Tensor,
    patch: int,
    out_w: int,
    antialias: bool,
    max_radius: int,
) -> torch.Tensor:
    B, H, W, C = img.shape
    pad = (patch - out_w) // 2
    s_inv = size / patch
    # gen_trans_from_patch_cv maps (cx, cy) -> (patch/2, patch/2); inverse:
    # src = (dst - patch/2) * s_inv + c
    tx = cx - s_inv * (patch * 0.5)
    ty = cy - s_inv * (patch * 0.5)
    # only the destination columns the model keeps (hmr2's x[:, :, :, pad:-pad])
    xi = torch.arange(pad, pad + out_w, dtype=torch.int32, device=img.device)
    yi = torch.arange(patch, dtype=torch.int32, device=img.device)
    wx = _border0_weights(cv2_affine_coords(s_inv, tx, xi), W, img.dtype)    # [B, out_w, W]
    wy = _border0_weights(cv2_affine_coords(s_inv, ty, yi), H, img.dtype)    # [B, patch, H]

    blurred = torch.zeros(B, dtype=torch.bool, device=img.device)
    if antialias:
        # hmr2 anti-aliasing: df = (size / patch) / 2; blur iff df > 1.1 with
        # sigma = (df - 1) / 2 (skimage gaussian, mode nearest, truncate 4)
        df = (size / patch) * 0.5
        blurred = df > 1.1
        sigma = (df - 1.0) * 0.5
        wx = _compose_gaussian(wx, sigma, blurred, max_radius)
        wy = _compose_gaussian(wy, sigma, blurred, max_radius)

    t = torch.matmul(wy, img.reshape(B, H, W * C)).reshape(B, patch, W, C)
    out = torch.einsum("bywc,bxw->byxc", t, wx)
    # uint8 path: cv2 warps the uint8 frame, rounds and saturates; the float
    # (blurred) path does not
    out_round = torch.round(out).clamp(0.0, 255.0)
    return torch.where(blurred[:, None, None, None], out, out_round)


def vitdet_mesh_crop(
    frames: torch.Tensor,       # [B, H, W, 3] f32 RGB 0..255
    boxes_xyxy: torch.Tensor,   # [B, 4]
    out_hw: T.Tuple[int, int] = (256, 192),
    rescale_factor: float = 2.5,
    bbox_shape: T.Optional[T.Tuple[int, int]] = None,
    antialias: bool = True,
    mean: T.Optional[np.ndarray] = None,
    std: T.Optional[np.ndarray] = None,
) -> torch.Tensor:
    """ViTDetDataset-exact mesh crops: [B, out_h, out_w, 3], normalised.

    ``out_hw`` is the model input (TokenHMR's 256x192); the warp target is the
    square ``patch = out_h`` IMAGE_SIZE with the width slice fused in.
    ``bbox_shape`` defaults to (out_w, out_h), TokenHMR's BBOX_SHAPE
    [192, 256]. Frames are RGB: blur and warp are channelwise, so warping RGB
    equals the reference's warp of BGR followed by the flip."""
    oh, ow = out_hw
    if bbox_shape is None:
        bbox_shape = (ow, oh)
    if (oh - ow) % 2:
        raise ValueError(f"patch-slice padding must be even, got {out_hw}")
    cx, cy, size = vitdet_square_bbox(boxes_xyxy, rescale_factor, bbox_shape)
    H, W = frames.shape[1:3]
    max_radius = 0
    if antialias:
        # static bound on the blur radius: boxes are at most frame-sized
        w_t, h_t = bbox_shape
        size_max = rescale_factor * max(W * (h_t / w_t), H)
        sigma_max = max((size_max / oh / 2.0 - 1.0) * 0.5, 0.0)
        max_radius = int(4.0 * sigma_max + 0.5)
    crops = _vitdet_warp(frames, cx, cy, size, oh, ow, antialias, max_radius)
    mean = VITDET_MEAN_RGB if mean is None else mean
    std = VITDET_STD_RGB if std is None else std
    mean_t = torch.as_tensor(np.asarray(mean), dtype=crops.dtype, device=crops.device)
    std_t = torch.as_tensor(np.asarray(std), dtype=crops.dtype, device=crops.device)
    return (crops - mean_t) / std_t
