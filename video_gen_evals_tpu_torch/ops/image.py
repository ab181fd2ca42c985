"""Batched image ops of the extraction: box crops with bilinear resize, and
the full-frame resize with PIL-BILINEAR semantics, as fp32 products.

Port of ``video_gen_evals_tpu/ops/image.py``:

- :func:`bilinear_sample`, :func:`crop_resize` and
  :func:`crop_resize_matmul`: a box of each frame cropped and resized to a
  fixed size, by 4-tap gathers or as two products with separable weight
  matrices (the same numbers up to the order of the sums);
- :func:`batched_person_crops`: the legacy preprocessing's top-down crops
  (``ExtractorConfig.preproc="legacy"``): each person box expanded to the
  output's aspect, scaled, cropped, resized and normalised;
- :func:`pil_resize_weights` (host numpy, a copy) and
  :func:`resize_pil_matmul`: detectron2's ``ResizeShortestEdge`` resizes a
  frame with ``PIL.Image.resize(..., BILINEAR)``, so the detector's input is
  ``Wy @ frame @ Wx^T`` with Pillow's filter rows as weights.

JAX computes these outside any Pallas kernel, its products pinned to
``Precision.HIGHEST``; here they are ``torch`` matmuls and einsums in fp32,
and the caller keeps TF32 off (``utils/device.py::disable_tf32``). The JAX
functions take one image and are vmapped; these take a batch ``[N, H, W,
C]`` with one box a frame.
"""

from __future__ import annotations

import functools
import typing as T

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def pil_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's BILINEAR resample weights as a dense ``[n_out, n_in]``
    float32 matrix (``Resample.c::precompute_coeffs`` over the full extent):
    ``center = (i + 0.5) * scale``, the triangle's support widened by
    ``max(scale, 1)`` (so a downscale antialiases), out-of-range taps dropped
    and the window renormalised. Read-only; one per size pair."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 1.0 * fscale
    out = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = np.arange(lo, hi, dtype=np.float64)
        w = np.maximum(1.0 - np.abs((x - center + 0.5) / fscale), 0.0)
        out[i, lo:hi] = w / w.sum()
    out = out.astype(np.float32)
    out.setflags(write=False)
    return out


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample ``img [N, H, W, C]`` at float coordinates ``ys`` / ``xs``
    ``[N, h, w]``: ``[N, h, w, C]``. The floor tap and the tap after it are
    clipped to the image, each on its own, so a sample below the range
    interpolates rows (columns) 0 and 1 with the raw fractional part."""
    N, H, W, _ = img.shape
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[..., None]
    wx = (xs - x0)[..., None]
    y0 = y0.to(torch.int64).clamp(0, H - 1)
    x0 = x0.to(torch.int64).clamp(0, W - 1)
    y1 = (y0 + 1).clamp(0, H - 1)
    x1 = (x0 + 1).clamp(0, W - 1)
    n = torch.arange(N, device=img.device)[:, None, None]
    return (img[n, y0, x0] * (1 - wy) * (1 - wx) + img[n, y0, x1] * (1 - wy) * wx
            + img[n, y1, x0] * wy * (1 - wx) + img[n, y1, x1] * wy * wx)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division on every device: CUDA divides a
    tensor by a Python scalar as a product with the scalar's reciprocal,
    which moves a result by an ulp against the CPU's (and JAX's) quotient."""
    return x / torch.full_like(x, d)


def _sample_coords(boxes_cxcywh: torch.Tensor, out_hw: T.Tuple[int, int]
                   ) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """The pixel-centre convention: output pixel ``i`` samples
    ``box_start + (i + 0.5) * box_extent / out - 0.5``. Returns ``ys [N, oh]``
    and ``xs [N, ow]``."""
    oh, ow = out_hw
    cx, cy, w, h = boxes_cxcywh.unbind(-1)
    x0 = cx - w / 2.0
    y0 = cy - h / 2.0
    ar = lambda n: torch.arange(n, dtype=boxes_cxcywh.dtype, device=boxes_cxcywh.device)   # noqa: E731
    ys = y0[:, None] + (ar(oh) + 0.5) * true_div(h, oh)[:, None] - 0.5
    xs = x0[:, None] + (ar(ow) + 0.5) * true_div(w, ow)[:, None] - 0.5
    return ys, xs


def crop_resize(img: torch.Tensor, boxes_cxcywh: torch.Tensor, out_hw: T.Tuple[int, int]) -> torch.Tensor:
    """Each frame of ``img [N, H, W, C]`` cropped to its box (``[N, 4]``:
    centre x, centre y, width, height in pixels) and resized to ``out_hw``
    by :func:`bilinear_sample`: ``[N, oh, ow, C]``."""
    oh, ow = out_hw
    ys, xs = _sample_coords(boxes_cxcywh, out_hw)
    N = ys.shape[0]
    return bilinear_sample(img, ys[:, :, None].expand(N, oh, ow), xs[:, None, :].expand(N, oh, ow))


def _tap_weights(coords: torch.Tensor, n: int) -> torch.Tensor:
    """``[N, o] -> [N, o, n]``: ``1 - frac`` at the clipped floor tap and
    ``frac`` at the clipped tap after it (summed where the two clip to one),
    :func:`bilinear_sample`'s taps as a matrix."""
    f = torch.floor(coords)
    frac = (coords - f)[..., None]
    i0 = f.to(torch.int64).clamp(0, n - 1)[..., None]
    i1 = (i0 + 1).clamp(0, n - 1)
    idx = torch.arange(n, device=coords.device)
    return (idx == i0) * (1.0 - frac) + (idx == i1) * frac


def crop_resize_matmul(img: torch.Tensor, boxes_cxcywh: torch.Tensor, out_hw: T.Tuple[int, int]) -> torch.Tensor:
    """:func:`crop_resize` as two products: ``Wy @ img @ Wx^T`` with the
    separable tap matrices of :func:`_tap_weights`, rows first as in JAX, in
    fp32. The same taps and weights as the gather form, out-of-range samples
    included; only the order of the sums differs."""
    N, H, W, C = img.shape
    oh, ow = out_hw
    ys, xs = _sample_coords(boxes_cxcywh, out_hw)
    wy = _tap_weights(ys, H).to(img.dtype)                        # [N, oh, H]
    wx = _tap_weights(xs, W).to(img.dtype)                        # [N, ow, W]
    t = torch.bmm(wy, img.reshape(N, H, W * C)).reshape(N, oh, W, C)
    return torch.einsum("nywc,nxw->nyxc", t, wx)


def batched_person_crops(frames: torch.Tensor, boxes_xyxy: torch.Tensor,
                         out_hw: T.Tuple[int, int] = (256, 192), aspect_expand: bool = True,
                         scale: float = 1.0, mean: T.Optional[torch.Tensor] = None,
                         std: T.Optional[torch.Tensor] = None, impl: str = "matmul") -> torch.Tensor:
    """Top-down crops of ``frames [N, H, W, 3]`` (fp32 RGB, 0..255) at one
    person box a frame (``[N, 4]`` xyxy pixels): ``[N, oh, ow, 3]``.

    Each box is scaled by ``scale`` about its centre and, with
    ``aspect_expand``, expanded (never squashed) to ``out_hw``'s aspect, in
    JAX's order: the width first, then the height from the *new* width, with
    ``>`` on the one line and ``>=`` on the other, so an exact tie takes both
    branches' roundings. Then cropped and resized (``impl``: ``"matmul"``,
    :func:`crop_resize_matmul`, or ``"gather"``, :func:`crop_resize`) and,
    with ``mean`` / ``std`` (per channel, 0..255 scale), normalised."""
    if impl not in ("matmul", "gather"):
        raise ValueError(f"impl must be 'matmul' or 'gather', got {impl!r}")
    oh, ow = out_hw
    x0, y0, x1, y1 = boxes_xyxy.unbind(-1)
    cx = (x0 + x1) / 2.0
    cy = (y0 + y1) / 2.0
    w = (x1 - x0) * scale
    h = (y1 - y0) * scale
    if aspect_expand:
        w, h = expand_to_aspect(w, h, ow / oh)
    boxes = torch.stack([cx, cy, w, h], dim=1)
    crops = (crop_resize_matmul if impl == "matmul" else crop_resize)(frames, boxes, out_hw)
    if mean is not None:
        crops = (crops - mean) / std
    return crops


def expand_to_aspect(w: torch.Tensor, h: torch.Tensor, target: float) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """Box sizes expanded to the aspect ``target`` (width over height), as
    JAX's ``batched_person_crops`` does it: ``w`` first, ``h`` from the new
    ``w``."""
    w = torch.where(w / torch.clamp(h, min=1e-6) > target, w, h * target)
    h = torch.where(w / torch.clamp(h, min=1e-6) >= target, true_div(w, target), h)
    return w, h


def resize_pil_matmul(img: torch.Tensor, out_hw: T.Tuple[int, int]) -> torch.Tensor:
    """``img`` ``[..., H, W, C]`` float32 -> ``[..., oh, ow, C]`` with
    PIL-BILINEAR semantics: ``Wy @ img @ Wx^T``, rows first as in JAX."""
    H, W = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    wy = torch.tensor(pil_resize_weights(H, oh), device=img.device)
    wx = torch.tensor(pil_resize_weights(W, ow), device=img.device)
    t = torch.einsum("yh,...hwc->...ywc", wy, img)
    return torch.einsum("...ywc,xw->...yxc", t, wx)
