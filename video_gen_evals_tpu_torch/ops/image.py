"""Full-frame resize with PIL-BILINEAR semantics, as two fp32 products.

Port of ``video_gen_evals_tpu/ops/image.py``: :func:`pil_resize_weights`
(host numpy, a copy) and :func:`resize_pil_matmul`. detectron2's
``ResizeShortestEdge`` resizes a frame with ``PIL.Image.resize(...,
BILINEAR)``, so the detector's input is ``Wy @ frame @ Wx^T`` with Pillow's
filter rows as weights. The products go to ``torch.matmul`` in fp32, as the
JAX package left them to XLA at ``Precision.HIGHEST``; the caller keeps TF32
off (``utils/device.py::disable_tf32``).
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


def resize_pil_matmul(img: torch.Tensor, out_hw: T.Tuple[int, int]) -> torch.Tensor:
    """``img`` ``[..., H, W, C]`` float32 -> ``[..., oh, ow, C]`` with
    PIL-BILINEAR semantics: ``Wy @ img @ Wx^T``, rows first as in JAX."""
    H, W = img.shape[-3], img.shape[-2]
    oh, ow = out_hw
    wy = torch.tensor(pil_resize_weights(H, oh), device=img.device)
    wx = torch.tensor(pil_resize_weights(W, ow), device=img.device)
    t = torch.einsum("yh,...hwc->...ywc", wy, img)
    return torch.einsum("...ywc,xw->...yxc", t, wx)
