"""ROIAlignV2 over a packed FPN pyramid (K5), a CUDA kernel for Hopper.

Replaces ``video_gen_evals_tpu/ops/roi_align.py``: :func:`roi_align_pyramid_dma`
(``_pool_dma_kernel``, ``pallas_call`` at :335). Kernel source:
``csrc/roi_align.cu``. The detector's box head pools its proposals with it
(``models/rcnn.py::FasterRCNN._pool``).

What is computed (the JAX package's windowed ROIAlignV2, ``aligned=True``,
adaptive sampling capped at ``max_samples``): the pyramid levels are packed
one under the other into ``[sumH, Wmax8, C]`` (:func:`pack_pyramid`). For ROI
r on level l, a window of ``window`` rows and ``window_x`` columns starts at
``(wy0[r], wx0[r])``, and

    out[r, p, q, c] = sum_h sum_w Wy[r, p, h] * Wx[r, q, w] * buf[wy0 + h, wx0 + w, c]

where ``Wy [R, 7, window]`` and ``Wx [R, 7, window_x]`` hold, for each bin, the
sum over its sample positions of the two bilinear tap weights divided by the
sample count (:func:`_axis_weights`). The geometry is that of the DMA pool
(:func:`dma_geometry`): ``window_x = window + 8``, ``wx0`` floored to a
multiple of 8 and clipped to the buffer, ``wy0`` clipped to the level and
then to the buffer. It is ROIAlignV2 exactly (:func:`roi_align_reference`)
for every ROI whose tap span fits the window; a tap beyond the window reads
the window's last cell instead (``_axis_weights``' clamp), which is JAX's
rule and so the port's.

Two pools, as in JAX: :func:`roi_align_pyramid` is the matmul form (a square
``window`` x ``window`` slice, ``wx0`` clipped to the level), the CPU's pool;
:func:`roi_align_pyramid_dma` is K5 on CUDA tensors and
:func:`roi_align_pyramid_dma_plain` on CPU tensors. The two geometries agree
for every ROI whose span fits the window and differ beyond it.

The kernel computes each ROI's geometry and separable weights from its box
(in shared memory, with the plain version's rounding), never the dense outer
product ``[R, 49, window * window_x]`` that the TPU kernel is fed, and reads
only the window cells that carry weight. ``roi_align_pyramid_dma.launches``
counts its launches. Only a float32 pyramid is taken: the bfloat16 buffer of the JAX
package's ``fast()`` preset is not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import functools
import typing as T

import numpy as np
import torch

from .cuda_lib import check, load_library, stream_handle

OUT_SIZE = 7   # the kernel is built for 7 x 7 bins, the detector's roi_resolution


def pack_pyramid(
    feats: T.Sequence[torch.Tensor],   # per level [B, C, H_l, W_l] (NCHW)
) -> T.Tuple[torch.Tensor, T.Tuple[int, ...], T.Tuple[T.Tuple[int, int], ...]]:
    """Stack the levels along rows, channels last, columns zero-padded to
    the widest rounded up to 8: ``(buffer [B, sum(H_l), ceil8(max W_l), C],
    row_offsets, level_hw)``, one image's buffer per batch entry as JAX's
    ``pack_pyramid`` builds it. The padding is zero because a tap clamped
    to the window's edge may land there."""
    B, C = feats[0].shape[:2]
    wmax = max(f.shape[3] for f in feats)
    wmax += (-wmax) % 8
    hw = tuple((int(f.shape[2]), int(f.shape[3])) for f in feats)
    offs, rows = [], 0
    for h, _ in hw:
        offs.append(rows)
        rows += h
    buf = torch.zeros((B, rows, wmax, C), dtype=feats[0].dtype, device=feats[0].device)
    for f, off, (h, w) in zip(feats, offs, hw):
        buf[:, off:off + h, :w].copy_(f.permute(0, 2, 3, 1))
    return buf, tuple(offs), hw


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on any device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal instead, which can move a
    sample position (or a level boundary) by one ulp."""
    return x / torch.full_like(x, d)


def _axis_weights(
    start: torch.Tensor,      # [R] roi start in level coords (x0 / stride - 0.5)
    length: torch.Tensor,     # [R] roi extent in level coords
    extent: torch.Tensor,     # [R] int32 level size along this axis
    win_start: torch.Tensor,  # [R] int32 level index of window cell 0
    bins: int,
    window: int,
    max_samples: int,
) -> torch.Tensor:
    """``[R, bins, window]`` bilinear + average weights along one axis, the
    JAX ``_axis_weights`` term by term: ``ceil(length / bins)`` samples a
    bin (capped at ``max_samples``; 0 for an empty ROI), positions
    ``start + binw * (b + (k + .5) / s)``, taps zeroed outside ``[-1,
    extent]`` and clamped into the level with the ``floor >= extent - 1``
    edge rule, each sample weighted ``1 / s``; a tap beyond the window
    counts for the window's last cell."""
    dev = start.device
    binw = _div(length, bins)
    s = torch.ceil(binw).to(torch.int32).clamp(0, max_samples)
    safe_s = s.clamp_min(1).to(torch.float32)[:, None, None]
    binw = binw[:, None, None]
    b = torch.arange(bins, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(max_samples, dtype=torch.float32, device=dev)[None, None, :]
    kmask = k < s.to(torch.float32)[:, None, None]
    pos = start[:, None, None] + binw * (b + (k + 0.5) / safe_s)
    ext = extent[:, None, None]
    oob = (pos < -1.0) | (pos > ext.to(torch.float32))
    p = pos.clamp_min(0.0)
    low = torch.floor(p).to(torch.int32)
    at_edge = low >= ext - 1
    low = torch.where(at_edge, ext - 1, low)
    high = torch.where(at_edge, ext - 1, low + 1)
    frac = torch.where(at_edge, torch.zeros_like(p), p - low.to(torch.float32))
    w = torch.where(oob | ~kmask, 0.0, 1.0) / safe_s
    idx = torch.arange(window, dtype=torch.int32, device=dev)
    ws = win_start[:, None, None]
    rel_low = torch.clamp_max(low - ws, window - 1)[..., None]
    rel_high = torch.clamp_max(high - ws, window - 1)[..., None]
    contrib = ((w * (1.0 - frac))[..., None] * (idx == rel_low).to(torch.float32)
               + (w * frac)[..., None] * (idx == rel_high).to(torch.float32))
    return contrib.sum(dim=2)


def _level_tables(row_offsets, level_hw, strides, device):
    offs = torch.tensor(row_offsets, dtype=torch.int32, device=device)
    hs = torch.tensor([h for h, _ in level_hw], dtype=torch.int32, device=device)
    ws = torch.tensor([w for _, w in level_hw], dtype=torch.int32, device=device)
    st = torch.tensor(strides, dtype=torch.float32, device=device)
    return offs, hs, ws, st


def _roi_coords(boxes, levels, row_offsets, level_hw, strides):
    """Per ROI: level offset, H_l, W_l and (x0, y0, lx, ly) in level coords."""
    offs, hs, ws, st = _level_tables(row_offsets, level_hw, strides, boxes.device)
    lv = levels.long()
    stride = st[lv]
    x0 = boxes[:, 0] / stride - 0.5
    y0 = boxes[:, 1] / stride - 0.5
    lx = (boxes[:, 2] - boxes[:, 0]) / stride
    ly = (boxes[:, 3] - boxes[:, 1]) / stride
    return offs[lv], hs[lv], ws[lv], x0, y0, lx, ly


def _dma_windows(bufh: int, bufw: int, window: int, window_x: T.Optional[int]) -> T.Tuple[int, int]:
    """The DMA pool's window rows and columns on a ``bufh x bufw`` buffer."""
    window = min(window, bufh)
    window_x = window + 8 if window_x is None else window_x
    window_x = min(window_x, bufw - bufw % 8)
    if window_x <= 0 or bufw % 8:
        raise ValueError(f"buffer cols {bufw} must be 8-padded (pack_pyramid does this)")
    return window, window_x


def dma_geometry(
    buffer_hw: T.Tuple[int, int],
    row_offsets: T.Tuple[int, ...],
    level_hw: T.Tuple[T.Tuple[int, int], ...],
    strides: T.Tuple[int, ...],
    boxes: torch.Tensor,    # [R, 4] xyxy, image coords
    levels: torch.Tensor,   # [R] int in [0, L)
    out_size: int = OUT_SIZE,
    window: int = 48,
    window_x: T.Optional[int] = None,
    max_samples: int = 8,
) -> T.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int, int]:
    """The DMA pool's per-ROI geometry (JAX ``roi_align_pyramid_dma``'s
    ``geom``): ``(wy0 [R] int32, wx0 [R] int32, Wy [R, out, window],
    Wx [R, out, window_x], window, window_x)``, window starts in buffer
    coordinates. The column window is clipped to the buffer, not the level,
    so a right-edge box of a narrow level keeps its taps in the window."""
    bufh, bufw = buffer_hw
    window, window_x = _dma_windows(bufh, bufw, window, window_x)
    off, H_l, W_l, x0, y0, lx, ly = _roi_coords(boxes, levels, row_offsets, level_hw, strides)
    wy0 = torch.minimum(torch.floor(y0).to(torch.int32).clamp_min(0), (H_l - window).clamp_min(0)) + off
    wy0 = wy0.clamp(0, bufh - window)
    wx0 = torch.floor(x0).to(torch.int32).clamp(0, bufw)
    wx0 = torch.div(wx0, 8, rounding_mode="floor") * 8
    wx0 = wx0.clamp(0, bufw - window_x)
    Wy = _axis_weights(y0, ly, H_l, wy0 - off, out_size, window, max_samples)
    Wx = _axis_weights(x0, lx, W_l, wx0, out_size, window_x, max_samples)
    return wy0, wx0, Wy, Wx, window, window_x


def _batched(buffer: torch.Tensor, boxes: torch.Tensor, levels: torch.Tensor):
    """(buffer [B, sumH, W, C], boxes [B, R, 4], levels [B, R], unbatched)."""
    if buffer.dim() == 3:
        if boxes.dim() != 2 or levels.dim() != 1:
            raise ValueError("a [sumH, W, C] buffer takes boxes [R, 4] and levels [R]")
        return buffer[None], boxes[None], levels[None], True
    if buffer.dim() != 4 or boxes.dim() != 3 or levels.dim() != 2:
        raise ValueError("a [B, sumH, W, C] buffer takes boxes [B, R, 4] and levels [B, R]")
    if boxes.shape[:2] != levels.shape or boxes.shape[0] != buffer.shape[0] or boxes.shape[-1] != 4:
        raise ValueError(f"boxes {tuple(boxes.shape)} and levels {tuple(levels.shape)} do not match "
                         f"the buffer's {buffer.shape[0]} images")
    return buffer, boxes, levels, False


def _windows(buffer: torch.Tensor, img: torch.Tensor, wy0: torch.Tensor, wx0: torch.Tensor,
             window: int, window_x: int) -> torch.Tensor:
    """``[R, window, window_x, C]`` slices of the batched buffer."""
    B, bufh, bufw, C = buffer.shape
    dev = buffer.device
    rows = img.long()[:, None] * bufh + wy0.long()[:, None] + torch.arange(window, device=dev)
    cols = wx0.long()[:, None] + torch.arange(window_x, device=dev)
    flat = rows[:, :, None] * bufw + cols[:, None, :]
    return buffer.reshape(-1, C)[flat]


def _separable_pool(win: torch.Tensor, Wy: torch.Tensor, Wx: torch.Tensor) -> torch.Tensor:
    """``out[r, p, q, c] = sum_w Wx[r, q, w] sum_h Wy[r, p, h] win[r, h, w, c]``."""
    t = torch.einsum("rph,rhwc->rpwc", Wy, win)
    return torch.einsum("rqw,rpwc->rpqc", Wx, t)


def _check_buffer(buffer: torch.Tensor) -> None:
    if buffer.dtype != torch.float32:
        raise NotImplementedError(
            f"ROIAlign over a {buffer.dtype} pyramid is not ported: only float32 (the JAX "
            "package's fast() preset with its bfloat16 buffer is in ROADMAP.md, Queue 1)")


def roi_align_pyramid(
    buffer: torch.Tensor,                      # [sumH, Wmax, C] or [B, sumH, Wmax, C]
    row_offsets: T.Tuple[int, ...],
    level_hw: T.Tuple[T.Tuple[int, int], ...],
    strides: T.Tuple[int, ...],
    boxes: torch.Tensor,                       # [R, 4] or [B, R, 4] xyxy, image coords
    levels: torch.Tensor,                      # [R] or [B, R] int in [0, L)
    out_size: int = OUT_SIZE,
    window: int = 48,
    max_samples: int = 8,
    chunk: int = 128,
) -> torch.Tensor:
    """The matmul pool (JAX ``roi_align_pyramid``), in plain PyTorch on any
    device: a square ``window`` slice whose column start is clipped to the
    level, two products per ROI, ``chunk`` ROIs at a time. Returns
    ``[(B,) R, out, out, C]`` float32."""
    _check_buffer(buffer)
    buf, bx, lv, unbatched = _batched(buffer, boxes, levels)
    B, bufh, bufw, C = buf.shape
    R = bx.shape[1]
    window = min(window, bufh, bufw)
    boxes_f, levels_f = bx.reshape(-1, 4).to(torch.float32), lv.reshape(-1)
    img = torch.arange(B, device=buf.device).repeat_interleave(R)
    off, H_l, W_l, x0, y0, lx, ly = _roi_coords(boxes_f, levels_f, row_offsets, level_hw, strides)
    wy0 = torch.minimum(torch.floor(y0).to(torch.int32).clamp_min(0), (H_l - window).clamp_min(0)) + off
    wy0 = wy0.clamp(0, bufh - window)
    wx0 = torch.minimum(torch.floor(x0).to(torch.int32).clamp_min(0), (W_l - window).clamp_min(0))
    wx0 = wx0.clamp(0, bufw - window)
    Wy = _axis_weights(y0, ly, H_l, wy0 - off, out_size, window, max_samples)
    Wx = _axis_weights(x0, lx, W_l, wx0, out_size, window, max_samples)
    out = torch.empty((B * R, out_size, out_size, C), dtype=torch.float32, device=buf.device)
    for lo in range(0, B * R, chunk):
        sl = slice(lo, lo + chunk)
        win = _windows(buf, img[sl], wy0[sl], wx0[sl], window, window)
        out[sl] = _separable_pool(win, Wy[sl], Wx[sl])
    out = out.reshape(B, R, out_size, out_size, C)
    return out[0] if unbatched else out


def roi_align_pyramid_dma_plain(
    buffer: torch.Tensor,
    row_offsets: T.Tuple[int, ...],
    level_hw: T.Tuple[T.Tuple[int, int], ...],
    strides: T.Tuple[int, ...],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    out_size: int = OUT_SIZE,
    window: int = 48,
    window_x: T.Optional[int] = None,
    max_samples: int = 8,
    chunk: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version of K5 on any device: the DMA pool's geometry,
    each ROI's ``[window, window_x, C]`` slice gathered and contracted with
    the separable weights, ``chunk`` ROIs at a time. ``[(B,) R, out, out, C]``."""
    _check_buffer(buffer)
    buf, bx, lv, unbatched = _batched(buffer, boxes, levels)
    wy0, wx0, Wy, Wx, window, window_x = dma_geometry(
        tuple(buf.shape[1:3]), row_offsets, level_hw, strides, bx.reshape(-1, 4).to(torch.float32),
        lv.reshape(-1), out_size, window, window_x, max_samples)
    B, R, C = buf.shape[0], bx.shape[1], buf.shape[3]
    img = torch.arange(B, device=buf.device).repeat_interleave(R)
    out = torch.empty((B * R, out_size, out_size, C), dtype=torch.float32, device=buf.device)
    for lo in range(0, B * R, chunk):
        sl = slice(lo, lo + chunk)
        out[sl] = _separable_pool(_windows(buf, img[sl], wy0[sl], wx0[sl], window, window_x), Wy[sl], Wx[sl])
    out = out.reshape(B, R, out_size, out_size, C)
    return out[0] if unbatched else out


@functools.lru_cache(maxsize=16)
def _device_tables(row_offsets, level_hw, strides, device):
    """The kernel's level table ``[3, L]`` (row offset, H_l, W_l) and strides
    on ``device``, made once per pyramid geometry."""
    info = torch.tensor([*row_offsets, *(h for h, _ in level_hw), *(w for _, w in level_hw)], dtype=torch.int32)
    return info.to(device), torch.tensor(strides, dtype=torch.float32).to(device)


def roi_align_pyramid_dma(
    buffer: torch.Tensor,                      # [sumH, Wmax8, C] or [B, sumH, Wmax8, C] float32
    row_offsets: T.Tuple[int, ...],
    level_hw: T.Tuple[T.Tuple[int, int], ...],
    strides: T.Tuple[int, ...],
    boxes: torch.Tensor,                       # [R, 4] or [B, R, 4] xyxy, image coords
    levels: torch.Tensor,                      # [R] or [B, R] int in [0, L)
    out_size: int = OUT_SIZE,
    window: int = 48,
    window_x: T.Optional[int] = None,
    max_samples: int = 8,
) -> torch.Tensor:
    """K5: the DMA pool (signature of the JAX ``roi_align_pyramid_dma``, with
    an optional leading image axis; ``rois_per_step`` and ``precision`` are
    TPU knobs and are not taken). On a CUDA buffer one launch pools every ROI
    of every image, the kernel computing each ROI's geometry and weights from
    its box; on a CPU buffer :func:`roi_align_pyramid_dma_plain` runs.
    Returns ``[(B,) R, out, out, C]`` float32."""
    if buffer.device.type == "cpu":
        return roi_align_pyramid_dma_plain(buffer, row_offsets, level_hw, strides, boxes, levels,
                                           out_size, window, window_x, max_samples)
    if buffer.device.type != "cuda":
        raise ValueError(f"roi_align_pyramid_dma runs on CUDA or CPU tensors, not {buffer.device}")
    if out_size != OUT_SIZE:
        raise ValueError(f"the kernel is built for {OUT_SIZE} x {OUT_SIZE} bins, not {out_size}")
    if boxes.device != buffer.device or levels.device != buffer.device:
        raise ValueError("buffer, boxes and levels must be on one device")
    _check_buffer(buffer)
    buf, bx, lv, unbatched = _batched(buffer, boxes, levels)
    B, bufh, bufw, C = buf.shape
    window, window_x = _dma_windows(bufh, bufw, window, window_x)
    if len(level_hw) != len(row_offsets) or len(strides) < len(level_hw):
        raise ValueError("row_offsets, level_hw and strides must describe the same levels")
    buf = buf.contiguous()
    R = bx.shape[1]
    boxes_f = bx.reshape(-1, 4).to(torch.float32).contiguous()
    levels_i = lv.reshape(-1).to(torch.int32).contiguous()
    n_levels = len(level_hw)
    info, strides_t = _device_tables(tuple(row_offsets), tuple(level_hw), tuple(strides[:n_levels]), buf.device)
    out = torch.empty((B * R, out_size, out_size, C), dtype=torch.float32, device=buf.device)
    lib = load_library().lib
    code = lib.vge_roi_align(
        buf.device.index, buf.data_ptr(), bufh, bufw, C, boxes_f.data_ptr(), levels_i.data_ptr(),
        info.data_ptr(), strides_t.data_ptr(), n_levels, B * R, R, window, window_x, max_samples,
        out.data_ptr(), stream_handle(buf.device))
    check(code, "roi_align_pyramid_dma launch")
    roi_align_pyramid_dma.launches += 1
    out = out.reshape(B, R, out_size, out_size, C)
    return out[0] if unbatched else out


roi_align_pyramid_dma.launches = 0


def assign_fpn_levels(
    boxes: torch.Tensor,   # [..., 4] xyxy
    min_level: int = 2,
    max_level: int = 5,
    canonical_size: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """detectron2 ``assign_boxes_to_levels`` in float32, JAX's expression:
    ``floor(L0 + log2(sqrt(area) / s0 + 1e-8))`` clamped to the pyramid,
    0-based into ``[p_min..p_max]``."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)
    lvl = torch.floor(canonical_level + torch.log2(_div(torch.sqrt(area), canonical_size) + 1e-8))
    return (lvl.clamp(min_level, max_level) - min_level).to(torch.int32)


def roi_align_reference(
    feat: np.ndarray,        # [H, W, C]
    boxes: np.ndarray,       # [R, 4] xyxy in image coords
    stride: float,
    out_size: int = 7,
    sampling_ratio: int = 0,
    aligned: bool = True,
) -> np.ndarray:
    """Direct per-sample numpy ROIAlign(V2), transcribed from the published
    CUDA kernel (torchvision ``roi_align`` / detectron2 ``ROIAlign``): the
    oracle both pools are held against where the ROI's span fits the window.
    A copy of the JAX package's; python loops, test sizes only."""
    H, W, C = feat.shape
    R = boxes.shape[0]
    out = np.zeros((R, out_size, out_size, C), np.float64)
    off = 0.5 if aligned else 0.0
    f = feat.astype(np.float64)

    def interp(y, x):
        if y < -1.0 or y > H or x < -1.0 or x > W:
            return np.zeros(C)
        y = max(y, 0.0)
        x = max(x, 0.0)
        y_low, x_low = int(y), int(x)
        if y_low >= H - 1:
            y_low = y_high = H - 1
            y = float(y_low)
        else:
            y_high = y_low + 1
        if x_low >= W - 1:
            x_low = x_high = W - 1
            x = float(x_low)
        else:
            x_high = x_low + 1
        ly, lx = y - y_low, x - x_low
        hy, hx = 1.0 - ly, 1.0 - lx
        return (hy * hx * f[y_low, x_low] + hy * lx * f[y_low, x_high]
                + ly * hx * f[y_high, x_low] + ly * lx * f[y_high, x_high])

    for r in range(R):
        x0 = boxes[r, 0] / stride - off
        y0 = boxes[r, 1] / stride - off
        x1 = boxes[r, 2] / stride - off
        y1 = boxes[r, 3] / stride - off
        rw, rh = x1 - x0, y1 - y0
        if not aligned:
            rw, rh = max(rw, 1.0), max(rh, 1.0)
        bw, bh = rw / out_size, rh / out_size
        gw = sampling_ratio if sampling_ratio > 0 else int(np.ceil(rw / out_size))
        gh = sampling_ratio if sampling_ratio > 0 else int(np.ceil(rh / out_size))
        count = max(gw * gh, 1)
        for by in range(out_size):
            for bx in range(out_size):
                acc = np.zeros(C)
                for iy in range(gh):
                    yy = y0 + by * bh + (iy + 0.5) * bh / gh
                    for ix in range(gw):
                        xx = x0 + bx * bw + (ix + 0.5) * bw / gw
                        acc += interp(yy, xx)
                out[r, by, bx] = acc / count
    return out.astype(np.float32)
