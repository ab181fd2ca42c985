"""The port's ROIAlignV2 (``ops/roi_align.py``: the pyramid packing, the
matmul pool, K5's plain version, the level rule) and its PIL resize
(``ops/image.py``) on the CPU against the JAX package's functions, with the
same numpy pyramids and boxes. The JAX DMA pool runs its Pallas kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.ops import image as jax_image
from video_gen_evals_tpu.ops import roi_align as jax_roi
from video_gen_evals_tpu_torch.ops import image as port_image
from video_gen_evals_tpu_torch.ops import roi_align as port_roi

STRIDES = (4, 8, 16, 32)
CANVAS = (256, 272)   # p2 is 64 x 68: the buffer is 120 x 72, window 48, window_x 56
# (box xyxy in canvas pixels, level), each named for what it covers
IN_SPAN = {
    "small": ([2.0, 2.0, 30.0, 40.0], 0),
    "multi_sample": ([10.0, 5.0, 46.0, 70.0], 0),          # 16 cells: 3 samples a bin
    "right_edge_p2": ([240.0, 20.0, 268.0, 120.0], 0),     # taps up to column 67 of 68
    "right_edge_mid_level": ([200.0, 40.0, 270.0, 200.0], 1),   # p3 is 34 wide in a 72-wide buffer
    "corner_p5": ([180.0, 200.0, 272.0, 256.0], 3),
    "fractional": ([33.3, 47.9, 101.7, 88.2], 1),
    "empty": ([50.0, 50.0, 50.0, 80.0], 0),                # zero width: zero output
}
OVER_SPAN = {
    "wide_p2": ([0.0, 100.0, 250.0, 140.0], 0),            # 62 cells > window_x 56
    "wide_mid_p2": ([20.0, 10.0, 266.0, 30.0], 0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pyramid(seed, C=8, batch=1):
    """Per-level numpy features [B, H_l, W_l, C], unit scale."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, CANVAS[0] // s, CANVAS[1] // s, C)).astype(np.float32)
            for s in STRIDES]


def _port_buffer(levels_nhwc):
    feats = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in levels_nhwc]   # NCHW, as the backbone hands them
    return port_roi.pack_pyramid(feats)


def _jax_buffer(levels_nhwc, b=0):
    return jax_roi.pack_pyramid([jnp.asarray(f[b]) for f in levels_nhwc])


def _rois(*groups):
    items = [v for g in groups for v in g.values()]
    boxes = np.asarray([b for b, _ in items], np.float32)
    levels = np.asarray([lv for _, lv in items], np.int32)
    return boxes, levels


def _tol(x):
    return 1e-5 * max(1.0, float(np.abs(x).max()))


@pytest.fixture(scope="module")
def pyramid():
    feats = _pyramid(0)
    buf, offs, hw = _port_buffer(feats)
    jbuf, joffs, jhw = _jax_buffer(feats)
    return dict(feats=feats, buf=buf[0], offs=offs, hw=hw, jbuf=jbuf, joffs=joffs, jhw=jhw)


@pytest.fixture(scope="module")
def jax_dma(pyramid):
    """JAX ``roi_align_pyramid_dma`` (its Pallas kernel in interpret mode) on
    every ROI of both groups, in one call: ``{group: [R, 7, 7, C]}``."""
    boxes, levels = _rois(IN_SPAN, OVER_SPAN)
    out = np.asarray(jax_roi.roi_align_pyramid_dma(
        pyramid["jbuf"], pyramid["joffs"], pyramid["jhw"], STRIDES, jnp.asarray(boxes),
        jnp.asarray(levels), interpret=True))
    return {"in_span": out[:len(IN_SPAN)], "over_span": out[len(IN_SPAN):]}


def test_pack_pyramid_matches_jax(pyramid):
    """NCHW levels in, JAX's channels-last [sumH, ceil8(max W), C] out, bitwise,
    with the same row offsets and level sizes; the padding is zero."""
    assert pyramid["offs"] == pyramid["joffs"] and pyramid["hw"] == pyramid["jhw"]
    assert tuple(pyramid["buf"].shape) == (120, 72, 8)
    np.testing.assert_array_equal(pyramid["buf"].numpy(), np.asarray(pyramid["jbuf"]))


@pytest.mark.parametrize("group", ["in_span", "over_span"])
def test_k5_plain_matches_jax_dma_kernel(pyramid, jax_dma, group):
    """K5's plain version against JAX ``roi_align_pyramid_dma`` (the Pallas
    kernel in interpret mode) on the DMA geometry, in-span ROIs (small,
    multi-sample, right-edge, mid-level, corner, empty) and ROIs whose span
    exceeds the window, where both clamp taps to the window's last cell.
    Tolerance 1e-5 x max(1, max|x|): fp32 sums in another order."""
    boxes, levels = _rois(IN_SPAN if group == "in_span" else OVER_SPAN)
    want = jax_dma[group]
    got = port_roi.roi_align_pyramid_dma_plain(
        pyramid["buf"], pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes),
        torch.from_numpy(levels)).numpy()
    assert got.shape == (len(boxes), 7, 7, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = port_roi.roi_align_pyramid_dma.launches
    again = port_roi.roi_align_pyramid_dma(
        pyramid["buf"], pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes),
        torch.from_numpy(levels)).numpy()
    assert port_roi.roi_align_pyramid_dma.launches == before
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("group", ["in_span", "over_span"])
def test_matmul_pool_matches_jax(pyramid, group):
    """The matmul pool (square window, column start clipped to the level)
    against JAX ``roi_align_pyramid``, in-span and over-span ROIs."""
    boxes, levels = _rois(IN_SPAN if group == "in_span" else OVER_SPAN)
    want = np.asarray(jax_roi.roi_align_pyramid(
        pyramid["jbuf"], pyramid["joffs"], pyramid["jhw"], STRIDES, jnp.asarray(boxes),
        jnp.asarray(levels), chunk=4))
    got = port_roi.roi_align_pyramid(
        pyramid["buf"], pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes),
        torch.from_numpy(levels), chunk=4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


@pytest.mark.parametrize("window", [48, 32])
def test_k5_plain_at_bf16_matches_jax_dma_kernel(pyramid, window):
    """A bfloat16 buffer (``RCNNConfig.fast()``'s pyramid) through K5's plain
    version against JAX ``roi_align_pyramid_dma`` on the same bfloat16 buffer
    (the Pallas kernel in interpret mode), at window 48 and at fast()'s 32,
    in-span and over-span ROIs: within 1e-6 x max(1, max|x|), since the
    cells widen exactly and both sum in float32. The wrapper on the CPU
    tensor is the plain version, and equals the float32 pool on the buffer
    rounded to bfloat16 and back."""
    boxes, levels = _rois(IN_SPAN, OVER_SPAN)
    want = np.asarray(jax_roi.roi_align_pyramid_dma(
        pyramid["jbuf"].astype(jnp.bfloat16), pyramid["joffs"], pyramid["jhw"], STRIDES, jnp.asarray(boxes),
        jnp.asarray(levels), window=window, interpret=True))
    args = (pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes), torch.from_numpy(levels))
    buf16 = pyramid["buf"].bfloat16()
    got = port_roi.roi_align_pyramid_dma_plain(buf16, *args, window=window).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
    np.testing.assert_array_equal(port_roi.roi_align_pyramid_dma(buf16, *args, window=window).numpy(), got)
    np.testing.assert_array_equal(
        port_roi.roi_align_pyramid_dma_plain(buf16.float(), *args, window=window).numpy(), got)
    fp32 = port_roi.roi_align_pyramid_dma_plain(pyramid["buf"], *args, window=window).numpy()
    assert np.abs(got - fp32).max() > 1e-4     # the buffer's rounding shows


def test_matmul_pool_at_bf16_matches_jax(pyramid):
    """The matmul pool over a bfloat16 buffer against JAX ``roi_align_pyramid``
    over the same buffer (which casts each window to float32), at fast()'s
    window 32, in-span and over-span ROIs: within the float32 pool's
    tolerance (two products, each summed in another order)."""
    boxes, levels = _rois(IN_SPAN, OVER_SPAN)
    want = np.asarray(jax_roi.roi_align_pyramid(
        pyramid["jbuf"].astype(jnp.bfloat16), pyramid["joffs"], pyramid["jhw"], STRIDES, jnp.asarray(boxes),
        jnp.asarray(levels), window=32, chunk=4))
    got = port_roi.roi_align_pyramid(
        pyramid["buf"].bfloat16(), pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes),
        torch.from_numpy(levels), window=32, chunk=4).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def test_both_pools_match_the_cuda_transcription_in_span(pyramid):
    """In-span ROIs: both pools are ROIAlignV2 itself (``roi_align_reference``,
    the published CUDA kernel's per-sample loop in float64)."""
    boxes, levels = _rois(IN_SPAN)
    args = (pyramid["buf"], pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes),
            torch.from_numpy(levels))
    dma = port_roi.roi_align_pyramid_dma_plain(*args).numpy()
    mm = port_roi.roi_align_pyramid(*args).numpy()
    for i, (box, lv) in enumerate(zip(boxes, levels)):
        want = port_roi.roi_align_reference(pyramid["feats"][lv][0], box[None], STRIDES[lv])[0]
        np.testing.assert_allclose(dma[i], want, rtol=0, atol=_tol(want), err_msg=f"dma roi {i}")
        np.testing.assert_allclose(mm[i], want, rtol=0, atol=_tol(want), err_msg=f"matmul roi {i}")
    assert np.abs(dma[list(IN_SPAN).index("empty")]).max() == 0.0


def test_pools_differ_only_beyond_the_window(pyramid):
    """Over-span ROIs: the two geometries clamp at different window edges, so
    the pools disagree there (each still reads every bin, never zeros)."""
    boxes, levels = _rois(OVER_SPAN)
    args = (pyramid["buf"], pyramid["offs"], pyramid["hw"], STRIDES, torch.from_numpy(boxes),
            torch.from_numpy(levels))
    dma = port_roi.roi_align_pyramid_dma_plain(*args).numpy()
    mm = port_roi.roi_align_pyramid(*args).numpy()
    assert np.abs(dma - mm).max() > 1e-2
    assert (np.abs(dma).max(axis=-1) > 0).all() and (np.abs(mm).max(axis=-1) > 0).all()


def test_batched_buffer_matches_per_image():
    """A [B, sumH, W, C] buffer with boxes [B, R, 4] pools each image from its
    own slice, as JAX's lax.map over images does."""
    feats = _pyramid(1, batch=2)
    buf, offs, hw = _port_buffer(feats)
    boxes, levels = _rois(IN_SPAN, OVER_SPAN)
    bx = torch.from_numpy(np.stack([boxes, boxes[::-1].copy()]))
    lv = torch.from_numpy(np.stack([levels, levels[::-1].copy()]))
    for pool in (port_roi.roi_align_pyramid_dma_plain, port_roi.roi_align_pyramid):
        both = pool(buf, offs, hw, STRIDES, bx, lv)
        for b in range(2):
            one = pool(buf[b], offs, hw, STRIDES, bx[b], lv[b])
            np.testing.assert_allclose(both[b].numpy(), one.numpy(), rtol=0, atol=1e-6)


def test_assign_fpn_levels_matches_jax():
    """The f32 level rule, equal on random boxes and on the boundary boxes
    (sqrt(area) = 112, 224, 448) of detectron2's rule."""
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 1333, size=(500, 2)).astype(np.float32)
    wh = rng.uniform(0, 600, size=(500, 2)).astype(np.float32) ** rng.uniform(0.5, 1.2, size=(500, 1))
    boxes = np.concatenate([xy, xy + wh.astype(np.float32)], axis=1).astype(np.float32)
    boundary = np.asarray([[0, 0, 64, 64], [0, 0, 224, 224], [0, 0, 448, 448], [0, 0, 1200, 1200],
                           [0, 0, 8, 8], [0, 0, 112, 112], [5, 5, 5, 9]], np.float32)
    boxes = np.concatenate([boxes, boundary])
    want = np.asarray(jax_roi.assign_fpn_levels(jnp.asarray(boxes)))
    got = port_roi.assign_fpn_levels(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-7:].tolist() == [0, 2, 3, 3, 0, 1, 0]


def test_refusals():
    buf = torch.zeros(120, 72, 8)
    boxes, levels = torch.zeros(1, 4), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_roi.roi_align_pyramid_dma(buf.half(), (0,), ((120, 72),), (4,), boxes, levels)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_roi.roi_align_pyramid(buf.double(), (0,), ((120, 72),), (4,), boxes, levels)
    with pytest.raises(ValueError, match="8-padded"):
        port_roi.roi_align_pyramid_dma(buf[:, :70], (0,), ((120, 70),), (4,), boxes, levels)
    with pytest.raises(ValueError, match="boxes"):
        port_roi.roi_align_pyramid_dma(buf, (0,), ((120, 72),), (4,), boxes[None], levels)


@pytest.mark.parametrize("out_hw", [(50, 71), (20, 30)])
def test_resize_pil_matmul_matches_jax(out_hw):
    """PIL-bilinear resize, up and down (the antialiased branch), against
    JAX's on a 0..255 image (1e-3 absolute: fp32 sums of 37-53 terms)."""
    img = np.random.default_rng(3).uniform(0, 255, size=(37, 53, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_image.pil_resize_weights(37, out_hw[0]),
                                  jax_image.pil_resize_weights(37, out_hw[0]))
    want = np.asarray(jax_image.resize_pil_matmul(jnp.asarray(img), out_hw))
    got = port_image.resize_pil_matmul(torch.from_numpy(img)[None], out_hw)[0].numpy()
    assert got.shape == (*out_hw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
