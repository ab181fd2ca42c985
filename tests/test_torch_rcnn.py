"""The port's Faster R-CNN (``models/rcnn.py``) on the CPU against the JAX
package's, at ``RCNNConfig.small()``: one seeded detectron2-layout state_dict,
loaded natively by the port and through ``detectron2_to_flax`` by JAX. JAX
runs at matmul precision "highest" (set for the module) and pools with its
matmul form, as on the
CPU it does; the port pools with the matmul form too, and with K5's plain
version where a test pins ``roi_impl="dma"``."""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import rcnn as jax_rcnn
from video_gen_evals_tpu_torch.models import rcnn as port_rcnn
from video_gen_evals_tpu_torch.models.torch_compat import rcnn_state_dict_from_jax_tree
from video_gen_evals_tpu_torch.pipelines.weights import extraction_params_from_checkpoints, load_torch_state_dict

CANVAS = (64, 96)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state_dict(cfg, seed=0):
    """detectron2-named numpy weights for ``cfg``: normal 0.1 (FrozenBN
    variances uniform in [0.5, 1.5]), the class logits' weights 30x so that
    some boxes pass the 0.25 score threshold."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in port_rcnn.FasterRCNN(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[k] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    sd["roi_heads.box_predictor.cls_score.weight"] *= 30.0
    return sd


def port_model(cfg, sd):
    model = port_rcnn.FasterRCNN(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    """The port's and JAX's detector on one state_dict, JAX's applies jitted
    once for the module at matmul precision "highest" (the flag and the
    compiled executables put back after it)."""
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = port_rcnn.RCNNConfig.small()
    jcfg = jax_rcnn.RCNNConfig.small()
    sd = seeded_state_dict(cfg)
    params = jax_rcnn.detectron2_to_flax(sd, jcfg)
    jmodel = jax_rcnn.FasterRCNN(jcfg)

    def jit(method=None):
        fn = (lambda p, *a: jmodel.apply({"params": p}, *a)) if method is None else \
            (lambda p, *a: jmodel.apply({"params": p}, *a, method=method))
        return jax.jit(fn)

    yield dict(cfg=cfg, jcfg=jcfg, sd=sd, params=params, jmodel=jmodel, port=port_model(cfg, sd),
               backbone=jit(jmodel.backbone_features), rpn=jit(jmodel.rpn_raw), box=jit(jmodel.box_forward))
    jax.config.update("jax_default_matmul_precision", before)
    jax.clear_caches()


def _canvas(seed, b=2):
    return (np.random.default_rng(seed).standard_normal((b, *CANVAS, 3)) * 50).astype(np.float32)


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_state_dict_round_trips_through_jax_tree(pair):
    """``rcnn_state_dict_from_jax_tree`` inverts ``detectron2_to_flax``
    exactly (fc1's row permutation included)."""
    back = rcnn_state_dict_from_jax_tree(pair["params"], pair["cfg"])
    assert set(back) == set(pair["sd"])
    for k, v in pair["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_backbone_and_rpn_match_jax(pair):
    """p2..p6 and the RPN's objectness and deltas within 1e-4 (fp32 convs in
    both; the port's are NCHW, compared in JAX's NHWC)."""
    x = _canvas(1)
    with torch.no_grad():
        feats = pair["port"].backbone_features(torch.from_numpy(x))
        rpn = pair["port"].rpn_raw(torch.from_numpy(x))
    want = pair["backbone"](pair["params"], jnp.asarray(x))
    want_rpn = pair["rpn"](pair["params"], jnp.asarray(x))
    assert len(feats) == 5
    for i, (g, w) in enumerate(zip(feats, want)):
        np.testing.assert_allclose(_nchw_to_nhwc(g), np.asarray(w), rtol=0, atol=1e-4, err_msg=f"p{i + 2}")
    for i, ((go, gd), (wo, wd)) in enumerate(zip(rpn, want_rpn)):
        np.testing.assert_allclose(_nchw_to_nhwc(go), np.asarray(wo), rtol=0, atol=1e-4, err_msg=f"obj {i}")
        np.testing.assert_allclose(_nchw_to_nhwc(gd), np.asarray(wd), rtol=0, atol=1e-4, err_msg=f"deltas {i}")


@pytest.mark.parametrize("roi_impl", ["matmul", "dma"])
def test_box_forward_matches_jax(pair, roi_impl):
    """Pool + box head on fixed in-span boxes against JAX's ``box_forward``
    (the matmul pool): fc1 loaded in torch's layout with the pool flattened
    channel first, class-major deltas. Within 1e-4; K5's plain version
    (``dma``) equals the matmul pool on in-span boxes."""
    cfg = dataclasses.replace(pair["cfg"], roi_impl=roi_impl)
    model = port_model(cfg, pair["sd"])
    x = _canvas(2)
    boxes = np.asarray([[[4, 4, 40, 60], [10, 20, 90, 50], [0, 0, 96, 64], [30, 10, 34, 18]],
                        [[60, 2, 95, 63], [1, 30, 20, 40], [45.5, 12.25, 70.75, 52.5], [8, 8, 24, 24]]],
                       np.float32)
    levels = port_rcnn.assign_fpn_levels(torch.from_numpy(boxes))
    with torch.no_grad():
        cls, deltas = model.box_forward(torch.from_numpy(x), torch.from_numpy(boxes), levels)
    wcls, wdel = pair["box"](pair["params"], jnp.asarray(x), jnp.asarray(boxes), jnp.asarray(levels.numpy()))
    assert cls.shape == (2, 4, 81) and deltas.shape == (2, 4, 320)
    np.testing.assert_allclose(cls.numpy(), np.asarray(wcls), rtol=0, atol=1e-4)
    np.testing.assert_allclose(deltas.numpy(), np.asarray(wdel), rtol=0, atol=1e-4)


def _boxes(rng, shape, hw=CANVAS):
    xy = rng.uniform(0, hw[1] * 0.8, size=(*shape, 2))
    wh = rng.uniform(1, hw[1] * 0.5, size=(*shape, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def test_nms_masked_matches_jax():
    """Greedy NMS keep-masks equal, batched over 6 rows of 40 clustered boxes
    (some invalid), at IoU 0.7 and 0.5."""
    rng = np.random.default_rng(3)
    centres = rng.uniform(10, 80, size=(6, 40, 2))
    size = rng.uniform(5, 30, size=(6, 40, 2))
    boxes = np.concatenate([centres - size / 2, centres + size / 2], -1).astype(np.float32)
    boxes[:, 1::3] = boxes[:, ::3][:, :boxes[:, 1::3].shape[1]] + rng.uniform(-2, 2, size=(6, 13, 4)).astype(np.float32)
    valid = rng.uniform(size=(6, 40)) > 0.1
    for thresh in (0.7, 0.5):
        want = np.asarray(jax.vmap(lambda b, v: jax_rcnn.nms_masked(b, v, thresh))(
            jnp.asarray(boxes), jnp.asarray(valid)))
        got = port_rcnn.nms_masked(torch.from_numpy(boxes), torch.from_numpy(valid), thresh).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < valid.sum()


def test_rpn_proposals_match_jax(pair):
    """rpn_proposals on seeded RPN outputs: the port takes detectron2's NCHW
    layout and ranks in JAX's (h, w, a) order; valid masks equal, valid
    proposals within 1e-4 (pixels)."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    rng = np.random.default_rng(4)
    A, B = 3, 2
    sizes = [(CANVAS[0] // s, CANVAS[1] // s) for s in cfg.strides]
    outs = [(rng.standard_normal((B, h, w, A)).astype(np.float32),
             (rng.standard_normal((B, h, w, 4 * A)) * 0.3).astype(np.float32)) for h, w in sizes]
    anchors = [port_rcnn.level_anchors(hw, cfg.strides[i], cfg.anchor_sizes[i], cfg.anchor_ratios)
               for i, hw in enumerate(sizes)]
    np.testing.assert_array_equal(anchors[1], jax_rcnn.level_anchors(sizes[1], 8, 64.0, (0.5, 1.0, 2.0)))
    wb, wv = jax.jit(jax_rcnn.rpn_proposals, static_argnums=(2, 3))(
        [(jnp.asarray(o), jnp.asarray(d)) for o, d in outs], [jnp.asarray(a) for a in anchors], CANVAS, jcfg)
    gb, gv = port_rcnn.rpn_proposals(
        [(torch.from_numpy(o).permute(0, 3, 1, 2), torch.from_numpy(d).permute(0, 3, 1, 2)) for o, d in outs],
        [torch.from_numpy(a) for a in anchors], CANVAS, cfg)
    wv = np.asarray(wv)
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_allclose(gb.numpy()[wv], np.asarray(wb)[wv], rtol=0, atol=1e-4)


def test_fast_rcnn_postprocess_matches_jax(pair):
    """Second stage on seeded logits: valid masks and classes equal, valid
    boxes within 1e-4 and scores within 1e-6."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    rng = np.random.default_rng(5)
    B, K, C = 2, 24, cfg.num_classes
    logits = (rng.standard_normal((B, K, C + 1)) * 3).astype(np.float32)
    deltas = (rng.standard_normal((B, K, 4 * C)) * 0.5).astype(np.float32)
    props = _boxes(rng, (B, K))
    pvalid = rng.uniform(size=(B, K)) > 0.2
    want = jax.jit(jax_rcnn.fast_rcnn_postprocess, static_argnums=(4, 5))(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(props), jnp.asarray(pvalid), CANVAS, jcfg)
    got = port_rcnn.fast_rcnn_postprocess(torch.from_numpy(logits), torch.from_numpy(deltas),
                                          torch.from_numpy(props), torch.from_numpy(pvalid), CANVAS, cfg)
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    assert v.sum() > 0
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-6)


def test_full_forward_matches_jax(pair):
    """The whole detector on two canvases: valid counts and classes equal,
    boxes within 5e-3 (JAX's own tolerance for its detector), scores 1e-4."""
    x = _canvas(6)
    with torch.no_grad():
        got = pair["port"](torch.from_numpy(x), image_hw=(60, 90))
    jmodel = pair["jmodel"]
    want = jax.jit(lambda p, a: jmodel.apply({"params": p}, a, image_hw=(60, 90)))(pair["params"], jnp.asarray(x))
    v = np.asarray(want["valid"])
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-4)
    assert (got["boxes"].numpy()[v][:, 2] <= 90).all() and (got["boxes"].numpy()[v][:, 3] <= 60).all()


def test_x101_key_and_shape_set_matches_jax():
    """The port's X101-32x8d-FPN state_dict, built on the meta device, is the
    key set JAX's converter takes, and converts to the shapes of the JAX
    model's own init tree (traced, nothing allocated at full size)."""
    with torch.device("meta"):
        model = port_rcnn.FasterRCNN(port_rcnn.RCNNConfig.x101_32x8d())
    zero = np.zeros((), np.float32)
    sd = {k: np.broadcast_to(zero, tuple(v.shape)) for k, v in model.state_dict().items()}
    assert len(sd) == 5 + 33 * 3 * 5 + 4 * 5 + 8 * 2 + 6 + 8   # stem, blocks, shortcuts, fpn, rpn, heads
    params = jax_rcnn.detectron2_to_flax(sd, jax_rcnn.RCNNConfig.x101_32x8d())
    init = jax.eval_shape(jax_rcnn.FasterRCNN(jax_rcnn.RCNNConfig.x101_32x8d()).init, jax.random.key(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))["params"]

    def shapes(tree):
        return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(params) == shapes(init)
    n = sum(int(np.prod(v.shape)) for v in model.parameters())
    assert 100e6 < n < 110e6, n


def test_pkl_checkpoint_loads(tmp_path, pair):
    """A detectron2 model-zoo ``.pkl`` (``{"model": {name: ndarray}}`` with its
    pixel statistics and anchor buffers) loads into the port's detector with
    every key used; an unknown key refuses the file."""
    model_dict = dict(pair["sd"], pixel_mean=np.zeros((3, 1, 1), np.float32),
                      pixel_std=np.ones((3, 1, 1), np.float32))
    model_dict["proposal_generator.anchor_generator.cell_anchors.0"] = np.zeros((3, 4), np.float32)
    path = str(tmp_path / "model_final.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": model_dict, "__author__": "zoo"}, f)
    loaded = load_torch_state_dict(path)
    sd = extraction_params_from_checkpoints(None, rcnn=loaded)["rcnn"]
    model = port_rcnn.FasterRCNN(pair["cfg"]).eval()
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(_canvas(7, b=1))
    with torch.no_grad():
        a, b = model(x), pair["port"](x)
    assert all(torch.equal(a[k], b[k]) for k in a)
    model_dict["roi_heads.box_predictor.extra.weight"] = np.zeros(3, np.float32)
    with open(path, "wb") as f:
        pickle.dump({"model": model_dict}, f)
    with pytest.raises(RuntimeError, match="extra"):
        model.load_state_dict(extraction_params_from_checkpoints(None, rcnn=path)["rcnn"], strict=True)


def test_left_out_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_rcnn.RCNNConfig.fast()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_rcnn.RCNNConfig(roi_dtype="bfloat16")
    with pytest.raises(ValueError, match="roi_impl"):
        port_rcnn.RCNNConfig(roi_impl="gather")
    assert port_rcnn.resize_shortest_edge((360, 640)) == (750, 1333)
    assert port_rcnn.pad_to_divisible((750, 1333)) == (768, 1344)


def test_predictor_canvas_matches_jax_preprocessing():
    """``predictor_canvas`` (the port's one copy of DefaultPredictor's
    preprocessing) against the JAX Extractor's inline steps: PIL resize to
    the shortest-edge size, BGR, mean subtracted, zero padding; within 1e-4
    on 0..255 pixels, the padding exactly zero."""
    from video_gen_evals_tpu.ops.image import resize_pil_matmul as jax_resize

    frames = np.random.default_rng(11).uniform(0, 255, (2, 36, 64, 3)).astype(np.float32)
    cfg = port_rcnn.RCNNConfig.small()
    canvas, (rh, rw) = port_rcnn.predictor_canvas(torch.from_numpy(frames).to(torch.uint8), cfg)
    u8 = frames.astype(np.uint8).astype(np.float32)
    assert (rh, rw) == jax_rcnn.resize_shortest_edge((36, 64), cfg.min_size_test, cfg.max_size_test)
    ch, cw = jax_rcnn.pad_to_divisible((rh, rw))
    resized = jax.vmap(lambda f: jax_resize(f, (rh, rw)))(jnp.asarray(u8))
    want = resized[..., ::-1] - jnp.asarray(jax_rcnn.PIXEL_MEAN_BGR)
    want = jnp.pad(want, ((0, 0), (0, ch - rh), (0, cw - rw), (0, 0)))
    assert canvas.shape == (2, ch, cw, 3) and canvas.dtype == torch.float32
    np.testing.assert_allclose(canvas.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert not canvas[:, rh:].any() and not canvas[:, :, rw:].any()

