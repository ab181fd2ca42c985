"""The port's YOLOX detector (``models/detector.py``), its letterbox
(``ops/upstream_crops.py``) and its checkpoint branch on the CPU against the
JAX package: one seeded Megvii-layout state_dict, loaded natively by the port
and through ``yolox_to_flax`` by JAX, and a JAX tree carried across by
``yolox_state_dict_from_jax_tree``. JAX runs at matmul precision "highest"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import detector as jax_det
from video_gen_evals_tpu.ops import upstream_crops as jax_crops
from video_gen_evals_tpu_torch.models import detector as port_det
from video_gen_evals_tpu_torch.models.pose2d import PoseNetConfig
from video_gen_evals_tpu_torch.models.torch_compat import yolox_state_dict_from_jax_tree
from video_gen_evals_tpu_torch.ops import upstream_crops as port_crops
from video_gen_evals_tpu_torch.pipelines.extract import ExtractorConfig
from video_gen_evals_tpu_torch.pipelines.weights import extraction_params_from_checkpoints, published_config

from test_yolox import TorchYOLOX

SMALL = dict(input_hw=(64, 64), width=0.125)   # base 8 channels, one block a CSP layer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def megvii_state_dict(cfg, seed=0):
    """Megvii-named numpy weights for ``cfg`` (the port's key set, held equal
    to Megvii's by ``test_yolox_l_key_set_matches_megvii``): conv weights
    normal with std ``fan_in ** -0.5``, norm variances uniform in [0.5, 1.5],
    everything else normal 0.1, the batch counters 0."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in port_det.YOLOXDetector(cfg).state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif len(shape) == 4:
            sd[k] = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        else:
            sd[k] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return sd


def port_model(cfg, sd):
    model = port_det.YOLOXDetector(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    """The small detector on one Megvii state_dict in both packages, JAX's
    apply jitted once (the params an argument, so any tree of the same shapes
    reuses it), at matmul precision "highest" (the flag and the compiled
    executables put back after the module)."""
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg, jcfg = port_det.DetectorConfig(**SMALL), jax_det.DetectorConfig(**SMALL)
    sd = megvii_state_dict(cfg)
    jmodel = jax_det.YOLOXDetector(jcfg)
    yield dict(cfg=cfg, jcfg=jcfg, sd=sd, params=jax_det.yolox_to_flax(sd, jcfg), port=port_model(cfg, sd),
               apply=jax.jit(lambda p, x: jmodel.apply({"params": p}, x)))
    jax.config.update("jax_default_matmul_precision", before)
    jax.clear_caches()


def _frames(seed, b=2, hw=(64, 64)):
    """Unit-scale inputs, so that the decoded boxes stay within a few strides."""
    return np.random.default_rng(seed).standard_normal((b, *hw, 3)).astype(np.float32)


def _assert_raw_close(got, want):
    """Raw predictions within 1e-4 x max(1, max |x|): fp32 convs summed in
    another order (the boxes reach ~60 pixels here)."""
    assert set(got) == set(want) == {"boxes", "obj", "cls"}
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()), err_msg=k)


def test_megvii_state_dict_loads_strictly_and_matches_jax(pair):
    """A Megvii-named state_dict through ``load_state_dict(strict=True)`` and
    through JAX's ``yolox_to_flax``: the same raw boxes, objectness and class
    scores (84 locations at strides 8/16/32 on a 64 x 64 input)."""
    x = _frames(1)
    with torch.no_grad():
        got = pair["port"](torch.from_numpy(x))
    assert got["boxes"].shape == (2, 84, 4) and got["cls"].shape == (2, 84, 80)
    _assert_raw_close(got, pair["apply"](pair["params"], jnp.asarray(x)))


def test_detector_matches_jax_through_the_tree_converter(pair):
    """A JAX tree filled from numpy (not from a Megvii dict) carried across by
    ``yolox_state_dict_from_jax_tree``: raw outputs within tolerance; and the
    converter inverts ``yolox_to_flax`` exactly on the Megvii dict."""
    rng = np.random.default_rng(2)
    back = yolox_state_dict_from_jax_tree(pair["params"], pair["cfg"])
    assert set(back) == set(pair["sd"])
    for k, v in pair["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    assert back["head.stems.0.bn.num_batches_tracked"].dtype == torch.int64

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, pair["params"])
    x = _frames(3)
    with torch.no_grad():
        got = port_model(pair["cfg"], yolox_state_dict_from_jax_tree(tree, pair["cfg"]))(torch.from_numpy(x))
    _assert_raw_close(got, pair["apply"](tree, jnp.asarray(x)))


def test_yolox_l_key_set_matches_megvii():
    """``yolox_l()`` built on the meta device has Megvii's state_dict keys and
    shapes (the torch replica of the published layout in tests/test_yolox.py),
    about 54.2 M parameters as Megvii's README gives, and converts to the
    shapes of the JAX module's own init tree (traced, nothing allocated)."""
    cfg = port_det.DetectorConfig.yolox_l()
    with torch.device("meta"):
        model = port_det.YOLOXDetector(cfg)
        megvii = TorchYOLOX(jax_det.DetectorConfig.yolox_l())
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in megvii.state_dict().items()}
    n = sum(v.numel() for v in model.parameters())
    assert 54.0e6 < n < 54.4e6, n
    zero = np.zeros((), np.float32)
    params = jax_det.yolox_to_flax({k: np.broadcast_to(zero, s) for k, s in ours.items()},
                                   jax_det.DetectorConfig.yolox_l())
    init = jax.eval_shape(jax_det.YOLOXDetector(jax_det.DetectorConfig.yolox_l()).init, jax.random.key(0),
                          jax.ShapeDtypeStruct((1, 640, 640, 3), jnp.float32))["params"]

    def shapes(tree):
        return {jax.tree_util.keystr(p): tuple(v.shape) for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    assert shapes(params) == shapes(init)


def _raw(seed, B=3, N=40, C=4):
    """Seeded raw predictions: clustered boxes, objectness and class scores
    with exact ties and, in frame 2, no score above 0.1 at all."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(10, 80, size=(B, N, 2))
    size = rng.uniform(5, 30, size=(B, N, 2))
    boxes = np.concatenate([centres - size / 2, centres + size / 2], -1).astype(np.float32)
    boxes[:, 1::4] = boxes[:, ::4][:, :boxes[:, 1::4].shape[1]] + 1.0       # overlapping neighbours
    obj = rng.choice([0.0, 0.25, 0.5, 0.9, 1.0], size=(B, N)).astype(np.float32)
    cls = rng.choice([0.0, 0.2, 0.7, 0.7, 0.95], size=(B, N, C)).astype(np.float32)
    obj[2] *= 0.05
    return {"boxes": boxes, "obj": obj, "cls": cls}


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocessing_matches_jax(seed):
    """nms_xla_indexed (boxes, scores, keep, indices), nms_xla,
    person_detections and dwpose_person_detections batched over frames
    against JAX's, vmapped over the same frames: equal masks and indices,
    boxes and scores within 1e-6. The scores hold exact ties (the stable
    order keeps JAX's lower index first) and one frame has none above the
    0.1 prefilter, where the padded slots hold tie-broken zero-score boxes;
    fewer candidates (N = 40) than 4 x max_out too."""
    raw = _raw(seed)
    traw = {k: torch.from_numpy(v) for k, v in raw.items()}
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    scores = raw["obj"] * raw["cls"][..., 0]
    want = jax.vmap(lambda b, s: jax_det.nms_xla_indexed(b, s, 0.5, 16))(jraw["boxes"], jnp.asarray(scores))
    got = port_det.nms_xla_indexed(traw["boxes"], torch.from_numpy(scores), 0.5, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for g, w in zip(port_det.nms_xla(traw["boxes"], torch.from_numpy(scores), 0.5, 16),
                    jax.vmap(lambda b, s: jax_det.nms_xla(b, s, 0.5, 16))(jraw["boxes"], jnp.asarray(scores))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for port_fn, jax_fn in ((port_det.person_detections, jax_det.person_detections),
                            (port_det.dwpose_person_detections, jax_det.dwpose_person_detections)):
        got, want = port_fn(traw), jax_fn(jraw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=port_fn.__name__)
    boxes, dscores, person = port_det.dwpose_person_detections(traw)
    assert person[:2].any() and not person[2].any() and (dscores[2] == 0).all()
    assert 0 < got[2].sum() < got[2].numel()
    valid = got[2]
    np.testing.assert_array_equal(port_det.single_person_mask(valid).numpy(),
                                  np.asarray(jax_det.single_person_mask(jnp.asarray(valid.numpy()))))
    for ratio in (0.3, 0.8):
        assert bool(port_det.video_is_single_person(valid[:, 0], ratio)) == bool(
            jax_det.video_is_single_person(jnp.asarray(valid[:, 0].numpy()), ratio))


@pytest.mark.parametrize("hw", [(50, 90), (64, 64), (72, 112)])
def test_letterbox_matches_jax(hw):
    """``yolox_letterbox`` and ``letterbox_geometry`` against JAX's on uint8
    frames: a downscale (50 x 90 -> 35 x 64), the identity size (64 x 64)
    and a downscale whose ``int(W * r)`` lands on 64; the canvas BGR, 114
    outside the content, equal to JAX's except where the exact resampled
    value (float64, JAX's weights) lies within 1e-3 of a rounding boundary
    x.5: the two fp32 sums of the same taps in another order may round that
    one to either side (one such pixel in the 50 x 90 case)."""
    frames = np.random.default_rng(4).integers(0, 256, size=(2, *hw, 3)).astype(np.float32)
    assert port_crops.letterbox_geometry(hw, 64) == jax_crops.letterbox_geometry(hw, 64)
    want, wr = jax_crops.yolox_letterbox(jnp.asarray(frames), size=64)
    want = np.asarray(want)
    got, r = port_crops.yolox_letterbox(torch.from_numpy(frames), size=64)
    got = got.numpy()
    r, rh, rw = port_crops.letterbox_geometry(hw, 64)
    assert r == wr and got.shape == (2, 64, 64, 3)
    assert (got[:, rh:] == 114).all() and (got[:, :, rw:] == 114).all()
    if (rh, rw) == hw:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, :rh, :rw], frames[..., ::-1])
        return
    H, W = hw
    coords = [(jnp.arange(n, dtype=jnp.float32) + 0.5) * (size / n) - 0.5 for n, size in ((rh, H), (rw, W))]
    wy, wx = (np.asarray(jax_crops._clamp_weights(c, n, jnp.float32), np.float64) for c, n in zip(coords, hw))
    exact = np.einsum("yh,bhwc,xw->byxc", wy, frames[..., ::-1].astype(np.float64), wx)
    tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-3
    content = (slice(None), slice(0, rh), slice(0, rw))
    differ = got[content] != want[content]
    assert not (differ & ~tie).any()
    assert np.abs(got - want).max() <= 1 and differ.sum() <= 2
    np.testing.assert_array_equal(got[content][~tie], np.clip(np.round(exact), 0, 255)[~tie])


def test_published_config_and_checkpoint_branch(tmp_path, pair):
    """A YOLOX checkpoint switches a default ``det`` to ``yolox_l()`` and
    keeps one the caller set; ``extraction_params_from_checkpoints`` reads
    Megvii's ``{"model": state_dict}`` file into ``det``; a DWPose
    checkpoint switches a default ``pose`` to ``dwpose_l()`` and keeps one the
    caller set."""
    base = ExtractorConfig()
    assert base.det == port_det.DetectorConfig() and base.keep_all_frames is False
    assert published_config(base, yolox="yolox_l.pth").det == port_det.DetectorConfig.yolox_l()
    mine = dataclasses.replace(base, det=pair["cfg"])
    assert published_config(mine, yolox="yolox_s.pth").det == pair["cfg"]
    path = str(tmp_path / "yolox_small.pth")
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in pair["sd"].items()},
                "start_epoch": 300}, path)
    det = extraction_params_from_checkpoints(mine, yolox=path)["det"]
    model = port_det.YOLOXDetector(pair["cfg"]).eval()
    model.load_state_dict(det, strict=True)
    x = torch.from_numpy(_frames(5, b=1))
    with torch.no_grad():
        a, b = model(x), pair["port"](x)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert published_config(base, dwpose="dw-ll_ucoco_384.pth").pose == PoseNetConfig.dwpose_l()
    tiny_pose = PoseNetConfig(input_hw=(64, 48))
    assert published_config(dataclasses.replace(base, pose=tiny_pose), dwpose="dw.pth").pose == tiny_pose
