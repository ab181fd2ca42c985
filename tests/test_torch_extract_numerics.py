"""The extraction numerics of the port against the JAX package, on the CPU at
tiny geometries: the six ``(matmul_precision, param_dtype)`` pairs and
``ViTConfig.block_precision``.

JAX on the CPU ignores the matmul class (every class gives fp32 dots), so
the two halves of a mode are held apart:

- the parameter semantics (which tensors are rounded to bf16, and that
  activations stay fp32) against JAX tightly, at each net's fp32 parity
  tolerance, with the port at ``"highest"`` and ``"high"``;
- the ``"default"`` class itself against a float64 oracle on bf16-rounded
  operands (``ops/precision.py``), and end to end against JAX at a stated
  tolerance that holds the class's rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import detector as jax_det
from video_gen_evals_tpu.models import pose2d as jax_pose
from video_gen_evals_tpu.models import rcnn as jax_rcnn
from video_gen_evals_tpu.models import smpl_head as jax_head
from video_gen_evals_tpu.models import vit as jax_vit
from video_gen_evals_tpu.pipelines import extract as jax_extract
from video_gen_evals_tpu_torch.models import detector as port_det
from video_gen_evals_tpu_torch.models import pose2d as port_pose
from video_gen_evals_tpu_torch.models import rcnn as port_rcnn
from video_gen_evals_tpu_torch.models import vit as port_vit
from video_gen_evals_tpu_torch.models.smpl_head import SMPLHeadConfig, SMPLTokenDecoderHead
from video_gen_evals_tpu_torch.models.torch_compat import (
    head_state_dict_from_jax_tree,
    pose_state_dict_from_jax_tree,
    vit_state_dict_from_jax_tree,
)
from video_gen_evals_tpu_torch.ops import precision as P
from video_gen_evals_tpu_torch.pipelines.extract import Extractor, ExtractorConfig

from test_torch_extract_mesh import EXACT, LARGE, RESCALE
from test_torch_mesh_models import TINY_HEAD, TINY_VIT, init_tree
from test_torch_rcnn import CANVAS, seeded_state_dict
from test_torch_rtmpose import LOGIT_TOL, _crops, seeded_pose_state_dict
from test_torch_yolox import SMALL, megvii_state_dict

PAIRS = [(p, d) for p in ("default", "high", "highest") for d in ("float32", "bfloat16")]
# the pose net of tests/test_torch_extract_keypoints.py's size class
POSE = dict(input_hw=(64, 48), widen_factor=0.125, deepen_factor=0.34, gau_dim=32, gau_s=16)
OUT_KEYS = ("pose", "betas", "global_orient", "vit")
# end to end at "default" against JAX's fp32 dots on the CPU: bf16's 2^-9
# relative rounding of each product's operands through the two ViT blocks
# and the head, on features of order 1 (measured: at most 0.042, in the body
# rotations; token_out 0.033 / 0.022 with fp32 / bf16 weights; 0.013 under
# the block schedule), with a margin of 2.4x
DEFAULT_E2E_TOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cast(tree):
    """JAX ``Extractor.__init__``'s ``param_dtype="bfloat16"`` cast, verbatim."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if hasattr(a, "dtype") and a.dtype == jnp.float32 else a, tree)


def _jit_as_written(fn, *args):
    """``fn`` jitted and run with XLA's excess precision off, so that every
    bf16 op rounds as JAX's types say (a BatchNorm's scale ``scale *
    rsqrt(var + eps)`` on bf16 statistics is bf16). XLA may otherwise keep
    some of those in fp32 on the CPU, an optimisation that JAX's eager run
    and the port (which rounds each bf16 op) do not make."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# (a), (d): the mesh nets through both Extractors

@pytest.fixture(scope="module")
def mesh():
    """One set of fp32 numpy trees for the ViT (JAX's einsum branch, the
    port's K6) and the head, and the port's state_dicts from them."""
    rng = np.random.default_rng(21)
    jvit = jax_vit.ViTConfig(**TINY_VIT)
    jhead = jax_head.SMPLHeadConfig(**TINY_HEAD)
    trees = {"vit": init_tree(jax_vit.ViTBackbone(jvit), np.zeros((1, 64, 48, 3), np.float32), rng),
             "head": init_tree(jax_head.SMPLTokenDecoderHead(jhead), np.zeros((1, 12, 64), np.float32), rng)}
    cfg = ExtractorConfig(vit=port_vit.ViTConfig(**TINY_VIT), head=SMPLHeadConfig(**TINY_HEAD), frame_batch=4,
                          vitdet_rescale=RESCALE)
    sds = {"vit": vit_state_dict_from_jax_tree(trees["vit"], cfg.vit),
           "head": head_state_dict_from_jax_tree(trees["head"], cfg.head)}
    return dict(jvit=jvit, jhead=jhead, trees=trees, cfg=cfg, sds=sds)


def _jax_extractor(mesh, precision, dtype):
    jcfg = jax_extract.ExtractorConfig(vit=mesh["jvit"], head=mesh["jhead"], frame_batch=4, vitdet_rescale=RESCALE,
                                       matmul_precision=precision, param_dtype=dtype, keep_all_frames=True)
    # the detector and pose nets are not on this path: empty trees skip their init
    return jax_extract.Extractor(jcfg, params={**mesh["trees"], "det": {}, "pose": {}})


def _port_extractor(mesh, precision, dtype):
    cfg = dataclasses.replace(mesh["cfg"], matmul_precision=precision, param_dtype=dtype)
    return Extractor(cfg, state_dicts=mesh["sds"], device="cpu")


def test_rounded_params_are_jax_cast_bitwise(mesh):
    """(a) The ViT's and the head's stored tensors under param_dtype
    "bfloat16", viewed as 16-bit words, are JAX's ``Extractor.params`` after
    its cast, every one; no floating tensor is left in fp32."""
    jex = _jax_extractor(mesh, "high", "bfloat16")
    port = _port_extractor(mesh, "high", "bfloat16")
    for name, net, to_sd, cfg in (("vit", port.backbone, vit_state_dict_from_jax_tree, port.cfg.vit),
                                  ("head", port.head, head_state_dict_from_jax_tree, port.cfg.head)):
        leaves = jax.tree_util.tree_leaves(jex.params[name])
        assert leaves and all(leaf.dtype == jnp.bfloat16 for leaf in leaves)
        # the converters widen to fp32, exactly; back to bf16 is exact too
        want = {k: v.to(torch.bfloat16) for k, v in to_sd(_f32(jex.params[name]), cfg).items()}
        got = net.state_dict()
        assert set(got) == set(want), name
        for k, v in got.items():
            assert v.dtype == torch.bfloat16, (name, k)
            assert torch.equal(v.view(torch.int16), want[k].view(torch.int16)), (name, k)


def _video(seed, n):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(n, 96, 128, 3), dtype=np.uint8)
    boxes = np.asarray([(EXACT + LARGE)[i % 6] for i in rng.permutation(n)], np.float32)
    return frames, boxes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_class_end_to_end_matches_jax(mesh, dtype):
    """(d) process_video at ("default", dtype) against JAX's stage at the
    same pair, within DEFAULT_E2E_TOL (JAX's CPU dots are fp32 whatever the
    class; the port rounds each product's operands to bf16), and against the
    port's own ("highest", dtype) run, which matches JAX at 1e-4: the default
    class moves the features by more than that, so the rounding happened."""
    jex = _jax_extractor(mesh, "default", dtype)
    port = _port_extractor(mesh, "default", dtype)
    frames, boxes = _video(0, 6)
    want = jex._batched(lambda f, b: jex._mesh_forward(jex.params["vit"], jex.params["head"], f, b),
                        jex._upload_frames(frames), boxes)
    got = port.process_video(frames, boxes)
    exact = _port_extractor(mesh, "highest", dtype).process_video(frames, boxes)
    moved = 0.0
    for key, jkey in zip(OUT_KEYS, ("body_pose", "betas", "global_orient", "token_out")):
        assert got[key].dtype == np.float32 and np.isfinite(got[key]).all(), key
        w = np.asarray(want[jkey])
        err = np.abs(got[key] - w).max()
        print(f"{dtype} {key}: max |port default - JAX| {err:.2e}")
        assert err <= DEFAULT_E2E_TOL, key
        np.testing.assert_allclose(exact[key], w, rtol=0, atol=1e-4, err_msg=key)
        moved = max(moved, np.abs(got[key] - exact[key]).max())
    assert moved > 1e-4


# ---------------------------------------------------------------------------
# (b): each net, fp32 activations on the same rounded weights

def _vit_net():
    rng = np.random.default_rng(22)
    jmod = jax_vit.ViTBackbone(jax_vit.ViTConfig(**TINY_VIT))
    tree = init_tree(jmod, np.zeros((1, 64, 48, 3), np.float32), rng)
    port = port_vit.ViTBackbone(port_vit.ViTConfig(**TINY_VIT))
    port.load_state_dict(vit_state_dict_from_jax_tree(tree, port.config))
    x = rng.normal(size=(3, 64, 48, 3)).astype(np.float32)
    return jmod, tree, port, x, lambda p, a: jmod.apply({"params": p}, a)[0], lambda a: port(a)[0], 2e-4


def _head_net():
    rng = np.random.default_rng(23)
    jmod = jax_head.SMPLTokenDecoderHead(jax_head.SMPLHeadConfig(**TINY_HEAD))
    tree = init_tree(jmod, np.zeros((1, 12, 64), np.float32), rng)
    port = SMPLTokenDecoderHead(SMPLHeadConfig(**TINY_HEAD))
    port.load_state_dict(head_state_dict_from_jax_tree(tree, port.config))
    x = rng.normal(size=(3, 12, 64)).astype(np.float32)
    keys = ("global_orient", "body_pose", "betas", "cam", "token_out")
    return (jmod, tree, port, x, lambda p, a: [jmod.apply({"params": p}, a)[k] for k in keys],
            lambda a: [port(a)[k] for k in keys], 1e-4)


def _yolox_net():
    cfg, jcfg = port_det.DetectorConfig(**SMALL), jax_det.DetectorConfig(**SMALL)
    sd = megvii_state_dict(cfg, seed=2)
    jmod = jax_det.YOLOXDetector(jcfg)
    port = port_det.YOLOXDetector(cfg)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, strict=True)
    x = np.random.default_rng(24).standard_normal((2, 64, 64, 3)).astype(np.float32)
    keys = ("boxes", "obj", "cls")
    return (jmod, jax_det.yolox_to_flax(sd, jcfg), port, x,
            lambda p, a: [jmod.apply({"params": p}, a)[k] for k in keys], lambda a: [port(a)[k] for k in keys],
            "relative")


def _rcnn_net():
    cfg, jcfg = port_rcnn.RCNNConfig.small(), jax_rcnn.RCNNConfig.small()
    sd = seeded_state_dict(cfg, seed=2)
    jmod = jax_rcnn.FasterRCNN(jcfg)
    port = port_rcnn.FasterRCNN(cfg)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    x = (np.random.default_rng(25).standard_normal((2, *CANVAS, 3)) * 50).astype(np.float32)

    def port_fn(a):
        return [f.permute(0, 2, 3, 1) for f in port.backbone_features(a)]

    return (jmod, jax_rcnn.detectron2_to_flax(sd, jcfg), port, x,
            lambda p, a: jmod.apply({"params": p}, a, method=jmod.backbone_features), port_fn, 1e-4)


def _pose_net():
    cfg, jcfg = port_pose.PoseNetConfig(**POSE), jax_pose.PoseNetConfig(**POSE)
    tree = jax_pose.mmpose_to_flax(seeded_pose_state_dict(cfg, seed=2), jcfg)
    jmod = jax_pose.RTMPoseNet(jcfg)
    port = port_pose.RTMPoseNet(cfg)
    port.load_state_dict(pose_state_dict_from_jax_tree(tree, cfg), strict=True)

    def jax_fn(p, a):
        _, state = jmod.apply({"params": p}, a, mutable=["intermediates"],
                              capture_intermediates=lambda m, _: m.name in ("cls_x", "cls_y"))
        return [state["intermediates"][k]["__call__"][0] for k in ("cls_x", "cls_y")]

    return jmod, tree, port, _crops(cfg, seed=3), jax_fn, lambda a: list(port.logits(a)), "logits"


NETS = {"vit": _vit_net, "head": _head_net, "yolox": _yolox_net, "rcnn": _rcnn_net, "pose": _pose_net}


@pytest.mark.parametrize("net", sorted(NETS))
def test_each_net_on_rounded_weights_matches_jax(net):
    """(b) Each net with its weights rounded to bf16 at ("highest",
    "bfloat16") and ("high", "bfloat16") against JAX's apply on its cast
    tree under ``default_matmul_precision`` "default" and "highest", at the
    net's fp32 parity tolerance (the ViT 2e-4 and the head 1e-4 of
    tests/test_torch_mesh_models.py, YOLOX 1e-4 of max(1, max |x|) of
    tests/test_torch_yolox.py, the R-CNN's p2..p6 1e-4 of
    tests/test_torch_rcnn.py, RTMPose's logits LOGIT_TOL of
    tests/test_torch_rtmpose.py): both sides run fp32 activations on the same
    rounded weights, and JAX's bf16 subexpressions (the norms' scales) round
    as its types say (``_jit_as_written``). The fp32 net's outputs differ
    from them by more."""
    _jmod, tree, port, x, jax_fn, port_fn, tol = NETS[net]()
    with torch.no_grad():
        fp32 = [t.numpy() for t in port_fn(torch.from_numpy(x))]
    port = port.to(torch.bfloat16).eval()
    cast = jax_cast(tree)
    wants = {}
    for jp in ("default", "highest"):
        def run(p, a, jp=jp):
            with jax.default_matmul_precision(jp):
                return jax_fn(p, a)
        wants[jp] = [np.asarray(w) for w in _jit_as_written(run, cast, jnp.asarray(x))]
    jax.clear_caches()
    scales = [max(1.0, np.abs(w).max()) for w in wants["highest"]]
    atols = {"relative": [1e-4 * s for s in scales], "logits": [LOGIT_TOL * max(scales)] * len(scales)}.get(
        tol, [tol] * len(scales))
    moved = 0.0
    for pp in ("highest", "high"):
        P.set_precision_(port, pp)
        with torch.no_grad():
            got = [t.numpy() for t in port_fn(torch.from_numpy(x))]
        for jp, want in wants.items():
            assert len(got) == len(want)
            for i, (g, w, atol) in enumerate(zip(got, want, atols)):
                assert g.dtype == np.float32 and g.shape == w.shape, (net, i)
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{net} port {pp} JAX {jp} #{i}")
        moved = max(moved, max((np.abs(g - f).max() / a for g, f, a in zip(got, fp32, atols))))
    print(f"{net}: the fp32 net is {moved:.1f} tolerances from the rounded one")
    assert moved > 1


# ---------------------------------------------------------------------------
# (c): the "default" class against a float64 oracle

def _oracle_close(got, oracle):
    """rtol 1e-5 of the output's scale: exact products of bf16 values,
    summed in fp32."""
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-5 * oracle.abs().max().item())


def test_default_class_is_fp32_sums_of_rounded_operands():
    """(c) ``linear``, ``conv2d`` (grouped, strided, padded) and ``matmul``
    at "default" against float64 products of the bf16-rounded operands, with
    fp32 and bf16 weights; "high" and "highest" against float64 products of
    the unrounded ones. The default class is not the fp32 product."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(5, 7, 48, generator=gen)
    w = torch.randn(24, 48, generator=gen) / 7
    b = torch.randn(24, generator=gen)
    r64 = lambda t: P.round_bf16(t).double()   # noqa: E731
    for weight in (w, w.to(torch.bfloat16)):
        _oracle_close(P.linear(x, weight, b, "default"), r64(x) @ r64(weight).T + b.double())
    for prec in ("high", "highest"):
        _oracle_close(P.linear(x, w, b, prec), x.double() @ w.double().T + b.double())
    assert (P.linear(x, w, b, "default") - P.linear(x, w, b, "highest")).abs().max() > 1e-3

    img = torch.randn(2, 8, 13, 11, generator=gen)
    k = torch.randn(12, 4, 3, 3, generator=gen) / 6
    kb = torch.randn(12, generator=gen)
    want = torch.nn.functional.conv2d(r64(img), r64(k), kb.double(), 2, 1, 1, 2)
    for weight in (k, k.to(torch.bfloat16)):
        _oracle_close(P.conv2d(img, weight, kb, 2, 1, 1, 2, "default"), want)
    _oracle_close(P.conv2d(img, k, kb, 2, 1, 1, 2, "highest"),
                  torch.nn.functional.conv2d(img.double(), k.double(), kb.double(), 2, 1, 1, 2))
    layer = P.set_precision_(P.Conv2d(8, 12, 3, 2, 1, groups=2), "default")
    with torch.no_grad():
        layer.weight.copy_(k)
        layer.bias.copy_(kb)
        _oracle_close(layer(img), want)

    a, m = torch.randn(3, 4, 9, 16, generator=gen), torch.randn(16, 10, generator=gen)
    _oracle_close(P.matmul(a, m, "default"), r64(a) @ r64(m))
    # rounding to nearest even: 1 + 2^-8 is a tie between 1 and 1 + 2^-7
    ties = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)])
    assert P.round_bf16(ties).tolist() == [1.0, 1 + 2 ** -6, -1.0]
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        P.linear(x, w, b, "bf16x3")


# ---------------------------------------------------------------------------
# (e): ViTConfig.block_precision

JAX_GEOMETRY = dict(img_size=(32, 24), patch_size=8, embed_dim=32, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def schedule_pair():
    """tests/test_extraction_models.py's geometry: JAX's ViT and the port's
    (K6's plain version) on one fp32 numpy tree, and one input."""
    rng = np.random.default_rng(26)
    jmod = jax_vit.ViTBackbone(jax_vit.ViTConfig(**JAX_GEOMETRY))
    tree = init_tree(jmod, np.zeros((1, 32, 24, 3), np.float32), rng)
    x = rng.normal(size=(2, 32, 24, 3)).astype(np.float32)
    return tree, x


def _port_vit(tree, schedule=None, stage="highest"):
    cfg = port_vit.ViTConfig(**JAX_GEOMETRY, block_precision=schedule)
    net = port_vit.ViTBackbone(cfg).eval()
    net.load_state_dict(vit_state_dict_from_jax_tree(tree, cfg))
    return P.set_precision_(net, stage)


def test_block_precision_schedule(schedule_pair, monkeypatch):
    """(e) JAX's test geometry and schedule ("default", "high"): the port
    against JAX's scheduled forward within the default class's rounding
    (DEFAULT_E2E_TOL; JAX's CPU dots are fp32 in both blocks), and exactly
    the port's own forward with block 0 at "default" and block 1 at "high";
    ("highest", "high") against JAX at 1e-5; an all-"highest" schedule
    bitwise the unscheduled forward; each block's class reaches mha_core
    ("default", then "highest"); the patch embedding and final norm keep the
    stage's class."""
    tree, x = schedule_pair
    xt = torch.from_numpy(x)
    jcfg = jax_vit.ViTConfig(**JAX_GEOMETRY, block_precision=("default", "high"))
    want = np.asarray(jax.jit(jax_vit.ViTBackbone(jcfg).apply)({"params": tree}, jnp.asarray(x))[0])
    jax.clear_caches()
    seen = []
    real = port_vit.mha_core

    def spy(*args, precision, **kw):
        seen.append(precision)
        return real(*args, precision=precision, **kw)

    monkeypatch.setattr(port_vit, "mha_core", spy)
    net = _port_vit(tree, ("default", "high"))
    assert [blk.attn.qkv.precision for blk in net.blocks] == ["default", "high"]
    assert net.patch_embed.proj.precision == "highest"
    with torch.no_grad():
        got = net(xt)[0]
        assert seen == ["default", "highest"]
        by_hand = _port_vit(tree)
        P.set_precision_(by_hand.blocks[0], "default")
        P.set_precision_(by_hand.blocks[1], "high")
        assert torch.equal(got, by_hand(xt)[0])
        err = np.abs(got.numpy() - want).max()
        print(f"schedule (default, high): max |port - JAX| {err:.2e}")
        assert 1e-5 < err <= DEFAULT_E2E_TOL
        np.testing.assert_allclose(_port_vit(tree, ("highest", "high"))(xt)[0].numpy(), want, rtol=0, atol=1e-5)
        assert torch.equal(_port_vit(tree, ("highest", "highest"))(xt)[0], _port_vit(tree)(xt)[0])


@pytest.mark.parametrize("schedule", [("high",), ("default", "high", "high"), ("default", "bf16x3")])
def test_block_precision_refuses(schedule):
    """(e) A schedule whose length is not the depth, or with an unknown class."""
    with pytest.raises(ValueError, match="block_precision"):
        port_vit.ViTConfig(**JAX_GEOMETRY, block_precision=schedule)


# ---------------------------------------------------------------------------
# (f) and the six pairs end to end

@pytest.mark.parametrize("precision,dtype", PAIRS)
def test_is_parity_agrees_with_jax(precision, dtype):
    """(f) ``is_parity`` of the parity preset at each pair, as JAX's."""
    kw = dict(matmul_precision=precision, param_dtype=dtype)
    assert (ExtractorConfig.parity(**kw).is_parity()
            == jax_extract.ExtractorConfig.parity(**kw).is_parity()
            == (precision != "default" and dtype == "float32"))


@pytest.mark.parametrize("precision,dtype", PAIRS)
def test_every_pair_runs_process_video_full(precision, dtype):
    """Every pair builds all five nets (rcnn mode) and runs
    process_video_full with keypoints: weights stored in ``dtype``, every
    product layer at ``precision`` (RTMPose's head and gates at fp32
    products), fp32 outputs, finite."""
    cfg = ExtractorConfig(vit=port_vit.ViTConfig(**TINY_VIT), head=SMPLHeadConfig(**TINY_HEAD),
                          det=port_det.DetectorConfig(**SMALL), pose=port_pose.PoseNetConfig(**POSE),
                          mesh_detector="rcnn", rcnn=port_rcnn.RCNNConfig.small(), frame_batch=4,
                          keep_all_frames=True, matmul_precision=precision, param_dtype=dtype)
    ex = Extractor(cfg, seed=1, device="cpu")
    want_dtype = getattr(torch, dtype)
    for net in (ex.backbone, ex.head, ex.detector, ex.rcnn, ex.pose_net):
        assert all(t.dtype == want_dtype for t in net.state_dict().values() if t.is_floating_point())
    assert ex.backbone.blocks[0].mlp.fc1.precision == ex.rcnn.roi_heads.box_head.fc1.precision == precision
    assert ex.detector.head.obj_preds[0].precision == ex.pose_net.backbone.stem[0].conv.precision == precision
    assert ex.pose_net.head.cls_x.precision == "highest"
    frames = np.random.default_rng(3).integers(0, 256, size=(5, 72, 112, 3), dtype=np.uint8)
    mesh, kp = ex.process_video_full(frames, with_keypoints=True)
    assert mesh["vit"].shape == (5, 64) and kp["kp120"].shape == (5, 120)
    for key in OUT_KEYS:
        assert mesh[key].dtype == np.float32 and np.isfinite(mesh[key]).all(), key
    assert kp["kp120"].dtype == np.float32 and np.isfinite(kp["kp120"]).all()
