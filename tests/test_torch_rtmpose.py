"""The port's RTMPose (``models/pose2d.py``), DWPose's crops
(``ops/upstream_crops.py``) and DWPose's postprocessing on the CPU against the
JAX package. One seeded port net's mmpose-named state_dict goes to JAX through
``mmpose_to_flax``, and the JAX tree comes back through
``pose_state_dict_from_jax_tree``. JAX runs at matmul precision "highest".

Argmax keypoints are compared only where the two largest logits of a row are
further apart than the logits' tolerance (a near tie may pick the other bin in
either framework), and the crops' uint8 rounding only where the float64 value
before rounding is further than 1e-4 from x.5; each test prints how
many elements it excused."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import pose2d as jax_pose
from video_gen_evals_tpu.ops import upstream_crops as jax_crops
from video_gen_evals_tpu_torch.models import pose2d as port_pose
from video_gen_evals_tpu_torch.models.torch_compat import pose_state_dict_from_jax_tree
from video_gen_evals_tpu_torch.ops import upstream_crops as port_crops
from video_gen_evals_tpu_torch.ops.precision import set_precision_

from test_rtmpose import TINY, TorchRTMPose
from test_torch_mesh_models import assert_trees_equal

# TINY of tests/test_rtmpose.py, and a 133-keypoint tiny net for the wholebody
# postprocess
CONFIGS = {
    "tiny": dataclasses.asdict(TINY),
    "wholebody": dict(input_hw=(64, 48), num_keypoints=133, widen_factor=0.125, deepen_factor=0.34,
                      gau_dim=32, gau_s=16),
}
LOGIT_TOL = 1e-4   # relative to max(1, max |logit|): fp32 sums in another order
# the bf16 pose net's SimCC logits against fp32's, ||d|| / ||logits||: the
# rounding of each product's operands accumulates over the convolutions
# (0.03-0.05 measured here)
POSE_BF16_TOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_pose_state_dict(cfg: port_pose.PoseNetConfig, seed: int = 0):
    """The port's seeded net (``init_pose_weights_``: calibrated norms) as
    numpy, the ScaleNorm gains, the residual scale and the GAU's gamma and
    beta moved off their initial values so that their mapping and the GAU's
    attention term are tested."""
    net = port_pose.RTMPoseNet(cfg)
    port_pose.init_pose_weights_(net, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    for k, std in (("head.mlp.0.g", 0.2), ("head.gau.ln.g", 0.2), ("head.gau.res_scale.scale", 0.2),
                   ("head.gau.gamma", 1.0), ("head.gau.beta", 0.5)):
        sd[k] = (sd[k] + std * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return sd


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def nets(request):
    """(port net, JAX module, JAX tree, jitted JAX logits) on the same weights."""
    cfg = port_pose.PoseNetConfig(**CONFIGS[request.param])
    jcfg = jax_pose.PoseNetConfig(**CONFIGS[request.param])
    tree = jax_pose.mmpose_to_flax(seeded_pose_state_dict(cfg), jcfg)
    port = port_pose.RTMPoseNet(cfg).eval()
    port.load_state_dict(pose_state_dict_from_jax_tree(tree, cfg), strict=True)
    jnet = jax_pose.RTMPoseNet(jcfg)

    @jax.jit
    def jax_logits(params, x):
        with jax.default_matmul_precision("highest"):
            _, state = jnet.apply({"params": params}, x, mutable=["intermediates"],
                                  capture_intermediates=lambda m, _: m.name in ("cls_x", "cls_y"))
        inter = state["intermediates"]
        return inter["cls_x"]["__call__"][0], inter["cls_y"]["__call__"][0]

    yield cfg, port, jnet, tree, jax_logits
    jax.clear_caches()


def _crops(cfg, n=3, seed=1):
    """Normalised crops as DWPose's look: a smooth image and pixel noise."""
    rng = np.random.default_rng(seed)
    h, w = cfg.input_hw
    coarse = rng.uniform(0, 255, size=(n, 3, h // 8, w // 8)).astype(np.float32)
    smooth = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(h, w), mode="bilinear").numpy()
    img = smooth.transpose(0, 2, 3, 1) + rng.normal(0, 16, size=(n, h, w, 3))
    return ((img - port_crops.DWPOSE_MEAN) / port_crops.DWPOSE_STD).astype(np.float32)


def _top2_gap(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def test_rtmpose_matches_jax(nets):
    """SimCC logits within 1e-4 of max(1, max |logit|); keypoints equal
    where both axes' top-two gaps exceed that; scores within it."""
    cfg, port, _jnet, tree, jax_logits = nets
    x = _crops(cfg)
    want = [np.asarray(a) for a in jax_logits(tree, jnp.asarray(x))]
    with torch.no_grad():
        got = [a.numpy() for a in port.logits(torch.from_numpy(x))]
    tol = LOGIT_TOL * max(1.0, max(np.abs(w).max() for w in want))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    kp_w, sc_w = (np.asarray(a) for a in jax_pose.simcc_decode(jnp.asarray(want[0]), jnp.asarray(want[1]),
                                                                cfg.simcc_ratio))
    with torch.no_grad():
        kp_g, sc_g = (a.numpy() for a in port(torch.from_numpy(x)))
    np.testing.assert_allclose(sc_g, sc_w, rtol=0, atol=tol)
    clear = (_top2_gap(want[0]) > tol) & (_top2_gap(want[1]) > tol) & (np.abs(sc_w) > tol)
    print(f"{(~clear).sum()} of {clear.size} keypoints excused as near ties")
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(kp_g[clear], kp_w[clear])


def test_simcc_decode_matches_jax():
    """The first maximum on exact ties, -1 where the score is 0 or less,
    bitwise."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 20)).astype(np.float32)
    y = rng.normal(size=(2, 9, 28)).astype(np.float32)
    x[0, 0, [3, 11]] = x[0, 0].max() + 1.0       # a tie: bin 3 wins
    x[1, :3] = -np.abs(x[1, :3]) - 0.1           # scores <= 0
    y[1, 3] = -np.abs(y[1, 3])
    y[1, 3, 5] = 0.0                             # score exactly 0
    got = port_pose.simcc_decode(torch.from_numpy(x), torch.from_numpy(y), 2.0)
    want = jax_pose.simcc_decode(jnp.asarray(x), jnp.asarray(y), 2.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0, 0, 0] == 1.5 and (got[0][1, :4] == -1).all()


@pytest.mark.parametrize("persons", [1, 2])
def test_dwpose_postprocess_matches_jax(persons):
    """``wholebody_to_openpose`` (the neck, the reorder read before it
    scatters), ``dwpose_postprocess`` and ``flatten_first_person`` under both
    ``visibility_rule`` values (P = 2: the reference's pairing of persons 0's
    and 1's left hands) bitwise, one frame at a time in JAX and over a batch
    of frames here."""
    rng = np.random.default_rng(persons)
    frames, K = 4, jax_pose.NUM_WHOLEBODY_KPTS
    kpts = rng.uniform(-20, 300, size=(frames, persons, K, 2)).astype(np.float32)
    scores = rng.uniform(0, 1, size=(frames, persons, K)).astype(np.float32)
    scores[0, 0, 92:134] = 0.1    # frame 0: person 0 shows no hand keypoint
    k134, s134 = port_pose.wholebody_to_openpose(torch.from_numpy(kpts), torch.from_numpy(scores))
    post = port_pose.dwpose_postprocess(k134, s134, (320.0, 240.0))
    got = [port_pose.flatten_first_person(post, visibility_rule=rule) for rule in (False, True)]

    @jax.jit
    def jax_frame(k, s, wh):   # (W, H) traced, as the JAX pipeline's kp_post takes them
        jk, js = jax_pose.wholebody_to_openpose(k, s)
        jpost = jax_pose.dwpose_postprocess(jk, js, wh)
        return jk, js, jpost, [jax_pose.flatten_first_person(jpost, visibility_rule=rule) for rule in (False, True)]

    for f in range(frames):
        jk, js, jpost, flat = jax_frame(kpts[f], scores[f], (np.float32(320.0), np.float32(240.0)))
        np.testing.assert_array_equal(k134[f].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(s134[f].numpy(), np.asarray(js))
        for key, v in jpost.items():
            np.testing.assert_array_equal(post[key][f].numpy(), np.asarray(v), err_msg=key)
        for (kp120, valid), (want_kp, want_valid) in zip(got, flat):
            assert kp120.shape == (frames, 120) and valid.shape == (frames,)
            np.testing.assert_array_equal(kp120[f].numpy(), np.asarray(want_kp))
            assert bool(valid[f]) == bool(want_valid)
    assert not got[1][1][0] and got[0][1].all()   # frame 0 fails the visibility rule only
    kp120 = got[0][0]
    if persons == 2:   # rows 0 and 1 of the hands stack: persons 0's and 1's left hands
        np.testing.assert_array_equal(kp120[:, 78:].reshape(frames, 21, 2), post["candidate"][:, 1, 92:113])


def _warp_oracle(frames_bgr, center, scale, out_hw):
    """float64 ``cv2.warpAffine`` of the uint8 frame before rounding:
    bilinear taps of a zero-bordered image at ``s_inv * dst + t``."""
    B, H, W, _ = frames_bgr.shape
    oh, ow = out_hw
    out = np.zeros((B, oh, ow, 3))
    for b in range(B):
        s = scale[b, 0] / ow
        ys = s * np.arange(oh) + (center[b, 1] - s * oh * 0.5)
        xs = s * np.arange(ow) + (center[b, 0] - s * ow * 0.5)
        y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
        fy, fx = ys - y0, xs - x0
        pad = np.zeros((H + 2, W + 2, 3))
        pad[1:-1, 1:-1] = frames_bgr[b]

        def tap(yi, xi):
            return pad[np.clip(yi + 1, 0, H + 1)[:, None], np.clip(xi + 1, 0, W + 1)[None, :]]

        out[b] = ((1 - fy)[:, None, None] * ((1 - fx)[None, :, None] * tap(y0, x0) + fx[None, :, None] * tap(y0, x0 + 1))
                  + fy[:, None, None] * ((1 - fx)[None, :, None] * tap(y0 + 1, x0) + fx[None, :, None] * tap(y0 + 1, x0 + 1)))
    return out


def test_dwpose_crops_match_jax():
    """``dwpose_center_scale`` and ``dwpose_backmap`` within 1e-5 pixels of
    JAX's; ``dwpose_topdown_crop`` on random boxes and on boxes whose warp
    samples half-way between pixels (ties of the uint8 rounding) against a
    float64 oracle: rounded half to even and normalised with the RGB-order
    means on the BGR crop, equal to JAX's where the oracle is further than
    1e-4 from x.5."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, size=(6, 40, 56, 3)).astype(np.float32)
    boxes = np.stack([rng.uniform(-8, 20, 6), rng.uniform(-5, 15, 6), rng.uniform(25, 70, 6),
                      rng.uniform(20, 48, 6)], 1).astype(np.float32)
    boxes[4:] = [[10, 12, 18, 20], [21, 5, 29, 13]]   # sw = 12 at padding 1.5: s_inv 0.5, half-pixel taps
    hw = (32, 24)
    for pad in (1.25, 1.5):
        c_g, s_g = port_crops.dwpose_center_scale(torch.from_numpy(boxes), hw, pad)
        c_w, s_w = jax_crops.dwpose_center_scale(jnp.asarray(boxes), hw, pad)
        np.testing.assert_allclose(c_g.numpy(), np.asarray(c_w), rtol=0, atol=1e-5)
        np.testing.assert_allclose(s_g.numpy(), np.asarray(s_w), rtol=0, atol=1e-5)
        got, gc, gs = port_crops.dwpose_topdown_crop(torch.from_numpy(frames), torch.from_numpy(boxes), hw, pad)
        want = np.asarray(jax_crops.dwpose_topdown_crop(jnp.asarray(frames), jnp.asarray(boxes), hw, pad)[0])
        exact = _warp_oracle(frames[..., ::-1].astype(np.float64), gc.numpy().astype(np.float64),
                             gs.numpy().astype(np.float64), hw)
        tie = np.abs(exact - np.floor(exact) - 0.5) < 1e-4
        raw = got.numpy() * port_crops.DWPOSE_STD + port_crops.DWPOSE_MEAN
        print(f"padding {pad}: {tie.sum()} of {tie.size} crop values excused as rounding ties")
        if pad == 1.5:
            assert tie.sum() > 0
        np.testing.assert_allclose(raw[~tie], np.clip(np.round(exact), 0, 255)[~tie], rtol=0, atol=1e-3)
        assert (np.abs(raw[tie] - exact[tie]) <= 0.5 + 1e-3).all()
        np.testing.assert_allclose(got.numpy()[~tie], want[~tie], rtol=0, atol=1e-5)
    kp = rng.uniform(0, 24, size=(6, 133, 2)).astype(np.float32)
    np.testing.assert_allclose(
        port_crops.dwpose_backmap(torch.from_numpy(kp), gc, gs, hw).numpy(),
        np.asarray(jax_crops.dwpose_backmap(jnp.asarray(kp), jnp.asarray(gc.numpy()), jnp.asarray(gs.numpy()), hw)),
        rtol=0, atol=1e-4)


def test_dwpose_l_layout_matches_mmpose():
    """``dwpose_l()`` built on the meta device has the state_dict keys and
    shapes of tests/test_rtmpose.py's replica of mmpose's published layout
    (384 x 288, 133 keypoints, 576 x 768 bins), and that replica's
    state_dict loads into it strictly."""
    cfg = port_pose.PoseNetConfig.dwpose_l()
    with torch.device("meta"):
        port = port_pose.RTMPoseNet(cfg)
        mmpose = TorchRTMPose(jax_pose.PoseNetConfig.dwpose_l())
    ours = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert ours == {k: tuple(v.shape) for k, v in mmpose.state_dict().items()}
    assert ours["head.cls_x.weight"] == (576, 256) and ours["head.cls_y.weight"] == (768, 256)
    assert ours["head.final_layer.weight"] == (133, 1024, 7, 7)
    assert ours["backbone.stage4.2.attention.fc.weight"] == (1024, 1024, 1, 1)
    port.load_state_dict(mmpose.state_dict(), strict=True, assign=True)


def test_mmpose_to_flax_round_trip(nets):
    """``mmpose_to_flax`` of the port's state_dict is the tree the port was
    built from, and ``pose_state_dict_from_jax_tree`` carries every key back
    (the batch counters as int64 zeros)."""
    cfg, port, jnet, tree, _ = nets
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    jcfg = jax_pose.PoseNetConfig(**dataclasses.asdict(cfg))
    assert_trees_equal(jax_pose.mmpose_to_flax(sd, jcfg), tree)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
        jnet.init, jax.random.key(0), jnp.zeros((1, *cfg.input_hw, 3)))["params"])
    assert jax.tree_util.tree_map(np.shape, tree) == shapes
    back = pose_state_dict_from_jax_tree(tree, cfg)
    assert set(back) == set(sd)
    counters = [k for k in back if k.endswith("num_batches_tracked")]
    assert counters and all(back[k].dtype == torch.int64 and back[k] == 0 for k in counters)


def test_bf16_pose_net_keeps_its_head_in_fp32(nets):
    """In the bf16 mode (bf16-rounded weights, fp32 activations, products at
    "default") the backbone's products are single-pass bf16 and the channel
    attentions' gates and the head run fp32 products on the rounded weights:
    the logits stay within POSE_BF16_TOL of the fp32 net's in L2 norm, and
    seeding is deterministic."""
    cfg, port, _jnet, _tree, _ = nets
    bf16 = port_pose.RTMPoseNet(cfg).eval()
    bf16.load_state_dict(port.state_dict())
    set_precision_(bf16.to(torch.bfloat16), "default")
    assert bf16.backbone.stem[0].conv.weight.dtype == bf16.head.cls_x.weight.dtype == torch.bfloat16
    assert bf16.backbone.stem[0].conv.precision == "default"
    assert bf16.head.cls_x.precision == bf16.head.gau.precision == "highest"
    assert bf16.backbone.stage1[1].attention.fc.precision == "highest"
    x = torch.from_numpy(_crops(cfg))
    with torch.no_grad():
        for a, b in zip(port.logits(x), bf16.logits(x)):
            assert b.dtype == torch.float32
            assert (a - b).norm() <= POSE_BF16_TOL * a.norm()
        kp, sc = bf16(x)
    assert kp.dtype == sc.dtype == torch.float32
    nets_ = [port_pose.RTMPoseNet(cfg) for _ in range(2)]
    for n in nets_:
        port_pose.init_pose_weights_(n, torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(nets_[0].state_dict().values(), nets_[1].state_dict().values()))
