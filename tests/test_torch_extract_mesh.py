"""The mesh-recovery stage of the port as a whole, on the CPU at a tiny
geometry: ``Extractor.process_video`` against the JAX package's
``Extractor._mesh_forward`` driven through ``_batched``, with the same numpy
weights, frames and boxes."""

import dataclasses

import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import smpl_head as jax_head
from video_gen_evals_tpu.models import vit as jax_vit
from video_gen_evals_tpu.pipelines import extract as jax_extract
from video_gen_evals_tpu_torch.data.features import ModalityPaths, load_video_arrays
from video_gen_evals_tpu_torch.data.manifest import VideoItem
from video_gen_evals_tpu_torch.models.detector import DetectorConfig
from video_gen_evals_tpu_torch.models.pose2d import PoseNetConfig, RTMPoseNet, init_pose_weights_
from video_gen_evals_tpu_torch.models.smpl_head import SMPLHeadConfig
from video_gen_evals_tpu_torch.models.torch_compat import (
    head_state_dict_from_jax_tree,
    vit_state_dict_from_jax_tree,
)
from video_gen_evals_tpu_torch.models.vit import ViTConfig
from video_gen_evals_tpu_torch.pipelines.extract import Extractor, ExtractorConfig
from video_gen_evals_tpu_torch.utils.io import save_video_npz

from test_torch_mesh_models import TINY_HEAD, TINY_VIT, highest, init_tree  # noqa: F401

FRAME_BATCH = 4
H, W = 96, 128
# the crop window is 2x the box here (not the default 2.5x) so that boxes of
# 32 and 16 pixels give windows of exactly 64 and 32 with quarter-pixel
# offsets: the unblurred, rounded crops are then exact in both frameworks and
# cannot round to different sides. The large boxes take the blurred branch.
RESCALE = 2.0
EXACT = [(45.25, 24.5, 55.25, 56.5), (100.0, 60.25, 108.0, 76.25), (0.25, 70.0, 10.25, 86.0)]
LARGE = [(30.3, 5.2, 90.9, 90.7), (50.1, 2.0, 120.4, 95.3), (-20.0, 5.5, 60.2, 92.9)]
OUT_KEYS = ("pose", "betas", "global_orient", "vit")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them (each Extractor here also draws
    and calibrates the default YOLOX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _video(seed, n):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(n, H, W, 3), dtype=np.uint8)
    boxes = np.asarray([(EXACT + LARGE)[i % 6] for i in rng.permutation(n)], np.float32)
    return frames, boxes


@pytest.fixture(scope="module")
def weights():
    """One set of numpy weights as the JAX trees and as the port's state_dicts."""
    rng = np.random.default_rng(11)
    jvit = jax_vit.ViTConfig(**TINY_VIT, attention_impl="core_interpret")
    jhead = jax_head.SMPLHeadConfig(**TINY_HEAD)
    vit_tree = init_tree(jax_vit.ViTBackbone(jvit), np.zeros((1, 64, 48, 3), np.float32), rng)
    head_tree = init_tree(jax_head.SMPLTokenDecoderHead(jhead), np.zeros((1, 12, 64), np.float32), rng)
    cfg = ExtractorConfig(vit=ViTConfig(**TINY_VIT), head=SMPLHeadConfig(**TINY_HEAD),
                          frame_batch=FRAME_BATCH, vitdet_rescale=RESCALE, matmul_precision="highest")
    sds = {"vit": vit_state_dict_from_jax_tree(vit_tree, cfg.vit),
           "head": head_state_dict_from_jax_tree(head_tree, cfg.head)}
    return dict(jvit=jvit, jhead=jhead, vit_tree=vit_tree, head_tree=head_tree, cfg=cfg, sds=sds)


@pytest.fixture(scope="module")
def port(weights):
    return Extractor(weights["cfg"], state_dicts=weights["sds"], device="cpu")


def test_process_video_matches_jax(highest, weights, port):  # noqa: F811
    """Two videos whose lengths (6 and 9) are no multiple of frame_batch (4):
    pose, betas, global_orient and vit within 1e-4 of the JAX stage (fp32 on
    both sides; K6 in interpret mode there, its plain version here)."""
    jcfg = jax_extract.ExtractorConfig(
        vit=weights["jvit"], head=weights["jhead"], frame_batch=FRAME_BATCH,
        vitdet_rescale=RESCALE, matmul_precision="highest", keep_all_frames=True)
    # the detector and pose nets are not on this path: empty trees skip their init
    jex = jax_extract.Extractor(jcfg, params={"vit": weights["vit_tree"], "head": weights["head_tree"],
                                              "det": {}, "pose": {}})
    assert port.cfg.vit.attention_impl == "core"
    for seed, n in ((0, 6), (1, 9)):
        frames, boxes = _video(seed, n)
        want = jex._batched(
            lambda f, b: jex._mesh_forward(jex.params["vit"], jex.params["head"], f, b),
            jex._upload_frames(frames), boxes)
        got = port.process_video(frames, boxes)
        assert set(got) == set(OUT_KEYS) | {"frame_idx"}
        assert got["pose"].shape == (n, 23, 3, 3) and got["global_orient"].shape == (n, 1, 3, 3)
        assert got["betas"].shape == (n, 10) and got["vit"].shape == (n, 64)
        assert all(got[k].dtype == np.float32 for k in OUT_KEYS)
        np.testing.assert_array_equal(got["frame_idx"], np.arange(n, dtype=np.int32))
        for key, jkey in zip(OUT_KEYS, ("body_pose", "betas", "global_orient", "token_out")):
            np.testing.assert_allclose(got[key], np.asarray(want[jkey]), atol=1e-4, err_msg=key)


def test_padding_does_not_change_kept_frames(port):
    """Frames 4 and 5 of a 6-frame video sit in a padded chunk; as the last
    two of a full chunk they give the same values (1e-5: the same arithmetic
    at another position of the batch)."""
    frames, boxes = _video(2, 6)
    whole = port.process_video(frames, boxes)
    tail = port.process_video(frames[2:], boxes[2:])
    for key in OUT_KEYS:
        np.testing.assert_allclose(whole[key][2:], tail[key], atol=1e-5, err_msg=key)
    # tensors are taken as well as arrays
    again = port.process_video(torch.from_numpy(frames), torch.from_numpy(boxes))
    assert all(np.array_equal(again[k], whole[k]) for k in whole)


def test_every_attention_impl_and_the_bf16_mode(weights, port):
    """The stage gives the same features through each attention_impl (1e-4),
    and the bf16 fast mode stays finite and near them (0.25 on features of
    order 1: bf16 carries 8 bits through two blocks and the head)."""
    frames, boxes = _video(3, 5)
    want = port.process_video(frames, boxes)
    for impl in ("plain", "head_batched", "flash"):
        cfg = dataclasses.replace(weights["cfg"], vit=ViTConfig(**TINY_VIT, attention_impl=impl))
        got = Extractor(cfg, state_dicts=weights["sds"], device="cpu").process_video(frames, boxes)
        for key in OUT_KEYS:
            np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=f"{impl} {key}")
    fast = dataclasses.replace(weights["cfg"], matmul_precision="default", param_dtype="bfloat16")
    got = Extractor(fast, state_dicts=weights["sds"], device="cpu").process_video(frames, boxes)
    for key in OUT_KEYS:
        assert got[key].dtype == np.float32 and np.isfinite(got[key]).all(), key
    assert np.abs(got["vit"] - want["vit"]).max() <= 0.25
    R = torch.from_numpy(got["pose"])
    assert (R @ R.transpose(-1, -2) - torch.eye(3)).abs().max().item() <= 1e-4


def test_seeded_weights_and_checkpoint_file(tmp_path, weights, port):
    """Without state_dicts the nets are drawn from the seed (same seed, same
    output; another seed, another). A TokenHMR-layout file (``backbone.*`` +
    ``smpl_head.*``, the tokenizer decoder nested under a prefix) loads
    through from_checkpoints with the head's geometry read from its shapes."""
    frames, boxes = _video(4, 3)
    cfg = weights["cfg"]
    a, b, c = (Extractor(cfg, seed=s, device="cpu").process_video(frames, boxes)["vit"] for s in (5, 5, 6))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.isfinite(a).all() and np.abs(a).max() > 0

    ckpt = {f"backbone.{k}": v for k, v in weights["sds"]["vit"].items()}
    for k, v in weights["sds"]["head"].items():
        if k.startswith("decpose.") and not k.startswith("decpose.cls_head."):
            k = "decpose.tokenizer." + k[len("decpose."):]
        ckpt[f"smpl_head.{k}"] = v
    path = str(tmp_path / "tokenhmr.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in ckpt.items()}}, path)
    bare = dataclasses.replace(cfg, head=SMPLHeadConfig(**dict(TINY_HEAD, token_num=3, token_class_num=7)))
    loaded = Extractor.from_checkpoints(bare, tokenhmr=path, device="cpu")
    assert loaded.cfg.head == cfg.head
    want = port.process_video(frames, boxes)
    got = loaded.process_video(frames, boxes)
    assert all(np.array_equal(got[k], want[k]) for k in want)

    torch.save(dict(ckpt, **{"smpl_head.decpose.tokenizer.mystery.weight": torch.zeros(2)}), path)
    with pytest.raises(ValueError, match="mystery"):
        Extractor.from_checkpoints(bare, tokenhmr=path, device="cpu")
    torch.save({"unrelated.weight": torch.zeros(2)}, path)
    with pytest.raises(ValueError, match="no keys under prefix"):
        Extractor.from_checkpoints(bare, tokenhmr=path, device="cpu")
    # an mmpose-layout DWPose file of a pose geometry the caller set loads into
    # the pose net (a default one would become dwpose_l())
    small_pose = PoseNetConfig(input_hw=(64, 48), widen_factor=0.125, deepen_factor=0.34, gau_dim=32, gau_s=16)
    pose_net = RTMPoseNet(small_pose)
    init_pose_weights_(pose_net, torch.Generator().manual_seed(1))
    pose_sd = pose_net.state_dict()
    torch.save({"state_dict": pose_sd, "meta": {"epoch": 270}}, path)
    with_pose = Extractor.from_checkpoints(dataclasses.replace(cfg, pose=small_pose), dwpose=path, device="cpu")
    assert with_pose.cfg.pose == small_pose
    assert torch.equal(with_pose.pose_net.state_dict()["head.cls_x.weight"], pose_sd["head.cls_x.weight"])
    # a Megvii YOLOX file of the lite geometry loads into the detector (a det
    # the caller set, here with 8 detections a frame, is kept; a default one
    # would become yolox_l())
    det_sd = {k: v.clone() for k, v in port.detector.state_dict().items()}
    det_sd["head.obj_preds.0.bias"] += 1.0
    torch.save({"model": det_sd}, path)
    with_det = Extractor.from_checkpoints(dataclasses.replace(cfg, det=DetectorConfig(max_detections=8)),
                                         yolox=path, device="cpu")
    assert torch.equal(with_det.detector.state_dict()["head.obj_preds.0.bias"], det_sd["head.obj_preds.0.bias"])


def test_calls_that_need_a_detector_raise(port, tmp_path):
    """The legacy preprocessing is accepted (and its detector input need not
    be square: only the upstream letterbox needs that), an unknown one
    refused, and a run_tree across hosts refuses a host index outside
    [0, num_hosts) before it writes anything. Without boxes, process_video
    runs the default YOLOX detect stage (its seeded lite net here) under
    JAX's default rule (keep_all_frames False): the result is None or the
    frames of the detector's single-person mask, and the keypoint entry gives
    one row a frame."""
    frames, boxes = _video(5, 2)
    assert ExtractorConfig().keep_all_frames is False and port.cfg.mesh_detector == "yolox"
    single = port.detect_stage(torch.from_numpy(frames))["single"].numpy()
    out = port.process_video(frames)
    if single.mean() < port.cfg.min_single_ratio or not single.any():
        assert out is None
    else:
        np.testing.assert_array_equal(out["frame_idx"], np.flatnonzero(single))
    kp = port.process_video_keypoints(frames)
    assert kp["kp120"].shape == (len(frames), 120) and kp["valid"].shape == (len(frames),)
    with pytest.raises(ValueError, match=r"host_id must be in \[0, 2\)"):
        port.run_tree(str(tmp_path / "videos"), str(tmp_path / "meshes"), str(tmp_path / "logs"),
                      num_hosts=2, host_id=2)
    assert not (tmp_path / "logs").exists()
    legacy = ExtractorConfig(preproc="legacy", det=DetectorConfig(input_hw=(416, 320)))
    assert legacy.preproc == "legacy" and legacy.crop_scale == 1.2
    with pytest.raises(ValueError, match="unknown preproc"):
        ExtractorConfig(preproc="stretched")
    with pytest.raises(ValueError, match="square"):
        ExtractorConfig(det=DetectorConfig(input_hw=(416, 320)))
    with pytest.raises(ValueError, match="not a mode"):
        ExtractorConfig(matmul_precision="default", param_dtype="float32")
    with pytest.raises(ValueError, match=r"\[2, 4\]"):
        port.process_video(frames, boxes[:1])


def test_no_silent_cpu_fallback(weights):
    """``device=None`` means the card: without one the constructor raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the constructor would succeed")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Extractor(weights["cfg"], state_dicts=weights["sds"])


def test_hand_off_to_the_scoring_loader(tmp_path, port):
    """The mesh dict written by save_video_npz is what the scoring path's
    loader reads: vit [T, D], global [T, 9], pose [T, 207], beta [T, 10]."""
    frames, boxes = _video(6, 5)
    mesh = port.process_video(frames, boxes)
    path = save_video_npz(str(tmp_path), "walk/clip_0", **mesh, meta={"frames": 5})
    assert path.endswith("walk/clip_0.npz")
    item = VideoItem(cls="walk", name="clip_0.npz", path=path, length=5, vit_dim=64)
    arrays = load_video_arrays(item, ModalityPaths())
    assert {k: v.shape for k, v in arrays.items()} == {
        "vit": (5, 64), "global": (5, 9), "pose": (5, 207), "beta": (5, 10)}
    np.testing.assert_array_equal(arrays["vit"], mesh["vit"])
    np.testing.assert_array_equal(arrays["pose"], mesh["pose"].reshape(5, -1))
