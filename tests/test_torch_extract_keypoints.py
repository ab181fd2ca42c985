"""The keypoint branch and the rest of the extractor on the CPU at a tiny
geometry, against the JAX package on the same numpy weights:
``process_video_keypoints``, ``process_video_full(with_keypoints=True)`` in
yolox and rcnn modes, the full-frame fallback and ``kp_bug_compat``,
``parity()``, the streamed path against the per-video one, ``run_tree`` with
its ledgers, resume and fault isolation, ``RUN_CONFIG.json`` and the CLI.

The ViT, head and pose net are JAX's ``tests/test_extract_pipeline.py``
``tiny_extractor`` geometry; the detector is ``tests/test_torch_extract_yolox.py``'s
calibrated small YOLOX on its frame pool, whose frames hold zero, one or
several persons. JAX runs at matmul precision "highest". A keypoint is
compared only where its SimCC logits' top-two gaps and its score's distance
from the 0.3 visibility threshold exceed the logits' tolerance (an argmax or
a threshold on a near tie may go either way in either framework); the tests
print how many entries they excused."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import detector as jax_det
from video_gen_evals_tpu.models import pose2d as jax_pose
from video_gen_evals_tpu.models import rcnn as jax_rcnn
from video_gen_evals_tpu.models import smpl_head as jax_head
from video_gen_evals_tpu.models import vit as jax_vit
from video_gen_evals_tpu.pipelines import extract as jax_extract
from video_gen_evals_tpu.pipelines import full as jax_full
from video_gen_evals_tpu_torch.models.detector import DetectorConfig
from video_gen_evals_tpu_torch.models.pose2d import PoseNetConfig, wholebody_to_openpose
from video_gen_evals_tpu_torch.models.rcnn import RCNNConfig
from video_gen_evals_tpu_torch.models.smpl_head import SMPLHeadConfig
from video_gen_evals_tpu_torch.models.torch_compat import (
    head_state_dict_from_jax_tree,
    pose_state_dict_from_jax_tree,
    vit_state_dict_from_jax_tree,
)
from video_gen_evals_tpu_torch.models.vit import ViTConfig
from video_gen_evals_tpu_torch.ops.upstream_crops import dwpose_topdown_crop
from video_gen_evals_tpu_torch.pipelines import extract as port_extract
from video_gen_evals_tpu_torch.pipelines import full as port_full
from video_gen_evals_tpu_torch.pipelines.extract import Extractor, ExtractorConfig

from test_torch_extract_yolox import KEPT_VIDEO, REJECTED_VIDEO, SMALL, THRESH, _pool, detector_state_dict
from test_torch_mesh_models import init_tree
from test_torch_rcnn import seeded_state_dict
from test_torch_rtmpose import LOGIT_TOL, seeded_pose_state_dict

# tests/test_extract_pipeline.py::tiny_extractor
VIT = dict(img_size=(32, 24), patch_size=8, embed_dim=32, depth=1, num_heads=4)
HEAD = dict(dim=32, context_dim=32, depth=1, heads=2, dim_head=8, mlp_dim=32, token_num=2, token_class_num=8,
            token_code_dim=4)
POSE = dict(input_hw=(32, 24), widen_factor=0.0625, deepen_factor=0.2, gau_dim=16, gau_s=8)
# the pose rule at the mesh rule's threshold: this detector scores a pose
# person above 0.3 in every frame, and above THRESH only in some
KNOBS = dict(frame_batch=4, vitdet_rescale=12.0, matmul_precision="highest", det_score_thresh=THRESH,
             pose_det_score_thresh=THRESH)
MESH_KEYS = ("pose", "betas", "global_orient", "vit")
# a video with frames of no pose person (0 and 1 of the pool) besides ones with one
# (5, 9, 12) and several (11)
MIXED_VIDEO = [5, 1, 9, 0, 12, 11, 5]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(21)
    jvit = jax_vit.ViTConfig(**VIT, attention_impl="xla")
    jhead = jax_head.SMPLHeadConfig(**HEAD)
    jpose = jax_pose.PoseNetConfig(**POSE)
    jdet = jax_det.DetectorConfig(**SMALL)
    det_sd = detector_state_dict(DetectorConfig(**SMALL))
    pose_sd = seeded_pose_state_dict(PoseNetConfig(**POSE), seed=5)
    rcnn_sd = seeded_state_dict(RCNNConfig.small(), seed=1)
    rcnn_sd["roi_heads.box_predictor.cls_score.bias"][0] += 2.0
    trees = {"vit": init_tree(jax_vit.ViTBackbone(jvit), np.zeros((1, 32, 24, 3), np.float32), rng),
             "head": init_tree(jax_head.SMPLTokenDecoderHead(jhead), np.zeros((1, 12, 32), np.float32), rng),
             "pose": jax_pose.mmpose_to_flax(pose_sd, jpose),
             "det": jax_det.yolox_to_flax(det_sd, jdet)}
    cfg = ExtractorConfig(det=DetectorConfig(**SMALL), vit=ViTConfig(**VIT), head=SMPLHeadConfig(**HEAD),
                          pose=PoseNetConfig(**POSE), **KNOBS)
    sds = {"vit": vit_state_dict_from_jax_tree(trees["vit"], cfg.vit),
           "head": head_state_dict_from_jax_tree(trees["head"], cfg.head),
           "pose": pose_state_dict_from_jax_tree(trees["pose"], cfg.pose),
           "det": {k: torch.from_numpy(np.asarray(v)) for k, v in det_sd.items()}}
    jcfg = jax_extract.ExtractorConfig(det=jdet, vit=jvit, head=jhead, pose=jpose, **KNOBS)
    return dict(cfg=cfg, sds=sds, jcfg=jcfg, trees=trees, rcnn_sd=rcnn_sd)


@pytest.fixture(scope="module")
def jax_flag():
    """JAX at matmul precision "highest" with XLA's optimisation passes off
    (its CPU compiles dominate these tests, and the passes change what an f32
    program computes by rounding only); both flags are put back and every
    executable compiled under them dropped after the module."""
    before = jax.config.jax_default_matmul_precision, jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_default_matmul_precision", before[0])
    jax.config.update("jax_disable_most_optimizations", before[1])
    jax.clear_caches()


@pytest.fixture(scope="module")
def pair(weights, jax_flag):
    """The yolox-mode port Extractor and the JAX one (JAX's stage jits
    compiled once for the module)."""
    port = Extractor(weights["cfg"], state_dicts=weights["sds"], device="cpu")
    jex = jax_extract.Extractor(weights["jcfg"], params=dict(weights["trees"]))
    return port, jex


@pytest.fixture(scope="module")
def rcnn_pair(weights, jax_flag):
    """The rcnn-mode pair at RCNNConfig.small(), keep_all_frames."""
    cfg = dataclasses.replace(weights["cfg"], mesh_detector="rcnn", rcnn=RCNNConfig.small(), keep_all_frames=True)
    sds = dict(weights["sds"], rcnn={k: torch.from_numpy(v) for k, v in weights["rcnn_sd"].items()})
    jcfg = dataclasses.replace(weights["jcfg"], mesh_detector="rcnn", rcnn=jax_rcnn.RCNNConfig.small(),
                               keep_all_frames=True)
    params = dict(weights["trees"], rcnn=jax_rcnn.detectron2_to_flax(weights["rcnn_sd"], jcfg.rcnn))
    return Extractor(cfg, state_dicts=sds, device="cpu"), jax_extract.Extractor(jcfg, params=params)


def clear_entries(port: Extractor, frames: np.ndarray, box_pose=None) -> np.ndarray:
    """``[T, 120]``: the kp120 entries whose keypoint is no near tie (both
    SimCC axes' top-two gaps and the score's distance from 0.3 above
    LOGIT_TOL of the logits' scale), recomputed from the port's own pose
    boxes, crops and logits."""
    fr = torch.from_numpy(frames)
    if box_pose is None:
        box_pose = port.detect_stage(fr, with_keypoints=True)["box_pose"]
    with torch.no_grad():
        crops, _, _ = dwpose_topdown_crop(fr.float(), box_pose, port.cfg.pose.input_hw, port.cfg.pose_padding)
        lx, ly = port.pose_net.logits(crops)
    tol = LOGIT_TOL * max(1.0, lx.abs().max().item(), ly.abs().max().item())
    gap = [torch.topk(a, 2, dim=-1).values for a in (lx, ly)]
    score = torch.minimum(gap[0][..., 0], gap[1][..., 0])
    clear = ((gap[0][..., 0] - gap[0][..., 1] > tol) & (gap[1][..., 0] - gap[1][..., 1] > tol)
             & ((score - 0.3).abs() > tol) & (score.abs() > tol))
    # through the openpose reorder (the neck is clear iff both shoulders are)
    _, c134 = wholebody_to_openpose(torch.zeros(*clear.shape, 2), clear.float())
    rows = torch.cat([c134[:, :18], c134[:, 92:134]], dim=1) > 0.5
    return rows.repeat_interleave(2, dim=1).numpy()


def assert_kp_match(got, want, clear, tag=""):
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]), err_msg=f"{tag} valid")
    g, w = got["kp120"], np.asarray(want["kp120"])
    assert g.shape == w.shape and g.dtype == np.float32, tag
    print(f"{tag}: {(~clear).sum()} of {clear.size} kp120 entries excused as near ties")
    assert clear.mean() > 0.9, tag
    np.testing.assert_allclose(g[clear], w[clear], rtol=0, atol=1e-4, err_msg=tag)


def assert_mesh_match(got, want, tag=""):
    assert (got is None) == (want is None), tag
    if want is None:
        return
    np.testing.assert_array_equal(got["frame_idx"], np.asarray(want["frame_idx"]), err_msg=tag)
    for k in MESH_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-4, err_msg=f"{tag} {k}")


def test_process_video_keypoints_matches_jax(pair):
    """``process_video_keypoints`` on a video with person and no-person
    frames: kp120 [T, 120] float32 and valid [T] against JAX's; every frame
    valid under the full-frame fallback."""
    port, jex = pair
    frames = _pool()[MIXED_VIDEO]
    got = port.process_video_keypoints(frames)
    want = jex.process_video_keypoints(frames)
    assert got["kp120"].shape == (len(frames), 120) and got["valid"].dtype == bool and got["valid"].all()
    assert_kp_match(got, want, clear_entries(port, frames), "keypoints")
    vals = got["kp120"]
    assert np.isfinite(vals).all() and ((vals == -1) | ((vals > -1) & (vals < 2))).all()


@pytest.mark.parametrize("video,keep_all_frames", [(KEPT_VIDEO, False), (REJECTED_VIDEO, False),
                                                   (REJECTED_VIDEO, True)])
def test_process_video_full_matches_jax(pair, video, keep_all_frames):
    """``process_video_full(with_keypoints=True)`` at the default yolox mode
    (one detect pass for both branches): the kept video's mesh frames and
    arrays, its keypoints over every frame; (None, None) for the rejected
    one, which keep_all_frames keeps whole."""
    port, jex = pair
    frames = _pool()[video]
    for c in (port.cfg, jex.cfg):
        c.keep_all_frames = keep_all_frames
    try:
        got = port.process_video_full(frames, with_keypoints=True)
        want = jex.process_video_full(frames, with_keypoints=True)
    finally:
        for c in (port.cfg, jex.cfg):
            c.keep_all_frames = False
    assert_mesh_match(got[0], want[0], "mesh")
    assert (got[1] is None) == (want[1] is None) == (got[0] is None)
    if got[1] is not None:
        assert_kp_match(got[1], want[1], clear_entries(port, frames), "kp")


def test_rcnn_mode_matches_jax_and_the_yolox_mode(pair, rcnn_pair):
    """rcnn mode with keypoints: the mesh from the R-CNN's boxes against
    JAX's, the keypoints from YOLOX's pose boxes against JAX's and bitwise
    the yolox mode's (the same YOLOX and pose weights)."""
    port, jex = rcnn_pair
    frames = _pool()[MIXED_VIDEO]
    got = port.process_video_full(frames, with_keypoints=True)
    want = jex.process_video_full(frames, with_keypoints=True)
    assert_mesh_match(got[0], want[0], "rcnn mesh")
    assert_kp_match(got[1], want[1], clear_entries(port, frames), "rcnn kp")
    yolox = pair[0].process_video_keypoints(frames)
    assert np.array_equal(got[1]["kp120"], yolox["kp120"]) and np.array_equal(got[1]["valid"], yolox["valid"])


def test_fullframe_fallback_and_kp_bug_compat(pair):
    """Without the full-frame fallback a frame with no pose person is not
    valid, as in JAX (the valid frames' keypoints equal); the bug-compat
    flatten then keeps only the valid rows, as JAX's
    ``arrays_from_extraction`` does; keep_all_frames keeps every row."""
    port, jex = pair
    frames = _pool()[MIXED_VIDEO]
    det = port.detect_stage(torch.from_numpy(frames))
    present = det["present"].numpy()
    assert present.any() and not present.all()
    port.cfg.pose_fullframe_fallback = jex.cfg.pose_fullframe_fallback = False
    try:
        got = port.process_video_keypoints(frames)
        want = jex.process_video_keypoints(frames)
        port.cfg.keep_all_frames = True
        every = port.process_video_keypoints(frames)
    finally:
        port.cfg.pose_fullframe_fallback = jex.cfg.pose_fullframe_fallback = True
        port.cfg.keep_all_frames = False
    np.testing.assert_array_equal(got["valid"], present)
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
    clear = clear_entries(port, frames, det["box_pose"])[present]
    np.testing.assert_allclose(got["kp120"][present][clear], np.asarray(want["kp120"])[present][clear],
                               rtol=0, atol=1e-4)
    assert every["valid"].all()
    mesh = {"pose": np.zeros((3, 23, 3, 3), np.float32), "betas": np.zeros((3, 10), np.float32),
            "global_orient": np.zeros((3, 1, 3, 3), np.float32), "vit": np.zeros((3, 8), np.float32)}
    for compat in (True, False):
        a = port_full.arrays_from_extraction(mesh, got, kp_bug_compat=compat)
        b = jax_full.arrays_from_extraction(mesh, got, kp_bug_compat=compat)
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
        assert len(a["kp2d"]) == (present.sum() if compat else len(frames))


def test_parity_preset_knobs():
    """``ExtractorConfig.parity()`` and ``is_parity()`` knob for knob against
    JAX's (the port has no legacy preprocessing); a default config is the
    yolox throughput mode."""
    cfg = ExtractorConfig.parity()
    jcfg = jax_extract.ExtractorConfig.parity()
    for f in ("mesh_detector", "preproc", "matmul_precision", "param_dtype", "kp_bug_compat", "vitdet_antialias",
              "pose_fullframe_fallback", "pose_padding", "pose_det_prefilter", "pose_det_iou",
              "pose_det_score_thresh", "det_score_thresh", "min_single_ratio", "frame_batch", "rcnn_frame_batch"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.rcnn == RCNNConfig.x101_32x8d() and cfg.rcnn != RCNNConfig.fast()
    assert ExtractorConfig.parity(frame_batch=16).frame_batch == 16
    cases = [{}, dict(matmul_precision="highest"), dict(mesh_detector="yolox"), dict(kp_bug_compat=False),
             dict(vitdet_antialias=False), dict(pose_fullframe_fallback=False), dict(keep_all_frames=True)]
    for kw in cases:
        assert ExtractorConfig.parity(**kw).is_parity() == jax_extract.ExtractorConfig.parity(**kw).is_parity(), kw
    assert not ExtractorConfig.parity(rcnn=RCNNConfig.fast()).is_parity()
    assert jax_extract.ExtractorConfig.parity(rcnn=jax_rcnn.RCNNConfig.fast()).is_parity() is False
    assert not ExtractorConfig.parity(matmul_precision="default", param_dtype="bfloat16").is_parity()
    assert not ExtractorConfig().is_parity() and not jax_extract.ExtractorConfig().is_parity()
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1, item 3"):
        ExtractorConfig.parity(preproc="legacy")


def test_streamed_matches_per_video(pair):
    """``process_videos_streamed`` over three videos of two sizes (one
    rejected, super-batches of at most 12 frames) equals
    ``process_video_full`` a video: mesh within 1e-5, masks equal, keypoints
    where no near tie; ``fetch_arrays=False`` leaves tensors, the same ones."""
    port, _ = pair
    pool = _pool()
    # 88 x 112: 16 rows of the letterbox's grey below frames that hold one person
    taller = np.concatenate([pool[[9, 12, 9, 12, 9]], np.full((5, 16, 112, 3), 114, np.uint8)], axis=1)
    items = [("kept", pool[KEPT_VIDEO]), ("rejected", pool[REJECTED_VIDEO]), ("taller", taller)]
    mesh_by, kp_by = port.process_videos_streamed(items, with_keypoints=True, max_stream_frames=12)
    dev_mesh, dev_kp = port.process_videos_streamed(items, with_keypoints=True, fetch_arrays=False)
    for name, frames in items:
        mesh, kp = port.process_video_full(frames, with_keypoints=True)
        assert (mesh_by[name] is None) == (mesh is None) == (kp_by[name] is None) == (dev_mesh[name] is None)
        if mesh is None:
            continue
        np.testing.assert_array_equal(mesh_by[name]["frame_idx"], mesh["frame_idx"])
        for k in MESH_KEYS:
            np.testing.assert_allclose(mesh_by[name][k], mesh[k], rtol=0, atol=1e-5, err_msg=f"{name} {k}")
            assert isinstance(dev_mesh[name][k], torch.Tensor)
            np.testing.assert_allclose(dev_mesh[name][k].numpy(), mesh[k], rtol=0, atol=1e-5)
        assert isinstance(dev_kp[name]["kp120"], torch.Tensor)
        clear = clear_entries(port, frames)
        for got in (kp_by[name], {"kp120": dev_kp[name]["kp120"].numpy(), "valid": dev_kp[name]["valid"]}):
            assert_kp_match(got, kp, clear, f"streamed {name}")
    assert mesh_by["rejected"] is None and mesh_by["taller"]["vit"].shape == (5, 32)


def _tree(root):
    """2 actions x 3 .npy videos: kept, kept and rejected ones, and one corrupt
    file."""
    pool = _pool()
    videos = {"JumpingJack": {"a": KEPT_VIDEO, "b": REJECTED_VIDEO, "c": KEPT_VIDEO[::-1]},
              "PushUps": {"a": KEPT_VIDEO[1:], "b": KEPT_VIDEO + [9], "c": None}}
    for action, vids in videos.items():
        os.makedirs(os.path.join(root, action))
        for name, idx in vids.items():
            path = os.path.join(root, action, f"{name}.npy")
            if idx is None:
                with open(path, "wb") as f:
                    f.write(b"not a frame stack")
            else:
                np.save(path, pool[idx])
    return videos


def _ledgers(log_dir):
    out = {}
    for kind in ("single", "not_single", "errors"):
        for action in ("JumpingJack", "PushUps"):
            path = os.path.join(log_dir, kind, f"{action}.json")
            if os.path.exists(path):   # a ledger is written at its first record
                with open(path) as f:
                    out[(kind, action)] = sorted(json.load(f))
    return out


@pytest.mark.parametrize("stream_group", [8, 1])
def test_run_tree_matches_jax(pair, tmp_path, stream_group):
    """``run_tree`` on a .npy tree against JAX's (streamed groups of 8, and
    one video at a time): equal counts and ledgers (the corrupt file an error
    and nothing else), the npz within 1e-4 and keypoints.npy where no near
    tie; a second run skips every processed video; ``RUN_CONFIG.json`` equal
    to JAX's but for the four RCNNConfig fields that only lay work out on the
    TPU."""
    port, jex = pair
    videos = _tree(tmp_path / "videos")
    runs = {}
    for tag, ex in (("port", port), ("jax", jex)):
        out = {k: str(tmp_path / f"{tag}_{k}") for k in ("m", "k", "l")}
        counts = ex.run_tree(str(tmp_path / "videos"), out["m"], out["l"], kp_out_root=out["k"],
                             stream_group=stream_group)
        runs[tag] = (counts, out)
    assert runs["port"][0] == runs["jax"][0] == {"single": 4, "not_single": 1, "errors": 1, "skipped": 0}
    (_, pout), (_, jout) = runs["port"], runs["jax"]
    assert _ledgers(pout["l"]) == _ledgers(jout["l"])
    pool = _pool()
    for action, vids in videos.items():
        for name, idx in vids.items():
            path = os.path.join(action, f"{name}.npz")
            if not os.path.exists(os.path.join(jout["m"], path)):
                assert not os.path.exists(os.path.join(pout["m"], path))
                continue
            with np.load(os.path.join(pout["m"], path)) as a, np.load(os.path.join(jout["m"], path)) as b:
                assert set(a.files) == set(b.files) and str(a["meta"]) == str(b["meta"])
                for k in MESH_KEYS:
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4)
                np.testing.assert_array_equal(a["frame_idx"], b["frame_idx"])
            kp = [np.load(os.path.join(o["k"], action, name, "keypoints.npy")) for o in (pout, jout)]
            clear = clear_entries(port, pool[idx])
            assert_kp_match({"kp120": kp[0], "valid": True}, {"kp120": kp[1], "valid": True}, clear, path)
    again = port.run_tree(str(tmp_path / "videos"), pout["m"], pout["l"], kp_out_root=pout["k"],
                          stream_group=stream_group)
    assert again == {"single": 0, "not_single": 0, "errors": 1, "skipped": 5}
    with open(os.path.join(pout["l"], "RUN_CONFIG.json")) as f:
        ours = json.load(f)
    with open(os.path.join(jout["l"], "RUN_CONFIG.json")) as f:
        theirs = json.load(f)
    tpu_only = {"grouped_conv_impl", "grouped_conv_width", "roi_chunk", "roi_rois_per_step"}
    assert set(theirs["rcnn"]) - set(ours["rcnn"]) == tpu_only
    theirs["rcnn"] = {k: v for k, v in theirs["rcnn"].items() if k not in tpu_only}
    assert ours == theirs and ours["parity"] is False


def test_cli_refusals_and_main(pair, tmp_path, monkeypatch, capsys):
    """The CLI refuses what is not ported and names its ROADMAP item
    (data-parallel, multi-host and distributed runs: item 5; legacy crops:
    item 3), and so does ``run_tree`` across hosts; ``main`` drives a tiny
    ``Extractor.from_checkpoints`` through ``run_tree`` at its defaults."""
    port, _ = pair
    for argv in (["--mesh-data", "2"], ["--num-hosts", "2", "--host-id", "1"], ["--coordinator", "h:1"],
                 ["--num-processes", "2"], ["--process-id", "0"]):
        with pytest.raises(SystemExit):
            port_extract.main(["--videos", "v", *argv])
        assert "ROADMAP.md, Queue 1, item 5" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_extract.main(["--videos", "v", "--preproc", "legacy"])
    assert "ROADMAP.md, Queue 1, item 3" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1, item 5"):
        port.run_tree("v", "m", "l", num_hosts=2, host_id=1)

    _tree(tmp_path / "videos")
    built = {}

    def from_checkpoints(cls, config, **kw):
        built.update(kw, parity=config.is_parity(), kp_bug_compat=config.kp_bug_compat)
        return port

    monkeypatch.setattr(Extractor, "from_checkpoints", classmethod(from_checkpoints))
    logs = str(tmp_path / "logs")
    counts = port_extract.main(["--videos", str(tmp_path / "videos"), "--out-meshes", str(tmp_path / "m"),
                                "--log-dir", logs, "--out-kps", str(tmp_path / "k"), "--device", "cpu"])
    assert counts == {"single": 4, "not_single": 1, "errors": 1, "skipped": 0}
    assert built["device"] == "cpu" and built["kp_bug_compat"] is True and built["parity"] is False
    assert "throughput mode" in capsys.readouterr().err
    with open(os.path.join(logs, "errors", "PushUps.json")) as f:
        assert list(json.load(f)) == ["c.npy"]
    assert os.path.exists(str(tmp_path / "k" / "JumpingJack" / "a" / "keypoints.npy"))
