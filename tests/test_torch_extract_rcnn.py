"""``Extractor.process_video`` from raw frames in rcnn mode, on the CPU at a
tiny geometry, against the JAX package's ``Extractor.process_video_full`` on
the same numpy weights: the R-CNN detect stage at ``RCNNConfig.small()``
(DefaultPredictor resize, detector, person rule), then the ViT and SMPL head
of ``tests/test_torch_extract_mesh.py``. The accept/reject rule runs on a
stub detect stage."""

import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import rcnn as jax_rcnn
from video_gen_evals_tpu.models import smpl_head as jax_head
from video_gen_evals_tpu.models import vit as jax_vit
from video_gen_evals_tpu.pipelines import extract as jax_extract
from video_gen_evals_tpu_torch.models.rcnn import RCNNConfig
from video_gen_evals_tpu_torch.models.smpl_head import SMPLHeadConfig
from video_gen_evals_tpu_torch.models.torch_compat import (
    head_state_dict_from_jax_tree,
    vit_state_dict_from_jax_tree,
)
from video_gen_evals_tpu_torch.models.vit import ViTConfig
from video_gen_evals_tpu_torch.pipelines.extract import Extractor, ExtractorConfig

from test_torch_mesh_models import TINY_HEAD, TINY_VIT, init_tree
from test_torch_rcnn import seeded_state_dict

FRAME_BATCH = 4        # the detect stage chunks by min(rcnn_frame_batch, frame_batch) = 4 too
H, W = 96, 128         # resized to 48 x 64 on a 64 x 64 canvas by the small config
RESCALE = 2.0
OUT_KEYS = ("pose", "betas", "global_orient", "vit")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, n):
    """Smooth seeded frames (the detector's random weights respond to
    structure) with uint8 noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, size=(n, 4, 5, 3)).astype(np.float32)
    big = np.repeat(np.repeat(coarse, H // 4, axis=1), W // 4 + 1, axis=2)[:, :, :W]
    return np.clip(big + rng.normal(0, 20, size=big.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(12)
    # the JAX ViT's plain attention: K6 against its interpret-mode kernel is
    # tests/test_torch_extract_mesh.py's; this file holds the detect path
    jvit = jax_vit.ViTConfig(**TINY_VIT, attention_impl="xla")
    jhead = jax_head.SMPLHeadConfig(**TINY_HEAD)
    vit_tree = init_tree(jax_vit.ViTBackbone(jvit), np.zeros((1, 64, 48, 3), np.float32), rng)
    head_tree = init_tree(jax_head.SMPLTokenDecoderHead(jhead), np.zeros((1, 12, 64), np.float32), rng)
    rcnn_sd = seeded_state_dict(RCNNConfig.small(), seed=1)
    # the person logit raised so that some frames hold exactly one person box
    # above 0.5, others none or several
    rcnn_sd["roi_heads.box_predictor.cls_score.bias"][0] += 2.0
    cfg = ExtractorConfig(vit=ViTConfig(**TINY_VIT), head=SMPLHeadConfig(**TINY_HEAD), frame_batch=FRAME_BATCH,
                          vitdet_rescale=RESCALE, matmul_precision="highest", mesh_detector="rcnn",
                          rcnn=RCNNConfig.small())
    sds = {"vit": vit_state_dict_from_jax_tree(vit_tree, cfg.vit),
           "head": head_state_dict_from_jax_tree(head_tree, cfg.head),
           "rcnn": {k: torch.from_numpy(v) for k, v in rcnn_sd.items()}}
    jcfg = jax_extract.ExtractorConfig(
        vit=jvit, head=jhead, frame_batch=FRAME_BATCH, vitdet_rescale=RESCALE, matmul_precision="highest",
        keep_all_frames=True, mesh_detector="rcnn", rcnn=jax_rcnn.RCNNConfig.small())
    jparams = {"vit": vit_tree, "head": head_tree, "det": {}, "pose": {},
               "rcnn": jax_rcnn.detectron2_to_flax(rcnn_sd, jcfg.rcnn)}
    return dict(cfg=cfg, sds=sds, rcnn_sd=rcnn_sd, jcfg=jcfg, jparams=jparams)


@pytest.fixture(scope="module")
def pair(weights):
    """The port's Extractor and the JAX one (keep_all_frames=True at first)."""
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    port = Extractor(weights["cfg"], state_dicts=weights["sds"], device="cpu")
    jex = jax_extract.Extractor(dataclasses.replace(weights["jcfg"]), params=weights["jparams"])
    yield port, jex
    jax.config.update("jax_default_matmul_precision", before)
    jax.clear_caches()


def test_detect_stage_matches_jax(pair):
    """Per frame: the best person box (frame pixels) within 1e-4, and the
    single / present masks equal, against JAX's ``_detect_rcnn`` through its
    ``_batched`` (9 frames: two full chunks of 4 and a padded one)."""
    port, jex = pair
    frames = _frames(0, 9)
    want = jex._batched(lambda f: jex._detect_rcnn(jex.params["rcnn"], f), jex._upload_frames(frames),
                        batch=FRAME_BATCH)
    got = port.detect_stage(torch.from_numpy(frames))
    np.testing.assert_allclose(got["box"].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["single"].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got["present"].numpy(), np.asarray(want[2]))
    assert got["present"].any() and (got["box"][:, 2] <= W).all() and (got["box"][:, 3] <= H).all()


@pytest.mark.parametrize("keep_all_frames,min_single_ratio,kept", [(True, 0.8, 9), (False, 0.5, 5), (False, 0.8, None)])
def test_process_video_from_frames_matches_jax(pair, keep_all_frames, min_single_ratio, kept):
    """``process_video(frames)`` with no boxes against JAX's
    ``process_video_full`` on a video whose detector finds exactly one person
    in 5 of 9 frames: the mesh outputs within 1e-4 and the kept frames
    equal; with keep_all_frames=False the reference's rule decides on both
    sides (5/9 passes a 0.5 ratio and is rejected, None, at 0.8)."""
    port, jex = pair
    frames = _frames(1, 9)
    for c in (port.cfg, jex.cfg):
        c.keep_all_frames, c.min_single_ratio = keep_all_frames, min_single_ratio
    try:
        want, _ = jex.process_video_full(frames)
        got = port.process_video(frames)
    finally:
        for c in (port.cfg, jex.cfg):
            c.keep_all_frames, c.min_single_ratio = True, 0.8
    assert (got is None) == (want is None) == (kept is None)
    if want is None:
        return
    assert len(got["frame_idx"]) == kept
    np.testing.assert_array_equal(got["frame_idx"], want["frame_idx"])
    for key in OUT_KEYS:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=1e-4, err_msg=key)


def test_accept_reject_rule_on_a_stub_detect_stage(weights):
    """The reference's rule (ref ``mesh_generator.py:103-117``) with a stub
    detector: frame i holds exactly one person iff i % 3 == 1, so 3 of 9
    frames qualify. min_single_ratio 0.5 rejects the video; 0.3 keeps frames
    1, 4 and 7; keep_all_frames keeps all nine."""
    cfg = dataclasses.replace(weights["cfg"], keep_all_frames=False)
    ex = Extractor(cfg, state_dicts=weights["sds"], device="cpu")

    def stub(frames):
        idx = frames[:, 0, 0, 0].long()
        box = torch.tensor([[10.0, 12.0, 70.0, 90.0]]).expand(len(idx), 4)
        return {"box": box, "single": idx % 3 == 1, "present": idx % 3 >= 1}

    ex.detect_rcnn = stub
    frames = np.broadcast_to(np.arange(9, dtype=np.uint8)[:, None, None, None], (9, H, W, 3)).copy()
    ex.cfg.min_single_ratio = 0.5
    assert ex.process_video(frames) is None
    ex.cfg.min_single_ratio = 0.3
    out = ex.process_video(frames)
    np.testing.assert_array_equal(out["frame_idx"], [1, 4, 7])
    whole = ex.process_video(frames, np.tile([[10.0, 12.0, 70.0, 90.0]], (9, 1)).astype(np.float32))
    for key in OUT_KEYS:
        np.testing.assert_allclose(out[key], whole[key][[1, 4, 7]], rtol=0, atol=1e-5, err_msg=key)
    ex.cfg.keep_all_frames = True
    np.testing.assert_array_equal(ex.process_video(frames)["frame_idx"], np.arange(9))
    ex.detect_rcnn = lambda f: dict(stub(f), single=torch.zeros(len(f), dtype=torch.bool))
    ex.cfg.keep_all_frames = False
    ex.cfg.min_single_ratio = 0.0
    assert ex.process_video(frames) is None               # no single-person frame at all


def test_rcnn_checkpoint_selects_the_mode(tmp_path, weights, pair):
    """A detectron2 ``.pkl`` given to from_checkpoints switches the default
    (yolox) configuration to mesh_detector="rcnn" with those weights; the
    modes this slice leaves out raise."""
    path = str(tmp_path / "model_final_68b088.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": dict(weights["rcnn_sd"], pixel_mean=np.zeros((3, 1, 1), np.float32))}, f)
    base = dataclasses.replace(weights["cfg"], mesh_detector="yolox")
    ex = Extractor.from_checkpoints(base, rcnn=path, device="cpu")
    assert ex.cfg.mesh_detector == "rcnn"
    frames = torch.from_numpy(_frames(2, 3))
    want = pair[0].rcnn(torch.zeros(1, 64, 64, 3))
    got = ex.rcnn(torch.zeros(1, 64, 64, 3))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(ex.detect_stage(frames)["box"], pair[0].detect_stage(frames)["box"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataclasses.replace(weights["cfg"], param_dtype="bfloat16", matmul_precision="default")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dataclasses.replace(base, keep_all_frames=False)
    with pytest.raises(ValueError, match="mesh_detector"):
        dataclasses.replace(base, mesh_detector="dino")
    with pytest.raises(ValueError, match="does not have"):
        Extractor(base, state_dicts={"rcnn": weights["sds"]["rcnn"]}, device="cpu")
