"""``Extractor.process_video`` from raw frames at the default
``mesh_detector="yolox"``, on the CPU at a tiny geometry, against the JAX
package's ``Extractor.process_video_full`` on the same numpy weights: the
YOLOX detect stage (letterbox, detector, DWPose's postprocess, the mesh and
keypoint rules), then the ViT and SMPL head of
``tests/test_torch_extract_mesh.py``. Then the bf16 extraction mode with the
R-CNN against the port's own fp32 run."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import detector as jax_det
from video_gen_evals_tpu.models import smpl_head as jax_head
from video_gen_evals_tpu.models import vit as jax_vit
from video_gen_evals_tpu.pipelines import extract as jax_extract
from video_gen_evals_tpu_torch.models.detector import DetectorConfig
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
from test_torch_yolox import SMALL, megvii_state_dict

FRAME_BATCH = 4
H, W = 72, 112          # letterboxed by r = 64 / 112 to 41 x 64 on the 64 x 64 canvas
# the detector's boxes are about 13 pixels: a crop window 12x the box takes the
# anti-alias blur branch, whose crops are not rounded to integers, so a box
# that differs in its sixth digit between the frameworks cannot round a crop
# pixel to the other side (tests/test_torch_extract_mesh.py holds the
# rounded branch on exact boxes)
RESCALE = 12.0
THRESH = 0.45           # the mesh rule's det_score_thresh for these random weights
OUT_KEYS = ("pose", "betas", "global_orient", "vit")
# frames of the seeded pool (see _pool) by the number of person boxes above
# THRESH the detector finds in them: exactly one in 5, 9 and 12
KEPT_VIDEO = [5, 9, 12, 9, 5, 6]      # 5 of 6 single-person frames: kept at min_single_ratio 0.8
REJECTED_VIDEO = [0, 1, 5, 6, 11]     # 1 of 5: rejected


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool(n=24, seed=0):
    """Smooth seeded frames with uint8 noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, size=(n, 4, 5, 3)).astype(np.float32)
    big = np.repeat(np.repeat(coarse, H // 4, axis=1), W // 4 + 1, axis=2)[:, :, :W]
    return np.clip(big + rng.normal(0, 20, size=big.shape), 0, 255).astype(np.uint8)


def detector_state_dict(cfg):
    """Megvii-named seeded weights whose person scores depend on the frame:
    the norms' gains raised by 1.5 (so the signal reaches the head), the stem
    dividing raw pixels by 128, the box regression damped (boxes of about a
    stride), the person class's bias raised by 2 (so that class wins)."""
    sd = megvii_state_dict(cfg, seed=2)
    for k in sd:
        if k.endswith("bn.weight"):
            sd[k] = sd[k] + 1.5
    sd["backbone.backbone.stem.conv.bn.running_var"][:] = 128.0 ** 2
    for i in range(len(cfg.strides)):
        sd[f"head.reg_preds.{i}.weight"] *= 0.02
        sd[f"head.cls_preds.{i}.bias"][0] += 2.0
    return sd


@pytest.fixture(scope="module")
def pair():
    """The port's Extractor and the JAX one on the same numpy weights (JAX at
    matmul precision "highest", its stage jits compiled once for the module;
    the flag and the executables put back after it)."""
    before = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    rng = np.random.default_rng(13)
    jvit = jax_vit.ViTConfig(**TINY_VIT, attention_impl="xla")
    jhead = jax_head.SMPLHeadConfig(**TINY_HEAD)
    jdet = jax_det.DetectorConfig(**SMALL)
    vit_tree = init_tree(jax_vit.ViTBackbone(jvit), np.zeros((1, 64, 48, 3), np.float32), rng)
    head_tree = init_tree(jax_head.SMPLTokenDecoderHead(jhead), np.zeros((1, 12, 64), np.float32), rng)
    det = DetectorConfig(**SMALL)
    det_sd = detector_state_dict(det)
    cfg = ExtractorConfig(det=det, vit=ViTConfig(**TINY_VIT), head=SMPLHeadConfig(**TINY_HEAD),
                          frame_batch=FRAME_BATCH, vitdet_rescale=RESCALE, matmul_precision="highest",
                          det_score_thresh=THRESH)
    assert cfg.mesh_detector == "yolox" and cfg.keep_all_frames is False
    port = Extractor(cfg, device="cpu", state_dicts={
        "vit": vit_state_dict_from_jax_tree(vit_tree, cfg.vit),
        "head": head_state_dict_from_jax_tree(head_tree, cfg.head),
        "det": {k: torch.from_numpy(np.asarray(v)) for k, v in det_sd.items()}})
    jcfg = jax_extract.ExtractorConfig(det=jdet, vit=jvit, head=jhead, frame_batch=FRAME_BATCH,
                                       vitdet_rescale=RESCALE, matmul_precision="highest",
                                       det_score_thresh=THRESH)
    jex = jax_extract.Extractor(jcfg, params={"vit": vit_tree, "head": head_tree, "pose": {},
                                              "det": jax_det.yolox_to_flax(det_sd, jdet)})
    yield port, jex
    jax.config.update("jax_default_matmul_precision", before)
    jax.clear_caches()


def test_detect_stage_matches_jax(pair):
    """JAX's ``detect`` through its ``_batched`` (the 9 frames of the pool
    with some person box, two full chunks of 4 and a padded one): mesh and
    pose boxes within 1e-4 pixels, single and present equal. Frames with no
    person above THRESH take slot 0's box for the mesh (the tie-broken
    zero-score candidate), and frames with none above 0.3 the full frame
    for the pose. No score lies within 1e-4 of either threshold."""
    port, jex = pair
    frames = _pool()[[0, 5, 6, 9, 11, 12, 1, 2, 3]]
    want = jex._batched(lambda f: jex._detect(jex.params["det"], f, (np.float32(W), np.float32(H))),
                        jex._upload_frames(frames), batch=FRAME_BATCH)
    got = port.detect_stage(torch.from_numpy(frames))
    for key, w in zip(("box_mesh", "box_pose", "single", "present"), want):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=key)
    assert got["single"].tolist() == [False, True, False, True, False, True, False, False, False]
    assert (got["box_pose"][~got["present"]] == torch.tensor([0.0, 0.0, W, H])).all()
    with torch.no_grad():
        from video_gen_evals_tpu_torch.models.detector import dwpose_person_detections
        from video_gen_evals_tpu_torch.ops.upstream_crops import yolox_letterbox

        _, scores, person = dwpose_person_detections(port.detector(yolox_letterbox(
            torch.from_numpy(frames).float(), 64)[0]))
    s = scores[person]
    assert min((s - THRESH).abs().min().item(), (s - 0.3).abs().min().item()) > 1e-4


@pytest.mark.parametrize("video,keep_all_frames,kept", [
    (KEPT_VIDEO, False, [0, 1, 2, 3, 4]), (KEPT_VIDEO, True, [0, 1, 2, 3, 4, 5]),
    (REJECTED_VIDEO, False, None), (REJECTED_VIDEO, True, [0, 1, 2, 3, 4])])
def test_process_video_from_frames_matches_jax(pair, video, keep_all_frames, kept):
    """``process_video(frames)`` with no boxes at the default
    ``mesh_detector="yolox"`` against JAX's ``process_video_full``: the
    reference's rule keeps the single-person frames of a video where 5 of 6
    hold one person and rejects (None) one where 1 of 5 does;
    keep_all_frames keeps every frame of both. frame_idx equal, the mesh
    outputs within 1e-4."""
    port, jex = pair
    frames = _pool()[video]
    for c in (port.cfg, jex.cfg):
        c.keep_all_frames = keep_all_frames
    try:
        want, _ = jex.process_video_full(frames)
        got = port.process_video(frames)
    finally:
        for c in (port.cfg, jex.cfg):
            c.keep_all_frames = False
    assert (got is None) == (want is None) == (kept is None)
    if want is None:
        return
    np.testing.assert_array_equal(got["frame_idx"], kept)
    np.testing.assert_array_equal(got["frame_idx"], want["frame_idx"])
    for key in OUT_KEYS:
        assert got[key].dtype == np.float32
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("rcnn", ["exact", "fast"])
def test_bf16_mode_with_the_rcnn_against_fp32(rcnn):
    """The bf16 extraction mode with the R-CNN (bf16-rounded weights in the
    detectors, the ViT and the head, fp32 activations, each product's
    operands rounded to bf16; proposals, NMS and box decoding in fp32;
    fast()'s pyramid bf16, the exact one fp32) against the port's own fp32
    run on the same weights, at RCNNConfig.small() on the 9 frames of
    tests/test_torch_extract_rcnn.py (5 hold one person). The same frames
    hold one person in both runs but for at most two flips near the 0.5
    threshold. Where both keep one, it is the same person (IoU >= 0.5, as
    NMS would merge them), and the median box moves by at most 0.1 pixel
    (0.03 measured): the products' operands carry 2^-9 relative, and the boxes are 20 to 60
    pixels wide; a box may still swap with an overlapping candidate whose
    score it passes. The features stay finite and within 0.25 (0.16
    measured; they reach 7 here)."""
    from test_torch_extract_rcnn import _frames

    from video_gen_evals_tpu_torch.models.detector import box_iou

    rc = RCNNConfig.small() if rcnn == "exact" else dataclasses.replace(RCNNConfig.small(), roi_dtype="bfloat16",
                                                                        roi_window=32)
    sd = {k: torch.from_numpy(v) for k, v in seeded_state_dict(rc, seed=1).items()}
    sd["roi_heads.box_predictor.cls_score.bias"][0] += 2.0
    base = ExtractorConfig(vit=ViTConfig(**TINY_VIT), head=SMPLHeadConfig(**TINY_HEAD), frame_batch=FRAME_BATCH,
                           vitdet_rescale=RESCALE, matmul_precision="highest", mesh_detector="rcnn", rcnn=rc,
                           keep_all_frames=True)
    fp32 = Extractor(base, seed=3, device="cpu", state_dicts={"rcnn": sd})
    bf16 = Extractor(dataclasses.replace(base, matmul_precision="default", param_dtype="bfloat16"), seed=3,
                     device="cpu", state_dicts={"rcnn": sd})
    assert {t.dtype for net in (bf16.rcnn, bf16.detector) for t in net.state_dict().values()
            if t.is_floating_point()} == {torch.bfloat16}
    frames = _frames(1, 9)
    a, b = fp32.detect_stage(torch.from_numpy(frames)), bf16.detect_stage(torch.from_numpy(frames))
    assert b["box_mesh"].dtype == torch.float32 and torch.isfinite(b["box_mesh"]).all()
    both = a["single"] & b["single"]
    assert both.sum() >= 4 and (a["single"] != b["single"]).sum() <= 2
    iou = box_iou(a["box_mesh"][both][:, None], b["box_mesh"][both][:, None])[:, 0, 0]
    assert (iou >= 0.5).all()
    assert (a["box_mesh"][both] - b["box_mesh"][both]).abs().amax(-1).median().item() <= 0.1
    want, got = fp32.process_video(frames), bf16.process_video(frames)
    for key in OUT_KEYS:
        assert got[key].dtype == np.float32 and np.isfinite(got[key]).all(), key
    idx = both.numpy()
    assert np.abs(got["vit"][idx] - want["vit"][idx]).max() <= 0.25
