"""The legacy preprocessing (``ExtractorConfig.preproc="legacy"``) on the CPU
against the JAX package on the same numpy weights.

- The crops: ``crop_resize`` (4-tap gathers), ``crop_resize_matmul`` and
  ``batched_person_crops`` (both ``impl``s, scaled or not, normalised or
  not) against JAX's vmapped functions on seeded frames and boxes, with
  boxes beyond the frame, degenerate boxes and boxes at the output's exact
  aspect (where the aspect expansion's ``>`` and ``>=`` both act). Within
  1e-4 in 0-255 units. JAX runs them op by op here, as written: under
  ``jit`` XLA rewrites ``h / oh`` as ``h * (1 / oh)`` and fuses the sample
  coordinate's multiply-add, which moves a coordinate by an ulp, and on
  uniform-noise frames (neighbours 255 apart) an ulp of a coordinate is
  ~1e-3 of a pixel value. The extraction tests below run JAX's jitted
  stages on smooth frames.
- The legacy stages on one chunk (``detect_yolox``'s stretched ImageNet
  canvas and ``person_detections``, ``mesh_forward``, ``pose_forward`` with
  its inverse crop map) against JAX's jitted stages, then
  ``process_video_full(with_keypoints=True)`` on a kept and a rejected video
  against JAX's, in ``tests/test_torch_extract_keypoints.py``'s geometry and
  tolerances (JAX at matmul precision "highest"; a keypoint is compared only
  where it is no near tie).

The calibrated small YOLOX of those tests divides raw pixels by 128 in its
stem; the legacy canvas is ImageNet-normalised (pixels / ~57), so the stem's
norm is set to divide by 128 / 57 here, and the mesh rule's threshold is
set where this pool's frames hold zero, one and several persons."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import detector as jax_det
from video_gen_evals_tpu.ops import image as jax_image
from video_gen_evals_tpu.pipelines import extract as jax_extract
from video_gen_evals_tpu_torch.models.pose2d import wholebody_to_openpose
from video_gen_evals_tpu_torch.ops import image
from video_gen_evals_tpu_torch.pipelines.extract import Extractor

from test_torch_extract_keypoints import LOGIT_TOL, assert_kp_match, assert_mesh_match, jax_flag, weights  # noqa: F401
from test_torch_extract_yolox import _pool

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)
CROP_TOL = 1e-4                  # 0-255 units
STEM_VAR = 5.0                   # (128 / 57.2) ** 2: the stem's scale for normalised input
LEGACY_THRESH = 0.955            # the mesh (and keypoint) rule's score threshold
# frames of the pool by the number of person boxes above LEGACY_THRESH on the
# legacy canvas: one in 15, 19 and 21, none in 2 and 3, several in 0 and 5
KEPT_VIDEO = [15, 19, 21, 2, 15, 19, 21, 15, 19, 0]    # 8 of 10 single: kept, frame 3 no person
REJECTED_VIDEO = [0, 2, 15, 3, 5]                      # 1 of 5: rejected


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the crops


def _frames_and_boxes(out_hw, n=8, hw=(40, 56), seed=3):
    """Seeded float frames and xyxy boxes: inside, across every border,
    beyond the frame, of zero width and zero height, and at ``out_hw``'s
    exact aspect."""
    rng = np.random.default_rng(seed)
    H, W = hw
    frames = rng.uniform(0, 255, size=(n, H, W, 3)).astype(np.float32)
    oh, ow = out_hw
    boxes = np.array([
        [10.3, 5.7, 30.2, 33.9],           # inside
        [-12.5, -8.25, 20.0, 18.0],         # across the top-left corner
        [40.0, 25.0, 75.5, 61.0],           # across the bottom-right corner
        [-30.0, -20.0, -5.0, -2.0],         # wholly above and left of the frame
        [12.0, 10.0, 12.0, 30.0],           # zero width
        [5.0, 14.0, 25.0, 14.0],            # zero height
        [3.0, 4.0, 3.0 + ow, 4.0 + oh],     # exactly the output's aspect
        [7.5, 2.0, 7.5 + 2 * ow, 2.0 + 2 * oh],
    ], np.float32)
    return frames, boxes


def _cxcywh(boxes):
    return np.stack([(boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2,
                     boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], axis=1).astype(np.float32)


@pytest.mark.parametrize("out_hw", [(32, 24), (30, 20)])
def test_crops_match_jax(out_hw):
    """``crop_resize``, ``crop_resize_matmul`` and ``batched_person_crops``
    (matmul and gather; scale 1, and scale 1.2 with the ImageNet
    normalisation) within 1e-4 in 0-255 units of JAX's; the two crop forms
    agree with each other too. (30, 20)'s aspect 2/3 is not exact in fp32,
    so its tie boxes take both branches' roundings."""
    frames, boxes = _frames_and_boxes(out_hw)
    fr, bx = torch.from_numpy(frames), torch.from_numpy(boxes)
    cxcywh = _cxcywh(boxes)
    for name, fn in (("crop_resize", image.crop_resize), ("crop_resize_matmul", image.crop_resize_matmul)):
        jfn = jax.vmap(lambda im, b, f=getattr(jax_image, name): f(im, b, out_hw))
        want = np.asarray(jfn(jnp.asarray(frames), jnp.asarray(cxcywh)))
        got = fn(fr, torch.from_numpy(cxcywh), out_hw).numpy()
        assert got.shape == (len(frames), *out_hw, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=CROP_TOL, err_msg=name)
    np.testing.assert_allclose(image.crop_resize(fr, torch.from_numpy(cxcywh), out_hw).numpy(),
                               image.crop_resize_matmul(fr, torch.from_numpy(cxcywh), out_hw).numpy(),
                               rtol=0, atol=CROP_TOL)
    for impl in ("matmul", "gather"):
        for scale, norm in ((1.0, False), (1.2, True)):
            kw = dict(out_hw=out_hw, scale=scale, impl=impl)
            jkw = dict(kw, mean=jnp.asarray(MEAN), std=jnp.asarray(STD)) if norm else kw
            pkw = dict(kw, mean=torch.from_numpy(MEAN), std=torch.from_numpy(STD)) if norm else kw
            want = np.asarray(jax_image.batched_person_crops(jnp.asarray(frames), jnp.asarray(boxes), **jkw))
            got = image.batched_person_crops(fr, bx, **pkw).numpy()
            units = STD if norm else np.ones(3, np.float32)
            np.testing.assert_allclose(got * units, want * units, rtol=0, atol=CROP_TOL,
                                       err_msg=f"{impl} scale {scale} norm {norm}")
    with pytest.raises(ValueError, match="impl"):
        image.batched_person_crops(fr, bx, impl="nearest")


# ---------------------------------------------------------------------------
# the legacy extraction


@pytest.fixture(scope="module")
def legacy_pair(weights, jax_flag):
    """The legacy-mode port Extractor and the JAX one on the keypoint tests'
    weights, the detector's stem set for the normalised canvas."""
    det_sd = {k: v.numpy().copy() for k, v in weights["sds"]["det"].items()}
    det_sd["backbone.backbone.stem.conv.bn.running_var"][:] = STEM_VAR
    knobs = dict(preproc="legacy", det_score_thresh=LEGACY_THRESH)
    cfg = dataclasses.replace(weights["cfg"], **knobs)
    sds = dict(weights["sds"], det={k: torch.from_numpy(v) for k, v in det_sd.items()})
    jcfg = dataclasses.replace(weights["jcfg"], **knobs)
    params = dict(weights["trees"], det=jax_det.yolox_to_flax(det_sd, jcfg.det))
    return Extractor(cfg, state_dicts=sds, device="cpu"), jax_extract.Extractor(jcfg, params=params)


def legacy_clear(port: Extractor, frames: torch.Tensor, box_pose: torch.Tensor) -> torch.Tensor:
    """``[B, 134]``: the keypoints that are no near tie (both SimCC axes'
    top-two gaps and the score's distance from 0.3 above LOGIT_TOL of the
    logits' scale), on the port's own legacy pose crops and logits, in
    openpose's order (tests/test_torch_extract_keypoints.py's rule)."""
    with torch.no_grad():
        crops = port._legacy_crops(frames, box_pose, port.cfg.pose.input_hw)
        lx, ly = port.pose_net.logits(crops)
    tol = LOGIT_TOL * max(1.0, lx.abs().max().item(), ly.abs().max().item())
    gap = [torch.topk(a, 2, dim=-1).values for a in (lx, ly)]
    score = torch.minimum(gap[0][..., 0], gap[1][..., 0])
    clear = ((gap[0][..., 0] - gap[0][..., 1] > tol) & (gap[1][..., 0] - gap[1][..., 1] > tol)
             & ((score - 0.3).abs() > tol) & (score.abs() > tol))
    _, c134 = wholebody_to_openpose(torch.zeros(*clear.shape, 2), clear.float())
    return c134 > 0.5


def _kp120_clear(clear134: torch.Tensor) -> np.ndarray:
    rows = torch.cat([clear134[:, :18], clear134[:, 92:134]], dim=1)
    return rows.repeat_interleave(2, dim=1).numpy()


def test_legacy_stages_match_jax(legacy_pair):
    """One chunk of the kept video through the legacy stages: the detect
    stage's masks equal and its boxes within 1e-4 of JAX's (the pose box
    where a person is present; no full-frame fallback in legacy), the mesh
    forward within 1e-4, the pose forward's keypoints and scores within 1e-4
    where no near tie."""
    port, jex = legacy_pair
    frames = _pool()[KEPT_VIDEO[:4]]
    fr = torch.from_numpy(frames)
    H, W = frames.shape[1:3]
    det = port.detect_yolox(fr)
    want = jex._detect(jex.params["det"], jnp.asarray(frames, jnp.float32), (jnp.float32(W), jnp.float32(H)))
    box_mesh, box_pose, single, present = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(det["single"].numpy(), single)
    np.testing.assert_array_equal(det["present"].numpy(), present)
    assert single.tolist() == [True, True, True, False] and present.tolist() == [True, True, True, False]
    np.testing.assert_allclose(det["box_mesh"].numpy()[single], box_mesh[single], rtol=0, atol=1e-4)
    np.testing.assert_allclose(det["box_pose"].numpy()[present], box_pose[present], rtol=0, atol=1e-4)

    boxes = det["box_mesh"]
    got = port.mesh_forward(fr, boxes)
    mesh = jex._mesh_forward(jex.params["vit"], jex.params["head"], jnp.asarray(frames, jnp.float32),
                             jnp.asarray(boxes.numpy()))
    for k in ("body_pose", "betas", "global_orient", "token_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(mesh[k]), rtol=0, atol=1e-4, err_msg=k)

    kp = port.pose_forward(fr, det["box_pose"])
    kps, scores = jex._pose_forward(jex.params["pose"], jnp.asarray(frames, jnp.float32),
                                    jnp.asarray(det["box_pose"].numpy()), (jnp.float32(W), jnp.float32(H)))
    clear = legacy_clear(port, fr, det["box_pose"]).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_allclose(kp["kps"].numpy()[clear], np.asarray(kps)[clear], rtol=0, atol=1e-4)
    np.testing.assert_allclose(kp["scores"].numpy()[clear], np.asarray(scores)[clear], rtol=0, atol=1e-4)


@pytest.mark.parametrize("video", ["kept", "rejected"])
def test_legacy_process_video_full_matches_jax(legacy_pair, video):
    """``process_video_full(with_keypoints=True)`` in the legacy mode: the
    kept video's mesh frames and arrays and its keypoints, whose frame with
    no person is dropped (``valid & present``, as JAX's legacy rule), within
    the keypoint tests' tolerances; (None, None) for the rejected one."""
    port, jex = legacy_pair
    frames = _pool()[KEPT_VIDEO if video == "kept" else REJECTED_VIDEO]
    got = port.process_video_full(frames, with_keypoints=True)
    want = jex.process_video_full(frames, with_keypoints=True)
    assert_mesh_match(got[0], want[0], f"legacy {video} mesh")
    assert (got[1] is None) == (want[1] is None) == (got[0] is None) == (video == "rejected")
    if got[1] is None:
        return
    assert got[0]["frame_idx"].tolist() == [0, 1, 2, 4, 5, 6, 7, 8]
    assert not got[1]["valid"][3] and got[1]["valid"][[0, 1, 2]].all()
    fr = torch.from_numpy(frames)
    clear = _kp120_clear(legacy_clear(port, fr, port.detect_stage(fr, with_keypoints=True)["box_pose"]))
    assert_kp_match(got[1], want[1], clear, f"legacy {video} kp")
