"""``pipelines/full.py::score_videos_end_to_end`` (frames -> extraction ->
in-memory bank -> encoder -> AC / TC, BASELINE config 4) on the CPU at a tiny
geometry, against the JAX package's on the same numpy weights: the extractor
pair of ``tests/test_torch_extract_keypoints.py`` (yolox mode, with the
keypoint branch) and a tiny scorer with the same seeded weights on both sides
(the module forward and the sliced gather in JAX, at "highest")."""

import numpy as np
import pytest
import torch

from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
from video_gen_evals_tpu.pipelines import full as jax_full
from video_gen_evals_tpu.pipelines import score as jax_score
from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.pipelines import full
from video_gen_evals_tpu_torch.pipelines.score import ScoreConfig

from test_torch_extract_keypoints import REJECTED_VIDEO, jax_flag, pair, weights  # noqa: F401  (fixtures)
from test_torch_extract_yolox import _pool

DIMS_RAW = {"vit": 32, "global": 9, "pose": 207, "beta": 10, "kp2d": 120}
DIMS_DIFF = {"vit": 32, "global": 3, "pose": 69, "beta": 10, "kp2d": 120}
LABELS = {"JumpingJack": 0, "PushUps": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite runs six workers on the host's cores, and
    more threads a worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _videos():
    """Three videos whose every frame holds one person (one of them of no
    known class) and one the single-person rule rejects."""
    pool = _pool()
    return {"GenX_JumpingJack_00": pool[[5, 9, 12] * 4], "GenX_PushUps_01": pool[[9, 12, 5, 12] * 3],
            "GenX_mystery_clip_02": pool[[12, 5, 9] * 4], "GenX_JumpingJack_03": pool[REJECTED_VIDEO]}


@pytest.fixture(scope="module")
def runs(pair):
    port_ex, jax_ex = pair
    pcfg = EncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=32, time_layers=1, time_heads=4)
    jcfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=32, time_layers=1, time_heads=4)
    model = HumanActionScorer(pcfg, generator=torch.Generator().manual_seed(3))
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in model.state_dict().items()}, jcfg, strict=True)
    centroids = np.random.default_rng(4).normal(size=(2, 32)).astype(np.float32)
    centroids /= np.linalg.norm(centroids, axis=-1, keepdims=True)
    videos = _videos()
    times = {}
    got = full.score_videos_end_to_end(port_ex, model, videos, centroids, LABELS, phase_times=times,
                                       cfg=ScoreConfig(clip_len=8, stride=8, batch_size=8, precision="highest"))
    want = jax_full.score_videos_end_to_end(
        jax_ex, JaxHumanActionScorer(jcfg), params, videos, centroids, LABELS,
        cfg=jax_score.ScoreConfig(clip_len=8, stride=8, batch_size=8, matmul_precision="highest",
                                  encoder_impl="module", gather_impl="sliced", bank_impl="host"))
    return got, want, times, (port_ex, model, centroids)


def test_scores_match_jax(runs):
    """AC and TC within 1e-4 of JAX's for every scored video, the rejected
    list equal, the class-less video scored by TC only, and the stats of the
    five modalities equal within float32 rounding."""
    got, want, times, _ = runs
    assert got.rejected == want.rejected == ["GenX_JumpingJack_03"]
    assert set(got.scores) == set(want.scores) == {"GenX_JumpingJack_00", "GenX_PushUps_01", "GenX_mystery_clip_02"}
    for name, s in got.scores.items():
        assert set(s) == set(want.scores[name]), name
        for k, v in s.items():
            assert np.isfinite(v)
            np.testing.assert_allclose(v, want.scores[name][k], rtol=0, atol=1e-4, err_msg=f"{name} {k}")
    assert "ac" not in got.scores["GenX_mystery_clip_02"]
    assert got.stats.modalities == want.stats.modalities == ["vit", "global", "pose", "beta", "kp2d"]
    for m in got.stats.modalities:
        for a, b in ((got.stats.mean_raw, want.stats.mean_raw), (got.stats.std_diff, want.stats.std_diff)):
            np.testing.assert_allclose(a[m], np.asarray(b[m]), rtol=1e-4, atol=1e-5, err_msg=m)
    assert set(times) == {"extract_s", "bank_s", "score_s"} and all(t >= 0 for t in times.values())


def test_refusals_and_empty_input(runs):
    """bank_impl="device" (the bank built where the extraction ran, from
    outputs left there) with the host run's stats scores every video within
    1e-4 of JAX's host run and rejects the same video (its float32 stream
    stats, the default without stats, are held against JAX's in
    tests/test_torch_bank_layer.py); an unknown bank_impl is refused; a call
    whose every video is rejected returns no scores; without keypoints the
    kp2d modality is not used."""
    got, want, _, (port_ex, model, centroids) = runs
    dev = full.score_videos_end_to_end(port_ex, model, _videos(), centroids, LABELS, stats=got.stats,
                                       bank_impl="device",
                                       cfg=ScoreConfig(clip_len=8, stride=8, batch_size=8, precision="highest"))
    assert dev.rejected == want.rejected and set(dev.scores) == set(want.scores)
    for name, s in dev.scores.items():
        assert set(s) == set(want.scores[name])
        for k, v in s.items():
            np.testing.assert_allclose(v, want.scores[name][k], rtol=0, atol=1e-4, err_msg=f"{name} {k}")
    with pytest.raises(ValueError, match="bank_impl"):
        full.score_videos_end_to_end(port_ex, model, {}, centroids, LABELS, bank_impl="tpu")
    empty = full.score_videos_end_to_end(port_ex, model, {"GenX_PushUps_09": _pool()[REJECTED_VIDEO]},
                                         centroids, LABELS)
    assert empty.scores == {} and empty.rejected == ["GenX_PushUps_09"]
    arrays = full.arrays_from_extraction(*port_ex.process_video_full(_videos()["GenX_PushUps_01"]))
    assert set(arrays) == {"vit", "global", "pose", "beta"}
