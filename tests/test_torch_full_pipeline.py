"""``pipelines/full.py::score_videos_end_to_end`` (frames -> extraction ->
in-memory bank -> encoder -> AC / TC, BASELINE config 4) on the CPU at a tiny
geometry, against the JAX package's on the same numpy weights: the extractor
pair of ``tests/test_torch_extract_keypoints.py`` (yolox mode, with the
keypoint branch) and a tiny scorer with the same seeded weights on both sides
(the module forward and the sliced gather in JAX, at "highest")."""

import contextlib

import numpy as np
import pytest
import torch

from video_gen_evals_tpu.data import features as jax_features
from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
from video_gen_evals_tpu.pipelines import full as jax_full
from video_gen_evals_tpu.pipelines import score as jax_score
from video_gen_evals_tpu_torch.data.features import compute_modality_diffs
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
    with _recorded(port_ex) as got_ex, _recorded(jax_ex) as want_ex:
        got = full.score_videos_end_to_end(port_ex, model, videos, centroids, LABELS, phase_times=times,
                                           cfg=ScoreConfig(clip_len=8, stride=8, batch_size=8, precision="highest"))
        want = jax_full.score_videos_end_to_end(
            jax_ex, JaxHumanActionScorer(jcfg), params, videos, centroids, LABELS,
            cfg=jax_score.ScoreConfig(clip_len=8, stride=8, batch_size=8, matmul_precision="highest",
                                      encoder_impl="module", gather_impl="sliced", bank_impl="host"))
    arrays = (_kept_arrays(got_ex, full.arrays_from_extraction, port_ex.cfg.kp_bug_compat),
              _kept_arrays(want_ex, jax_full.arrays_from_extraction, jax_ex.cfg.kp_bug_compat))
    return got, want, times, (port_ex, model, centroids), arrays


@contextlib.contextmanager
def _recorded(extractor):
    """Records what ``extractor.process_videos_streamed`` returns while the
    block runs: the (mesh_by_name, kp_by_name) each pipeline scored."""
    seen = []
    inner = extractor.process_videos_streamed

    def record(*args, **kw):
        out = inner(*args, **kw)
        seen.append(out)
        return out

    extractor.process_videos_streamed = record
    try:
        yield seen
    finally:
        del extractor.process_videos_streamed


def _kept_arrays(seen, arrays_from_extraction, kp_bug_compat):
    """name -> the per-modality arrays of each kept video of the one recorded
    extraction, as that package's pipeline builds them."""
    (mesh_by_name, kp_by_name), = seen
    return {n: {k: np.asarray(v) for k, v in arrays_from_extraction(mesh, kp_by_name[n], kp_bug_compat).items()}
            for n, mesh in mesh_by_name.items() if mesh is not None}


def _kabsch_branches(kp: np.ndarray):
    """``[T, 2K]`` keypoints -> ``(rank_one [T - 1], deltas [2, T - 1, 2K])``
    in float64: whether each consecutive pair's ``H = X^T Y`` is rank one to
    rounding (``|det H| <= KABSCH_TOL ||H||_F^2``), and the pair's delta under
    each branch of the closed form (``det H >= 0`` and ``< 0``), between
    which a rounding-level determinant's sign picks."""
    pts = kp.astype(np.float64).reshape(len(kp), -1, 2)
    pc = pts - pts.mean(axis=1, keepdims=True)
    pn = pc / np.maximum(np.sqrt((pc**2).sum(axis=(1, 2), keepdims=True)), 1e-6)
    X, Y = pn[:-1], pn[1:]
    H = np.einsum("tki,tkj->tij", X, Y)
    a, b, c, d = H[:, 0, 0], H[:, 0, 1], H[:, 1, 0], H[:, 1, 1]
    rank_one = np.abs(a * d - b * c) <= KABSCH_TOL * (H**2).sum(axis=(1, 2))
    deltas = []
    for ang in (np.arctan2(c - b, a + d), np.arctan2(c + b, a - d)):
        cos, sin = np.cos(ang), np.sin(ang)
        R = np.stack([np.stack([cos, sin], -1), np.stack([-sin, cos], -1)], -2)    # rot(-ang)
        deltas.append((Y - np.einsum("tki,tij->tkj", X, R)).reshape(len(X), -1))
    return rank_one, np.stack(deltas)


def _sin_near_pi(R: np.ndarray) -> np.ndarray:
    """``[T, J, 3, 3]`` rotations -> ``[J]``: the smallest ``sin θ`` of a
    consecutive turn ``R_{t-1}^T R_t`` past 90 degrees (1 where there is
    none), in float64."""
    R = R.astype(np.float64)
    rel = np.einsum("tjki,tjkl->tjil", R[:-1], R[1:])
    cos = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return np.where(cos < 0, np.sqrt(1.0 - cos**2), 1.0).min(axis=0, initial=1.0)


def _excused_joints(got_arrays, want_arrays, m):
    """``(sin_min, dR)`` per joint of rotation modality ``m`` over the kept
    videos: the smallest sin of a turn past 90 degrees in the port's own
    rotations, and the largest entry of |port - JAX| rotation."""
    sin_min, dR = None, None
    for n, arrays in got_arrays.items():
        R = arrays[m].reshape(arrays[m].shape[0], -1, 3, 3)
        Rj = want_arrays[n][m].reshape(R.shape)
        s, d = _sin_near_pi(R), np.abs(R.astype(np.float64) - Rj).max(axis=(0, 2, 3))
        sin_min, dR = (s, d) if sin_min is None else (np.minimum(sin_min, s), np.maximum(dR, d))
    return sin_min, dR


# A rotation modality's diff is the log map of R_{t-1}^T R_t, whose factor
# θ / (2 sin θ) is flat near θ = 0 but grows as 1 / sin θ near π. There the
# float32 rounding by which the two extractions' rotations differ (~2e-5 on a
# tiny seeded net) is amplified ~1 / sin θ in the delta and its std. A joint
# with a turn past 90 degrees whose sin is below SIN_TOL (within ~5.7 degrees
# of π) has its std_diff entries excused from the end-to-end rtol/atol and
# held to the first-order bound C · max|ΔR| / sin θ_min: an entry of
# R_{t-1}^T R_t moves by at most 2√3 max|ΔR| (unit columns), the skew part
# by twice that, a delta by at most π / (2 sin θ) times the skew part's
# change, and a std over frames by at most the largest delta's change.
SIN_TOL = 0.1
C_BOUND = 2.0 * np.sqrt(3.0) * np.pi
EXCUSED_MAX = 0.1          # of the rotation modalities' std_diff entries
# The tiny pose net puts every keypoint of a frame on one line, so kp2d's
# Kabsch problem H = X^T Y is rank one and the closed form's branch follows
# the sign of a determinant that is rounding noise: both branches are right,
# and the two packages' float32 arithmetic may pick differently on the same
# keypoints.
KABSCH_TOL = 1e-6


def test_scores_match_jax(runs):
    """AC and TC within 1e-4 of JAX's for every scored video, the rejected
    list equal and the class-less video scored by TC only. The stats: the
    port's stats pass on JAX's own extracted arrays equals JAX's within
    float32 rounding (where kp2d's Kabsch problem is rank one, see
    KABSCH_TOL, the port's row must be one of the two answers and JAX's
    feeds the stats); end to end, each package on its own extraction, every
    entry is held to the same tolerance except the std_diff entries of a
    rotation joint with a turn near π (see SIN_TOL), each held to its
    first-order bound, at most EXCUSED_MAX of them."""
    got, want, times, _, (got_arrays, want_arrays) = runs
    assert got.rejected == want.rejected == ["GenX_JumpingJack_03"]
    assert set(got.scores) == set(want.scores) == {"GenX_JumpingJack_00", "GenX_PushUps_01", "GenX_mystery_clip_02"}
    for name, s in got.scores.items():
        assert set(s) == set(want.scores[name]), name
        for k, v in s.items():
            assert np.isfinite(v)
            np.testing.assert_allclose(v, want.scores[name][k], rtol=0, atol=1e-4, err_msg=f"{name} {k}")
    assert "ac" not in got.scores["GenX_mystery_clip_02"]
    assert got.stats.modalities == want.stats.modalities == ["vit", "global", "pose", "beta", "kp2d"]
    assert set(got_arrays) == set(want_arrays) == set(got.scores)
    # same inputs: the port's stats pass over JAX's arrays, as JAX's pipeline keeps them
    common = set.intersection(*(set(a) for a in want_arrays.values()))
    kept = [{m: a[m] for m in a if m in common} for a in want_arrays.values()]
    diffs, n_pairs, n_rank_one = [], 0, 0
    for arrays in kept:
        d = compute_modality_diffs(arrays)
        rank_one, branches = _kabsch_branches(arrays["kp2d"])
        jax_kp = np.asarray(jax_features.compute_modality_diffs({"kp2d": arrays["kp2d"]})["kp2d"])
        np.testing.assert_allclose(d["kp2d"][1:][~rank_one], jax_kp[1:][~rank_one], rtol=1e-4, atol=1e-5)
        # a rank-one pair: the port's row is one of the two answers; JAX's pick feeds the stats
        err = np.abs(d["kp2d"][1:][rank_one][None] - branches[:, rank_one]).max(axis=-1).min(axis=0)
        np.testing.assert_array_less(err, 1e-5, err_msg="kp2d rank-one pair")
        d["kp2d"][1:][rank_one] = jax_kp[1:][rank_one]
        diffs.append(d)
        n_pairs, n_rank_one = n_pairs + rank_one.size, n_rank_one + int(rank_one.sum())
    print(f"{n_rank_one} of {n_pairs} kp2d frame pairs rank one (either Kabsch branch is right)")
    same = full.stats_from_arrays(kept, diffs_list=diffs)
    for m in want.stats.modalities:
        for a, b in ((same.mean_raw, want.stats.mean_raw), (same.std_diff, want.stats.std_diff)):
            np.testing.assert_allclose(a[m], np.asarray(b[m]), rtol=1e-4, atol=1e-5, err_msg=f"same inputs {m}")
    # end to end, each side on its own extraction
    n_rot = n_excused = 0
    for m in got.stats.modalities:
        np.testing.assert_allclose(got.stats.mean_raw[m], np.asarray(want.stats.mean_raw[m]), rtol=1e-4, atol=1e-5,
                                   err_msg=m)
        g, w = got.stats.std_diff[m], np.asarray(want.stats.std_diff[m])
        held = np.ones(g.shape, bool)
        if m in ("global", "pose"):
            sin_min, dR = _excused_joints(got_arrays, want_arrays, m)
            near_pi = np.repeat(sin_min < SIN_TOL, 3)
            bound = np.repeat(C_BOUND * dR / sin_min, 3)
            np.testing.assert_array_less(np.abs(g - w)[near_pi], bound[near_pi], err_msg=f"{m} excused")
            held, n_rot, n_excused = ~near_pi, n_rot + g.size, n_excused + int(near_pi.sum())
        np.testing.assert_allclose(g[held], w[held], rtol=1e-4, atol=1e-5, err_msg=m)
    print(f"{n_excused} of {n_rot} rotation std_diff entries excused as turns near pi")
    assert n_excused <= EXCUSED_MAX * n_rot
    assert set(times) == {"extract_s", "bank_s", "score_s"} and all(t >= 0 for t in times.values())


def test_refusals_and_empty_input(runs):
    """bank_impl="device" (the bank built where the extraction ran, from
    outputs left there) with the host run's stats scores every video within
    1e-4 of JAX's host run and rejects the same video (its float32 stream
    stats, the default without stats, are held against JAX's in
    tests/test_torch_bank_layer.py); an unknown bank_impl is refused; a call
    whose every video is rejected returns no scores; without keypoints the
    kp2d modality is not used."""
    got, want, _, (port_ex, model, centroids), _ = runs
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
