"""The port's scoring slice against the JAX package on the CPU: manifests,
stats, bank, finalize, and ``score_generated`` end to end on the fixture tree
of ``tests/test_score_pipeline.py``, checked with ``scripts/compare_scores.py``.
Also: the port never imports jax (a subprocess, since conftest imports it)."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu import data as jax_data
from video_gen_evals_tpu.metrics import scores as jax_scores
from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
from video_gen_evals_tpu.pipelines import score as jax_score

from video_gen_evals_tpu_torch import data
from video_gen_evals_tpu_torch.data.fixtures import make_fixture_tree, write_keypoints, write_mesh_npz
from video_gen_evals_tpu_torch.metrics import scores
from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.pipelines import score

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import compare_scores  # noqa: E402

CLASSES = ["JumpingJack", "PushUps"]
DIMS_RAW = {"vit": 64, "global": 9, "pose": 207, "beta": 10, "kp2d": 120}
DIMS_DIFF = {"vit": 64, "global": 3, "pose": 69, "beta": 10, "kp2d": 120}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(_one_thread, tmp_path_factory):
    """The tree of tests/test_score_pipeline.py: 2 classes x 4 real videos,
    6 generated videos with class-coded names, human scores."""
    root = tmp_path_factory.mktemp("torch_e2e")
    mesh_root, kp_root = make_fixture_tree(
        str(root), CLASSES, videos_per_class=4, frames=(40, 36, 25, 44), seed=3
    )
    gen_dir = str(root / "generated_meshes")
    gen_kp = str(root / "generated_kps")
    rng = np.random.default_rng(7)
    names = []
    for i, cls in enumerate(CLASSES * 3):
        stem = f"GenModel{i % 2}_{cls}_{i:02d}_hash{i}"
        write_mesh_npz(os.path.join(gen_dir, f"{stem}.npz"), 38, 64, rng)
        write_keypoints(os.path.join(gen_kp, stem, "keypoints.npy"), 38, rng)
        names.append(stem)
    human = {f"{n}.mp4": {"ac": float(i), "tc": float(-i)} for i, n in enumerate(names)}
    human_path = str(root / "human.json")
    with open(human_path, "w") as f:
        json.dump(human, f)
    return root, mesh_root, kp_root, gen_dir, gen_kp, human_path, names


def _real_paths(kp_root):
    return data.ModalityPaths(keypoint_dir=kp_root, layout="real")


def test_manifests_and_windows_match_jax(env):
    """The copied host modules give the same manifests, split and windows."""
    _root, mesh_root, _kp, gen_dir, *_ = env
    real_j, real_p = jax_data.scan_class_tree(mesh_root), data.scan_class_tree(mesh_root)
    assert [vars(i) for i in real_p.items] == [vars(i) for i in real_j.items]
    gen_j, gen_p = jax_data.scan_generated_flat(gen_dir), data.scan_generated_flat(gen_dir)
    assert [vars(i) for i in gen_p.items] == [vars(i) for i in gen_j.items]
    for (tj, ej), (tp, ep) in [(jax_data.train_test_split(real_j, 0.8, seed=1337),
                                data.train_test_split(real_p, 0.8, seed=1337))]:
        assert [i.name for i in tp.items] == [i.name for i in tj.items]
        assert [i.name for i in ep.items] == [i.name for i in ej.items]
    assert data.enumerate_windows(gen_p, 16, 8) == jax_data.enumerate_windows(gen_j, 16, 8)


def test_finalize_matches_jax(rng):
    """tc_per_window / finalize_* at atol 1e-6, NaN centroid for an empty class."""
    fe = rng.normal(size=(6, 17, 8)).astype(np.float32)
    fe /= np.linalg.norm(fe, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        scores.tc_per_window(torch.from_numpy(fe)).numpy(),
        np.asarray(jax_scores.tc_per_window(jnp.asarray(fe))), atol=1e-6)
    seq_sum = rng.normal(size=(3, 8)).astype(np.float32)
    count = np.array([2.0, 0.0, 5.0], np.float32)
    cen_p = scores.finalize_centroids(torch.from_numpy(seq_sum), torch.from_numpy(count)).numpy()
    cen_j = np.asarray(jax_scores.finalize_centroids(jnp.asarray(seq_sum), jnp.asarray(count)))
    assert np.all(np.isnan(cen_p[1])) and np.all(np.isnan(cen_j[1]))
    np.testing.assert_allclose(cen_p[[0, 2]], cen_j[[0, 2]], atol=1e-6)
    vsum = rng.normal(size=(4, 8)).astype(np.float32)
    tsum = rng.uniform(size=4).astype(np.float32)
    vcnt = np.array([1.0, 3.0, 2.0, 4.0], np.float32)
    label = np.array([0, 2, 2, 0], np.int32)
    got = scores.finalize_video_scores(*(torch.from_numpy(a) for a in (vsum, tsum, vcnt, label, cen_p)))
    want = jax_scores.finalize_video_scores(*(jnp.asarray(a) for a in (vsum, tsum, vcnt, label, cen_j)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_metrics_from_window_embeddings_match_jax(rng, masked):
    """segment_mean, build_centroids, video_tc_scores and video_ac_scores at
    atol 1e-6 on the same per-window values: 4 classes, the third with no
    windows (a NaN centroid on both sides), 5 videos, the fourth with one
    window; ``masked`` adds a 0/1 weights mask that drops windows, all of
    video 1's among them (its mean is 0 over a clamped count on both sides)."""
    n, d = 23, 8
    seq = rng.normal(size=(n, d)).astype(np.float32)
    seq /= np.linalg.norm(seq, axis=-1, keepdims=True)
    tc = rng.uniform(size=n).astype(np.float32)
    labels = rng.choice([0, 1, 3], size=n).astype(np.int32)
    video = np.sort(rng.choice([0, 1, 2, 4], size=n - 1)).astype(np.int32)
    video = np.insert(video, rng.integers(n), 3)   # video 3: one window
    video_label = np.array([0, 3, 2, 1, 0], np.int32)   # video 2's class has no centroid
    weights = None
    if masked:
        weights = (rng.uniform(size=n) > 0.3).astype(np.float32)
        weights[video == 1] = 0.0
        weights[video == 3] = 1.0
    P = lambda a: None if a is None else torch.from_numpy(a)   # noqa: E731
    J = lambda a: None if a is None else jnp.asarray(a)        # noqa: E731

    got = scores.segment_mean(P(seq), P(video), 5, P(weights)).numpy()
    want = np.asarray(jax_scores.segment_mean(J(seq), J(video), 5, J(weights)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    cen_p, cnt_p = scores.build_centroids(P(seq), P(labels), 4, P(weights))
    cen_j, cnt_j = jax_scores.build_centroids(J(seq), J(labels), 4, J(weights))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_j))
    assert cnt_p[2] == 0 and np.all(np.isnan(cen_p[2].numpy())) and np.all(np.isnan(np.asarray(cen_j)[2]))
    np.testing.assert_allclose(cen_p.numpy(), np.asarray(cen_j), atol=1e-6)   # NaNs compare equal
    tc_p = scores.video_tc_scores(P(tc), P(video), 5, P(weights)).numpy()
    np.testing.assert_allclose(tc_p, np.asarray(jax_scores.video_tc_scores(J(tc), J(video), 5, J(weights))),
                               atol=1e-6)
    ac_p = scores.video_ac_scores(P(seq), P(video), P(video_label), cen_p, P(weights)).numpy()
    ac_j = np.asarray(jax_scores.video_ac_scores(J(seq), J(video), J(video_label), cen_j, J(weights)))
    assert np.isnan(ac_p[2]) and np.isnan(ac_j[2]) and np.all(np.isfinite(ac_p[[0, 1, 3, 4]]))
    np.testing.assert_allclose(ac_p, ac_j, atol=1e-6)


def _models(seed, d_model=32, layers=1, heads=4):
    """The same seeded weights for both packages."""
    pcfg = EncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=d_model, time_layers=layers,
                                time_heads=heads)
    jcfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=d_model, time_layers=layers,
                                   time_heads=heads)
    port = HumanActionScorer(pcfg, generator=torch.Generator().manual_seed(seed))
    params = torch_state_dict_to_flax(
        {k: v.numpy() for k, v in port.state_dict().items()}, jcfg, strict=True)
    return port, JaxHumanActionScorer(jcfg), params


@pytest.fixture(scope="module")
def jax_run(_one_thread, env, tmp_path_factory):
    """The JAX slice, run once: stats of the real train split, the JAX
    score_generated (module forward, sliced gather, f32) with the weights
    of :func:`_models`, and the train split's bank. The JAX CPU backend compiles for tens of seconds
    here, so the tests below share this one run."""
    _root, mesh_root, kp_root, gen_dir, gen_kp, human_path, _names = env
    _port, jax_model, params = _models(seed=0)
    train = jax_data.train_test_split(jax_data.scan_class_tree(mesh_root), 0.8, seed=1337)[0]
    jpaths = jax_data.ModalityPaths(keypoint_dir=kp_root, layout="real")
    out_json = str(tmp_path_factory.mktemp("jax_scores") / "jax.json")
    # XLA's CPU compiles dominate this run; its optimization passes do not
    # change what an f32 program computes beyond rounding, so they are off
    # while it runs. Afterwards the flag is restored and every executable
    # compiled under it is dropped, so later tests in this process compile
    # their own.
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        stats = jax_data.compute_stats(train.items, jpaths)
        result = jax_score.score_generated(
            jax_model, params, gen_dir, mesh_root, real_paths=jpaths,
            gen_paths=jax_data.ModalityPaths(keypoint_dir=gen_kp, layout="generated"),
            cfg=jax_score.ScoreConfig(clip_len=16, stride=8, batch_size=16,
                                      matmul_precision="highest", encoder_impl="module",
                                      gather_impl="sliced"),
            human_scores_path=human_path, output_json=out_json, stats=stats,
        )
        bank = jax_data.build_feature_bank(train.items, jpaths, stats, min_rows=24)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()
    return train.items, stats, bank, result


def test_stats_and_bank_match_jax(env, jax_run):
    """Stats within rtol 1e-5 (float64 sums of float32 diffs from two
    libraries); the bank within atol 1e-4 (normalized features); layout
    metadata exactly."""
    _root, _mesh_root, kp_root, *_ = env
    items, st_j, bank_j, _result = jax_run
    st_p = data.compute_stats(items, _real_paths(kp_root))
    assert st_p.modalities == st_j.modalities
    for kind in ("mean_raw", "std_raw", "mean_diff", "std_diff"):
        for m in st_j.modalities:
            np.testing.assert_allclose(
                getattr(st_p, kind)[m], getattr(st_j, kind)[m], rtol=1e-5, atol=1e-6,
                err_msg=f"{kind}/{m}")
    bank_p = data.build_feature_bank(items, _real_paths(kp_root), st_j, min_rows=24)
    np.testing.assert_array_equal(bank_p.offsets, bank_j.offsets)
    np.testing.assert_array_equal(bank_p.row_limit, bank_j.row_limit)
    np.testing.assert_array_equal(bank_p.z0_diff, bank_j.z0_diff)
    assert bank_p.one_pass_raw == bank_j.one_pass_raw
    np.testing.assert_allclose(bank_p.bank, bank_j.bank, atol=1e-4)
    with pytest.raises(ValueError, match="clip_len"):
        bank_p.validate_clip_len(int(bank_p.row_limit.min()) + 2)


def test_score_generated_matches_jax(env, jax_run, tmp_path):
    """The whole slice on the CPU: the port's score_generated (its own stats,
    bank, K1/K3 plain versions at "highest") against the JAX run, with one
    set of weights: every video's AC and TC within 1e-4."""
    _root, mesh_root, kp_root, gen_dir, gen_kp, human_path, names = env
    *_, want = jax_run
    port, _jm, _params = _models(seed=0)
    port_json = str(tmp_path / "port.json")
    got = score.score_generated(
        port, gen_dir, mesh_root, _real_paths(kp_root),
        data.ModalityPaths(keypoint_dir=gen_kp, layout="generated"),
        cfg=score.ScoreConfig(clip_len=16, stride=8, batch_size=16, precision="highest"),
        human_scores_path=human_path, output_json=port_json, device="cpu",
    )
    assert sorted(got["scores"]) == sorted(names)
    assert all("ac" in v and "tc" in v for v in got["scores"].values())
    assert compare_scores.main([port_json, want["output_json"], "--tol", "1e-4"]) == 0
    assert got["ac_corr"]["n"] == want["ac_corr"]["n"] == len(names)
    np.testing.assert_allclose(got["ac_corr"]["spearman"], want["ac_corr"]["spearman"], atol=1e-9)


def test_score_generated_data_parallel_and_host_shards_match_jax(env, jax_run, tmp_path):
    """``score_generated`` over a 2-rank gloo group (ranks spawned by
    ``launch_local``, one torch thread each) and over 2 host shards joined by
    ``merge_scores``, against the JAX run at test_score_generated_matches_jax's
    1e-4: the sweeps' batches split over the ranks, the segment sums summed
    over them; rank 0 alone writes the output; each host writes its
    ``.host<I>of2`` shard with no correlations."""
    from video_gen_evals_tpu_torch.parallel import launch_local
    from video_gen_evals_tpu_torch.pipelines import merge_scores

    from test_torch_parallel import _score_rank

    _root, mesh_root, kp_root, gen_dir, gen_kp, human_path, _names = env
    *_, want = jax_run
    port, _jm, _params = _models(seed=0)
    cfg = score.ScoreConfig(clip_len=16, stride=8, batch_size=16, precision="highest")
    gen_paths = data.ModalityPaths(keypoint_dir=gen_kp, layout="generated")
    enc_kw = dict(dims_map_raw=DIMS_RAW, dims_map_diff=DIMS_DIFF, d_model=32, time_layers=1, time_heads=4)
    ranked = str(tmp_path / "ranked.json")
    ranks = launch_local(2, _score_rank, port.state_dict(), enc_kw, gen_dir, mesh_root, _real_paths(kp_root),
                         gen_paths, cfg, ranked, device="cpu", timeout=120)
    assert ranks[0]["scores"] == ranks[1]["scores"] and all(r["jax"] == [] for r in ranks)
    assert compare_scores.main([ranked, want["output_json"], "--tol", "1e-4"]) == 0
    scanned = [os.path.splitext(it.name)[0] for it in data.scan_generated_flat(gen_dir).items]
    shards = []
    for h in range(2):
        got = score.score_generated(port, gen_dir, mesh_root, _real_paths(kp_root), gen_paths, cfg=cfg,
                                    human_scores_path=human_path, output_json=str(tmp_path / "hosts.json"),
                                    device="cpu", num_hosts=2, host_id=h)
        assert got["output_json"] == str(tmp_path / f"hosts.host{h}of2.json") and "ac_corr" not in got
        assert sorted(got["scores"]) == sorted(scanned[h::2])
        shards.append(got["output_json"])
    merged = str(tmp_path / "merged.json")
    merge_scores.main(shards + ["--output", merged])
    assert compare_scores.main([merged, want["output_json"], "--tol", "1e-4"]) == 0


def test_window_encoder_masks_the_padded_tail(env):
    """Segment sums do not depend on the batch size (pad + mask), and counts
    are the window counts."""
    _root, mesh_root, kp_root, *_ = env
    items = data.scan_class_tree(mesh_root).items
    paths = _real_paths(kp_root)
    stats = data.compute_stats(items, paths)
    bank = data.build_feature_bank(items, paths, stats, min_rows=24)
    windows = data.enumerate_windows(data.VideoManifest(items), 16, 8)
    seg = [v for v, _s in windows]
    port, _jm, _p = _models(seed=1)
    outs = []
    for bs in (7, 64):
        enc = score.WindowEncoder(port, bs, 16, precision="high", device="cpu")
        outs.append(enc.encode_bank_segsum(bank, windows, seg, len(items)))
    np.testing.assert_array_equal(outs[0][2], np.bincount(seg, minlength=len(items)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=1e-5)
    with pytest.raises(ValueError, match="entries for"):
        enc.encode_bank_segsum(bank, windows, seg[:-1], len(items))


def test_score_cli_runs_on_cpu_from_a_reference_checkpoint(env, tmp_path):
    """The CLI builds the model from the stats' dims, loads a reference-layout
    ``.pt`` strictly (--no-bug-compat), and writes every generated video."""
    _root, mesh_root, kp_root, gen_dir, gen_kp, _human, names = env
    port, _jm, _p = _models(seed=2, d_model=256, layers=4, heads=8)
    ckpt = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": port.state_dict()}, ckpt)
    out = str(tmp_path / "scores.json")
    score.main([
        "--generated-meshes", gen_dir, "--real-meshes", mesh_root, "--checkpoint", ckpt,
        "--real-kp-dir", kp_root, "--gen-kp-dir", gen_kp, "--clip-len", "16",
        "--batch-size", "32", "--output", out, "--no-bug-compat", "--precision", "highest",
        "--device", "cpu",
    ])
    with open(out) as f:
        got = json.load(f)
    assert sorted(got) == sorted(names)
    assert all(np.isfinite(v["ac"]) and np.isfinite(v["tc"]) for v in got.values())


@pytest.fixture(scope="module")
def fused_scores(_one_thread, env, tmp_path_factory):
    """score_generated's AC and TC per encoder_impl, one set of weights, at
    "high" on the CPU (the kernels' plain versions)."""
    _root, mesh_root, kp_root, gen_dir, gen_kp, _human, _names = env
    port, _jm, _p = _models(seed=6)
    out = {}
    for impl in ("module", "block_kernel", "chain_kernel"):
        got = score.score_generated(
            port, gen_dir, mesh_root, _real_paths(kp_root),
            data.ModalityPaths(keypoint_dir=gen_kp, layout="generated"),
            cfg=score.ScoreConfig(clip_len=16, stride=8, batch_size=16, precision="high",
                                  encoder_impl=impl),
            output_json=None, device="cpu",
        )
        out[impl] = got["scores"]
    return out


@pytest.mark.parametrize("encoder_impl", ["block_kernel", "chain_kernel"])
def test_window_encoder_fused_forwards_match_module(fused_scores, encoder_impl):
    """block_kernel (K3 a stage) and chain_kernel (K10 a chain) give every
    video's AC and TC within 1e-4 of the module forward."""
    want, got = fused_scores["module"], fused_scores[encoder_impl]
    assert sorted(got) == sorted(want)
    for vid in want:
        for m in ("ac", "tc"):
            assert np.isfinite(got[vid][m])
            assert abs(got[vid][m] - want[vid][m]) <= 1e-4, (vid, m)


def test_fused_encoder_impls_refuse_highest_and_the_cli_parses_them(env, tmp_path):
    """An explicit kernel forward at "highest" raises rather than changing
    numerics, in WindowEncoder and through --encoder-impl; an unknown
    --encoder-impl is refused by the parser."""
    _root, mesh_root, kp_root, gen_dir, gen_kp, _human, _names = env
    port, _jm, _p = _models(seed=7)
    for impl in ("block_kernel", "chain_kernel"):
        with pytest.raises(ValueError, match="precision 'high'"):
            score.WindowEncoder(port, 16, 16, precision="highest", device="cpu",
                                encoder_impl=impl)
    with pytest.raises(ValueError, match="encoder_impl"):
        score.WindowEncoder(port, 16, 16, device="cpu", encoder_impl="stacked")
    ckpt = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": _models(seed=7, d_model=256, layers=4, heads=8)[0].state_dict()},
               ckpt)
    argv = ["--generated-meshes", gen_dir, "--real-meshes", mesh_root, "--checkpoint", ckpt,
            "--real-kp-dir", kp_root, "--gen-kp-dir", gen_kp, "--clip-len", "16",
            "--output", str(tmp_path / "scores.json"), "--no-bug-compat", "--device", "cpu"]
    with pytest.raises(ValueError, match="chain_kernel"):
        score.main(argv + ["--encoder-impl", "chain_kernel", "--precision", "highest"])
    with pytest.raises(SystemExit):
        score.main(argv + ["--encoder-impl", "stacked"])


def test_score_cli_refuses_cuda_without_a_card(env, tmp_path):
    """--device cuda never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _root, mesh_root, _kp, gen_dir, *_ = env
    with pytest.raises(SystemExit):
        score.main(["--generated-meshes", gen_dir, "--real-meshes", mesh_root,
                    "--checkpoint", str(tmp_path / "none.pt")])


def test_port_imports_no_jax():
    """In a fresh interpreter: the scoring and training CLI modules, and every
    module of the port they do not reach (the mesh-recovery stage's, the
    fused forwards', the parallel and reporting modules' among them), load
    neither jax, flax, optax, orbax nor anything of the JAX package (a
    spawned rank's modules: tests/test_torch_parallel.py)."""
    code = (
        "import sys, pkgutil, importlib, video_gen_evals_tpu_torch as pkg\n"
        "import video_gen_evals_tpu_torch.pipelines.score\n"
        "import video_gen_evals_tpu_torch.pipelines.train_cli\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'video_gen_evals_tpu_torch.train.experiment' in sys.modules\n"
        "assert 'video_gen_evals_tpu_torch.ops.conv_kernel_train' in sys.modules\n"
        "for m in ('ops.attention', 'ops.attention_core', 'ops.upstream_crops', 'models.vit',\n"
        "          'models.smpl_head', 'pipelines.extract', 'pipelines.weights', 'utils.io',\n"
        "          'ops.chain_kernel', 'models.fused_apply', 'ops.roi_align', 'ops.image',\n"
        "          'models.rcnn', 'models.pose2d', 'pipelines.full', 'utils.native_video',\n"
        "          'parallel.mesh', 'utils.cli', 'pipelines.merge_scores', 'pipelines.leaderboard',\n"
        "          'human.mos', 'data.device_bank', 'utils.native_npz', 'utils.profiling',\n"
        "          'utils.hostload', 'parallel.tensor', 'ops.precision'):\n"
        "    assert 'video_gen_evals_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'video_gen_evals_tpu')]\n"
        "print(bad); raise SystemExit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
