"""The port's bank layer against the JAX package on the CPU: the native npz
reader, the bank and stats caches and their fingerprints (files either
package wrote read by the other), the torch window gathers, the
device-resident bank and its stream stats, ``score_generated`` with a bank
cache, ``--dump-features``, every ``--gather-impl``, ``--precision default``
and a JAX path-keyed ``.npz`` checkpoint, K3's ``default`` plain version,
``TrainConfig`` JSON, profiling and hostload. That these modules import no
jax: ``tests/test_torch_score_pipeline.py::test_port_imports_no_jax``.

One JAX ``score_generated`` run (small widths, "highest", module forward,
``take`` gather) writes the caches and the feature dump the port reads;
inputs are made with numpy from seeds."""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu import data as jax_data
from video_gen_evals_tpu.core.config import TrainConfig as JaxTrainConfig
from video_gen_evals_tpu.data import device_bank as jax_device_bank
from video_gen_evals_tpu.data import features as jax_features
from video_gen_evals_tpu.data import stats as jax_stats
from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
from video_gen_evals_tpu.ops.conv_kernel_train import fused_temporal_block_train as jax_block_train
from video_gen_evals_tpu.ops import window_kernel as jax_window_kernel
from video_gen_evals_tpu.pipelines import score as jax_score
from video_gen_evals_tpu.train.checkpoint import _flatten_with_paths
from video_gen_evals_tpu.utils import hostload as jax_hostload

from video_gen_evals_tpu_torch import data
from video_gen_evals_tpu_torch.core.config import TrainConfig
from video_gen_evals_tpu_torch.data import device_bank, features, stats as port_stats
from video_gen_evals_tpu_torch.data.fixtures import make_fixture_tree, write_keypoints, write_mesh_npz
from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
from video_gen_evals_tpu_torch.ops.conv_kernel_train import fused_temporal_block_train_plain
from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows as k1_gather
from video_gen_evals_tpu_torch.pipelines import score
from video_gen_evals_tpu_torch.train.checkpoint import load_jax_npz_params
from video_gen_evals_tpu_torch.utils import hostload, native_npz, profiling

CLASSES = ["JumpingJack", "PushUps"]
DIMS_RAW = {"vit": 64, "global": 9, "pose": 207, "beta": 10, "kp2d": 120}
DIMS_DIFF = {"vit": 64, "global": 3, "pose": 69, "beta": 10, "kp2d": 120}
CLIP, BATCH = 16, 16


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
    """2 classes x 4 real videos with keypoints, 6 generated videos. Two
    video lengths only: JAX's eager host math compiles each op once a shape."""
    root = str(tmp_path_factory.mktemp("bank_layer"))
    mesh_root, kp_root = make_fixture_tree(root, CLASSES, videos_per_class=4, frames=(40, 40, 38, 40), seed=3)
    gen_dir, gen_kp = os.path.join(root, "generated_meshes"), os.path.join(root, "generated_kps")
    rng = np.random.default_rng(7)
    for i, cls in enumerate(CLASSES * 3):
        stem = f"GenModel{i % 2}_{cls}_{i:02d}_hash{i}"
        write_mesh_npz(os.path.join(gen_dir, f"{stem}.npz"), 40, 64, rng)
        write_keypoints(os.path.join(gen_kp, stem, "keypoints.npy"), 40, rng)
    return dict(root=root, mesh_root=mesh_root, kp_root=kp_root, gen_dir=gen_dir, gen_kp=gen_kp)


def _paths(pkg, env):
    return (pkg.ModalityPaths(keypoint_dir=env["kp_root"], layout="real"),
            pkg.ModalityPaths(keypoint_dir=env["gen_kp"], layout="generated"))


def _port_model(seed=0, **kw):
    widths = {"d_model": 32, "time_layers": 1, "time_heads": 4, **kw}
    return HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF, **widths),
                             generator=torch.Generator().manual_seed(seed))


def _splits(env):
    """The real train split and the generated items, in the port's and in
    JAX's manifests."""
    return ([m.train_test_split(m.scan_class_tree(env["mesh_root"]), 0.8, seed=1337)[0].items
             for m in (data, jax_data)],
            [m.scan_generated_flat(env["gen_dir"]).items for m in (data, jax_data)])


@pytest.fixture(scope="module")
def jax_run(env):
    """A cache directory written by the JAX package's own writers under its
    own fingerprints (``ModalityStats.save``, ``save_feature_bank``,
    ``source_fingerprint``, ``bank_fingerprint``), holding the port's stats
    and banks (tests/test_torch_score_pipeline.py holds those against JAX's
    within 1e-4), so JAX runs no eager host pass; then JAX's score_generated
    once on it ("highest", module forward, ``take`` gather): its scores and
    feature dump. Also the port model's weights as the JAX package's
    multi-process params file (``np.savez`` of ``_flatten_with_paths``)."""
    port = _port_model()
    jcfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=32, time_layers=1, time_heads=4)
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in port.state_dict().items()}, jcfg, strict=True)
    ckpt = os.path.join(env["root"], "jax_params.npz")
    np.savez(ckpt, **_flatten_with_paths(params))
    (real_p, gen_p), (real_j, gen_j) = _paths(data, env), _paths(jax_data, env)
    (train_p, train_j), (gitems_p, gitems_j) = _splits(env)
    st = data.compute_stats(train_p, real_p)
    st_j = jax_stats.ModalityStats(st.mean_raw, st.std_raw, st.mean_diff, st.std_diff)
    cache = os.path.join(env["root"], "jax_cache")
    os.makedirs(cache)
    st_j.save(os.path.join(cache, "stats.npz"),
              fingerprint=jax_features.source_fingerprint(train_j, real_j, tag=f"stats-v1|eps={1e-6!r}"))
    for items_p, items_j, paths_p, paths_j, name in ((train_p, train_j, real_p, real_j, "real_train_bank.npz"),
                                                     (gitems_p, gitems_j, gen_p, gen_j, "generated_bank.npz")):
        b = data.build_feature_bank(items_p, paths_p, st, min_rows=CLIP + 8)
        jax_features.save_feature_bank(
            jax_features.FeatureBank(b.bank, b.offsets, b.row_limit, b.z0_diff, b.one_pass_raw, b.classes, b.names),
            os.path.join(cache, name),
            fingerprint=jax_features.bank_fingerprint(items_j, paths_j, st_j, min_rows=CLIP + 8))
    written = {f: os.stat(os.path.join(cache, f)) for f in os.listdir(cache)}
    dump = os.path.join(env["root"], "jax_dump.npz")
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        result = jax_score.score_generated(
            JaxHumanActionScorer(jcfg), params, env["gen_dir"], env["mesh_root"], real_j, gen_j,
            cfg=jax_score.ScoreConfig(clip_len=CLIP, stride=8, batch_size=BATCH, matmul_precision="highest",
                                      encoder_impl="module", gather_impl="take"),
            output_json=None, dump_features=dump, bank_cache_dir=cache)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()
    return dict(ckpt=ckpt, cache=cache, written=written, dump=dump, scores=result["scores"])


def _counts():
    return dict(features.CACHE_COUNTS)


def _score(env, model, cfg, **kw):
    real, gen = _paths(data, env)
    return score.score_generated(model, env["gen_dir"], env["mesh_root"], real, gen, cfg=cfg,
                                 output_json=None, device="cpu", **kw)["scores"]


def _worst(a, b):
    assert sorted(a) == sorted(b)
    return max(abs(a[v][m] - b[v][m]) for v in a for m in ("ac", "tc"))


# --------------------------------------------------------------------- reader

def test_native_reader_matches_numpy(env, capsys, monkeypatch):
    """The reader is built with g++ into _build/ and reads every numeric
    member of every mesh npz bitwise as numpy does (arrays, header shapes,
    the thread pool, None for a missing file; the string ``meta`` member is
    skipped, as the JAX reader skips it). Without a compiler it falls back
    to numpy and says so."""
    assert native_npz.reader() == "native"
    assert os.path.dirname(native_npz._LIB._name) == native_npz.BUILD_DIR
    paths = [it.path for it in data.scan_class_tree(env["mesh_root"]).items]
    many = native_npz.load_npz_many(paths + [os.path.join(env["root"], "none.npz")], n_threads=3)
    assert many[-1] is None
    for p, got_many in zip(paths, many):
        with np.load(p) as z:
            want = {k: z[k] for k in z.files if z[k].dtype.kind not in "OSU"}
        assert "meta" not in want
        for got in (native_npz.load_npz(p), got_many):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (p, k)
        assert native_npz.npz_shapes(p) == {k: v.shape for k, v in want.items()}
    with pytest.raises(IOError):
        native_npz.load_npz(os.path.join(env["root"], "none.npz"))

    for name, value in (("_TRIED", False), ("_LIB", None)):
        monkeypatch.setattr(native_npz, name, value)
    monkeypatch.setattr(native_npz, "_compiler", lambda: None)
    assert native_npz.reader() == "numpy"
    assert "no C++ compiler" in capsys.readouterr().err
    fallback = native_npz.load_npz(paths[0])
    assert all(np.array_equal(fallback[k], many[0][k]) for k in many[0])


# ---------------------------------------------------------------- fingerprints and caches

def test_fingerprints_match_jax(env):
    """Bank and stats fingerprints are the JAX package's strings on the same
    tree, stats and configuration."""
    items_p = data.scan_class_tree(env["mesh_root"]).items
    items_j = jax_data.scan_class_tree(env["mesh_root"]).items
    (real_p, gen_p), (real_j, gen_j) = _paths(data, env), _paths(jax_data, env)
    st = data.compute_stats(items_p, real_p)
    st_j = jax_stats.ModalityStats(st.mean_raw, st.std_raw, st.mean_diff, st.std_diff)
    for mods in (None, ["vit", "pose", "kp2d"]):
        assert (features.bank_fingerprint(items_p, real_p, st, mods, min_rows=24)
                == jax_features.bank_fingerprint(items_j, real_j, st_j, mods, min_rows=24))
    gen_items = data.scan_generated_flat(env["gen_dir"]).items
    gen_items_j = jax_data.scan_generated_flat(env["gen_dir"]).items
    assert (features.source_fingerprint(gen_items, gen_p, "stats-v1|eps=1e-06")
            == jax_features.source_fingerprint(gen_items_j, gen_j, "stats-v1|eps=1e-06"))


def test_caches_cross_packages(env, jax_run, tmp_path):
    """Files the JAX package wrote (stats.npz, real_train_bank.npz) are hits
    for the port, bitwise what they hold, and were hits for JAX's own run
    (not rewritten: same inode and mtime); files the port writes are hits
    for JAX (not rewritten; arrays bitwise)."""
    real_p, _ = _paths(data, env)
    real_j, _ = _paths(jax_data, env)
    (train, train_j), _ = _splits(env)
    cache = jax_run["cache"]
    for f, before in jax_run["written"].items():
        after = os.stat(os.path.join(cache, f))
        assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns), f
    c0 = _counts()
    st = port_stats.compute_stats_cached(train, real_p, cache_path=os.path.join(cache, "stats.npz"))
    bank = data.build_feature_bank_cached(train, real_p, st, min_rows=CLIP + 8,
                                          cache_path=os.path.join(cache, "real_train_bank.npz"))
    assert _counts()["hit"] == c0["hit"] + 2 and _counts()["miss"] == c0["miss"]
    want = jax_features.load_feature_bank(os.path.join(cache, "real_train_bank.npz"))
    np.testing.assert_array_equal(bank.bank, want.bank)
    assert bank.names == want.names and bank.classes == want.classes

    mine = str(tmp_path)
    st_p = port_stats.compute_stats_cached(train, real_p, cache_path=os.path.join(mine, "stats.npz"))
    bank_p = data.build_feature_bank_cached(train, real_p, st_p, min_rows=CLIP + 8,
                                            cache_path=os.path.join(mine, "bank.npz"))
    ident = {f: os.stat(os.path.join(mine, f)) for f in ("stats.npz", "bank.npz")}
    st_j = jax_stats.compute_stats_cached(train_j, real_j, cache_path=os.path.join(mine, "stats.npz"))
    bank_j = jax_features.build_feature_bank_cached(train_j, real_j, st_j, min_rows=CLIP + 8,
                                                    cache_path=os.path.join(mine, "bank.npz"))
    for f, before in ident.items():
        after = os.stat(os.path.join(mine, f))
        assert (after.st_ino, after.st_mtime_ns) == (before.st_ino, before.st_mtime_ns), f
    for m in st_p.modalities:
        np.testing.assert_array_equal(st_j.std_diff[m], st_p.std_diff[m])
    np.testing.assert_array_equal(np.asarray(bank_j.bank), bank_p.bank)


def test_touched_source_invalidates_both_caches(env, tmp_path):
    """A source file with a new mtime changes both fingerprints: the next
    cached call misses and rewrites the file."""
    real_p, _ = _paths(data, env)
    items = data.scan_class_tree(env["mesh_root"]).items[:3]
    sp, bp = str(tmp_path / "stats.npz"), str(tmp_path / "bank.npz")
    st = port_stats.compute_stats_cached(items, real_p, cache_path=sp)
    data.build_feature_bank_cached(items, real_p, st, min_rows=24, cache_path=bp)
    c0 = _counts()
    data.build_feature_bank_cached(items, real_p, st, min_rows=24, cache_path=bp)
    assert _counts()["hit"] == c0["hit"] + 1
    kp = os.path.join(env["kp_root"], items[1].cls, os.path.splitext(items[1].name)[0], "keypoints.npy")
    for touched in (items[0].path, kp):
        st_before = os.stat(touched)
        try:
            os.utime(touched, ns=(st_before.st_atime_ns, st_before.st_mtime_ns + 10**9))
            c0 = _counts()
            ino = os.stat(bp).st_ino
            st2 = port_stats.compute_stats_cached(items, real_p, cache_path=sp)
            data.build_feature_bank_cached(items, real_p, st2, min_rows=24, cache_path=bp)
            assert _counts()["miss"] == c0["miss"] + 2, touched
            assert os.stat(bp).st_ino != ino
        finally:
            os.utime(touched, ns=(st_before.st_atime_ns, st_before.st_mtime_ns))


# -------------------------------------------------------------------- gathers

def test_gathers_match_jax(rng):
    """take / sliced / K1's plain version against JAX's gather_windows,
    gather_windows_sliced and the burst kernel (Pallas interpret mode), on
    unaligned, clipped, negative and past-the-end starts: bitwise. take and
    sliced differ only where a start lies outside a video's bank."""
    rows, D, raw = [24, 40, 32], 20, 12
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    row_limit = (np.array(rows) - 1).astype(np.int32)
    bank = rng.normal(size=(sum(rows), D)).astype(np.float32)
    z0 = rng.normal(size=D - raw).astype(np.float32)
    vi = np.array([0, 1, 2, 1, 0, 2, 1, 1], np.int32)
    st = np.array([3, 13, 40, -5, 9, 16, 30, 0], np.int32)
    clip = 16
    t = lambda a: torch.from_numpy(a)   # noqa: E731
    j = lambda a: jnp.asarray(a)        # noqa: E731
    args_p = (t(bank), t(offsets), t(row_limit), t(z0), raw, t(vi), t(st), clip)
    args_j = (j(bank), j(offsets), j(row_limit), j(z0), raw, j(vi), j(st), clip)
    take = features.gather_windows(*args_p).numpy()
    sliced = features.gather_windows_sliced(*args_p).numpy()
    np.testing.assert_array_equal(take, np.asarray(jax_features.gather_windows(*args_j)))
    np.testing.assert_array_equal(sliced, np.asarray(jax_features.gather_windows_sliced(*args_j)))
    np.testing.assert_array_equal(k1_gather(*args_p).numpy(), sliced)
    inside = (st >= 0) & (st + clip <= np.array(rows)[vi])
    np.testing.assert_array_equal(take[inside], sliced[inside])
    assert not np.array_equal(take[~inside], sliced[~inside])
    aligned = np.array([0, 8, 16, 24, 8, 16, 0, 8], np.int32)
    burst = jax_window_kernel.pallas_gather_windows_burst(
        jax_window_kernel.pad_bank_lanes(j(bank)), j(offsets), j(row_limit), j(z0), raw, j(vi),
        j(aligned), clip, out_dim=D, interpret=True)
    np.testing.assert_array_equal(
        k1_gather(*args_p[:6], t(aligned), clip).numpy(), np.asarray(burst))


# ---------------------------------------------------------------- device bank

@pytest.fixture(scope="module")
def videos(env):
    real_p, _ = _paths(data, env)
    items = data.scan_class_tree(env["mesh_root"]).items[:4]
    return [features.load_video_arrays(it, real_p) for it in items], [it.name for it in items]


def test_device_bank_matches_host_and_jax(videos):
    """build_bank_device on the CPU against the port's host bank: bitwise,
    but for the kp2d diff block within 1e-5 (the stream's Procrustes einsums
    sum a [T, 60, 2] batch of another length, which torch may block
    differently: last-bit differences); against JAX's build_bank_device
    within the host bank's 1e-4. stream_stats against JAX's within rtol
    1e-5 and against the float64 host stats within rtol 1e-4 (float32 sums
    of ~150 rows)."""
    from video_gen_evals_tpu_torch.pipelines.full import bank_from_arrays, stats_from_arrays

    arrays, names = videos
    classes = ["a", "b", "a", "b"]
    st = stats_from_arrays(arrays)
    host = bank_from_arrays(arrays, names, classes, st, min_rows=40)
    dev = device_bank.build_bank_device(arrays, names, classes, st, min_rows=40, device="cpu")
    assert isinstance(dev.bank, torch.Tensor)
    got = dev.bank.numpy()
    kp_cols = np.zeros(got.shape[1], bool)
    kp_cols[dev.one_pass_raw + sum(DIMS_DIFF[m] for m in ("vit", "global", "pose", "beta")):] = True
    np.testing.assert_array_equal(got[:, ~kp_cols], host.bank[:, ~kp_cols])
    np.testing.assert_allclose(got[:, kp_cols], host.bank[:, kp_cols], rtol=0, atol=1e-5)
    for k in ("offsets", "row_limit", "z0_diff"):
        np.testing.assert_array_equal(getattr(dev, k), getattr(host, k))
    assert dev.one_pass_raw == host.one_pass_raw and dev.names == names and dev.classes == classes
    st_j = jax_stats.ModalityStats(st.mean_raw, st.std_raw, st.mean_diff, st.std_diff)
    want = jax_device_bank.build_bank_device(arrays, names, classes, st_j, min_rows=40)
    np.testing.assert_allclose(got, np.asarray(want.bank), rtol=0, atol=1e-4)

    ss, streams = device_bank.stream_stats(arrays, device="cpu")
    ss_j, _ = jax_device_bank.stream_stats(arrays)
    for m in st.modalities:
        for kind in ("mean_raw", "std_raw", "mean_diff", "std_diff"):
            np.testing.assert_allclose(getattr(ss, kind)[m], getattr(ss_j, kind)[m], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(getattr(ss, kind)[m], getattr(st, kind)[m], rtol=1e-4, atol=1e-6)
    again = device_bank.build_bank_device(arrays, names, classes, ss, min_rows=40, streams=streams)
    np.testing.assert_array_equal(
        again.bank.numpy(), device_bank.build_bank_device(arrays, names, classes, ss, min_rows=40).bank.numpy())
    with pytest.raises(ValueError, match="zero-frame"):
        device_bank.build_bank_device([{**arrays[0], "beta": arrays[0]["beta"][:0]}], names[:1], ["a"], st)


# ------------------------------------------------------------ score_generated

def test_score_generated_from_jax_caches_and_checkpoint(env, jax_run):
    """The port loads the JAX params file, reads the JAX run's three caches
    (3 hits) and scores every video within 1e-4 of JAX at "highest"; its
    feature dump has the JAX keys, the same metadata and embeddings and TCs
    within 1e-4."""
    model = _port_model(seed=5)   # other weights, replaced by the file's
    load_jax_npz_params(jax_run["ckpt"], model)
    np.testing.assert_array_equal(model.state_dict()["cls"].numpy(), _port_model().state_dict()["cls"].numpy())
    dump = os.path.join(env["root"], "port_dump.npz")
    cache = os.path.join(env["root"], "jax_cache_copy")
    shutil.copytree(jax_run["cache"], cache)
    c0 = _counts()
    got = _score(env, model, score.ScoreConfig(clip_len=CLIP, stride=8, batch_size=BATCH, precision="highest",
                                               gather_impl="take"),
                 dump_features=dump, bank_cache_dir=cache)
    assert _counts()["hit"] == c0["hit"] + 3 and _counts()["miss"] == c0["miss"]
    assert _worst(got, jax_run["scores"]) <= 1e-4
    with np.load(dump) as a, np.load(jax_run["dump"]) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            ["seq_embeds", "window_tc", "window_video", "window_start", "video_names", "video_classes"])
        for k in ("window_video", "window_start", "video_names", "video_classes"):
            np.testing.assert_array_equal(a[k], b[k])
        for k in ("seq_embeds", "window_tc"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="orbax"):
        load_jax_npz_params(env["root"], model)


@pytest.fixture(scope="module")
def port_scores(env, jax_run):
    """score_generated per gather_impl and precision on the JAX-written
    cache (the banks JAX scored), and with bank_impl="device" without a
    cache (a hit is a host bank), one set of weights."""
    model = _port_model()
    cache = jax_run["cache"]
    out = {}
    for gather in ("take", "sliced", "burst"):   # "auto" is "burst": K1
        out[gather] = _score(env, model, score.ScoreConfig(clip_len=CLIP, stride=8, batch_size=BATCH,
                                                           precision="highest", gather_impl=gather),
                             bank_cache_dir=cache)
    out["default"] = _score(env, model, score.ScoreConfig(clip_len=CLIP, stride=8, batch_size=BATCH,
                                                          precision="default"), bank_cache_dir=cache)
    out["device"] = _score(env, model, score.ScoreConfig(clip_len=CLIP, stride=8, batch_size=BATCH,
                                                         precision="highest", bank_impl="device"))
    return out


def test_gather_impls_precision_default_and_device_bank(port_scores, jax_run):
    """Every gather_impl gives the same bits on the enumerated windows, each
    within 1e-4 of JAX's take run at "highest", and so do the device-built
    banks; "default" (bf16 operands in the conv
    stages, fp32 sums) lies within the bf16 class's 2e-2 of JAX's fp32 run
    (JAX's CPU computes "default" in fp32) and is not the fp32 result."""
    want = jax_run["scores"]
    for gather in ("sliced", "burst"):
        assert port_scores[gather] == port_scores["take"], gather
    assert _worst(port_scores["take"], want) <= 1e-4
    assert _worst(port_scores["device"], want) <= 1e-4
    d = _worst(port_scores["default"], want)
    assert 1e-6 < d <= 2e-2, d


def test_score_cli_flags(env, tmp_path):
    """The CLI at its default widths: no cache (--gather-impl burst, .pt),
    --bank-cache cold (take, --dump-features) and warm (3 hits; sliced, the
    weights as a JAX .npz) give the same bits; the dump holds finite
    embeddings and TCs of every window at the model's width; unknown values
    are refused."""
    model = _port_model(seed=2, d_model=256, time_layers=4, time_heads=8)
    pt = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": model.state_dict()}, pt)
    from video_gen_evals_tpu_torch.train.checkpoint import save_jax_npz_params

    npz = save_jax_npz_params(str(tmp_path / "model"), model.state_dict(), model.config)
    base = ["--generated-meshes", env["gen_dir"], "--real-meshes", env["mesh_root"],
            "--real-kp-dir", env["kp_root"], "--gen-kp-dir", env["gen_kp"], "--clip-len", str(CLIP),
            "--batch-size", "32", "--no-bug-compat", "--device", "cpu", "--precision", "highest"]

    def run(tag, *extra, ckpt=pt):
        out = str(tmp_path / f"{tag}.json")
        score.main(base + ["--checkpoint", ckpt, "--output", out, *extra])
        with open(out) as f:
            return json.load(f)

    cache = str(tmp_path / "cache")
    ref = run("ref", "--gather-impl", "burst")
    cold = run("cold", "--bank-cache", cache, "--gather-impl", "take", "--dump-features", str(tmp_path / "dump.npz"))
    c0 = _counts()
    warm = run("warm", "--bank-cache", cache, "--gather-impl", "sliced", ckpt=npz)
    assert _counts()["hit"] == c0["hit"] + 3
    assert ref == cold == warm
    with np.load(str(tmp_path / "dump.npz")) as z:
        assert z["seq_embeds"].shape == (len(z["window_video"]), 256) and z["video_names"].shape == (6,)
        assert np.isfinite(z["seq_embeds"]).all() and np.isfinite(z["window_tc"]).all()
    for flag, value in (("--gather-impl", "xla"), ("--precision", "fp8")):
        with pytest.raises(SystemExit):
            score.main(base + ["--checkpoint", pt, flag, value])


# ----------------------------------------------------------------- K3 default

def test_k3_default_plain_matches_jax_k4_forward():
    """K3's "default" plain version against JAX's K4 forward at "default"
    without a mask (Pallas interpret mode): bf16 operands, f32 sums on both
    sides; an element of GELU(conv1) on a bf16 rounding boundary may round
    the other way (the f32 sums before it differ in their last bits), as in
    tests/test_torch_train_ops.py: atol 5e-3. Bitwise the port's K4 plain
    forward at "default" without a mask, and not the fp32 stage."""
    rng = np.random.default_rng(11)
    B, T, C = 8, 8, 32
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w1, w2 = (0.1 * rng.normal(size=(5, C, C)).astype(np.float32) for _ in range(2))
    gs = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    gb = (0.1 * rng.normal(size=C)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, w1, w2, gs, gb)]
    for d in (1, 2, 4):
        got = fused_temporal_block(*args, d, "default")
        want = jax_block_train(*(jnp.asarray(a) for a in (x, w1, w2, gs, gb)), None, d, "default")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-3)
        assert torch.equal(got, fused_temporal_block_train_plain(*args, None, d, "default"))
        assert (got - fused_temporal_block(*args, d, "highest")).abs().max().item() > 1e-4


# ------------------------------------------------------------- config, tools

def test_train_config_json_both_ways_and_conv_impl_flag(tmp_path):
    """A TrainConfig JSON either package writes loads in the other with every
    field, conv_impl and bank_cache_dir included; the train CLI refuses an
    unknown --conv-impl, and Experiment an unknown conv_impl."""
    from video_gen_evals_tpu_torch.pipelines import train_cli
    from video_gen_evals_tpu_torch.train.experiment import Experiment

    mine = TrainConfig(conv_impl="module", bank_cache_dir="CACHE", epochs=3, num_dp_devices=2)
    mine.to_json(str(tmp_path / "port.json"))
    theirs = JaxTrainConfig.from_json(str(tmp_path / "port.json"))
    jax_cfg = JaxTrainConfig(conv_impl="kernel", bank_cache_dir="C2", lr=1e-3)
    jax_cfg.to_json(str(tmp_path / "jax.json"))
    back = TrainConfig.from_json(str(tmp_path / "jax.json"))
    import dataclasses

    assert dataclasses.asdict(theirs) == dataclasses.asdict(mine)
    assert dataclasses.asdict(back) == dataclasses.asdict(jax_cfg)
    with pytest.raises(SystemExit):
        train_cli.main(["--conv-impl", "xla", "--device", "cpu"])
    with pytest.raises(ValueError, match="conv_impl"):
        Experiment(TrainConfig(conv_impl="xla"), device="cpu")


def test_profiling_and_hostload(tmp_path, monkeypatch):
    """trace() without a directory is a no-op; with one it writes a Chrome
    trace naming the annotated span and the ops inside it; StepTimer's
    rates and hostload.snapshot() have the JAX package's keys."""
    monkeypatch.delenv("VGE_TRACE_DIR", raising=False)
    with profiling.trace() as prof:
        assert prof is None
    out = str(tmp_path / "trace")
    with profiling.trace(out):
        with profiling.annotate("vge_span"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    (f,) = os.listdir(out)
    with open(os.path.join(out, f)) as fh:
        text = fh.read()
    assert "vge_span" in text and "aten::mm" in text
    monkeypatch.setenv("VGE_TRACE_DIR", str(tmp_path / "env_trace"))
    with profiling.trace():
        torch.zeros(2).sum()
    assert len(os.listdir(str(tmp_path / "env_trace"))) == 1
    timer = profiling.StepTimer()
    timer.tick(8)
    assert set(timer.rates()) == {"seconds", "steps_per_sec", "items_per_sec"}
    snap = hostload.snapshot()
    assert set(snap) == set(jax_hostload.snapshot()) and snap["ncpu"] >= 1
