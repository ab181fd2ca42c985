"""The train CLI's ``--bank-cache`` and ``--conv-impl`` on the CPU, on the
fixture tree of ``tests/test_torch_train_experiment.py`` at its small widths:
stats and train / test bank caches written by the JAX package's writers
under its fingerprints, with the JAX ``Experiment``'s file names,
modalities and ``min_rows``, are hits for the port and train to the bits
of a cold run; a warm run writes nothing; ``module`` (K4's plain version
under autograd) trains as ``kernel`` (K4's autograd Function, whose plain
versions ``tests/test_torch_train_ops.py`` holds against JAX's Pallas
kernels)."""

import json
import os

import numpy as np
import pytest
import torch

from video_gen_evals_tpu import data as jax_data
from video_gen_evals_tpu.data import features as jax_features
from video_gen_evals_tpu.data import stats as jax_stats

from video_gen_evals_tpu_torch import data
from video_gen_evals_tpu_torch.core.config import PathsConfig, TrainConfig
from video_gen_evals_tpu_torch.data import features
from video_gen_evals_tpu_torch.data.fixtures import make_fixture_tree
from video_gen_evals_tpu_torch.pipelines import train_cli

CLASSES = ["JumpingJack", "PushUps"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for the whole module: a bitwise comparison of two runs
    needs both to sum in the same order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The real tree of tests/test_train.py, and a cache of its stats and
    train / test banks written by the JAX package's writers under its own
    fingerprints. The arrays are the port's, which
    tests/test_torch_score_pipeline.py holds against JAX's within 1e-4: so
    JAX runs no eager host pass here."""
    root = str(tmp_path_factory.mktemp("train_flags"))
    mesh_root, kp_root = make_fixture_tree(root, CLASSES, videos_per_class=4, frames=(60, 48, 40, 56), seed=5)
    paths = data.ModalityPaths(keypoint_dir=kp_root, layout="real")
    paths_j = jax_data.ModalityPaths(keypoint_dir=kp_root, layout="real")
    train, test = data.train_test_split(data.scan_class_tree(mesh_root), 0.8, 1337)
    train_j, test_j = jax_data.train_test_split(jax_data.scan_class_tree(mesh_root), 0.8, 1337)
    cache = os.path.join(root, "jax_cache")
    os.makedirs(cache)
    st = data.compute_stats(train.items, paths)
    st_j = jax_stats.ModalityStats(st.mean_raw, st.std_raw, st.mean_diff, st.std_diff)
    st_j.save(os.path.join(cache, "stats.npz"),
              fingerprint=jax_features.source_fingerprint(train_j.items, paths_j, tag=f"stats-v1|eps={1e-6!r}"))
    mods = [m for m in TrainConfig().detect_modalities() if m in st.modalities]
    for ds, ds_j, name in ((train, train_j, "train_bank.npz"), (test, test_j, "test_bank.npz")):
        b = data.build_feature_bank(ds.items, paths, st, mods, min_rows=24)
        jax_features.save_feature_bank(
            jax_features.FeatureBank(b.bank, b.offsets, b.row_limit, b.z0_diff, b.one_pass_raw, b.classes, b.names),
            os.path.join(cache, name),
            fingerprint=jax_features.bank_fingerprint(ds_j.items, paths_j, st_j, mods, min_rows=24))
    return dict(root=root, mesh_root=mesh_root, kp_root=kp_root, jax_cache=cache)


def _run(env, tag, *flags):
    """One epoch of the train CLI on the CPU; returns its train and eval
    losses and the saved config."""
    none = os.path.join(env["root"], "none")
    cfg = TrainConfig(
        paths=PathsConfig(real_meshes_dir=env["mesh_root"], real_kp_dir=env["kp_root"],
                          generated_meshes_dir=none, gen_kp_dir=None, human_scores=none + ".json"),
        epochs=1, clip_len=16, stride=8, P=2, K=4, d_model=32, time_layers=1, time_heads=4,
        filter_classes=None, save_dir=os.path.join(env["root"], f"SAVE_{tag}"))
    path = os.path.join(env["root"], f"{tag}.json")
    cfg.to_json(path)
    (res,) = train_cli.main(["--config", path, "--device", "cpu", *flags])
    with open(os.path.join(res["save_dir"], "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    with open(os.path.join(res["save_dir"], "config.json")) as f:
        saved = json.load(f)
    losses = [e["loss"] for e in events if e["event"] in ("train_epoch", "eval_loss")]
    return np.array(losses), saved


def test_bank_cache_and_conv_impl(env, capsys):
    """A cold --bank-cache run builds the banks as a run without a cache does
    and writes the three files; the JAX-written cache files are 3 hits and
    train to the same bits (they hold the same arrays); a warm run is 3 hits
    and writes nothing; --conv-impl module (on the warm cache) trains within
    rtol 1e-3 of kernel (the same forward; autograd's gradients and the
    Function's backward formulas sum in another order, and four AdamW steps,
    which normalize each gradient element, carry last-bit differences of
    small elements into the weights: 1.8e-4 read on the eval loss), and the
    run's log and saved config name both flags."""
    cache = os.path.join(env["root"], "port_cache")
    ref, _ = _run(env, "cold", "--bank-cache", cache, "--conv-impl", "kernel")
    files = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
    assert sorted(files) == ["stats.npz", "test_bank.npz", "train_bank.npz"]

    c0 = dict(features.CACHE_COUNTS)
    from_jax, _ = _run(env, "jax", "--bank-cache", env["jax_cache"])
    assert features.CACHE_COUNTS["hit"] == c0["hit"] + 3 and features.CACHE_COUNTS["miss"] == c0["miss"]
    np.testing.assert_array_equal(from_jax, ref)

    capsys.readouterr()
    c0 = dict(features.CACHE_COUNTS)
    module, saved = _run(env, "module", "--bank-cache", cache, "--conv-impl", "module")
    assert features.CACHE_COUNTS["hit"] == c0["hit"] + 3
    assert files == {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
    assert "--conv-impl module (K4's plain version under autograd)" in capsys.readouterr().out
    assert saved["conv_impl"] == "module" and saved["bank_cache_dir"] == cache
    np.testing.assert_allclose(module, ref, rtol=1e-3)
    assert np.isfinite(module).all()
