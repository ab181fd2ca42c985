"""The port's training harness on the CPU device: ``Experiment`` on the
fixture tree of ``tests/test_train.py`` (2 classes, clip 16, P = 2, K = 4,
d_model 32), its events and checkpoints, the train -> score round trip, exact
resume, and the train CLI. The kernels' plain versions run here; the same
code launches the kernels on a card."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from video_gen_evals_tpu.core.config import TrainConfig as JaxTrainConfig
from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer

from video_gen_evals_tpu_torch.core.config import PathsConfig, TrainConfig
from video_gen_evals_tpu_torch.data.fixtures import make_fixture_tree, write_keypoints, write_mesh_npz
from video_gen_evals_tpu_torch.models.torch_compat import jax_params_from_state_dict
from video_gen_evals_tpu_torch.pipelines import score, train_cli
from video_gen_evals_tpu_torch.train.checkpoint import AsyncSaver, restore_train_state
from video_gen_evals_tpu_torch.train.experiment import Experiment, infer_generated_classes

CLASSES = ["JumpingJack", "PushUps"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for the whole module, the module's fixtures included: a
    bitwise comparison of two runs needs both to sum in the same order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Real tree as in tests/test_train.py, plus 4 generated videos (one with
    no class in its name) and a MOS file."""
    root = str(tmp_path_factory.mktemp("torch_train"))
    mesh_root, kp_root = make_fixture_tree(
        root, CLASSES, videos_per_class=4, frames=(60, 48, 40, 56), seed=5)
    gen_dir, gen_kp = os.path.join(root, "generated_meshes"), os.path.join(root, "generated_kps")
    rng = np.random.default_rng(7)
    stems = ["GenA_JumpingJack_00", "GenB_PushUps_01", "GenA_PushUps_02", "GenB_unknown_03"]
    for stem in stems:
        write_mesh_npz(os.path.join(gen_dir, f"{stem}.npz"), 38, 64, rng)
        write_keypoints(os.path.join(gen_kp, stem, "keypoints.npy"), 38, rng)
    human_path = os.path.join(root, "human.json")
    with open(human_path, "w") as f:
        json.dump({f"{s}.mp4": {"ac": float(i), "tc": float(-i)} for i, s in enumerate(stems)}, f)
    return dict(root=root, mesh_root=mesh_root, kp_root=kp_root, gen_dir=gen_dir, gen_kp=gen_kp,
                human=human_path, stems=stems)


def _cfg(env, name, epochs=2, monitor=True, **kw) -> TrainConfig:
    none = os.path.join(env["root"], "none")
    return TrainConfig(
        paths=PathsConfig(
            real_meshes_dir=env["mesh_root"], real_kp_dir=env["kp_root"],
            generated_meshes_dir=env["gen_dir"] if monitor else none,
            gen_kp_dir=env["gen_kp"] if monitor else None,
            human_scores=env["human"] if monitor else none + ".json"),
        epochs=epochs, clip_len=16, stride=8, P=2, K=4, d_model=32, time_layers=1,
        time_heads=4, filter_classes=None, save_dir=os.path.join(env["root"], "SAVE_" + name), **kw)


def _events(exp):
    with open(exp.metrics_path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def two_epochs(env):
    exp = Experiment(_cfg(env, "two"), eval_batch=16, device="cpu", precision="highest")
    exp.run()
    return exp


def test_experiment_events_and_files(two_epochs):
    exp = two_epochs
    events = _events(exp)
    kinds = [e["event"] for e in events]
    assert {"train_epoch", "eval_loss", "centroid_distance", "human_corr", "checkpoint"} <= set(kinds)
    assert "human_corr_failed" not in kinds
    # the JAX order within an epoch
    first = kinds[: kinds.index("train_epoch", 1)]
    assert first == ["train_epoch", "eval_loss", "checkpoint", "centroid_distance", "human_corr"]
    train = [e for e in events if e["event"] == "train_epoch"]
    assert [e["epoch"] for e in train] == [0, 1]
    for e in train:
        assert set(e) == {"event", "epoch", "loss", "batches", "skipped", "seconds", "clips_per_sec"}
        assert np.isfinite(e["loss"]) and e["skipped"] == 0 and e["batches"] == 4
    ev = next(e for e in events if e["event"] == "eval_loss")
    assert set(ev) == {"event", "epoch", "loss", "tcl", "hard_shuf", "hard_rev", "hard_stat"}
    cd = next(e for e in events if e["event"] == "centroid_distance")
    assert set(cd) == {"event", "epoch", "avg", "cls_JumpingJack", "cls_PushUps"}
    hc = next(e for e in events if e["event"] == "human_corr")
    assert set(hc) == {"event", "epoch", "action_spearman", "motion_spearman"}
    assert exp.best_ckpt is not None and os.path.exists(exp.best_ckpt)
    for name in ("label_mapping.json", "config.json", "resume_epoch000.pt", "resume_epoch001.pt"):
        assert os.path.exists(os.path.join(exp.save_dir, name)), name
    assert exp.train_step.step == 8 and exp.train_step.scheduler.last_epoch == 8


def test_trained_checkpoint_scores_and_converts_to_jax(env, two_epochs, tmp_path):
    """Train -> score: the best ``.pt`` loads strictly into the port's score
    CLI (built at the same widths) and scores every generated video; and it
    converts to JAX params that the JAX model accepts."""
    exp = two_epochs
    sd = torch.load(exp.best_ckpt, map_location="cpu", weights_only=True)["model_state_dict"]
    assert sorted(sd) == sorted(exp.model.state_dict())
    model = copy.deepcopy(exp.model)
    from video_gen_evals_tpu_torch.models.torch_compat import load_torch_checkpoint

    missing, unexpected = load_torch_checkpoint(exp.best_ckpt, model, strict=True)
    assert not missing and not unexpected
    out = str(tmp_path / "scores.json")
    got = score.score_generated(
        model, env["gen_dir"], env["mesh_root"],
        score.ModalityPaths(keypoint_dir=env["kp_root"], layout="real"),
        score.ModalityPaths(keypoint_dir=env["gen_kp"], layout="generated"),
        cfg=score.ScoreConfig(clip_len=16, stride=8, batch_size=16, precision="highest"),
        output_json=out, device="cpu")
    assert sorted(got["scores"]) == sorted(env["stems"])
    assert all(np.isfinite(v["tc"]) for v in got["scores"].values())
    assert sum("ac" in v for v in got["scores"].values()) == 3   # the class-less name has no AC

    dims_raw, dims_diff = dict(exp.enc_cfg.dims_map_raw), dict(exp.enc_cfg.dims_map_diff)
    jcfg = JaxEncoderConfig.create(dims_raw, dims_diff, d_model=32, time_layers=1, time_heads=4)
    params = jax_params_from_state_dict(sd, exp.enc_cfg, strict=True)
    x = np.random.default_rng(0).normal(size=(2, 16, jcfg.input_dim)).astype(np.float32)
    seq_j, _, _ = JaxHumanActionScorer(jcfg).apply({"params": params}, x, deterministic=True)
    with torch.inference_mode():
        seq_p, _, _ = model.eval()(torch.from_numpy(x), "highest")
    np.testing.assert_allclose(seq_p.numpy(), np.asarray(seq_j), atol=1e-4)


def test_resume_is_bitwise_the_uninterrupted_run(env, two_epochs):
    """Epoch 0's checkpoint + one resumed epoch == the 2-epoch run: weights,
    Adam moments, schedule, step and best loss, bit for bit."""
    exp = Experiment(_cfg(env, "resumed"), eval_batch=16, device="cpu", precision="highest")
    start = exp.restore_resume_checkpoint(os.path.join(two_epochs.save_dir, "resume_epoch000.pt"))
    assert start == 1 and exp.train_step.step == 4
    exp.run(start_epoch=start)
    assert [e["epoch"] for e in _events(exp) if e["event"] == "train_epoch"] == [1]
    a = restore_train_state(os.path.join(two_epochs.save_dir, "resume_epoch001.pt"))
    b = restore_train_state(os.path.join(exp.save_dir, "resume_epoch001.pt"))
    assert a["epoch"] == b["epoch"] == 1 and a["best_eval_loss"] == b["best_eval_loss"]
    assert a["train_step"]["step"] == b["train_step"]["step"] == 8
    assert a["train_step"]["scheduler"] == b["train_step"]["scheduler"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["train_step"]["optimizer"]["state"], b["train_step"]["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


def test_monitor_failure_and_nan_batch_do_not_stop_the_run(env):
    """A failing human-correlation monitor is logged and the epoch's resume
    checkpoint still lands; a non-finite step is left out of the epoch's loss."""
    exp = Experiment(_cfg(env, "monfail", epochs=1, async_checkpoint=False), eval_batch=16,
                     device="cpu", precision="highest")

    def boom(epoch, centroids):
        raise FileNotFoundError("gen video lost its keypoints.npy")

    exp.evaluate_human_corr = boom
    real_step, calls = exp.train_step.update, []

    def poisoned(stacked, labels):
        calls.append(1)
        return real_step(torch.full_like(stacked, float("nan")) if len(calls) == 1 else stacked, labels)

    exp.train_step.update = poisoned
    exp.run()
    events = _events(exp)
    fails = [e for e in events if e["event"] == "human_corr_failed"]
    assert len(fails) == 1 and "keypoints.npy" in fails[0]["error"]
    e = next(x for x in events if x["event"] == "train_epoch")
    assert e["skipped"] == 1 and e["batches"] == 4 and np.isfinite(e["loss"])
    assert exp.train_step.step == 4 and exp.train_step.scheduler.last_epoch == 3
    assert os.path.exists(os.path.join(exp.save_dir, "resume_epoch000.pt"))
    exp.cfg.debug_nans = True
    calls.clear()
    with pytest.raises(FloatingPointError, match="non-finite"):
        exp.train_one_epoch(1)


def test_infer_generated_classes_and_async_saver(env, tmp_path):
    from video_gen_evals_tpu_torch.data import scan_generated_flat

    items = scan_generated_flat(env["gen_dir"]).items
    inferred = infer_generated_classes(items, {"JumpingJack": 0, "PushUps": 1})
    assert inferred == ["JumpingJack", "PushUps", "PushUps", None]
    assert [it.cls for it in items] == ["JumpingJack", "PushUps", "PushUps", "JumpingJack"]

    saver, order = AsyncSaver(), []
    for i in range(3):
        saver.submit(lambda i=i: order.append(i))
    saver.wait()
    assert order == [0, 1, 2]

    def fail():
        raise OSError("disk full")

    saver.submit(fail)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.submit(lambda: order.append(3))   # the worker goes on after a failure
    saver.wait()
    assert order[-1] == 3


def _write_cfg(env, tmp_path, name, epochs, jax_written=False):
    cfg = _cfg(env, f"cli_{name}", epochs=epochs, monitor=False)
    cfg.save_dir = str(tmp_path / f"SAVE_{name}")
    path = str(tmp_path / f"cfg_{name}.json")
    cfg.to_json(path)
    if jax_written:   # a config the JAX package wrote carries three fields the port leaves out
        with open(path) as f:
            d = json.load(f)
        extra = {k: getattr(JaxTrainConfig(), k) for k in ("conv_impl", "num_dp_devices", "bank_cache_dir")}
        with open(path, "w") as f:
            json.dump({**d, **extra}, f)
    return path


def test_train_cli_main_and_resume(env, tmp_path, capsys):
    """``main`` with --device cpu from a JAX-written config, then --resume into
    a longer run: only the remaining epoch is trained, and the schedule of the
    new length takes over at the saved count."""
    train_cli.main(["--config", _write_cfg(env, tmp_path, "first", 1, jax_written=True),
                    "--device", "cpu", "--lr", "1e-3"])
    assert "Training complete" in capsys.readouterr().out
    (run1,) = os.listdir(str(tmp_path / "SAVE_first"))
    run1 = os.path.join(str(tmp_path / "SAVE_first"), run1)
    with open(os.path.join(run1, "config.json")) as f:
        assert json.load(f)["lr"] == 1e-3
    resume = os.path.join(run1, "resume_epoch000.pt")
    assert os.path.exists(resume)

    train_cli.main(["--config", _write_cfg(env, tmp_path, "second", 2), "--device", "cpu",
                    "--lr", "1e-3", "--resume", resume])
    assert "continuing at epoch 1" in capsys.readouterr().out
    (run2,) = os.listdir(str(tmp_path / "SAVE_second"))
    run2 = os.path.join(str(tmp_path / "SAVE_second"), run2)
    with open(os.path.join(run2, "metrics.jsonl")) as f:
        trained = [e["epoch"] for e in map(json.loads, f) if e["event"] == "train_epoch"]
    assert trained == [1]
    st = restore_train_state(os.path.join(run2, "resume_epoch001.pt"))
    assert st["train_step"]["step"] == 8 and st["train_step"]["scheduler"]["last_epoch"] == 8
    assert st["train_step"]["scheduler"]["T_max"] == 8
    np.testing.assert_allclose(st["train_step"]["optimizer"]["param_groups"][0]["lr"], 1e-6, rtol=1e-3)


def test_train_cli_refuses_cuda_without_a_card(env, tmp_path):
    """--device defaults to cuda and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        train_cli.main(["--config", _write_cfg(env, tmp_path, "nocard", 1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Experiment(_cfg(env, "nocard"), eval_batch=16)
