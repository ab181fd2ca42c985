"""The port's parallel slice on the CPU: ranks spawned by ``launch_local``
joining a gloo group (each rank on one torch thread, every launch under a
deadline). The data-parallel step at world 2 against JAX's loss and
gradients on a 2-device mesh; dropout at world 2 against world 1; the
``Experiment`` at world 2 against world 1, the world-1 path bitwise the
single-device run, parameters bitwise equal across ranks after every epoch,
files written by rank 0 only, a resumed world-2 run bitwise the
uninterrupted one; the score CLI's ``--mesh-data`` and ``--num-hosts`` +
``merge_scores`` against its one-rank run; the launcher's failure and
deadline handling; the CLIs' distributed flags; and no spawned rank loads
JAX.

This module imports nothing of JAX at its top: spawned ranks import it to
find their functions (the ``_rank_*`` and ``_*_main`` below), and must not
load JAX. The JAX side runs in the test process only."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from video_gen_evals_tpu_torch.core.config import PathsConfig, TrainConfig
from video_gen_evals_tpu_torch.data.fixtures import make_fixture_tree, write_keypoints, write_mesh_npz
from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.models import fusion_encoder
from video_gen_evals_tpu_torch.parallel import Rank, RankFailed, barrier, initialize_distributed, launch_local, shutdown
from video_gen_evals_tpu_torch.parallel.mesh import free_port
from video_gen_evals_tpu_torch.pipelines import merge_scores, score, train_cli
from video_gen_evals_tpu_torch.train import checkpoint as port_checkpoint
from video_gen_evals_tpu_torch.train.experiment import Experiment
from video_gen_evals_tpu_torch.train.step import _DROPOUT, TrainStep, loss_components, seeded_generator

CLASSES = ["JumpingJack", "PushUps"]
DIMS_RAW = {"vit": 16, "pose": 18}
DIMS_DIFF = {"vit": 16, "pose": 6}
B, T_LEN, HARD_WEIGHT = 8, 8, 10.0
KW = dict(d_model=32, time_layers=1, time_heads=4)
JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", "video_gen_evals_tpu")
DEADLINE = 150.0   # seconds a launch may take before its ranks are killed


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module and its fixtures (a bitwise comparison
    of two runs needs both to sum in the same order); the spawned ranks take
    this process's thread count divided among them, so one as well."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_ROOTS)


def _flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).clone()


# ---------------------------------------------------------------------------
# functions the spawned ranks run


def _rank_fails(rank: Rank):
    if rank.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    barrier(rank)   # waits for a peer that is gone
    return "rank 0 should not get here"


def _rank_sleeps(rank: Rank):
    time.sleep(10 * DEADLINE)


def _model(state_dict, dropout):
    model = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF, dropout=dropout, **KW))
    model.load_state_dict(state_dict, strict=True)
    return model.train()


def _step_main(rank: Rank, state_dict, stacked, labels, dropout):
    """The data-parallel step's loss and summed gradients on the stacked
    batch ``stacked`` (no optimizer step), with the dropout masks the
    forward drew (dim 0 is the window axis of every mask)."""
    model = _model(state_dict, dropout)
    ts = TrainStep(model, 3e-4, 100, hard_weight=HARD_WEIGHT, precision="highest", rank=rank)
    masks = []
    draw = fusion_encoder.Dropout.mask
    fusion_encoder.Dropout.mask = lambda self, like, *split: masks.append(draw(self, like, *split)) or masks[-1]
    try:
        emb = ts.embed(torch.from_numpy(stacked), "highest", seeded_generator(0, 0, _DROPOUT))
    finally:
        fusion_encoder.Dropout.mask = draw
    comps = loss_components(emb, torch.from_numpy(labels).long(), HARD_WEIGHT)
    total = sum(comps.values())
    total.backward()
    if rank is not None:
        ts._sum_gradients()
    return {"total": total.item(), "comps": {k: v.item() for k, v in comps.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "masks": masks, "jax": _jax_modules()}


def _steps_main(rank: Rank, state_dict, stacked, labels, dropouts):
    return {d: _step_main(rank, state_dict, stacked, labels, d) for d in dropouts}


def _world2_main(rank: Rank, state_dict, stacked, labels, dropouts, cfg: TrainConfig,
                 resume_cfg: TrainConfig):
    """Both world-2 jobs of this module in one launch, since each launch
    spawns its ranks and imports anew: the step at each dropout, then the
    2-epoch run and its resumed run."""
    return {"steps": _steps_main(rank, state_dict, stacked, labels, dropouts),
            "train": _train_main(rank, cfg, resume_cfg)}


def _train(cfg: TrainConfig, rank: Rank, resume: str = None) -> Experiment:
    exp = Experiment(cfg, eval_batch=16, device="cpu", precision="highest", rank=rank)
    exp.run(start_epoch=exp.restore_resume_checkpoint(resume) if resume else 0)
    return exp


def _train_main(rank: Rank, cfg: TrainConfig, resume_cfg: TrainConfig = None):
    """The 2-epoch run of ``cfg`` on this rank, with the parameters after
    every epoch and every file this rank opened for writing under the save
    root; then, given ``resume_cfg``, a run of it resumed from the first
    run's epoch-0 checkpoint. Returns the final train states."""
    import builtins

    snaps, writes = [], []
    save = Experiment.save_resume_checkpoint
    opened, saved = builtins.open, torch.save

    def snap(self, epoch, *a, **k):
        snaps.append(_flat_params(self.model))
        return save(self, epoch, *a, **k)

    def watch(path, mode="r", *a, **k):
        if any(c in mode for c in "wax") and str(path).startswith(os.path.dirname(cfg.save_dir)):
            writes.append(str(path))
        return opened(path, mode, *a, **k)

    def watch_save(obj, f, *a, **k):
        writes.append(str(f))
        return saved(obj, f, *a, **k)

    Experiment.save_resume_checkpoint = snap
    builtins.open, port_checkpoint.torch.save = watch, watch_save
    try:
        dirs = [_train(cfg, rank).save_dir]
        if resume_cfg is not None:
            dirs.append(_train(resume_cfg, rank, os.path.join(dirs[0], "resume_epoch000.pt")).save_dir)
    finally:
        Experiment.save_resume_checkpoint = save
        builtins.open, port_checkpoint.torch.save = opened, saved
    final = [port_checkpoint.restore_train_state(os.path.join(d, "resume_epoch001.pt")) for d in dirs]
    return {"snaps": snaps, "writes": writes, "dirs": dirs, "final": final, "jax": _jax_modules()}


def _score_rank(rank: Rank, state_dict, enc_kw, gen_dir, mesh_root, real_paths, gen_paths, cfg, output_json):
    """``score_generated`` as one rank of a data-parallel group."""
    model = HumanActionScorer(EncoderConfig.create(**enc_kw))
    model.load_state_dict(state_dict, strict=True)
    got = score.score_generated(model, gen_dir, mesh_root, real_paths, gen_paths, cfg=cfg,
                                output_json=output_json, device="cpu", rank=rank)
    return {"scores": got["scores"], "jax": _jax_modules()}


def _extract_rank(rank: Rank, cfg, state_dicts, tree, out_root, log_dir, kp_root):
    """``run_tree`` as the extract CLI's rank ``rank`` of ``--mesh-data``
    on one host: the shard ``rank_shard`` gives it."""
    from video_gen_evals_tpu_torch.pipelines.extract import Extractor, rank_shard

    shard, shards = rank_shard(0, 1, rank.rank, rank.world)
    ex = Extractor(cfg, state_dicts=state_dicts, device="cpu")
    counts = ex.run_tree(tree, out_root, log_dir, kp_out_root=kp_root, stream_group=1,
                         num_hosts=shards, host_id=shard)
    return {"counts": counts, "jax": _jax_modules()}


# ---------------------------------------------------------------------------
# the step: world 2 against JAX's 2-device mesh, dropout against world 1


def _stacked_as_jax(feats: np.ndarray, key) -> np.ndarray:
    """The stacked batch JAX's loss_fn builds from ``key``, built by the
    port's pure functions from the indices JAX draws
    (tests/test_torch_train_step.py)."""
    import jax

    from video_gen_evals_tpu_torch.ops.corruption import apply_partial_shuffle, reverse_sequence, static_window

    k_shuf, _k_drop = jax.random.split(key)
    n = max(1, int(0.7 * T_LEN))
    positions, order = [], []
    for k in jax.random.split(k_shuf, feats.shape[0]):
        k1, k2 = jax.random.split(k)
        positions.append(np.asarray(jax.random.permutation(k1, T_LEN)[:n]))
        order.append(np.asarray(jax.random.permutation(k2, n)))
    x = torch.from_numpy(feats)
    shuffled = apply_partial_shuffle(
        x, torch.from_numpy(np.stack(positions)).long(), torch.from_numpy(np.stack(order)).long())
    return torch.cat([x, shuffled, reverse_sequence(x), static_window(x)], dim=0).numpy()


@pytest.fixture(scope="module")
def step_case():
    """One seeded port model, a batch, JAX's loss and gradients on a 2-device
    mesh (module convs at matmul precision "highest", no dropout), and the
    stacked batch JAX's loss built."""
    import jax
    import jax.numpy as jnp

    from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
    from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
    from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
    from video_gen_evals_tpu.parallel import batch_sharding, make_mesh, replicated_sharding
    from video_gen_evals_tpu.train.step import make_loss_fn

    port = HumanActionScorer(EncoderConfig.create(DIMS_RAW, DIMS_DIFF, dropout=0.0, **KW),
                             generator=torch.Generator().manual_seed(3))
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    jcfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, dropout=0.0, **KW)
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, jcfg, strict=True)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T_LEN, jcfg.input_dim)).astype(np.float32)
    labels = np.repeat(np.arange(4), 2).astype(np.int32)
    key = jax.random.key(7)
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        loss_fn = make_loss_fn(JaxHumanActionScorer(jcfg), HARD_WEIGHT, matmul_precision="highest")
        grad_fn = jax.jit(jax.value_and_grad(lambda p, f, l, r: loss_fn(p, f, l, r, False)[0]))
        mesh = make_mesh(n_data=2, n_model=1)
        value, grads = grad_fn(jax.device_put(params, replicated_sharding(mesh)),
                               jax.device_put(jnp.asarray(feats), batch_sharding(mesh)),
                               jax.device_put(jnp.asarray(labels), batch_sharding(mesh)), key)
        grads = jax.tree_util.tree_map(np.asarray, jax.device_get(grads))
        stacked = _stacked_as_jax(feats, key)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()
    return dict(sd=sd, labels=labels, stacked=stacked, total=float(value), grads=grads, config=port.config)


@pytest.fixture(scope="module")
def world2(step_case, env):
    """One launch of 2 ranks for the step cases and the experiment below."""
    c = step_case
    return launch_local(2, _world2_main, c["sd"], c["stacked"], c["labels"], (0.0, 0.1),
                        _cfg(env, "w2"), _cfg(env, "w2_resumed"), device="cpu", timeout=DEADLINE)


@pytest.fixture(scope="module")
def step_runs(world2):
    """The step at world 2 without dropout (against JAX) and with dropout 0.1
    (against the one-device run below)."""
    return {d: [r["steps"][d] for r in world2] for d in (0.0, 0.1)}


def test_dp_loss_and_gradients_match_jax_mesh(step_case, step_runs):
    """World 2: the global loss within rtol 1e-5 of JAX's on its 2-device
    mesh, every parameter's summed gradient within atol 2e-5 (the JAX
    package's own dp tolerance, tests/test_train.py), the same on both
    ranks bitwise."""
    from video_gen_evals_tpu_torch.models.torch_compat import named_tensors_from_jax_tree

    c = step_case
    r0, r1 = step_runs[0.0]
    want = named_tensors_from_jax_tree(c["grads"], c["config"])
    assert sorted(want) == sorted(r0["grads"])
    for r in (r0, r1):
        np.testing.assert_allclose(r["total"], c["total"], rtol=1e-5)
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5, rtol=0, err_msg=name)
    assert r0["total"] == r1["total"]
    assert all(torch.equal(r0["grads"][n], r1["grads"][n]) for n in r0["grads"])


def test_dp_dropout_masks_and_loss_match_world_one(step_case, step_runs):
    """Dropout 0.1 at world 2: every mask the two ranks drew, joined along
    the window axis, is bitwise the mask the one-device forward draws, in
    the same order (K4's included), and the loss is within 1e-6; the summed
    gradients within 1e-6 of the one-device ones."""
    c = step_case
    one = _step_main(None, c["sd"], c["stacked"], c["labels"], 0.1)
    r0, r1 = step_runs[0.1]
    assert len(one["masks"]) == len(r0["masks"]) == len(r1["masks"]) > 0
    for m, a, b in zip(one["masks"], r0["masks"], r1["masks"]):
        assert a.shape[0] == b.shape[0] == m.shape[0] // 2
        assert torch.equal(torch.cat([a, b]), m)
    kept = float(np.mean([(m > 0).float().mean().item() for m in one["masks"]]))
    assert 0.85 < kept < 0.95
    for r in (r0, r1):
        np.testing.assert_allclose(r["total"], one["total"], rtol=0, atol=1e-6)
        for name, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), one["grads"][name].numpy(), atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the experiment


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """tests/test_torch_train_experiment.py's tree: 2 classes x 4 real
    videos, 4 generated videos, a MOS file."""
    root = str(tmp_path_factory.mktemp("torch_parallel"))
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


def _cfg(env, name, **kw) -> TrainConfig:
    return TrainConfig(
        paths=PathsConfig(real_meshes_dir=env["mesh_root"], real_kp_dir=env["kp_root"],
                          generated_meshes_dir=env["gen_dir"], gen_kp_dir=env["gen_kp"],
                          human_scores=env["human"]),
        epochs=2, clip_len=16, stride=8, P=2, K=4, time_layers=1, d_model=32, time_heads=4,
        filter_classes=None, save_dir=os.path.join(env["root"], name, "SAVE"), **kw)


@pytest.fixture(scope="module")
def runs(env, world2):
    """The same 2-epoch run alone (no rank) and at worlds 1 and 2; world 2
    also resumes from its epoch-0 checkpoint."""
    out = {"single": _train_main(None, _cfg(env, "single"))}
    # world 1 here: a gloo group of one in this process
    rank = initialize_distributed(f"localhost:{free_port()}", 1, 0, "cpu", join_alone=True)
    try:
        out[1] = [_train_main(rank, _cfg(env, "w1"))]
    finally:
        shutdown(rank)
    out[2] = [r["train"] for r in world2]
    return out


def _events(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_experiment_world_one_is_bitwise_the_single_device_run(runs):
    """The data-parallel path at world 1 (a gloo group of one, in this
    process) gives the single-device run's bits: parameters after every
    epoch, the final train state and every logged number."""
    single, (w1,) = runs["single"], runs[1]
    assert len(single["snaps"]) == len(w1["snaps"]) == 2
    assert all(torch.equal(a, b) for a, b in zip(single["snaps"], w1["snaps"]))
    (a,), (b,) = single["final"], w1["final"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["train_step"]["optimizer"]["state"], b["train_step"]["optimizer"]["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    strip = lambda e: {k: v for k, v in e.items() if k not in ("seconds", "clips_per_sec")}   # noqa: E731
    assert [strip(e) for e in _events(single["dirs"][0])] == [strip(e) for e in _events(w1["dirs"][0])]


def test_experiment_world_two_matches_world_one(runs):
    """World 2 against world 1: every epoch's train loss, eval loss and
    centroid distance within rtol 2e-3 (JAX's dp tolerance,
    tests/test_train.py); the parameters bitwise equal on both ranks after
    every epoch; rank 0 alone wrote files, and each event once."""
    (w1,), (r0, r1) = runs[1], runs[2]
    assert len(r0["snaps"]) == len(r1["snaps"]) == 2 + 1   # two epochs, then the resumed one
    assert all(torch.equal(a, b) for a, b in zip(r0["snaps"], r1["snaps"]))
    e1, e2 = _events(w1["dirs"][0]), _events(r0["dirs"][0])
    assert [e["event"] for e in e1] == [e["event"] for e in e2]
    for a, b in zip(e1, e2):
        for key in ("loss", "avg"):
            if key in a and a["event"] in ("train_epoch", "eval_loss", "centroid_distance"):
                np.testing.assert_allclose(b[key], a[key], rtol=2e-3, err_msg=str(a))
    assert r0["dirs"] == r1["dirs"]
    assert r1["writes"] == [] and r0["writes"]
    names = sorted(os.listdir(r0["dirs"][0]))
    assert {"metrics.jsonl", "config.json", "label_mapping.json", "resume_epoch000.pt",
            "resume_epoch001.pt"} <= set(names)
    assert sum(e["event"] == "train_epoch" for e in e2) == 2


def test_experiment_world_two_resumes_bitwise(runs):
    """World 2: epoch 0's checkpoint restored on every rank plus the second
    epoch ends with the uninterrupted world-2 run's bits (weights, Adam
    moments, schedule, step, best loss)."""
    r0, _r1 = runs[2]
    a, b = r0["final"]
    assert a["epoch"] == b["epoch"] == 1 and a["best_eval_loss"] == b["best_eval_loss"]
    assert a["train_step"]["step"] == b["train_step"]["step"]
    assert a["train_step"]["scheduler"] == b["train_step"]["scheduler"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    sa, sb = a["train_step"]["optimizer"]["state"], b["train_step"]["optimizer"]["state"]
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert [e["epoch"] for e in _events(r0["dirs"][1]) if e["event"] == "train_epoch"] == [1]


def test_spawned_ranks_load_no_jax(step_runs, runs):
    """A spawned rank's ``sys.modules`` holds nothing of jax, flax, optax,
    orbax or the JAX package, though the test process has them."""
    assert "jax" in sys.modules
    ranks = [r for rs in step_runs.values() for r in rs] + list(runs[2])
    assert all(r["jax"] == [] for r in ranks)


def test_experiment_refuses_an_indivisible_batch(env):
    """P x K must divide over the ranks, as JAX refuses on its mesh."""
    with pytest.raises(ValueError, match="divide evenly"):
        Experiment(_cfg(env, "odd", **{}), device="cpu", rank=Rank(0, 3, torch.device("cpu"), "gloo"))


# ---------------------------------------------------------------------------
# the CLIs


def _score_argv(env, ckpt, out):
    return ["--generated-meshes", env["gen_dir"], "--real-meshes", env["mesh_root"], "--checkpoint", ckpt,
            "--real-kp-dir", env["kp_root"], "--gen-kp-dir", env["gen_kp"], "--clip-len", "16",
            "--stride", "16", "--batch-size", "4", "--output", out, "--no-bug-compat", "--precision",
            "highest", "--device", "cpu"]


def test_score_cli_mesh_data_and_host_shards_match_one_rank(env, tmp_path, monkeypatch):
    """The score CLI at the flagship width on 2 local ranks (--mesh-data 2)
    and as 2 hosts (--num-hosts 2 --host-id 0/1) merged by ``merge_scores``
    against its one-rank run: every video's AC and TC within SCORE_ATOL /
    SCORE_RTOL; rank 0 alone wrote the output; the merge's human
    correlations are computed."""
    from video_gen_evals_tpu_torch.data import compute_stats, scan_class_tree, train_test_split
    from video_gen_evals_tpu_torch.data import ModalityPaths

    monkeypatch.setenv("VGE_LAUNCH_TIMEOUT", str(DEADLINE))
    train, _ = train_test_split(scan_class_tree(env["mesh_root"]), 0.8, seed=1337)
    stats = compute_stats(train.items, ModalityPaths(keypoint_dir=env["kp_root"], layout="real"))
    model = HumanActionScorer(EncoderConfig.create(stats.dims_map_raw(), stats.dims_map_diff()),
                              generator=torch.Generator().manual_seed(4))
    ckpt = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": model.state_dict()}, ckpt)
    outs = {k: str(tmp_path / f"{k}.json") for k in ("one", "two", "hosts")}
    (one,) = score.main(_score_argv(env, ckpt, outs["one"]))
    two = score.main(_score_argv(env, ckpt, outs["two"]) + ["--mesh-data", "2"])
    assert [r["rank"] for r in two] == [0, 1] and all(r["videos"] == one["videos"] == 4 for r in two)
    shards = [score.main(_score_argv(env, ckpt, outs["hosts"]) + ["--num-hosts", "2", "--host-id", str(h)])[0]
              for h in (0, 1)]
    assert [s["output_json"] for s in shards] == [str(tmp_path / f"hosts.host{h}of2.json") for h in (0, 1)]
    merged = str(tmp_path / "merged.json")
    merge_scores.main([s["output_json"] for s in shards] + ["--output", merged, "--human-scores", env["human"]])
    with open(outs["one"]) as f:
        want = json.load(f)
    for path in (outs["two"], merged):
        with open(path) as f:
            got = json.load(f)
        assert sorted(got) == sorted(want) == sorted(env["stems"])
        for vid, entry in want.items():
            assert set(got[vid]) == set(entry)
            for m, v in entry.items():
                np.testing.assert_allclose(got[vid][m], v, rtol=merge_scores.SCORE_RTOL,
                                           atol=merge_scores.SCORE_ATOL, err_msg=f"{path} {vid} {m}")


def test_launch_local_stops_every_rank_on_a_failure_or_past_its_deadline():
    """A rank that raises fails the launch at once (the other rank, blocked
    in a collective, is killed); a launch past its deadline is killed; a
    CUDA launch without a card raises."""
    t0 = time.monotonic()
    with pytest.raises(RankFailed, match=r"rank 1 \(exit code 1\)"):
        launch_local(2, _rank_fails, device="cpu", timeout=DEADLINE)
    assert time.monotonic() - t0 < DEADLINE / 2
    with pytest.raises(RankFailed, match="deadline of 2 s"):
        launch_local(2, _rank_sleeps, device="cpu", timeout=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_local(2, _rank_sleeps, device="cuda", timeout=3)


def test_train_cli_distributed_flags(env, tmp_path, capsys):
    """The train CLI: --tp 0 refused, --tp 2 accepted (two ranks start, and
    a missing tree fails them, as --dp 2's below); --dp 2 on cuda without a
    card refused; --dp that does not divide P x K refused; a
    rank that fails makes the CLI fail (RankFailed, so a nonzero exit); the
    distributed flags validated as JAX validates them."""
    cfg = _cfg(env, "cli")
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    with pytest.raises(SystemExit):
        train_cli.main(["--config", path, "--tp", "0", "--device", "cpu"])
    assert "--tp must be >= 1" in capsys.readouterr().err
    with pytest.raises(RankFailed, match=r"launch_local\(2 ranks of _run\).*\(exit code 1\)"):
        train_cli.main(["--config", path, "--tp", "2", "--device", "cpu", "--real-meshes", str(tmp_path / "missing")])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            train_cli.main(["--config", path, "--dp", "2", "--device", "cuda"])
        assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train_cli.main(["--config", path, "--dp", "3", "--device", "cpu"])
    assert "divide evenly" in capsys.readouterr().err
    for argv, said in ((["--coordinator", "h:1"], "--num-processes"), (["--num-processes", "2"], "--process-id"),
                       (["--num-processes", "2", "--process-id", "1"], "--coordinator")):
        with pytest.raises(SystemExit, match=said):
            train_cli.main(["--config", path, "--device", "cpu", *argv])
    with pytest.raises(RankFailed, match=r"\(exit code 1\)"):
        train_cli.main(["--config", path, "--dp", "2", "--device", "cpu",
                        "--real-meshes", str(tmp_path / "missing")])


def test_distributed_flag_validation():
    """``utils/cli.py`` passes JAX's own check
    (tests/test_train_cli.py::test_distributed_flag_validation), and a run
    without the flags joins nothing."""
    import argparse

    from video_gen_evals_tpu_torch.utils.cli import add_distributed_args, maybe_initialize_distributed

    p = argparse.ArgumentParser()
    add_distributed_args(p)
    with pytest.raises(SystemExit, match="--num-processes"):
        maybe_initialize_distributed(p.parse_args(["--coordinator", "x:1"]))
    with pytest.raises(SystemExit, match="--num-processes"):
        maybe_initialize_distributed(p.parse_args(["--process-id", "0"]))
    with pytest.raises(SystemExit, match="--process-id"):
        maybe_initialize_distributed(p.parse_args(["--num-processes", "2"]))
    with pytest.raises(SystemExit, match="--coordinator"):
        maybe_initialize_distributed(p.parse_args(["--num-processes", "2", "--process-id", "0"]))
    assert maybe_initialize_distributed(p.parse_args([])) is None
