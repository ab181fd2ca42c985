"""Tensor parallelism of the port on the CPU: ranks spawned by
``launch_local`` on a (data, model) grid of gloo groups, each rank on one
torch thread, every launch under a deadline.

- ``tp_param_spec`` against JAX ``tp_param_sharding``'s spec on every leaf
  of the flagship tree (built by ``init_encoder`` under ``jax.eval_shape``)
  at tp 1-4, the JAX axis carried to the port's layout through
  ``models/torch_compat.py``.
- The grid's layout and errors, and the blocks a rank keeps.
- One training step at tp 2 (d_model 32, 2 layers, 4 heads, P = 2, K = 2,
  clip 8, K4's plain version at "highest") against JAX's step under
  ``make_mesh(n_data=1, n_model=2)`` with ``tp_param_sharding`` on the
  conftest's virtual devices, dropout 0; and against the port's tp 1 with
  dropout 0.1, at 4 heads (in_proj by heads) and at 3 (q, k and v gathered
  and attended whole).
- The trainer on a (1, 2) grid for an epoch (the train CLI's ``--tp 2``
  path; the CLI itself starts its ranks in tests/test_torch_parallel.py):
  the gathered checkpoints load in a one-device model, and a one-device run
  restores the resume file.

This module imports nothing of JAX at its top: spawned ranks import it to
find their functions, and must not load JAX."""

import json
import os

import numpy as np
import pytest
import torch

from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.parallel import Rank, launch_local, make_grid, tp_param_spec
from video_gen_evals_tpu_torch.parallel.tensor import TensorParallel
from video_gen_evals_tpu_torch.train import checkpoint as port_checkpoint
from video_gen_evals_tpu_torch.train.experiment import Experiment
from video_gen_evals_tpu_torch.train.step import TrainStep

from test_torch_parallel import DEADLINE, HARD_WEIGHT, _cfg, _jax_modules, _stacked_as_jax
from test_torch_parallel import env  # noqa: F401  (fixture)

B, T_LEN, LR, TOTAL_STEPS = 4, 8, 3e-4, 100
# the step's encoder: one modality with its motion chain (two conv stacks)
DIMS_RAW, DIMS_DIFF = {"vit": 16}, {"vit": 16}
# the flagship scorer's input (chip_smoke.py, PERF.md): 5 modalities, 2596-d
FLAGSHIP_RAW = {"vit": 1024, "global": 9, "pose": 207, "beta": 10, "kp2d": 120}
FLAGSHIP_DIFF = {"vit": 1024, "global": 3, "pose": 69, "beta": 10, "kp2d": 120}
# against JAX: the loss, relative, and every parameter after one update,
# relative to its tensor's largest |value|
JAX_TOL = 1e-5
# against tp 1: the loss, relative, and every gradient, relative to the
# largest |gradient| of the model. The model axis sums the row-parallel
# products and the input gradients of the column-parallel ones in another
# order: measured up to 1.2e-6 on the loss (about 13 ulps of 2.6) and 2.0e-6
# on the gradients on the CPU, so 1e-6 does not hold for the loss
TP1_LOSS_RTOL, TP1_GRAD_TOL = 2e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module and its fixtures; the spawned ranks
    take this process's thread count divided among them, so one as well."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(heads: int, dropout: float) -> EncoderConfig:
    """4 heads at d_model 32; 3 heads (which 2 ranks do not divide) at 48."""
    return EncoderConfig.create(DIMS_RAW, DIMS_DIFF, time_heads=heads, dropout=dropout,
                                d_model=32 if heads == 4 else 48, time_layers=2)


def _key_bias(name: str, d_model: int) -> slice:
    """The key third of an in_proj bias: its true gradient is zero (a
    constant added to every logit of a query), so AdamW turns the rounding
    noise there into an update of up to lr of either sign."""
    return slice(d_model, 2 * d_model) if name.endswith("in_proj_bias") else slice(0, 0)


# ---------------------------------------------------------------------------
# functions the spawned ranks run


def _update(rank, state_dict, stacked, labels, heads, dropout, tp):
    """One ``TrainStep.update`` of the model of ``state_dict`` on
    ``stacked`` at ``heads`` heads: on one device (``rank`` None) or sharded
    over a model axis of ``tp`` ranks. Returns the loss, every gradient
    before the optimizer and every parameter after it, gathered whole."""
    model = HumanActionScorer(_config(heads, dropout))
    model.load_state_dict(state_dict, strict=True)
    if rank is not None:
        rank = make_grid(rank, n_model=tp)
        model.shard_(rank.model)
    ts = TrainStep(model, LR, TOTAL_STEPS, hard_weight=HARD_WEIGHT, precision="highest", seed=3, rank=rank)
    grads = {}

    def capture(_optimizer, _args, _kwargs):
        for n, p in model.named_parameters():
            grads[n] = p.grad.clone() if model.tp is None else model.tp.gather(n, p.grad)

    ts.optimizer.register_step_pre_hook(capture)
    metrics = ts.update(torch.from_numpy(stacked), torch.from_numpy(labels).long())
    return {"total": metrics["total"], "grads": grads, "params": model.full_state_dict(),
            "moments": ts.state_dict()["optimizer"]["state"], "local": dict(model.state_dict())}


def _updates_main(rank: Rank, cases, train_cfg):
    """The step cases, then a 1-epoch ``Experiment`` of ``train_cfg`` on a
    (1, 2) grid: its save directory and best checkpoint."""
    out = [_update(rank, *case) for case in cases]
    grid = make_grid(rank, n_model=2)
    exp = Experiment(train_cfg, eval_batch=16, device="cpu", rank=grid)
    exp.run()
    return {"cases": out, "grid": (grid.world // grid.tp, grid.tp), "save_dir": exp.save_dir,
            "best_ckpt": exp.best_ckpt, "jax": _jax_modules()}


# ---------------------------------------------------------------------------
# the layout


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship tree's leaf shapes (``init_encoder`` traced, not
    run) and the port's parameter shapes."""
    import jax

    from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
    from video_gen_evals_tpu.models.fusion_encoder import init_encoder

    jcfg = JaxEncoderConfig.create(FLAGSHIP_RAW, FLAGSHIP_DIFF)
    shapes = jax.eval_shape(lambda: init_encoder(jcfg, jax.random.key(0), 32)[1])
    cfg = EncoderConfig.create(FLAGSHIP_RAW, FLAGSHIP_DIFF)
    with torch.device("meta"):
        port = {n: tuple(p.shape) for n, p in HumanActionScorer(cfg).named_parameters()}
    return shapes, port, cfg


@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_tp_param_spec_matches_jax(flagship, tp):
    """Leaf for leaf on the flagship tree: the axis JAX's spec shards (on a
    (1, tp) mesh, after its divisibility rule), carried through the
    converter's transposes, is ``tp_param_spec``'s. Of the 240 leaves (10
    conv encoders of 18, the fusion's 11, the CLS token, 4 layers of 12),
    114 are sharded at tp 2 and 4 (each encoder's stem and 8 conv kernels,
    each layer's 6 projection leaves), and 8 at tp 3 (only the in_proj
    weight and bias divide)."""
    import jax

    from video_gen_evals_tpu.parallel.mesh import make_mesh, tp_param_sharding
    from video_gen_evals_tpu_torch.models.torch_compat import state_dict_from_jax_params

    shapes, port, cfg = flagship
    specs = tp_param_sharding(make_mesh(n_data=1, n_model=tp), shapes)

    def marked(leaf, sharding):
        """A stand-in of the leaf with every axis cut to at most 2, counting
        0, 1 along the axis JAX shards (zeros where it is replicated): the
        converter's transposes carry that axis to the port's layout."""
        small = tuple(min(n, 2) for n in leaf.shape)
        out = np.zeros(small, np.float32)
        axes = [i for i, ax in enumerate(sharding.spec) if ax == "model"]
        if axes:
            view = [1] * len(small)
            view[axes[0]] = small[axes[0]]
            out += np.arange(small[axes[0]], dtype=np.float32).reshape(view)
        return out

    tree = jax.tree_util.tree_map(marked, shapes, specs)
    n_jax = sum(any(ax == "model" for ax in s.spec) for s in jax.tree_util.tree_leaves(specs))
    sd = {k: v for k, v in state_dict_from_jax_params(tree, cfg).items() if k != "pos_enc.pe"}
    assert len(sd) == len(jax.tree_util.tree_leaves(shapes)) == 240
    assert sorted(sd) == sorted(port)
    n_port = 0
    for name, t in sd.items():
        varying = [a for a in range(t.ndim) if t.shape[a] > 1 and bool((t.diff(dim=a) != 0).any())]
        want = varying[0] if varying else None
        assert len(varying) <= 1 and tp_param_spec(name, port[name], tp) == want, (name, varying)
        n_port += want is not None
    assert n_port == n_jax == {1: 114, 2: 114, 3: 8, 4: 114}[tp]


def test_grid_layout_errors_and_blocks():
    """The grid refuses what JAX's make_mesh refuses and a grid that leaves
    ranks out; off a grid a rank's data axis is itself and its model axis a
    group of one. A rank's blocks: in_proj by heads (q, k and v rows of its
    heads), contiguous where the axis divides 3D but not the heads, the
    stem and conv kernels on output channels; the blocks of every rank,
    reassembled, are the whole tensor."""
    cpu = torch.device("cpu")
    one = Rank(0, 1, cpu, backend="none")
    with pytest.raises(ValueError, match="n_model must be >= 1"):
        make_grid(one, n_model=0)
    with pytest.raises(ValueError, match="need at least n_model=2"):
        make_grid(one, n_model=2)
    with pytest.raises(ValueError, match=r"grid \(1 data x 2 model\) needs 2 ranks"):
        make_grid(Rank(0, 3, cpu, "gloo"), n_model=2, n_data=1)
    assert make_grid(one) is one and one.data is one and one.model.world == 1
    r = Rank(3, 4, cpu, "gloo", tp=2)
    assert (r.data.rank, r.data.world, r.model.rank, r.model.world) == (1, 2, 1, 2)

    for heads, tp in ((4, 2), (3, 2), (4, 4)):
        model = HumanActionScorer(_config(heads, 0.0), generator=torch.Generator().manual_seed(0))
        full = {n: p.detach() for n, p in model.named_parameters()}
        shapes = {n: tuple(p.shape) for n, p in full.items()}
        views = [TensorParallel(Rank(i, tp, cpu, "gloo"), heads, shapes) for i in range(tp)]
        name = "temporal.layers.0.self_attn.in_proj_weight"
        blocks = [v.shard(name, full[name]) for v in views]
        d = model.config.d_model
        if heads % tp == 0:
            dl = d // tp
            assert views[0].by_heads and torch.equal(
                blocks[1], torch.cat([full[name][j * d + dl:j * d + 2 * dl] for j in range(3)]))
        else:
            assert not views[0].by_heads and torch.equal(blocks[1], full[name][3 * d // tp:2 * 3 * d // tp])
        for n, t in full.items():
            axis = tp_param_spec(n, t.shape, tp)
            parts = [v.shard(n, t) for v in views]
            if axis is None:
                assert all(p is t for p in parts), n
                continue
            order = torch.cat([v._block(n, i) for i, v in enumerate(views)])
            back = torch.empty_like(t).index_copy_(axis, order, torch.cat(parts, dim=axis))
            assert torch.equal(back, t), n
        assert views[0].sharded("state_enc.vit.stem.weight") and not views[0].sharded("fusion.Wq.weight")


# ---------------------------------------------------------------------------
# the step


@pytest.fixture(scope="module")
def step_case():
    """A seeded port model (4 heads), JAX's stacked batch, and JAX's step on
    a (1 data, 2 model) mesh with ``tp_param_sharding`` (module convs, no
    dropout): its loss and parameters after the update."""
    import jax
    import jax.numpy as jnp

    from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
    from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
    from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
    from video_gen_evals_tpu.parallel import make_mesh
    from video_gen_evals_tpu.parallel.mesh import tp_param_sharding
    from video_gen_evals_tpu.train import step as jax_step

    models = {h: HumanActionScorer(_config(h, 0.0), generator=torch.Generator().manual_seed(3)) for h in (4, 3)}
    sds = {h: {k: v.clone() for k, v in m.state_dict().items()} for h, m in models.items()}
    jcfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=32, time_layers=2, time_heads=4, dropout=0.0,
                                   conv_impl="module")
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in sds[4].items()}, jcfg, strict=True)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(B, T_LEN, jcfg.input_dim)).astype(np.float32)
    labels = np.repeat(np.arange(2), 2).astype(np.int32)
    key = jax.random.key(7)
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        mesh = make_mesh(n_data=1, n_model=2)
        placed = jax.tree_util.tree_map(jax.device_put, params, tp_param_sharding(mesh, params))
        tx = jax_step.make_optimizer(LR, TOTAL_STEPS)
        state = jax_step.TrainState(placed, tx.init(placed), jnp.zeros((), jnp.int32))
        step = jax_step.make_train_step(JaxHumanActionScorer(jcfg), tx, HARD_WEIGHT, donate=False)
        state, metrics = step(state, jnp.asarray(feats), jnp.asarray(labels), key)
        new = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
        stacked = _stacked_as_jax(feats, jax.random.fold_in(key, 0))
        total = float(metrics["total"])
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()
    return dict(sds=sds, labels=labels, stacked=stacked, total=total, params=new, jcfg=jcfg)


@pytest.fixture(scope="module")
def tp_runs(step_case, env):
    """At tp 2 in one launch: 4 heads without dropout (against JAX) and with
    dropout 0.1, 3 heads with dropout 0.1 (against tp 1 below); then the
    trainer for 1 epoch on the fixture tree."""
    c = step_case
    cases = [(c["sds"][4], c["stacked"], c["labels"], 4, 0.0, 2),
             (c["sds"][4], c["stacked"], c["labels"], 4, 0.1, 2),
             (c["sds"][3], c["stacked"], c["labels"], 3, 0.1, 2)]
    cfg = _cfg(env, "tp")
    cfg.epochs = 1
    return launch_local(2, _updates_main, cases, cfg, device="cpu", timeout=DEADLINE)


def test_tp_step_matches_jax(step_case, tp_runs):
    """tp 2 against JAX's step on its (1, 2) mesh, dropout 0: the loss
    within 1e-5 relative; every parameter after the update within 1e-5 of
    its tensor's largest |value|, but the key third of each in_proj bias
    within 2 x lr (its true gradient is zero, see ``_key_bias``); both ranks
    hold the same gathered tree, and no spawned rank loads JAX."""
    from video_gen_evals_tpu_torch.models.torch_compat import state_dict_from_jax_params

    c = step_case
    want = state_dict_from_jax_params(c["params"], _config(4, 0.0))
    for r in tp_runs:
        got = r["cases"][0]
        assert r["jax"] == []
        np.testing.assert_allclose(got["total"], c["total"], rtol=JAX_TOL)
        assert sorted(got["params"]) == sorted(want)
        for name, w in want.items():
            g, kb = got["params"][name], _key_bias(name, 32)
            scale = w.abs().max().item()
            mask = torch.ones_like(w, dtype=torch.bool)
            mask[kb] = False
            assert (g - w)[mask].abs().max().item() <= JAX_TOL * max(scale, 1e-12) if mask.any() else True, name
            assert (g - w)[kb].abs().max().item() <= 2 * LR if g[kb].numel() else True, name
    for name, v in tp_runs[0]["cases"][0]["params"].items():
        assert torch.equal(v, tp_runs[1]["cases"][0]["params"][name]), name


@pytest.mark.parametrize("case,heads", [(1, 4), (2, 3)])
def test_tp_step_with_dropout_matches_tp1(step_case, tp_runs, case, heads):
    """tp 2 against the port on one device, dropout 0.1 (the masks drawn at
    the one-rank shape and cut to the rank's heads and FFN columns; a mask
    cut wrong moves the loss by whole units): the loss within
    TP1_LOSS_RTOL, every gradient within TP1_GRAD_TOL of the model's largest
    |gradient|; the rank's blocks are the sharded tensors' blocks. At 3
    heads the axis divides 3D but not the heads, so q, k and v are gathered
    and attended whole."""
    c = step_case
    d = _config(heads, 0.1).d_model
    one = _update(None, c["sds"][heads], c["stacked"], c["labels"], heads, 0.1, 1)
    for r in tp_runs:
        got = r["cases"][case]
        np.testing.assert_allclose(got["total"], one["total"], rtol=TP1_LOSS_RTOL)
        scale = max(g.abs().max().item() for g in one["grads"].values())
        for name, g in one["grads"].items():
            assert (got["grads"][name] - g).abs().max().item() <= TP1_GRAD_TOL * scale, name
        local = got["local"]
        assert local["temporal.layers.0.self_attn.in_proj_weight"].shape == (3 * d // 2, d)
        assert local["temporal.layers.0.self_attn.out_proj.weight"].shape == (d, d // 2)
        assert local["temporal.layers.0.linear1.weight"].shape == (2 * d, d)
        assert local["state_enc.vit.blocks.0.conv1.weight"].shape == (d // 2, d, 5)
        assert local["fusion.Wq.weight"].shape == (d, d)


# ---------------------------------------------------------------------------
# the trainer


def test_tp2_trainer_checkpoints_load_on_one_device(env, tp_runs):
    """The trainer on a (1, 2) grid, 1 epoch: both ranks write to one
    directory, rank 0 alone; the best checkpoint and the resume file hold the
    gathered tree (the one-device model loads them strictly, the moments
    whole); a one-device run's ``Experiment`` restores the resume file
    (weights, moments, step) to continue at epoch 1."""
    r0, r1 = tp_runs
    assert r0["grid"] == r1["grid"] == (1, 2) and r0["save_dir"] == r1["save_dir"]
    save_dir = r0["save_dir"]
    best = torch.load(r0["best_ckpt"], map_location="cpu", weights_only=True)["model_state_dict"]
    state = port_checkpoint.restore_train_state(os.path.join(save_dir, "resume_epoch000.pt"))
    whole = HumanActionScorer(_tree_config(best))
    whole.load_state_dict(best, strict=True)
    whole.load_state_dict(state["model"], strict=True)
    shapes = [p.shape for p in whole.parameters()]
    assert all(s["exp_avg"].shape == s["exp_avg_sq"].shape == shapes[i]
               for i, s in state["train_step"]["optimizer"]["state"].items())
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert all(np.isfinite(e["loss"]) for e in events if e["event"] in ("train_epoch", "eval_loss"))
    assert sum(e["event"] == "train_epoch" for e in events) == 1

    exp = Experiment(_cfg(env, "tp_restored"), eval_batch=16, device="cpu")
    assert exp.restore_resume_checkpoint(os.path.join(save_dir, "resume_epoch000.pt")) == 1
    assert all(torch.equal(v, state["model"][k]) for k, v in exp.model.state_dict().items())
    assert exp.train_step.step == state["train_step"]["step"] > 0


def _tree_config(state_dict) -> EncoderConfig:
    """The encoder config of a fixture-tree run's state_dict: its modalities'
    stem widths, d_model 32, one layer (``_cfg``)."""
    raw, diff = {}, {}
    for k, v in state_dict.items():
        parts = k.split(".")
        if parts[0] in ("state_enc", "motion_enc") and parts[2] == "stem":
            (raw if parts[0] == "state_enc" else diff)[parts[1]] = v.shape[1]
    return EncoderConfig.create(raw, {m: diff.get(m, 0) for m in raw}, d_model=32, time_layers=1)
