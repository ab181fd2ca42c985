"""The training slice of the port against the JAX package on the CPU, as a
whole: a tiny encoder (two modalities, d_model 32, one layer, T = 8, dropout
0) with the same weights on both sides, the same stacked batch, the loss,
every parameter's gradient, and optimizer steps. The JAX side runs its fused
conv stages (``conv_impl="kernel"``, ``conv_precision="highest"``: the Pallas
kernels in interpret mode off-TPU); the port runs K4's plain versions through
its ``autograd.Function``. The port's shuffle is fed the indices that JAX
derives from its key (``fold_in(rng, step)``, then ``split``)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models.fusion_encoder import init_encoder
from video_gen_evals_tpu.train import step as jax_step

from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.models.torch_compat import (
    load_optax_adam_state,
    named_tensors_from_jax_tree,
    state_dict_from_jax_params,
)
from video_gen_evals_tpu_torch.ops.corruption import (
    apply_partial_shuffle,
    reverse_sequence,
    static_window,
)
from video_gen_evals_tpu_torch.train.step import (
    COMPONENTS,
    TrainStep,
    loss_components,
    position_cosine_schedule,
)

DIMS_RAW = {"vit": 16, "pose": 18}
DIMS_DIFF = {"vit": 16, "pose": 6}
B, T_LEN, LR, TOTAL_STEPS, HARD_WEIGHT = 8, 8, 3e-4, 100, 10.0
KW = dict(d_model=32, time_layers=1, time_heads=4, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_from(params) -> HumanActionScorer:
    cfg = EncoderConfig.create(DIMS_RAW, DIMS_DIFF, **KW)
    port = HumanActionScorer(cfg)
    port.load_state_dict(state_dict_from_jax_params(_numpy(params), cfg), strict=True)
    return port


def _stacked_as_jax(feats: np.ndarray, step_rng) -> torch.Tensor:
    """The stacked batch JAX's loss_fn builds from ``step_rng``, built by the
    port's pure functions from the indices JAX draws."""
    k_shuf, _k_drop = jax.random.split(step_rng)
    n = max(1, int(0.7 * T_LEN))
    positions, order = [], []
    for k in jax.random.split(k_shuf, feats.shape[0]):
        k1, k2 = jax.random.split(k)
        positions.append(np.asarray(jax.random.permutation(k1, T_LEN)[:n]))
        order.append(np.asarray(jax.random.permutation(k2, n)))
    x = torch.from_numpy(feats)
    shuffled = apply_partial_shuffle(
        x, torch.from_numpy(np.stack(positions)).long(), torch.from_numpy(np.stack(order)).long())
    return torch.cat([x, shuffled, reverse_sequence(x), static_window(x)], dim=0)


@pytest.fixture(scope="module")
def jax_run(_one_thread):
    """The JAX side, run once: four optimizer steps of JAX's jitted train
    step (states kept after each), the first step's loss components, and its
    gradients. The step does not return its gradients, but Adam's first
    moment after one step from zero is ``(1 - b1) * g``, one fp32 product
    away from them, so they are read from it (an ulp apart, far inside the
    tolerance); compiling the loss and its gradient apart again would double
    the XLA CPU compile that dominates here. Its optimization passes do not
    change what an f32 program computes beyond rounding, so they are off
    while this runs; afterwards the flag is restored and the executables
    dropped. The parameters come from a jitted init (an eager flax init
    costs seconds of dispatch)."""
    rng = np.random.default_rng(0)
    jcfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, conv_impl="kernel",
                                   conv_precision="highest", **KW)
    feats = rng.normal(size=(B, T_LEN, jcfg.input_dim)).astype(np.float32)
    labels = np.repeat(np.arange(4), 2).astype(np.int32)
    key = jax.random.key(42)
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        # the module-conv encoder has the same parameter tree and inits faster
        init_cfg = JaxEncoderConfig.create(DIMS_RAW, DIMS_DIFF, **KW)
        params = jax.jit(lambda k: init_encoder(init_cfg, k, clip_len=T_LEN)[1])(jax.random.key(0))
        model = JaxHumanActionScorer(jcfg)
        tx = jax_step.make_optimizer(LR, TOTAL_STEPS)
        state = jax_step.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
        step = jax_step.make_train_step(model, tx, HARD_WEIGHT, donate=False)
        metrics, states = [], []
        for _ in range(4):
            state, m = step(state, jnp.asarray(feats), jnp.asarray(labels), key)
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(_numpy({"params": state.params, "mu": state.opt_state[0].mu,
                                  "nu": state.opt_state[0].nu,
                                  "count": state.opt_state[0].count}))
    finally:
        jax.config.update("jax_disable_most_optimizations", before)
        jax.clear_caches()
    b1 = np.float32(1 - 0.9)   # make_optimizer's b1
    grads = jax.tree_util.tree_map(lambda mu: mu / b1, states[0]["mu"])
    return dict(feats=feats, labels=labels, key=key, params=_numpy(params),
                total=metrics[0]["total"], comps={k: metrics[0][k] for k in COMPONENTS},
                grads=grads, totals=[m["total"] for m in metrics], states=states)


def test_loss_and_every_gradient_match_jax(jax_run):
    """JAX's first step: loss components within 1e-5 relative; every
    parameter's gradient, mapped through ``named_tensors_from_jax_tree``,
    within atol 3e-4 / rtol 3e-3 (the JAX package's own kernel-vs-module
    tolerance)."""
    port = _port_from(jax_run["params"]).train()
    stacked = _stacked_as_jax(jax_run["feats"], _step_rng(jax_run["key"], 0))
    emb, _, _ = port(stacked, "highest")
    comps = loss_components(emb, torch.from_numpy(jax_run["labels"]).long(), HARD_WEIGHT)
    total = sum(comps.values())
    for k in COMPONENTS:
        np.testing.assert_allclose(comps[k].item(), jax_run["comps"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), jax_run["total"], rtol=1e-5)
    total.backward()
    want = named_tensors_from_jax_tree(jax_run["grads"], port.config)
    named = dict(port.named_parameters())
    assert sorted(want) == sorted(named)
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=3e-4, rtol=3e-3,
                                   err_msg=name)


def _step_rng(key, step):
    return jax.random.fold_in(key, step)


def test_three_steps_match_jax(jax_run):
    """``update`` on JAX's stacked batches: per-step totals within 1e-3
    relative, parameters after three steps within 2 x 3 x lr. Adam turns a
    gradient of rounding noise into a full lr-sized move of either sign (the
    attention's key bias has an exactly zero true gradient), so in three
    steps each side may walk 3 x lr, in opposite directions."""
    port = _port_from(jax_run["params"])
    ts = TrainStep(port, LR, TOTAL_STEPS, hard_weight=HARD_WEIGHT, precision="highest")
    labels = torch.from_numpy(jax_run["labels"]).long()
    for i in range(3):
        metrics = ts.update(_stacked_as_jax(jax_run["feats"], _step_rng(jax_run["key"], i)), labels)
        assert metrics["skipped"] == 0.0
        np.testing.assert_allclose(metrics["total"], jax_run["totals"][i], rtol=1e-3)
    assert ts.step == 3 and ts.scheduler.last_epoch == 3
    want = state_dict_from_jax_params(jax_run["states"][2]["params"], port.config)
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=2 * 3 * LR, err_msg=name)


def test_a_jax_run_continues_in_the_port(jax_run):
    """JAX's parameters, Adam moments and count after three steps, carried
    into a torch AdamW: the port's fourth step is JAX's fourth. With the
    moments carried, 99% of all parameter elements move as JAX's within 2% of
    lr; the rest (gradients that are rounding noise, like the attention's key
    bias, whose true gradient is zero) within 2 x lr, one lr-sized move of
    either sign on each side."""
    s3, s4 = jax_run["states"][2], jax_run["states"][3]
    port = _port_from(s3["params"])
    ts = TrainStep(port, LR, TOTAL_STEPS, hard_weight=HARD_WEIGHT, precision="highest")
    load_optax_adam_state(ts.optimizer, port, s3["mu"], s3["nu"], int(s3["count"]))
    position_cosine_schedule(ts.optimizer, ts.scheduler, int(s3["count"]))
    ts.step = 3
    start = copy.deepcopy(port.state_dict())
    metrics = ts.update(_stacked_as_jax(jax_run["feats"], _step_rng(jax_run["key"], 3)),
                        torch.from_numpy(jax_run["labels"]).long())
    np.testing.assert_allclose(metrics["total"], jax_run["totals"][3], rtol=1e-4)
    before = state_dict_from_jax_params(s3["params"], port.config)
    after = state_dict_from_jax_params(s4["params"], port.config)
    moved, close, count = 0.0, 0, 0
    for name, p in port.state_dict().items():
        want = (after[name] - before[name]).numpy()
        got = (p - start[name]).numpy()
        moved = max(moved, np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2 * LR, err_msg=name)
        close += int((np.abs(got - want) <= 0.02 * LR).sum())
        count += got.size
    assert close >= 0.99 * count, f"only {close} of {count} elements within 2% of lr"
    assert moved > 0.5 * LR   # the step really moved the weights


def test_nonfinite_batch_skips_the_update():
    """Parameters, optimizer state and learning rate unchanged, the step
    counter up by one, ``skipped == 1``."""
    cfg = EncoderConfig.create(DIMS_RAW, DIMS_DIFF, **KW)
    port = HumanActionScorer(cfg, generator=torch.Generator().manual_seed(0))
    ts = TrainStep(port, LR, TOTAL_STEPS, precision="highest", seed=3)
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(B, T_LEN, cfg.input_dim, generator=gen)
    labels = torch.arange(B) % 4
    assert ts(feats, labels)["skipped"] == 0.0
    params = copy.deepcopy(port.state_dict())
    opt = copy.deepcopy(ts.optimizer.state_dict())
    lr, sched_count = ts.scheduler.get_last_lr(), ts.scheduler.last_epoch
    metrics = ts(torch.full_like(feats, float("nan")), labels)
    assert metrics["skipped"] == 1.0 and np.isnan(metrics["total"])
    assert ts.step == 2
    assert ts.scheduler.last_epoch == sched_count and ts.scheduler.get_last_lr() == lr
    for name, p in port.state_dict().items():
        assert torch.equal(p, params[name]), name
    now = ts.optimizer.state_dict()
    assert now["param_groups"] == opt["param_groups"]
    for i, st in opt["state"].items():
        for k, v in st.items():
            assert torch.equal(now["state"][i][k], v), (i, k)


def test_schedule_stops_at_total_steps_and_steps_are_seeded():
    """Past ``total_steps`` the learning rate stays at ``eta_min`` (optax
    clamps; ``CosineAnnealingLR`` alone would climb). Two trainers with one
    seed take the same steps; dropout needs the generator in training mode."""
    cfg = EncoderConfig.create(DIMS_RAW, DIMS_DIFF, d_model=32, time_layers=1, time_heads=4,
                               dropout=0.1)
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(B, T_LEN, cfg.input_dim, generator=gen)
    labels = torch.arange(B) % 4
    runs = []
    for _ in range(2):
        port = HumanActionScorer(cfg, generator=torch.Generator().manual_seed(0))
        ts = TrainStep(port, LR, 3, eta_min=1e-6, precision="default", seed=9)
        totals = [ts(feats, labels)["total"] for _ in range(5)]
        assert ts.scheduler.last_epoch == 3
        np.testing.assert_allclose(ts.optimizer.param_groups[0]["lr"], 1e-6, rtol=1e-6)
        runs.append((totals, copy.deepcopy(port.state_dict())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    comps = ts.eval_loss(feats, labels, chunk=0)
    assert set(comps) == set(COMPONENTS) | {"total"}
    np.testing.assert_allclose(comps["total"], sum(comps[k] for k in COMPONENTS), rtol=1e-5)
    with pytest.raises(ValueError, match="Generator"):
        port.train()(feats)
