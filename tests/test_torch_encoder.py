"""The port's ``HumanActionScorer`` and weight converters against the JAX
package on the CPU: both converter directions against
``video_gen_evals_tpu.models.torch_compat``, strict loading of the reference
key set, the full forward against ``HumanActionScorer.apply`` and
``block_kernel_forward`` (Pallas conv stages in interpret mode), and
``apply_with_attention``'s fusion attention map against JAX's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models.fusion_encoder import apply_with_attention as jax_apply_with_attention
from video_gen_evals_tpu.models.fused_apply import block_kernel_forward
from video_gen_evals_tpu.models.torch_compat import (
    flax_params_to_torch_state_dict,
    torch_state_dict_to_flax,
)

from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.models import fusion_encoder
from video_gen_evals_tpu_torch.models.fusion_encoder import apply_with_attention
from video_gen_evals_tpu_torch.ops.conv_kernel import fused_temporal_block
from video_gen_evals_tpu_torch.models.torch_compat import (
    jax_params_from_state_dict,
    load_torch_checkpoint,
    state_dict_from_jax_params,
)

DIMS_RAW = {"vit": 16, "global": 9, "pose": 18, "beta": 10, "kp2d": 12}
DIMS_DIFF = {"vit": 16, "global": 3, "pose": 6, "beta": 10, "kp2d": 12}
CLIP = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dims_raw, dims_diff, layers):
    kw = dict(d_model=32, time_layers=layers, time_heads=4)
    return (JaxEncoderConfig.create(dims_raw, dims_diff, **kw),
            EncoderConfig.create(dims_raw, dims_diff, **kw))


def _jax_params(jcfg, pcfg, seed):
    """A flax param tree made by the JAX package's own converter from a
    seeded port model (no flax init: it compiles for seconds on the CPU)."""
    sd = HumanActionScorer(pcfg, generator=torch.Generator().manual_seed(seed)).state_dict()
    return torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, jcfg, strict=True)


@pytest.fixture(scope="module")
def jax_model(_one_thread):
    jcfg, pcfg = _configs(DIMS_RAW, DIMS_DIFF, layers=2)
    return jcfg, pcfg, _jax_params(jcfg, pcfg, seed=0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_state_dict_from_jax_params_matches_jax_converter(jax_model):
    """Key for key, value for value (exact: a transpose and a generated
    buffer), and the reference key set loads strictly into the port."""
    jcfg, pcfg, params = jax_model
    want = flax_params_to_torch_state_dict(params, jcfg)
    got = state_dict_from_jax_params(params, pcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    port = HumanActionScorer(pcfg)
    assert sorted(port.state_dict()) == sorted(want)
    port.load_state_dict(got, strict=True)
    np.testing.assert_array_equal(port.pos_enc.pe.numpy(), want["pos_enc.pe"])


def test_jax_params_from_state_dict_matches_jax_converter(jax_model):
    """Exact, both from a port state_dict and back to the original tree."""
    jcfg, pcfg, params = jax_model
    sd = state_dict_from_jax_params(params, pcfg)
    want = torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()}, jcfg, strict=True)
    got = jax_params_from_state_dict(sd, pcfg, strict=True)
    assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
    for (k, a), (_, b), (_, c) in zip(_leaves(got), _leaves(want), _leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(a, c, err_msg=k)
    with pytest.raises(KeyError, match="unconsumed"):
        jax_params_from_state_dict({**sd, "extra.weight": torch.zeros(1)}, pcfg, strict=True)


def test_load_torch_checkpoint_unwraps_and_switches_strictness(jax_model, tmp_path):
    _jcfg, pcfg, params = jax_model
    sd = state_dict_from_jax_params(params, pcfg)
    path = str(tmp_path / "model.pt")
    torch.save({"model_state_dict": {**sd, "extra.weight": torch.zeros(1)}, "epoch": 3}, path)
    with pytest.raises(RuntimeError, match="extra.weight"):
        load_torch_checkpoint(path, HumanActionScorer(pcfg), strict=True)
    port = HumanActionScorer(pcfg)
    result = load_torch_checkpoint(path, port, strict=False)
    assert result.unexpected_keys == ["extra.weight"] and not result.missing_keys
    np.testing.assert_array_equal(port.cls.detach().numpy(), params["cls"])
    torch.save(sd, path)   # a bare state_dict loads too
    assert not load_torch_checkpoint(path, HumanActionScorer(pcfg), strict=True).missing_keys


@pytest.fixture(scope="module")
def two_modalities(_one_thread):
    """Two modalities with diff streams (4 chains; a short JAX compile), the
    port model on the JAX weights, the input, and JAX's
    ``apply_with_attention`` on it, jitted once: ``(outputs, attn)``."""
    jcfg, pcfg = _configs({"vit": 16, "pose": 18}, {"vit": 16, "pose": 6}, layers=2)
    params = _jax_params(jcfg, pcfg, seed=1)
    x = np.random.default_rng(1337).normal(size=(4, CLIP, pcfg.input_dim)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_apply_with_attention(JaxHumanActionScorer(jcfg), p, x))(
        params, jnp.asarray(x))
    port = HumanActionScorer(pcfg)
    port.load_state_dict(state_dict_from_jax_params(params, pcfg), strict=True)
    return port, x, want


def test_forward_matches_jax_module(two_modalities):
    """atol 2e-5: fp32 throughout (conv stages at "highest")."""
    port, x, (want, _attn) = two_modalities
    with torch.no_grad():
        got = port(torch.from_numpy(x), "highest")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_apply_with_attention_matches_jax(two_modalities, monkeypatch):
    """The fusion attention map [B, T, M] (the softmax before dropout) at
    atol 2e-5 against JAX's, its rows summing to 1; the outputs bitwise the
    port's own forward at "highest", from one pass (the conv stage's plain
    version runs 4 chains x 4 stages once), and the module left as it was:
    no new attribute or buffer holds a tensor, and training mode comes back."""
    port, x, (want, want_attn) = two_modalities
    xt = torch.from_numpy(x)
    with torch.no_grad():
        plain = port(xt, "highest")
    tensors_before = {id(m): {k for k, v in vars(m).items() if isinstance(v, torch.Tensor)}
                      for m in port.modules()}
    buffers_before = sorted(n for n, _ in port.named_buffers())
    port.train()
    calls = []
    monkeypatch.setattr(fusion_encoder, "fused_temporal_block",
                        lambda *a, **k: calls.append(1) or fused_temporal_block(*a, **k))
    got, attn = apply_with_attention(port, xt, "highest")
    assert port.training
    port.eval()
    assert len(calls) == 16
    assert attn.shape == (4, CLIP, 2) and not attn.requires_grad
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=2e-5)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    assert {id(m): {k for k, v in vars(m).items() if isinstance(v, torch.Tensor)}
            for m in port.modules()} == tensors_before
    assert sorted(n for n, _ in port.named_buffers()) == buffers_before


def test_forward_matches_jax_block_kernel_forward(rng):
    """The port's forward against the JAX Pallas conv-stage forward
    (interpret mode, precision "highest") at atol 2e-5. One modality with no
    diff stream (one chain, 4 kernel calls) keeps the interpret-mode run
    short; the fusion over several modalities is the test above."""
    jcfg, pcfg = _configs({"pose": 18}, {"pose": 0}, layers=1)
    params = _jax_params(jcfg, pcfg, seed=2)
    x = rng.normal(size=(4, CLIP, pcfg.input_dim)).astype(np.float32)
    want = jax.jit(lambda p, x: block_kernel_forward(
        jcfg, p, x, block_windows=4, precision="highest", interpret=True))(params, jnp.asarray(x))
    port = HumanActionScorer(pcfg)
    port.load_state_dict(state_dict_from_jax_params(params, pcfg), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), "highest")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_seeded_init_is_reproducible():
    _jcfg, pcfg = _configs(DIMS_RAW, DIMS_DIFF, layers=1)
    a = HumanActionScorer(pcfg, generator=torch.Generator().manual_seed(5)).state_dict()
    b = HumanActionScorer(pcfg, generator=torch.Generator().manual_seed(5)).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["state_enc.vit.blocks.0.norm.weight"], torch.ones(32))
