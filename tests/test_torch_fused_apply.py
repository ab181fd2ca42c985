"""The port's fused scoring forwards and their kernels' plain versions against
the JAX package on the CPU: K9 (stacked conv stage), K10 (whole-chain conv)
and K2 (sub-block window gather) against the JAX Pallas kernels in interpret
mode, ``block_kernel_forward`` for every ``stage_fusion`` and
``attn_impl="core"``, ``fused_forward`` for both ``conv_impl``s, and
``EncoderConfig.attention_impl="pallas"`` (K8's plain version). Inputs are
made with numpy from a seed and handed to both; each test states its
tolerance. Widths are tiny: interpret-mode forwards cost seconds each."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu.models import EncoderConfig as JaxEncoderConfig
from video_gen_evals_tpu.models import HumanActionScorer as JaxHumanActionScorer
from video_gen_evals_tpu.models import fused_apply as jax_fused
from video_gen_evals_tpu.models.torch_compat import torch_state_dict_to_flax
from video_gen_evals_tpu.ops.chain_kernel import fused_temporal_chain as jax_chain
from video_gen_evals_tpu.ops.conv_kernel import fused_temporal_block_stacked as jax_stacked
from video_gen_evals_tpu.ops.window_kernel import pad_bank_lanes, pallas_gather_windows

from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.models.fused_apply import block_kernel_forward, fused_forward
from video_gen_evals_tpu_torch.ops.chain_kernel import fused_temporal_chain, fused_temporal_chain_plain
from video_gen_evals_tpu_torch.ops.conv_kernel import (
    fused_temporal_block_plain,
    fused_temporal_block_stacked,
    fused_temporal_block_stacked_plain,
)
from video_gen_evals_tpu_torch.ops.window_kernel import (
    gather_windows,
    gather_windows_subblock,
    gather_windows_subblock_plain,
)

# bf16x3 against bf16x3: both split alike and sum in another order (the
# class of the K3 "high" tests in tests/test_torch_ops.py)
HIGH_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_fast_compiles():
    """XLA's optimization passes off for the module: its CPU compiles of the
    interpret-mode kernels dominate these tests, and the passes change what
    an f32 program computes by rounding only. The flag is put back and every
    executable compiled under it dropped after the module."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
    jax.clear_caches()


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _stage_inputs(rng, lead, B=4, T=16, C=64):
    """x [*lead_x, B, T, C] and stage weights with ``lead`` leading axes."""
    w1, w2 = ((rng.normal(size=lead + (5, C, C)) / np.sqrt(5 * C)).astype(np.float32)
              for _ in range(2))
    gs = (1.0 + 0.1 * rng.normal(size=lead + (C,))).astype(np.float32)
    gb = (0.1 * rng.normal(size=lead + (C,))).astype(np.float32)
    return w1, w2, gs, gb


# --- K9: stacked conv stage ---------------------------------------------------


@pytest.mark.parametrize("dilation", [1, 8])
def test_stacked_plain_matches_jax_kernel(rng, dilation):
    """S = 3 chains, B = 4, T = 16, C = 64; at d = 8 the outer taps lie
    outside the window. atol 1e-4 (bf16x3)."""
    S = 3
    xs = rng.normal(size=(S, 4, 16, 64)).astype(np.float32)
    w = _stage_inputs(rng, (S,))
    want = np.asarray(jax.jit(lambda *a: jax_stacked(*a, dilation=dilation, block_windows=4,
                                                     interpret=True))(*_j((xs,) + w)))
    got = fused_temporal_block_stacked(*_t((xs,) + w), dilation)
    np.testing.assert_allclose(got.numpy(), want, atol=HIGH_ATOL)
    # the CPU route is the plain version, which is K3's plain version per chain
    np.testing.assert_array_equal(got.numpy(),
                                  fused_temporal_block_stacked_plain(*_t((xs,) + w), dilation).numpy())
    x0 = _t((xs[1],) + tuple(a[1] for a in w))
    np.testing.assert_array_equal(got[1].numpy(),
                                  fused_temporal_block_plain(*x0, dilation, "high").numpy())


def test_stacked_rejects_bad_shapes(rng):
    xs, w1, w2, gs, gb = _t((rng.normal(size=(2, 4, 16, 64)).astype(np.float32),)
                            + _stage_inputs(rng, (2,)))
    with pytest.raises(ValueError, match="w1"):
        fused_temporal_block_stacked(xs, w1[:1], w2, gs, gb, 1)
    with pytest.raises(ValueError, match=r"\[S, B, T, C\]"):
        fused_temporal_block_stacked(xs[0], w1, w2, gs, gb, 1)


# --- K10: whole-chain conv ----------------------------------------------------


@pytest.mark.parametrize("variant", ["slice", "mm_first"])
def test_chain_plain_matches_jax_kernel(rng, variant):
    """All 4 stages (dilations 1, 2, 4, 8) of one chain, B = 4, T = 16,
    C = 64, atol 1e-4 (bf16x3); both JAX variants against the one port
    function."""
    x = rng.normal(size=(4, 16, 64)).astype(np.float32)
    w = _stage_inputs(rng, (4,))
    want = np.asarray(jax.jit(lambda *a: jax_chain(*a, block_windows=4, variant=variant,
                                                   interpret=True))(*_j((x,) + w)))
    got = fused_temporal_chain(*_t((x,) + w), variant=variant)
    np.testing.assert_allclose(got.numpy(), want, atol=HIGH_ATOL)


def test_chain2_split_matches_jax_kernel(rng):
    """The chain2 split: stages (0, 1) then (2, 3), two launches, against the
    same split in JAX and against the 4-stage chain (bitwise on the CPU: the
    plain version runs the same stages in the same order)."""
    x = rng.normal(size=(4, 16, 64)).astype(np.float32)
    w = _stage_inputs(rng, (4,))
    jit_chain = jax.jit(lambda x, *a, dilations: jax_chain(x, *a, dilations=dilations,
                                                           block_windows=4, interpret=True),
                        static_argnames="dilations")
    want = jnp.asarray(x)
    got = torch.from_numpy(x)
    for g in ((0, 1), (2, 3)):
        dil = tuple((1, 2, 4, 8)[i] for i in g)
        want = jit_chain(want, *_j(tuple(a[list(g)] for a in w)), dilations=dil)
        got = fused_temporal_chain(got, *_t(tuple(a[list(g)] for a in w)), dilations=dil)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=HIGH_ATOL)
    np.testing.assert_array_equal(got.numpy(), fused_temporal_chain_plain(*_t((x,) + w)).numpy())


def test_chain_rejects_unknown_variant_and_stage_counts(rng):
    x, w1, w2, gs, gb = _t((rng.normal(size=(4, 16, 64)).astype(np.float32),)
                           + _stage_inputs(rng, (4,)))
    with pytest.raises(ValueError, match="variant"):
        fused_temporal_chain(x, w1, w2, gs, gb, variant="slices")
    with pytest.raises(ValueError, match="stage weights"):
        fused_temporal_chain(x, w1, w2, gs, gb, dilations=(1, 2))


# --- K2: sub-block window gather --------------------------------------------

_D, _OPR, _DIFF = 40, 22, 18


def _bank(rng, rows=(48, 37, 64)):
    """A sentinel-padded bank with 8-aligned video offsets: video 1 has 37
    rows, so a window of 32 starting at 8 clips to start 5."""
    offsets = np.array([sum(-(-r // 8) * 8 for r in rows[:i]) for i in range(len(rows))], np.int32)
    n = int(offsets[-1] + -(-rows[-1] // 8) * 8)
    bank = rng.normal(size=(n, _D)).astype(np.float32)
    row_limit = np.array([r - 1 for r in rows], np.int32)
    z0 = rng.normal(size=(_DIFF,)).astype(np.float32)
    return bank, offsets, row_limit, z0


def test_subblock_plain_matches_jax_kernel_bitwise(rng):
    """Bitwise (a copy), on the JAX kernel's lane-padded bank with out_dim,
    including windows whose clipped start is not a multiple of 8; there K2
    reads from the aligned row below and K1 does not."""
    bank, offsets, row_limit, z0 = _bank(rng)
    vi = np.array([0, 0, 1, 1, 1, 2, 2, 0], np.int32)
    st = np.array([0, 16, 0, 8, 40, 32, -8, 100], np.int32)
    want = np.asarray(pallas_gather_windows(
        pad_bank_lanes(jnp.asarray(bank)), *_j((offsets, row_limit, z0)), _OPR,
        *_j((vi, st)), 32, out_dim=_D, interpret=True))
    padded = np.pad(bank, ((0, 0), (0, 128 - _D)))
    for b in (bank, padded):
        args = _t((b, offsets, row_limit, z0)) + [_OPR] + _t((vi, st)) + [32]
        got = gather_windows_subblock(*args, out_dim=_D).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, gather_windows_subblock_plain(*args, out_dim=_D).numpy())
    k1 = gather_windows(*_t((bank, offsets, row_limit, z0)), _OPR, *_t((vi, st)), 32).numpy()
    unaligned = [3, 4]   # video 1, starts 8 and 40, both clipped to 5
    assert not np.array_equal(k1[unaligned], want[unaligned])
    np.testing.assert_array_equal(np.delete(k1, unaligned, 0), np.delete(want, unaligned, 0))


def test_subblock_rejects_unaligned_clip_and_bad_out_dim(rng):
    bank, offsets, row_limit, z0 = _t(_bank(rng))
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 8"):
        gather_windows_subblock(bank, offsets, row_limit, z0, _OPR, idx, idx, 12)
    with pytest.raises(ValueError, match="out_dim"):
        gather_windows_subblock(bank, offsets, row_limit, z0, _OPR, idx, idx, 16, out_dim=_D + 1)
    with pytest.raises(ValueError, match="diff block"):
        gather_windows_subblock(bank, offsets, row_limit, z0, _OPR, idx, idx, 16, out_dim=_OPR)


# --- the fused forwards ------------------------------------------------------

_ONE_MODALITY = ({"pose": 18}, {"pose": 6})   # one modality with a diff stream: 2 chains


def _models(dims, d_model, layers, heads, seed, **jax_kw):
    """The port's seeded model and the same weights as a JAX param tree."""
    pcfg = EncoderConfig.create(*dims, d_model=d_model, time_layers=layers, time_heads=heads)
    jcfg = JaxEncoderConfig.create(*dims, d_model=d_model, time_layers=layers,
                                   time_heads=heads, **jax_kw)
    port = HumanActionScorer(pcfg, generator=torch.Generator().manual_seed(seed))
    params = torch_state_dict_to_flax({k: v.numpy() for k, v in port.state_dict().items()},
                                      jcfg, strict=True)
    return pcfg, jcfg, port, params


def _assert_outputs_close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


@pytest.fixture(scope="module")
def block_models(_one_thread):
    return _models(_ONE_MODALITY, d_model=64, layers=1, heads=4, seed=3)


@pytest.mark.parametrize("stage_fusion,attn_impl", [
    ("stage", "xla"), ("chain", "xla"), ("chain2", "xla"), ("stacked", "xla"), ("stacked", "core"),
])
def test_block_kernel_forward_matches_jax(rng, block_models, stage_fusion, attn_impl):
    """d_model 64, 1 layer, 4 heads, one modality with a diff stream (2
    chains, so "stacked" stacks two), B = 4, T = 8, at "high": all three
    outputs within 1e-4 (bf16x3 conv stages and K6 at bf16x3)."""
    pcfg, jcfg, port, params = block_models
    x = rng.normal(size=(4, 8, pcfg.input_dim)).astype(np.float32)
    variant = "mm_first" if stage_fusion == "stage" else "slice"
    want = jax.jit(lambda p, x: jax_fused.block_kernel_forward(
        jcfg, p, x, block_windows=4, precision="high", interpret=True, stage_fusion=stage_fusion,
        conv_variant=variant, attn_impl=attn_impl))(params, jnp.asarray(x))
    with torch.no_grad():
        got = block_kernel_forward(pcfg, port, torch.from_numpy(x), precision="high",
                                   stage_fusion=stage_fusion, conv_variant=variant,
                                   attn_impl=attn_impl)
    _assert_outputs_close(got, want, HIGH_ATOL)


def test_block_kernel_forward_rejects_what_jax_rejects(block_models):
    pcfg, _jcfg, port, _params = block_models
    x = torch.zeros(4, 8, pcfg.input_dim)
    for fusion in ("chain", "chain2", "stacked"):
        with pytest.raises(ValueError, match="precision='high' only"):
            block_kernel_forward(pcfg, port, x, precision="highest", stage_fusion=fusion)
    for kw, what in ((dict(stage_fusion="chains"), "stage_fusion"),
                     (dict(conv_variant="mm"), "conv_variant"),
                     (dict(attn_impl="flash"), "attn_impl"),
                     (dict(block_windows=0), "block_windows")):
        with pytest.raises(ValueError, match=what):
            block_kernel_forward(pcfg, port, x, **kw)
    port.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            block_kernel_forward(pcfg, port, x)
    finally:
        port.eval()


@pytest.mark.parametrize("conv_impl", ["vmap_conv", "tap_matmul"])
def test_fused_forward_matches_jax(rng, conv_impl):
    """Both port conv_impls against the JAX fused_forward (tap_matmul,
    jitted) at atol 3e-5, the JAX test's own tolerance; d_model 32, a
    modality with no diff stream in the bookkeeping."""
    pcfg, jcfg, port, params = _models(({"vit": 16, "pose": 18, "beta": 10},
                                        {"vit": 16, "pose": 0, "beta": 10}),
                                       d_model=32, layers=2, heads=4, seed=4)
    x = rng.normal(size=(3, 8, pcfg.input_dim)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_fused.fused_forward(jcfg, p, x, conv_impl="tap_matmul"))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = fused_forward(pcfg, port, torch.from_numpy(x), conv_impl=conv_impl)
    _assert_outputs_close(got, want, 3e-5)
    with pytest.raises(ValueError, match="conv_impl"):
        fused_forward(pcfg, port, torch.from_numpy(x), conv_impl="conv")


def test_attention_impl_pallas_matches_jax(rng):
    """The port's eval forward with attention_impl "pallas" (K8; its plain
    version on the CPU) against the JAX module with "pallas_interpret"
    (multihead_attention, Pallas interpret mode) at N = 9 tokens, fp32:
    atol 2e-5 (sums in another order)."""
    dims = ({"pose": 18}, {"pose": 0})
    pcfg, jcfg, port, params = _models(dims, d_model=32, layers=1, heads=4, seed=5,
                                       attention_impl="pallas_interpret")
    x = rng.normal(size=(2, 8, pcfg.input_dim)).astype(np.float32)
    want = jax.jit(lambda p, x: JaxHumanActionScorer(jcfg).apply(
        {"params": p}, x, deterministic=True))(params, jnp.asarray(x))
    flash = HumanActionScorer(EncoderConfig.create(*dims, d_model=32, time_layers=1, time_heads=4,
                                                   attention_impl="pallas"))
    flash.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = flash(torch.from_numpy(x), "highest")
    _assert_outputs_close(got, want, 2e-5)
    with pytest.raises(ValueError, match="attention_impl"):
        EncoderConfig.create(*dims, attention_impl="flash")
