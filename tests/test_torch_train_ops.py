"""The training path's ops of the port against the JAX package on the CPU:
corruptions, the five losses, the PK sampler, and the trainable conv stage
(K4) forward and backward. Inputs are made with numpy from a seed and handed
to both sides. The JAX K4 runs as its own tests run it off-TPU: the Pallas
kernels in interpret mode, which ``fused_temporal_block_train`` selects itself;
the port runs its plain versions, through the same ``autograd.Function`` the
card uses."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu.data.sampler import PKBatchSampler as JaxPKBatchSampler
from video_gen_evals_tpu.ops import corruption as jax_corruption
from video_gen_evals_tpu.ops.conv_kernel_train import (
    fused_temporal_block_train as jax_block_train,
)
from video_gen_evals_tpu.train import losses as jax_losses

from video_gen_evals_tpu_torch.data import PKBatchSampler
from video_gen_evals_tpu_torch.ops import corruption
from video_gen_evals_tpu_torch.ops.conv_kernel_train import (
    fused_temporal_block_train,
    fused_temporal_block_train_bwd_plain,
    fused_temporal_block_train_plain,
)
from video_gen_evals_tpu_torch.train import losses


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- corruptions

def test_reverse_and_static_are_exact(rng):
    x = rng.normal(size=(5, 8, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        corruption.reverse_sequence(_t(x)).numpy(), np.asarray(jax_corruption.reverse_sequence(x)))
    np.testing.assert_array_equal(
        corruption.static_window(_t(x)).numpy(), np.asarray(jax_corruption.static_window(x)))


def test_shuffle_is_exact_on_jax_indices(rng):
    """Both sides move the same frames when the port is handed the indices
    JAX draws from its key (split per sample, then permutation twice)."""
    B, T, n = 6, 8, 5   # n = max(1, int(0.7 * 8))
    x = rng.normal(size=(B, T, 3)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jax_corruption.partial_shuffle_within_window(key, jnp.asarray(x)))
    positions, order = [], []
    for k in jax.random.split(key, B):
        k1, k2 = jax.random.split(k)
        positions.append(np.asarray(jax.random.permutation(k1, T)[:n]))
        order.append(np.asarray(jax.random.permutation(k2, n)))
    got = corruption.apply_partial_shuffle(
        _t(x), _t(np.stack(positions)).long(), _t(np.stack(order)).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_own_shuffle_draw_keeps_frames_and_moves_at_most_n():
    T = 10
    n = max(1, int(0.7 * T))
    x = torch.arange(4 * T, dtype=torch.float32).reshape(4, T, 1).repeat(1, 1, 2)
    gen = torch.Generator().manual_seed(3)
    out = corruption.partial_shuffle_within_window(x, gen)
    assert out.shape == x.shape
    for b in range(4):
        assert sorted(out[b, :, 0].tolist()) == x[b, :, 0].tolist()   # the same multiset
        assert int((out[b, :, 0] != x[b, :, 0]).sum()) <= n
    assert not torch.equal(out, x)
    # the same seed gives the same corruption; T = 1 has nothing to shuffle
    again = corruption.partial_shuffle_within_window(x, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)
    one = x[:, :1]
    assert corruption.partial_shuffle_within_window(one, gen) is one
    positions, order = corruption.draw_shuffle_indices(4, T, gen)
    assert positions.shape == order.shape == (4, n)
    assert all(len(set(p.tolist())) == n for p in positions)


# --------------------------------------------------------------------- losses

def _embeddings(rng, *shape):
    e = rng.normal(size=shape).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


LOSS_CASES = {
    "tcl": lambda m, a, b, c, y, w: m.tcl_loss(a, y),
    "supcon": lambda m, a, b, c, y, w: m.supcon_hard_negatives(a, b, c),
    "infonce": lambda m, a, b, c, y, w: m.hard_neg_infonce(a, c, positive=b, neg_margin=0.1),
    "infonce_self_positive": lambda m, a, b, c, y, w: m.hard_neg_infonce(a, c),
    "arc_margin": lambda m, a, b, c, y, w: m.arc_margin_logits(a, y, w),
    "margin_mean": lambda m, a, b, c, y, w: m.margin_hard_negatives(a, b, c),
    "margin_none": lambda m, a, b, c, y, w: m.margin_hard_negatives(a, b, c, reduction="none"),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(rng, case):
    """The five losses within 1e-5 of ``video_gen_evals_tpu/train/losses.py``."""
    a, b, c = (_embeddings(rng, 12, 16) for _ in range(3))
    y = np.repeat(np.arange(4), 3).astype(np.int32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    want = LOSS_CASES[case](jax_losses, *(jnp.asarray(v) for v in (a, b, c, y, w)))
    got = LOSS_CASES[case](losses, *(_t(v) for v in (a, b, c)), _t(y).long(), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_infonce_k_negatives_and_detach(rng):
    a = _embeddings(rng, 6, 8)
    negs = _embeddings(rng, 6, 3, 8)
    want = jax_losses.hard_neg_infonce(jnp.asarray(a), jnp.asarray(negs))
    np.testing.assert_allclose(
        losses.hard_neg_infonce(_t(a), _t(negs)).numpy(), np.asarray(want), atol=1e-5)
    # detach_neg: no gradient reaches the negatives, as jax's stop_gradient
    n = _t(negs).requires_grad_()
    anchor = _t(a).requires_grad_()
    losses.hard_neg_infonce(anchor, n, detach_neg=True).backward()
    assert n.grad is None and anchor.grad is not None
    losses.hard_neg_infonce(anchor, n, detach_neg=False).backward()
    assert n.grad is not None


def test_tcl_is_nan_for_a_class_of_one_on_both_sides(rng):
    """An anchor with no positive divides by n_pos = 0: NaN in JAX and in the
    port, which the step's skip guard depends on."""
    a = _embeddings(rng, 5, 8)
    y = np.array([0, 0, 1, 1, 2], np.int32)
    assert np.isnan(float(jax_losses.tcl_loss(jnp.asarray(a), jnp.asarray(y))))
    assert torch.isnan(losses.tcl_loss(_t(a), _t(y).long()))


# -------------------------------------------------------------------- sampler

def test_pk_sampler_is_bitwise_the_jax_sampler():
    """Two epochs from the same numpy seed, one class with fewer than K
    windows (topped up with replacement) and class-order wrap."""
    labels = np.array([0] * 9 + [1] * 3 + [2] * 7 + [3] * 8)
    ours = PKBatchSampler(labels, P=3, K=4, drop_last=True, rng=np.random.default_rng(5))
    theirs = JaxPKBatchSampler(labels, P=3, K=4, drop_last=True, rng=np.random.default_rng(5))
    assert len(ours) == len(theirs) == 2
    for _epoch in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert len(g) == 12


def test_pk_sampler_emits_one_batch_below_p_times_k():
    labels = np.array([0, 0, 1])
    batches = list(PKBatchSampler(labels, P=2, K=4, rng=np.random.default_rng(0)))
    assert len(batches) == 1 and len(batches[0]) == 8
    with pytest.raises(ValueError, match="exceeds num classes"):
        PKBatchSampler(labels, P=3, K=1)


# ------------------------------------------------------------------------- K4

B, T, C, K = 8, 8, 32, 5


def _k4_inputs(seed, with_mask):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w1, w2 = (0.1 * rng.normal(size=(K, C, C)).astype(np.float32) for _ in range(2))
    gs = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    gb = (0.1 * rng.normal(size=C)).astype(np.float32)
    mask = ((rng.uniform(size=(B, T, C)) < 0.9) / 0.9).astype(np.float32) if with_mask else None
    probe = rng.normal(size=(B, T, C)).astype(np.float32)
    return (x, w1, w2, gs, gb), mask, probe


@pytest.mark.parametrize("dilation", [1, 2, 4])   # at T = 8, d = 4 puts taps outside the window
@pytest.mark.parametrize("with_mask", [False, True])
def test_k4_forward_matches_jax_highest(dilation, with_mask):
    """fp32 on both sides: atol 2e-5 (the order of the sums)."""
    args, mask, _ = _k4_inputs(dilation, with_mask)
    want = jax_block_train(*(jnp.asarray(a) for a in args),
                           None if mask is None else jnp.asarray(mask), dilation, "highest")
    got = fused_temporal_block_train(*(_t(a) for a in args),
                                     None if mask is None else _t(mask), dilation, "highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_k4_forward_matches_jax_default():
    """bf16 operands, f32 sums on both sides. An element of GELU(conv1) * mask
    that sits on a bf16 rounding boundary may round the other way (the two f32
    sums before it differ in their last bits), a relative step of 2^-8 in one
    of conv2's 160 products per output: atol 5e-3."""
    args, mask, _ = _k4_inputs(7, True)
    want = jax_block_train(*(jnp.asarray(a) for a in args), jnp.asarray(mask), 2, "default")
    got = fused_temporal_block_train(*(_t(a) for a in args), _t(mask), 2, "default")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    full = fused_temporal_block_train(*(_t(a) for a in args), _t(mask), 2, "highest")
    assert (got - full).abs().max().item() > 1e-4   # the rounding is really applied


@pytest.mark.parametrize("with_mask", [False, True])
def test_k4_gradients_match_jax_custom_vjp(with_mask):
    """The autograd.Function's five gradients against jax.grad through the
    JAX custom VJP with the same probe (atol 5e-4, rtol 5e-4, the tolerance of
    ``tests/test_conv_kernel_train.py``), and against torch autograd of the
    plain forward (the explicit backward formulas are its derivative)."""
    args, mask, probe = _k4_inputs(3, with_mask)
    jmask = None if mask is None else jnp.asarray(mask)

    def jax_loss(x, w1, w2, gs, gb):
        return jnp.sum(jax_block_train(x, w1, w2, gs, gb, jmask, 2, "highest") * probe)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in args))
    tmask = None if mask is None else _t(mask)
    leaves = [_t(a).requires_grad_() for a in args]
    got = torch.autograd.grad(
        (fused_temporal_block_train(*leaves, tmask, 2, "highest") * _t(probe)).sum(), leaves)
    plain = torch.autograd.grad(
        (fused_temporal_block_train_plain(*leaves, tmask, 2, "highest") * _t(probe)).sum(), leaves)
    for name, g, w, p in zip(("dx", "dw1", "dw2", "dgs", "dgb"), got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=5e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=5e-4, rtol=5e-4, err_msg=name)


def test_k4_function_plumbing():
    """No gradient for the mask; permuted weight views get their gradient in
    the parameter's own layout; the explicit backward is what the Function
    returns; bad arguments raise."""
    args, mask, probe = _k4_inputs(5, True)
    x, w1, w2, gs, gb = (_t(a) for a in args)
    p1 = w1.permute(2, 1, 0).contiguous().requires_grad_()   # [Cout, Cin, K], as the encoder holds it
    m = _t(mask).requires_grad_()
    xr = x.clone().requires_grad_()
    out = fused_temporal_block_train(xr, p1.permute(2, 1, 0), w2, gs, gb, m, 2, "highest")
    out.backward(_t(probe))
    assert m.grad is None
    dx, dw1, *_ = fused_temporal_block_train_bwd_plain(x, w1, w2, gs, _t(mask), _t(probe), 2, "highest")
    assert torch.equal(xr.grad, dx)
    assert p1.grad.shape == (C, C, K) and torch.equal(p1.grad, dw1.permute(2, 1, 0))
    with pytest.raises(ValueError, match="precision"):
        fused_temporal_block_train(x, w1, w2, gs, gb, None, 1, "high")
    with pytest.raises(ValueError, match="mask"):
        fused_temporal_block_train(x, w1, w2, gs, gb, _t(mask)[:, :4], 1, "highest")
    with pytest.raises(TypeError, match="float32"):
        fused_temporal_block_train(x.double(), w1, w2, gs, gb, None, 1, "highest")
