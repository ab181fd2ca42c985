"""The port's attention functions (K6, K7, K8) on the CPU, where each wrapper
runs its plain version, against the JAX functions run in Pallas interpret
mode as ``tests/test_attention.py`` runs them. Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_gen_evals_tpu.ops.attention import attention_xla
from video_gen_evals_tpu.ops.attention import flash_attention as jax_flash
from video_gen_evals_tpu.ops.attention_core import mha_core as jax_mha_core
from video_gen_evals_tpu.ops.attention_core import mha_head_batched as jax_mha_head_batched
from video_gen_evals_tpu_torch.ops.attention import (
    attention_plain,
    flash_attention,
    flash_attention_plain,
    multihead_attention,
)
from video_gen_evals_tpu_torch.ops.attention_core import (
    mha_core,
    mha_core_plain,
    mha_head_batched,
    mha_head_batched_plain,
)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32_ATOL = 2e-5    # fp32 against fp32: the order of the sums differs
BF16_TOL = 0.03    # bf16 inputs, p and output: three roundings of 2^-9 relative


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


@pytest.mark.parametrize("B,N,H,D", [(2, 48, 4, 64), (2, 33, 8, 32), (1, 192, 2, 80)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_mha_core_matches_jax(B, N, H, D, precision):
    """fp32 at 2e-5. Interpret mode computes "high" in fp32; the port's
    "high" is bf16x3, whose error (about 2^-16 relative per product) stays
    inside the same bound at these sizes."""
    qkv = _qkv(0, (B, N, H * D))
    want = np.asarray(jax_mha_core(*_j(qkv), heads=H, precision=precision, interpret=True))
    got = mha_core(*_t(qkv), heads=H, precision=precision).numpy()
    # on a mismatch, say which side moved: each against a float64 reference
    q, k, v = (a.astype(np.float64).reshape(B, N, H, D).transpose(0, 2, 1, 3) for a in qkv)
    s = q @ k.transpose(0, 1, 3, 2) / np.sqrt(D)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    ref = ((p / p.sum(axis=-1, keepdims=True)) @ v).transpose(0, 2, 1, 3).reshape(B, N, H * D)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, err_msg=(
        f"max |JAX interpret - float64| {np.abs(want - ref).max():.3e}, "
        f"max |port - float64| {np.abs(got - ref).max():.3e}"))


def test_mha_core_bf16_matches_jax():
    """bf16 inputs at "default" against the JAX kernel on the same bf16
    inputs: atol and rtol 0.03."""
    B, N, H, D = 2, 192, 4, 80
    qkv = _qkv(1, (B, N, H * D))
    want = np.asarray(jax_mha_core(*_j(qkv, jnp.bfloat16), heads=H, precision="default",
                                   interpret=True).astype(jnp.float32))
    got = mha_core(*_t(qkv, torch.bfloat16), heads=H, precision="default")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


def test_mha_core_default_rounds_like_bf16_inputs():
    """"default" on fp32 inputs rounds q, k, v to bf16 first: it equals the
    same call on the rounded inputs, bit for bit."""
    q, k, v = _t(_qkv(2, (2, 40, 64)))
    a = mha_core(q, k, v, heads=4, precision="default")
    b = mha_core(*(t.bfloat16().float() for t in (q, k, v)), heads=4, precision="default")
    assert torch.equal(a, b)


def test_mha_core_rejects_bad_arguments():
    q = torch.zeros(2, 8, 32)
    with pytest.raises(ValueError, match="precision"):
        mha_core(q, q, q, heads=4, precision="BENCH_ATTN")
    with pytest.raises(ValueError, match="divisible"):
        mha_core(q, q, q, heads=5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mha_core(q.double(), q.double(), q.double(), heads=4)
    with pytest.raises(TypeError, match="high"):
        mha_core(q.bfloat16(), q.bfloat16(), q.bfloat16(), heads=4, precision="high")
    with pytest.raises(ValueError, match="precision"):
        mha_head_batched(q, q, q, heads=4, precision="high")
    with pytest.raises(ValueError, match="precision"):
        flash_attention(q.reshape(2, 8, 4, 8), q.reshape(2, 8, 4, 8), q.reshape(2, 8, 4, 8),
                        precision="high")


def test_mha_head_batched_matches_jax():
    B, N, H, D = 2, 48, 4, 64
    qkv = _qkv(3, (B, N, H * D))
    want = np.asarray(jax_mha_head_batched(*_j(qkv), heads=H, interpret=True))
    got = mha_head_batched(*_t(qkv), heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    # the packed schedule computes what the in-place one computes
    np.testing.assert_allclose(got, mha_core(*_t(qkv), heads=H, precision="highest").numpy(),
                               atol=F32_ATOL)


@pytest.mark.parametrize("fn,plain", [(mha_core, mha_core_plain),
                                      (mha_head_batched, mha_head_batched_plain)])
def test_strided_views_equal_contiguous(fn, plain):
    """q, k, v as column slices of one [B, N, 3D] buffer (how the ViT block
    hands them over) give the bits of contiguous copies."""
    B, N, H, D = 2, 24, 4, 16
    qkv = torch.from_numpy(np.random.default_rng(4).normal(size=(B, N, 3 * H * D)).astype(np.float32))
    views = [qkv[..., i * H * D:(i + 1) * H * D] for i in range(3)]
    assert not views[1].is_contiguous()
    a = fn(*views, heads=H, precision="highest")
    b = fn(*(t.contiguous() for t in views), heads=H, precision="highest")
    assert torch.equal(a, b)
    assert torch.equal(a, plain(*views, heads=H, precision="highest"))
    assert a.is_contiguous() and a.shape == (B, N, H * D)


@pytest.mark.parametrize("B,N,H,D", [(2, 33, 8, 32), (1, 192, 4, 64), (2, 128, 2, 128),
                                     (1, 130, 2, 64), (1, 100, 2, 80), (1, 300, 2, 32)])
def test_flash_matches_jax(B, N, H, D):
    """Default blocks (128 / 128), N a multiple of the block or not."""
    qkv = _qkv(5, (B, N, H, D))
    want = np.asarray(jax_flash(*_j(qkv), interpret=True))
    got = flash_attention(*_t(qkv)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    np.testing.assert_allclose(got, np.asarray(attention_xla(*_j(qkv))), atol=F32_ATOL)


@pytest.mark.parametrize("N", [256, 300])
def test_flash_blocked_kv_matches_jax(N):
    """block_q = block_kv = 64: several key blocks, the last one ragged at
    N = 300, so the running max and sum are rescaled between blocks."""
    qkv = _qkv(6, (1, N, 2, 32))
    want = np.asarray(jax_flash(*_j(qkv), block_q=64, block_kv=64, interpret=True))
    got = flash_attention(*_t(qkv), block_q=64, block_kv=64).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    one_block = flash_attention(*_t(qkv), block_q=512, block_kv=512).numpy()
    np.testing.assert_allclose(got, one_block, atol=F32_ATOL)


def test_flash_bf16_matches_jax():
    B, N, H, D = 2, 192, 4, 80
    qkv = _qkv(7, (B, N, H, D))
    want = np.asarray(jax_flash(*_j(qkv, jnp.bfloat16), interpret=True,
                                precision="default").astype(jnp.float32))
    got = flash_attention(*_t(qkv, torch.bfloat16), precision="default")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


def test_flash_strided_views_and_dispatch():
    """Views of a [B, N, 3, H, D] buffer equal contiguous copies, and
    multihead_attention reaches the three implementations by name."""
    B, N, H, D = 2, 40, 4, 16
    qkv = torch.from_numpy(np.random.default_rng(8).normal(size=(B, N, 3, H, D)).astype(np.float32))
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    a = flash_attention(q, k, v)
    assert torch.equal(a, flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))
    assert torch.equal(a, flash_attention_plain(q, k, v))
    assert torch.equal(multihead_attention(q, k, v, impl="flash"), a)
    assert torch.equal(multihead_attention(q, k, v, impl="plain"), attention_plain(q, k, v))
    bf = multihead_attention(q, k, v, impl="flash_bf16")
    assert (bf - a).abs().max().item() <= BF16_TOL
    assert not torch.equal(bf, a)
    with pytest.raises(ValueError, match="impl"):
        multihead_attention(q, k, v, impl="pallas")
