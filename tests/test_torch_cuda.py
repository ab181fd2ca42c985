"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and the CUDA toolkit (the kernels are
built from ``video_gen_evals_tpu_torch/csrc`` at first use); without a card
they skip. The file imports no jax, so it runs on a machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json

import pytest
import torch

from video_gen_evals_tpu_torch.models import EncoderConfig, HumanActionScorer
from video_gen_evals_tpu_torch.models.fused_apply import block_kernel_forward
from video_gen_evals_tpu_torch.models.vit import ViTBlock
from video_gen_evals_tpu_torch.ops import precision as P
from video_gen_evals_tpu_torch.ops.attention import flash_attention, flash_attention_plain
from video_gen_evals_tpu_torch.ops.attention_core import (
    mha_core,
    mha_core_plain,
    mha_head_batched,
    mha_head_batched_plain,
)
from video_gen_evals_tpu_torch.ops.chain_kernel import fused_temporal_chain, fused_temporal_chain_plain
from video_gen_evals_tpu_torch.ops.conv_kernel import (
    fma_plan,
    fused_temporal_block,
    fused_temporal_block_plain,
    fused_temporal_block_stacked,
    fused_temporal_block_stacked_plain,
)
from video_gen_evals_tpu_torch.ops.conv_kernel_train import (
    LAUNCHES_PER_BACKWARD,
    fused_temporal_block_train,
    fused_temporal_block_train_bwd_plain,
    fused_temporal_block_train_plain,
)
from video_gen_evals_tpu_torch.ops.roi_align import (
    assign_fpn_levels,
    pack_pyramid,
    roi_align_pyramid_dma,
    roi_align_pyramid_dma_plain,
)
from video_gen_evals_tpu_torch.ops.window_kernel import (
    gather_windows,
    gather_windows_plain,
    gather_windows_subblock,
    gather_windows_subblock_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(gen, rows, d, n_diff):
    offsets = torch.tensor([sum(rows[:i]) for i in range(len(rows))], dtype=torch.int32)
    row_limit = torch.tensor([r - 1 for r in rows], dtype=torch.int32)
    bank = torch.randn(sum(rows), d, generator=gen)
    z0 = torch.randn(n_diff, generator=gen)
    return bank, offsets, row_limit, z0


@pytest.mark.parametrize("d", [2596, 37])   # 16-byte path and scalar path
def test_gather_kernel_is_bitwise_plain(cuda, d):
    gen = torch.Generator().manual_seed(0)
    bank, offsets, row_limit, z0 = _bank(gen, (48, 40, 35, 64), d, d // 3)
    B, clip = 64, 32
    vi = torch.randint(0, 4, (B,), generator=gen, dtype=torch.int32)
    st = torch.randint(-20, 80, (B,), generator=gen, dtype=torch.int32)
    args = (bank, offsets, row_limit, z0, d - d // 3, vi, st, clip)
    want = gather_windows_plain(*args)
    before = gather_windows.launches
    got = gather_windows(*(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    assert gather_windows.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_gather_kernel_refuses_int64(cuda):
    gen = torch.Generator().manual_seed(1)
    bank, offsets, row_limit, z0 = (t.to(cuda) for t in _bank(gen, (40,), 8, 4))
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        gather_windows(bank, offsets, row_limit, z0, 4, idx, idx, 32)


# batches that are no multiple of the "high" kernel's W = 128 / T windows a
# block (1, 5, 37, 513) beside the multiples, over the T and C corners
_STAGE_SHAPES = [(64, 32, 256), (64, 16, 64), (1, 8, 64), (5, 32, 256), (37, 8, 256),
                 (37, 32, 128), (513, 16, 128), (513, 32, 256)]


@pytest.mark.parametrize("batch,t_len,channels", _STAGE_SHAPES)
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
@pytest.mark.parametrize("precision,atol", [("highest", 1e-4), ("high", 1e-4)])
def test_block_kernel_matches_plain(cuda, batch, t_len, channels, dilation, precision, atol):
    """Against the plain version at the same precision, computed on the card
    in fp32 (TF32 off): only the order of the sums differs."""
    gen = torch.Generator().manual_seed(dilation)
    B = batch
    x = torch.randn(B, t_len, channels, generator=gen)
    w1, w2 = (torch.randn(5, channels, channels, generator=gen) / (5 * channels) ** 0.5
              for _ in range(2))
    gs = 1.0 + 0.1 * torch.randn(channels, generator=gen)
    gb = 0.1 * torch.randn(channels, generator=gen)
    args = [a.to(cuda) for a in (x, w1, w2, gs, gb)]
    want = fused_temporal_block_plain(*args, dilation, precision)
    before = fused_temporal_block.launches
    got = fused_temporal_block(*args, dilation, precision)
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= atol


@pytest.mark.parametrize("batch,t_len,channels", _STAGE_SHAPES)
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_block_kernel_default_matches_plain(cuda, batch, t_len, channels, dilation):
    """K3 at "default" (bf16 operands, fp32 sums) runs K4's forward body with
    no mask: within K4_TOL's "default" forward bound (1e-2; an intermediate
    on a bf16 rounding boundary can round the other way) of its plain
    version on the card, bitwise K4's forward at "default" without a mask,
    one launch counted."""
    gen = torch.Generator().manual_seed(dilation)
    x = torch.randn(batch, t_len, channels, generator=gen)
    args = [a.to(cuda) for a in (x,) + _stage_weights(gen, (), channels)]
    want = fused_temporal_block_plain(*args, dilation, "default")
    before = fused_temporal_block.launches
    got = fused_temporal_block(*args, dilation, "default")
    torch.cuda.synchronize()
    assert fused_temporal_block.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-2
    with torch.no_grad():
        assert torch.equal(got, fused_temporal_block_train(*args, None, dilation, "default"))


@pytest.mark.parametrize("batch,t_len,channels", [(512, 32, 256), (5, 32, 256), (37, 8, 64),
                                                   (513, 16, 128)])
@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_block_kernel_high_is_bitwise_repeatable(cuda, batch, t_len, channels, precision):
    """K3 at every precision sums in a fixed order: two calls give the same
    bits."""
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn(batch, t_len, channels, generator=gen)
    args = [a.to(cuda) for a in (x,) + _stage_weights(gen, (), channels)]
    runs = [fused_temporal_block(*args, 2, precision) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


# K3 at "highest" on the FMA body: W = 128 / T windows a block (16 at T = 8,
# 8 at T = 16, 4 at T = 32) against batches that are no multiple of it, and
# taps whose shift reaches T or beyond (T = 8 at d = 4 and 8), which the
# kernel skips
@pytest.mark.parametrize("batch,t_len,channels,dilation", [
    (1, 8, 64, 4), (37, 8, 128, 8), (5, 8, 256, 4), (513, 8, 64, 8), (37, 16, 64, 8),
    (513, 16, 256, 2), (5, 32, 128, 8), (513, 32, 256, 1), (1, 32, 256, 4)])
def test_block_kernel_highest_edges(cuda, batch, t_len, channels, dilation):
    plan = fma_plan(t_len, channels, batch, "block")
    assert plan.windows_per_block == 128 // t_len and batch % plan.windows_per_block
    gen = torch.Generator().manual_seed(batch + dilation)
    x = torch.randn(batch, t_len, channels, generator=gen)
    args = [a.to(cuda) for a in (x,) + _stage_weights(gen, (), channels)]
    want = fused_temporal_block_plain(*args, dilation, "highest")
    got = fused_temporal_block(*args, dilation, "highest")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


def test_block_kernel_refuses_grad(cuda):
    x = torch.zeros(4, 32, 64, device=cuda, requires_grad=True)
    w = torch.zeros(5, 64, 64, device=cuda)
    g = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_temporal_block(x, w, w, g, g, 1, "high")


@pytest.mark.parametrize("d,out_dim", [(2596, 2596), (2688, 2596), (37, 37), (40, 37)])
@pytest.mark.parametrize("batch", [512, 61])
def test_subblock_gather_kernel_is_bitwise_plain(cuda, d, out_dim, batch):
    """K2 against its plain version, bitwise: 16-byte and scalar paths, a
    lane-padded bank sliced to out_dim, clipped starts that are no multiple
    of 8 (video 2 has 37 rows: its windows clip to start 5)."""
    gen = torch.Generator().manual_seed(batch)
    # 8-aligned offsets, as build_feature_bank lays them out
    offsets = torch.tensor([0, 48, 88, 128], dtype=torch.int32)
    row_limit = torch.tensor([47, 39, 36, 63], dtype=torch.int32)
    bank = torch.randn(192, d, generator=gen)
    z0 = torch.randn(11, generator=gen)
    vi = torch.randint(0, 4, (batch,), generator=gen, dtype=torch.int32)
    st = torch.randint(-20, 80, (batch,), generator=gen, dtype=torch.int32)
    vi[:4], st[:4] = 2, torch.tensor([8, 3, 40, 0], dtype=torch.int32)
    args = (bank, offsets, row_limit, z0, 13, vi, st, 32)
    want = gather_windows_subblock_plain(*args, out_dim=out_dim)
    before = gather_windows_subblock.launches
    got = gather_windows_subblock(*(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args),
                                  out_dim=out_dim)
    torch.cuda.synchronize()
    assert gather_windows_subblock.launches == before + 1
    assert got.shape == (batch, 32, out_dim)
    assert torch.equal(got.cpu(), want)


def _stage_weights(gen, lead, channels):
    w1, w2 = (torch.randn(lead + (5, channels, channels), generator=gen) / (5 * channels) ** 0.5
              for _ in range(2))
    gs = 1.0 + 0.1 * torch.randn(lead + (channels,), generator=gen)
    gb = 0.1 * torch.randn(lead + (channels,), generator=gen)
    return w1, w2, gs, gb


# the scorer's 10 chains, batches that are no multiple of W = 128 / T
# windows a block (37, 5, 513), one chain, and the T and C corners
@pytest.mark.parametrize("chains,batch,t_len,channels", [
    (10, 512, 32, 256), (3, 37, 16, 64), (2, 5, 32, 256), (3, 513, 32, 256), (1, 512, 32, 256),
    (1, 5, 8, 128), (2, 513, 8, 128), (2, 37, 32, 64)])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_stacked_kernel_matches_plain(cuda, chains, batch, t_len, channels, dilation):
    """K9 against its plain version (K3's plain version at "high" per chain)
    on the card: 1e-4, as K3 "high"; and chain by chain bitwise K3 "high",
    whose kernel K9 runs with the chain on the grid's second axis."""
    gen = torch.Generator().manual_seed(dilation)
    xs = torch.randn(chains, batch, t_len, channels, generator=gen)
    args = [a.to(cuda) for a in (xs,) + _stage_weights(gen, (chains,), channels)]
    want = fused_temporal_block_stacked_plain(*args, dilation)
    before = fused_temporal_block_stacked.launches
    got = fused_temporal_block_stacked(*args, dilation)
    torch.cuda.synchronize()
    assert fused_temporal_block_stacked.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4
    for s, chain in enumerate(zip(*args)):
        assert torch.equal(got[s], fused_temporal_block(*chain, dilation, "high")), s


def test_stacked_kernel_refuses_a_foreign_plan(cuda):
    """The "high" C entry point, with K9's chains, launches only with its
    instantiation's plan (another window count or shared-memory size is
    refused before any launch) and refuses more chains than the grid's
    second axis holds."""
    from video_gen_evals_tpu_torch.ops.conv_kernel import high_weight_planes, tc_plan
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library, stream_handle

    gen = torch.Generator().manual_seed(0)
    xs = torch.randn(2, 8, 32, 256, generator=gen).to(cuda)
    w1s, w2s, gs, gb = (a.to(cuda) for a in _stage_weights(gen, (2,), 256))
    wk = high_weight_planes(w1s, w2s)
    out = torch.full_like(xs, float("nan"))
    plan = tc_plan(32, 256, 8, "block_high")
    lib = load_library().lib

    def launch(windows_per_block, smem_bytes, chains=2):
        return lib.vge_temporal_block_high(
            xs.device.index, xs.data_ptr(), wk.data_ptr(), gs.data_ptr(), gb.data_ptr(), out.data_ptr(),
            chains, 8, 32, 256, 1, windows_per_block, smem_bytes, stream_handle(xs.device))

    assert launch(plan.windows_per_block + 1, plan.smem_bytes) != 0
    assert launch(plan.windows_per_block, plan.smem_bytes - 16) != 0
    assert launch(plan.windows_per_block, plan.smem_bytes, chains=65536) != 0
    torch.cuda.synchronize()
    assert torch.isnan(out).all()   # nothing ran
    assert launch(plan.windows_per_block, plan.smem_bytes) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


# batches that are no multiple of W = 128 / T windows a block (1, 5, 37, 513)
# beside the multiples, over the T and C corners
@pytest.mark.parametrize("batch,t_len,channels", [(512, 32, 256), (37, 16, 64), (1, 8, 128),
                                                   (5, 32, 256), (513, 32, 128), (513, 8, 256)])
@pytest.mark.parametrize("dilations", [(1, 2, 4, 8), (1, 2), (4, 8)])
@pytest.mark.parametrize("variant", ["slice", "mm_first"])
def test_chain_kernel_matches_plain(cuda, batch, t_len, channels, dilations, variant):
    """K10 (4 stages, and the two halves of chain2) against its plain
    version (K3's plain version at "high", stage after stage) on the card:
    1e-4, as K3 "high"; each stage renormalizes, so errors do not grow."""
    gen = torch.Generator().manual_seed(len(dilations) + dilations[0])
    x = torch.randn(batch, t_len, channels, generator=gen)
    args = [a.to(cuda) for a in (x,) + _stage_weights(gen, (len(dilations),), channels)]
    want = fused_temporal_chain_plain(*args, dilations)
    before = fused_temporal_chain.launches
    got = fused_temporal_chain(*args, dilations, variant)
    torch.cuda.synchronize()
    assert fused_temporal_chain.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("batch,t_len,channels", [(512, 32, 256), (5, 8, 128), (513, 16, 64)])
@pytest.mark.parametrize("dilations", [(1, 2, 4, 8), (4, 8)])
def test_chain_kernel_is_bitwise_repeatable(cuda, batch, t_len, channels, dilations):
    """K10 sums in a fixed order and each stage reads back only what its
    block wrote: two calls give the same bits."""
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn(batch, t_len, channels, generator=gen)
    args = [a.to(cuda) for a in (x,) + _stage_weights(gen, (len(dilations),), channels)]
    runs = [fused_temporal_chain(*args, dilations) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


def test_block_kernel_forward_on_card_matches_module(cuda):
    """Every stage_fusion, and attn_impl "core" (K6 at "high"), against the
    module forward (K3 per stage) on the card at "high": 1e-4 on all three
    outputs; each fused forward launches its own kernel and not K3."""
    cfg = EncoderConfig.create({"vit": 64, "pose": 207}, {"vit": 64, "pose": 69},
                               d_model=256, time_layers=1, time_heads=8)
    model = HumanActionScorer(cfg, generator=torch.Generator().manual_seed(5)).to(cuda)
    x = torch.randn(64, 32, cfg.input_dim, generator=torch.Generator().manual_seed(6)).to(cuda)
    fns = (fused_temporal_block, fused_temporal_block_stacked, fused_temporal_chain, mha_core)
    want_launches = {"stage": (16, 0, 0), "chain": (0, 0, 4), "chain2": (0, 0, 8),
                     "stacked": (0, 4, 0)}
    with torch.inference_mode():
        want = model(x, "high")
        for fusion, attn in [(f, "xla") for f in want_launches] + [("stacked", "core")]:
            before = [fn.launches for fn in fns]
            got = block_kernel_forward(cfg, model, x, precision="high", stage_fusion=fusion,
                                       attn_impl=attn)
            torch.cuda.synchronize()
            n = tuple(fn.launches - b for fn, b in zip(fns, before))
            assert n == want_launches[fusion] + (1 if attn == "core" else 0,), (fusion, attn, n)
            for g, w in zip(got, want):
                assert (g - w).abs().max().item() <= 1e-4, (fusion, attn)


@pytest.mark.parametrize("impl,tol", [("pallas", 2e-5), ("pallas_bf16", 0.05)])
def test_encoder_attention_impl_pallas_on_card(cuda, impl, tol):
    """attention_impl "pallas" (K8 at "highest") and "pallas_bf16" (K8 at
    "default") run K8 in eval mode (one launch a layer) against the plain fp32
    attention: 2e-5 (fp32 sums in another order); 0.05 at "default", where q,
    k, v and p are rounded to bf16 (2^-9 relative each) in 2 layers whose
    tokens reach a few units."""
    dims = ({"vit": 64}, {"vit": 64})
    model = HumanActionScorer(EncoderConfig.create(*dims, d_model=256, time_layers=2,
                                                   time_heads=8),
                              generator=torch.Generator().manual_seed(7)).to(cuda)
    flash = HumanActionScorer(EncoderConfig.create(*dims, d_model=256, time_layers=2,
                                                   time_heads=8, attention_impl=impl)).to(cuda)
    flash.load_state_dict(model.state_dict())
    x = torch.randn(64, 32, 128, generator=torch.Generator().manual_seed(8)).to(cuda)
    with torch.inference_mode():
        before = flash_attention.launches
        got = flash(x, "highest")
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 2
        for g, w in zip(got, model(x, "highest")):
            assert (g - w).abs().max().item() <= tol


def _train_inputs(seed, batch, t_len, channels, with_mask):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, t_len, channels, generator=gen)
    w1, w2 = (torch.randn(5, channels, channels, generator=gen) / (5 * channels) ** 0.5
              for _ in range(2))
    gs = 1.0 + 0.1 * torch.randn(channels, generator=gen)
    gb = 0.1 * torch.randn(channels, generator=gen)
    mask = (torch.rand(x.shape, generator=gen) < 0.9).float() / 0.9 if with_mask else None
    dy = torch.randn(x.shape, generator=gen)
    return x, w1, w2, gs, gb, mask, dy


@pytest.mark.parametrize("batch,t_len,channels", [(960, 32, 256), (24, 16, 64), (5, 8, 128),
                                                   (1, 32, 64), (37, 8, 256), (513, 16, 128),
                                                   (5, 32, 256), (961, 32, 256)])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_train_kernels_match_plain(cuda, batch, t_len, channels, dilation, with_mask, precision):
    """K4 forward and backward against their plain versions at the same
    precision, both on the card. Forward within 1e-4. Gradients within
    5e-4 * scale + 5e-4 * |plain| at "highest", scale = max(1, max |plain|) of
    the tensor: the order of the sums differs, and a weight-gradient element
    sums up to 30720 products, so one that cancels to near zero carries the
    rounding of the whole sum. At
    "default" an intermediate that lands on a bf16 rounding boundary can round
    the other way in the kernel than in the plain version, a relative step of
    2^-8 in one operand: forward within 1e-2, gradients within 2e-2 * scale +
    2e-2 * |plain|."""
    x, w1, w2, gs, gb, mask, dy = (
        None if t is None else t.to(cuda)
        for t in _train_inputs(dilation, batch, t_len, channels, with_mask))
    f_tol, g_tol = (1e-4, 5e-4) if precision == "highest" else (1e-2, 2e-2)
    want = fused_temporal_block_train_plain(x, w1, w2, gs, gb, mask, dilation, precision)
    want_g = fused_temporal_block_train_bwd_plain(x, w1, w2, gs, mask, dy, dilation, precision)
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2, gs, gb)]
    n_f, n_b = fused_temporal_block_train.launches, fused_temporal_block_train.launches_bwd
    got = fused_temporal_block_train(*leaves, mask, dilation, precision)
    got_g = torch.autograd.grad(got, leaves, dy)
    torch.cuda.synchronize()
    assert fused_temporal_block_train.launches == n_f + 1
    assert fused_temporal_block_train.launches_bwd == n_b + LAUNCHES_PER_BACKWARD
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= f_tol
    for name, g, w in zip(("dx", "dw1", "dw2", "dgamma", "dbeta"), got_g, want_g):
        assert torch.isfinite(g).all(), name
        excess = ((g - w).abs() - g_tol * w.abs()).max().item()
        assert excess <= g_tol * max(1.0, w.abs().max().item()), name


@pytest.mark.parametrize("batch,t_len,channels", [(960, 32, 256), (37, 8, 64), (513, 16, 128),
                                                   (5, 32, 256)])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_train_backward_is_bitwise_repeatable(cuda, precision, batch, t_len, channels):
    """No atomics and fixed-order sums: two backward calls give the same bits."""
    x, w1, w2, gs, gb, mask, dy = (t.to(cuda) for t in _train_inputs(7, batch, t_len, channels, True))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (x, w1, w2, gs, gb)]
        out = fused_temporal_block_train(*leaves, mask, 2, precision)
        runs.append(torch.autograd.grad(out, leaves, dy))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch,t_len,channels", [(960, 32, 256), (37, 8, 64), (513, 16, 128),
                                                   (5, 32, 256), (961, 32, 256), (1, 8, 256)])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_train_forward_is_bitwise_repeatable(cuda, precision, with_mask, batch, t_len, channels):
    """The forward writes each output once, no atomics: two calls give the
    same bits."""
    x, w1, w2, gs, gb, mask, _dy = (
        None if t is None else t.to(cuda) for t in _train_inputs(11, batch, t_len, channels, with_mask))
    runs = [fused_temporal_block_train(x, w1, w2, gs, gb, mask, 4, precision) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)


# K4's forward at "highest" on the FMA body (K3's kernel with the mask): W =
# 128 / T windows a block against batches that are no multiple of it, and
# taps whose shift reaches T or beyond (T = 8 at d = 4 and 8)
@pytest.mark.parametrize("batch,t_len,channels,dilation", [
    (1, 32, 256, 2), (5, 32, 256, 1), (37, 16, 128, 8), (961, 32, 256, 4), (961, 8, 64, 4),
    (37, 8, 256, 8), (5, 8, 128, 4)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_train_highest_forward_edges(cuda, batch, t_len, channels, dilation, with_mask):
    """Within K4_TOL's "highest" forward bound (1e-4) of the plain version."""
    plan = fma_plan(t_len, channels, batch, "train_fwd")
    assert plan.windows_per_block == 128 // t_len and batch % plan.windows_per_block
    x, w1, w2, gs, gb, mask, _dy = (
        None if t is None else t.to(cuda)
        for t in _train_inputs(batch + dilation, batch, t_len, channels, with_mask))
    want = fused_temporal_block_train_plain(x, w1, w2, gs, gb, mask, dilation, "highest")
    before = fused_temporal_block_train.launches
    got = fused_temporal_block_train(x, w1, w2, gs, gb, mask, dilation, "highest")
    torch.cuda.synchronize()
    assert fused_temporal_block_train.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


def test_train_highest_forward_refuses_a_foreign_plan(cuda):
    """The C entry point launches only with its instantiation's plan: another
    window count or shared-memory size is refused before any launch."""
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library, stream_handle

    x, w1, w2, gs, gb, mask, _dy = (t.to(cuda) for t in _train_inputs(1, 8, 32, 256, True))
    out = torch.full_like(x, float("nan"))
    plan = fma_plan(32, 256, 8, "train_fwd")
    lib = load_library().lib

    def launch(windows_per_block, smem_bytes):
        return lib.vge_temporal_block_train_fwd(
            x.device.index, x.data_ptr(), w1.data_ptr(), w2.data_ptr(), gs.data_ptr(), gb.data_ptr(),
            mask.data_ptr(), out.data_ptr(), 8, 32, 256, 1, windows_per_block, smem_bytes,
            stream_handle(x.device))

    assert launch(plan.windows_per_block + 1, plan.smem_bytes) != 0
    assert launch(plan.windows_per_block, plan.smem_bytes - 16) != 0
    torch.cuda.synchronize()
    assert torch.isnan(out).all()   # nothing ran
    assert launch(plan.windows_per_block, plan.smem_bytes) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


# K4's backward at "highest": row counts that are no multiple of the
# weight-gradient kernel's 128-row tile or 32-row stage, with one and with
# several row ranges (splits 1, 2, 4)
@pytest.mark.parametrize("batch,t_len,channels,dilation", [
    (77, 16, 128, 1), (37, 8, 256, 2), (300, 16, 64, 4), (301, 32, 128, 8), (1, 32, 256, 2)])
def test_train_highest_grads_at_ragged_rows(cuda, batch, t_len, channels, dilation):
    """Gradients within K4_TOL's "highest" bound (5e-4 * scale + 5e-4 *
    |plain|, as test_train_kernels_match_plain)."""
    assert (batch * t_len) % 128
    x, w1, w2, gs, gb, mask, dy = (t.to(cuda) for t in _train_inputs(batch, batch, t_len, channels, True))
    want_g = fused_temporal_block_train_bwd_plain(x, w1, w2, gs, mask, dy, dilation, "highest")
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2, gs, gb)]
    got_g = torch.autograd.grad(fused_temporal_block_train(*leaves, mask, dilation, "highest"), leaves, dy)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "dw1", "dw2", "dgamma", "dbeta"), got_g, want_g):
        assert torch.isfinite(g).all(), name
        excess = ((g - w).abs() - 5e-4 * w.abs()).max().item()
        assert excess <= 5e-4 * max(1.0, w.abs().max().item()), name


def test_train_kernel_carries_grads_through_permuted_weights(cuda):
    """The encoder hands the weights as permuted views of [Cout, Cin, K]
    parameters: their .grad must land in that layout, equal to the CPU run's."""
    x, w1, w2, gs, gb, mask, dy = _train_inputs(3, 8, 16, 64, True)
    grads = {}
    for dev in ("cpu", cuda):
        p1, p2 = (w.permute(2, 1, 0).contiguous().to(dev).requires_grad_() for w in (w1, w2))
        out = fused_temporal_block_train(
            x.to(dev), p1.permute(2, 1, 0), p2.permute(2, 1, 0), gs.to(dev), gb.to(dev),
            mask.to(dev), 2, "highest")
        out.backward(dy.to(dev))
        grads[str(dev)] = (p1.grad.cpu(), p2.grad.cpu())
    for a, b in zip(grads["cpu"], grads["cuda"]):
        assert a.shape == (64, 64, 5)
        assert (a - b).abs().max().item() <= 5e-4


def test_train_kernel_refuses_unbuilt_shapes(cuda):
    x = torch.zeros(4, 12, 64, device=cuda)
    w = torch.zeros(5, 64, 64, device=cuda)
    g = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="built for T"):
        fused_temporal_block_train(x, w, w, g, g, None, 1, "highest")
    with pytest.raises(ValueError, match="precision"):
        fused_temporal_block_train(x, w, w, g, g, None, 1, "high")


def test_forward_on_card_matches_cpu(cuda):
    """The whole encoder, kernels on the card against plain versions on the
    CPU, at "highest": atol 1e-4 (sum order through 8 conv stages and a
    transformer layer)."""
    cfg = EncoderConfig.create({"vit": 64, "pose": 207}, {"vit": 64, "pose": 69},
                               d_model=256, time_layers=1, time_heads=8)
    model = HumanActionScorer(cfg, generator=torch.Generator().manual_seed(3)).eval()
    x = torch.randn(32, 32, cfg.input_dim, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        want = model(x, "highest")
        got = model.to(cuda)(x.to(cuda), "highest")
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-4


# fp32 sums in another order: 2e-5. At "high" (bf16x3) each product carries
# about 2^-16 relative and the two sides split a p that differs in its last
# bits: 5e-5. With bf16 operands a p or an output on a rounding boundary can
# round the other way: 0.03.
_ATTN_TOL = {"highest": 2e-5, "high": 5e-5, "default": 0.03}
# "default" on fp32 I/O: fp32 outputs, only p rounded to bf16, at another
# point than in the plain version (chip_smoke.py's ATTN_FP32IO_TOL)
_ATTN_FP32IO_TOL = 5e-3


def _qkv_slices(seed, B, N, H, hd, dtype, device):
    """q, k, v as the column slices of one [B, N, 3 * H * hd] buffer."""
    D = H * hd
    qkv = torch.randn(B, N, 3 * D, generator=torch.Generator().manual_seed(seed)).to(device).to(dtype)
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def _unaligned(t):
    """A copy of [B, N, D] (or [B, N, H, hd]) t whose rows start one element
    past a 16-byte boundary, so the kernels load them through registers."""
    B, N = t.shape[:2]
    flat = t.reshape(B, N, -1)
    buf = torch.zeros(B, N, flat.shape[-1] + 1, dtype=t.dtype, device=t.device)
    buf[..., 1:] = flat
    row = buf.shape[-1]
    inner = (1,) if t.ndim == 3 else (t.shape[3], 1)
    return torch.as_strided(buf, t.shape, (N * row, row) + inner, storage_offset=1)


# N at the 16- and 64-key edges of the tensor-core kernels (1, 15 to 17, 63
# to 65) and 384 at head width 32; pairs packed several to a block at
# N = 33, the last block half empty at 15 pairs; the largest N the wrapper
# takes at widths 80, 64 and 32 (324, 396, 720: the FMA body's sub-tiles
# shrink to fit shared memory, and "default" runs there where the
# tensor-core plan does not fit)
@pytest.mark.parametrize("B,N,H,hd", [(32, 192, 16, 80), (64, 33, 8, 32), (3, 100, 4, 64),
                                      (2, 77, 3, 18), (2, 100, 2, 128),
                                      (3, 1, 4, 80), (3, 15, 4, 64), (2, 16, 4, 32), (3, 17, 4, 80),
                                      (2, 63, 4, 64), (2, 64, 4, 32), (2, 65, 4, 80), (2, 384, 2, 32),
                                      (5, 33, 3, 32), (1, 324, 2, 80), (1, 396, 2, 64), (1, 720, 2, 32)])
@pytest.mark.parametrize("dtype,precision", [(torch.float32, "highest"), (torch.float32, "high"),
                                             (torch.float32, "default"), (torch.bfloat16, "default"),
                                             (torch.bfloat16, "highest")])
def test_mha_core_kernel_matches_plain(cuda, B, N, H, hd, dtype, precision):
    """K6 on strided slices: the built head widths (80, 64, 32), a run-time
    width (128), a width that is no multiple of four (18: scalar loads), odd
    N. A bf16 output is one rounding of the fp32 result: 0.03 at any precision.
    Contiguous inputs, and rows that start off a 16-byte boundary (loaded
    through registers, not by cp.async), give the same bits."""
    q, k, v = _qkv_slices(N, B, N, H, hd, dtype, cuda)
    assert not q.is_contiguous()
    want = mha_core_plain(q, k, v, H, precision=precision)
    before = mha_core.launches
    got = mha_core(q, k, v, H, precision=precision)
    torch.cuda.synchronize()
    assert mha_core.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    tol = 0.03 if dtype == torch.bfloat16 else _ATTN_TOL[precision]
    assert (got.float() - want.float()).abs().max().item() <= tol
    again = mha_core(q.contiguous(), k.contiguous(), v.contiguous(), H, precision=precision)
    assert torch.equal(got, again)   # strides change no bit
    assert torch.equal(got, mha_core(*(_unaligned(t) for t in (q, k, v)), H, precision=precision))


@pytest.mark.parametrize("B,N,H,hd", [(32, 192, 16, 80), (3, 45, 4, 16)])
@pytest.mark.parametrize("dtype,precision", [(torch.float32, "highest"), (torch.bfloat16, "default")])
def test_mha_head_batched_kernel_matches_plain(cuda, B, N, H, hd, dtype, precision):
    """K7 on the card reads the strided slices in place through K6's kernel:
    it allocates only its output, makes no relayout copy, and gives K6's bits."""
    q, k, v = _qkv_slices(N + 1, B, N, H, hd, dtype, cuda)
    want = mha_head_batched_plain(q, k, v, H, precision=precision)
    before = mha_head_batched.launches
    held = torch.cuda.memory_allocated()
    probe = torch.empty(q.shape, dtype=q.dtype, device=cuda)
    out_block = torch.cuda.memory_allocated() - held   # the allocator's block for one output
    del probe
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = mha_head_batched(q, k, v, H, precision=precision)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - held == out_block
    assert mha_head_batched.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= _ATTN_TOL[precision]
    assert torch.equal(got, mha_core(q, k, v, H, precision=precision))


# N at the 16- and 64-key edges, pairs packed several to a block at N = 33,
# a ragged last key block (200 = 128 + 72), the largest block_kv the wrapper
# takes at head width 32 (384) on a sequence whose keys stream through it
@pytest.mark.parametrize("B,N,H,hd,block", [(32, 192, 16, 80, 128), (2, 33, 8, 32, 128), (2, 100, 4, 64, 64),
                                            (1, 300, 2, 32, 64), (2, 130, 2, 128, 64), (1, 1000, 2, 80, 128),
                                            (3, 1, 4, 80, 64), (3, 17, 4, 64, 64), (2, 65, 4, 32, 64),
                                            (5, 33, 3, 32, 128), (2, 200, 3, 80, 128), (1, 700, 2, 32, 384)])
@pytest.mark.parametrize("dtype,precision", [(torch.float32, "highest"), (torch.bfloat16, "default")])
def test_flash_kernel_matches_plain(cuda, B, N, H, hd, block, dtype, precision):
    """K8 on views of a [B, N, 3, H, hd] buffer: one block, several blocks,
    a ragged last block, and a sequence the one-pass kernels cannot hold.
    Contiguous and unaligned inputs give the same bits."""
    qkv = torch.randn(B, N, 3, H, hd, generator=torch.Generator().manual_seed(N)).to(cuda).to(dtype)
    q, k, v = qkv.unbind(dim=2)
    want = flash_attention_plain(q, k, v, block_q=block, block_kv=block, precision=precision)
    before = flash_attention.launches
    got = flash_attention(q, k, v, block_q=block, block_kv=block, precision=precision)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= _ATTN_TOL[precision]
    assert torch.equal(got, flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                            block_q=block, block_kv=block, precision=precision))
    assert torch.equal(got, flash_attention(*(_unaligned(t) for t in (q, k, v)),
                                            block_q=block, block_kv=block, precision=precision))


# The FMA body (fp32 "highest", bf16x3 "high") walks a pair's query rows in
# sub-tiles of at most 64 rows split evenly over the sequence: N at the edges
# of one, two and three sub-tiles at ViT-H's width
@pytest.mark.parametrize("N", [64, 65, 128, 129, 191, 192])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_mha_core_fma_subtile_edges(cuda, N, precision):
    q, k, v = _qkv_slices(N + 7, 3, N, 2, 80, torch.float32, cuda)
    got = mha_core(q, k, v, 2, precision=precision)
    torch.cuda.synchronize()
    assert (got - mha_core_plain(q, k, v, 2, precision=precision)).abs().max().item() <= _ATTN_TOL[precision]
    assert torch.equal(got, mha_core(q.contiguous(), k.contiguous(), v.contiguous(), 2, precision=precision))
    assert torch.equal(got, mha_core(*(_unaligned(t) for t in (q, k, v)), 2, precision=precision))


# Scores more than 90 apart in a row: exp(s - max) underflows to subnormal
# p (and p / sum below the normal range), the case where the IEEE
# division leaves its fast path. q and k hold integers and the scale is
# 1/8, so every side forms the same scores.
@pytest.mark.parametrize("kernel,precision", [("K6", "highest"), ("K6", "high"), ("K8", "highest")])
def test_attention_fma_underflowing_p(cuda, kernel, precision):
    B, N, H, hd = 2, 40, 2, 64
    gen = torch.Generator().manual_seed(11)
    q, k = (torch.randint(-12, 13, (B, N, H, hd), generator=gen).float() for _ in range(2))
    v = torch.randn(B, N, H, hd, generator=gen)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) / 8
    spread = (s.amax(-1) - s.amin(-1)).amax().item()
    assert spread > 90
    q, k, v = (t.to(cuda) for t in (q, k, v))
    if kernel == "K6":
        q, k, v = (t.reshape(B, N, H * hd) for t in (q, k, v))
        got = mha_core(q, k, v, H, precision=precision)
        want = mha_core_plain(q, k, v, H, precision=precision)
    else:
        got = flash_attention(q, k, v, precision=precision)
        want = flash_attention_plain(q, k, v, precision=precision)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= _ATTN_TOL[precision]


# Short sequences pack several pairs into a block (5 at N = 33 and width 32,
# 16 at N = 9): 21 and 28 pairs leave the last group partly empty; one pair
@pytest.mark.parametrize("B,N,H,hd", [(5, 33, 3, 32), (7, 33, 3, 32), (7, 9, 4, 64), (1, 33, 1, 80)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_mha_core_fma_packed_pairs(cuda, B, N, H, hd, precision):
    q, k, v = _qkv_slices(B * N, B, N, H, hd, torch.float32, cuda)
    got = mha_core(q, k, v, H, precision=precision)
    torch.cuda.synchronize()
    assert (got - mha_core_plain(q, k, v, H, precision=precision)).abs().max().item() <= _ATTN_TOL[precision]
    assert torch.equal(got, mha_core(*(_unaligned(t) for t in (q, k, v)), H, precision=precision))
    if precision == "highest":
        assert torch.equal(got, mha_head_batched(q, k, v, H, precision=precision))


# K8's FMA body holds a pair's keys in shared memory while 32 query rows a
# sub-tile still fit, and streams its key blocks beyond: the last N of one
# side and the first of the other, at ViT-H's width and at head width 32
@pytest.mark.parametrize("hd", [80, 32])
@pytest.mark.parametrize("side", [0, 1])
def test_flash_fma_resident_and_streamed(cuda, hd, side):
    from video_gen_evals_tpu_torch.ops.cuda_lib import load_library

    lib = load_library().lib
    n = next(n for n in range(64, 4096) if lib.vge_flash_streams(n + 1, hd, 128)) + side
    assert lib.vge_flash_streams(n, hd, 128) == side
    qkv = torch.randn(2, n, 3, 2, hd, generator=torch.Generator().manual_seed(n)).to(cuda)
    q, k, v = qkv.unbind(dim=2)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (got - flash_attention_plain(q, k, v)).abs().max().item() <= _ATTN_TOL["highest"]
    assert torch.equal(got, flash_attention(*(_unaligned(t) for t in (q, k, v))))


def test_attention_kernels_refuse_what_they_cannot_run(cuda):
    q = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        mha_core(q.requires_grad_(), q, q, 4)
    q = torch.zeros(1, 1000, 160, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mha_core(q, q, q, 2)                      # one head's keys no longer fit a block
    q4 = torch.zeros(1, 200, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="multiples of 64"):
        flash_attention(q4, q4, q4, block_q=32, block_kv=32)
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q4, q4.cpu(), q4)


@pytest.mark.parametrize("impl", ["core", "head_batched", "flash", "flash_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_block_on_card_matches_plain_impl(cuda, impl, dtype):
    """One ViT-H-width block per attention_impl against the einsum block on
    the same weights, fp32 activations: fp32 weights at "highest" within
    1e-4 (5e-2 for "flash_bf16", which rounds q, k, v and p); bf16-rounded
    weights at "default" (the extraction's bf16 mode: every product's
    operands rounded, the kernels at "default") within 0.1 on activations of
    order 1."""
    gen = torch.Generator().manual_seed(5)
    ref = ViTBlock(1280, 16, attention_impl="plain").eval()
    blk = ViTBlock(1280, 16, attention_impl=impl).eval()
    blk.load_state_dict(ref.state_dict())
    precision = "default" if dtype == torch.bfloat16 else "highest"
    x = torch.randn(4, 192, 1280, generator=gen).to(cuda)
    with torch.inference_mode():
        want = P.set_precision_(ref.to(cuda).to(dtype), precision)(x)
        got = P.set_precision_(blk.to(cuda).to(dtype), precision)(x)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    tol = 0.1 if dtype == torch.bfloat16 else 5e-2 if impl == "flash_bf16" else 1e-4
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("B,N,H,hd", [(2, 192, 16, 80), (512, 33, 8, 32)])
def test_mha_core_default_on_fp32_slices(cuda, B, N, H, hd):
    """K6 at "default" on fp32 q, k, v, the strided slices of one qkv
    projection as a ViT-H block at the "default" class hands them (and the
    scorer's shape): within _ATTN_FP32IO_TOL of its plain version, an fp32 output,
    one launch counted under "default", and the same bits as contiguous and
    unaligned copies of the inputs."""
    q, k, v = _qkv_slices(7, B, N, H, hd, torch.float32, cuda)
    assert not q.is_contiguous()
    before = dict(mha_core.launches_by_precision)
    got = mha_core(q, k, v, H, precision="default")
    torch.cuda.synchronize()
    assert mha_core.launches_by_precision == dict(before, default=before["default"] + 1)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert (got - mha_core_plain(q, k, v, H, precision="default")).abs().max().item() <= _ATTN_FP32IO_TOL
    assert torch.equal(got, mha_core(q.contiguous(), k.contiguous(), v.contiguous(), H, precision="default"))
    assert torch.equal(got, mha_core(*(_unaligned(t) for t in (q, k, v)), H, precision="default"))


def test_attention_launches_by_precision(cuda):
    """K6, K7 and K8 count each launch under the precision asked for, and
    only there."""
    q, k, v = _qkv_slices(8, 2, 64, 4, 32, torch.float32, cuda)
    q4, k4, v4 = (t.reshape(2, 64, 4, 32) for t in (q, k, v))
    calls = ((mha_core, lambda p: mha_core(q, k, v, 4, precision=p), ("default", "high", "highest")),
             (mha_head_batched, lambda p: mha_head_batched(q, k, v, 4, precision=p), ("default", "highest")),
             (flash_attention, lambda p: flash_attention(q4, k4, v4, block_q=64, block_kv=64, precision=p),
              ("default", "highest")))
    for fn, call, precisions in calls:
        assert set(fn.launches_by_precision) == set(precisions)
        for p in precisions:
            before, total = dict(fn.launches_by_precision), fn.launches
            call(p)
            assert fn.launches_by_precision == dict(before, **{p: before[p] + 1}) and fn.launches == total + 1
    torch.cuda.synchronize()


# the card's routes against their plain versions on the CPU: fp32 sums in
# another order over K = 1280 (linear) and 1152 (conv) terms of unit scale
_PRECISION_ROUTE_TOL = 2e-4


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_precision_routes_match_plain(cuda, precision, wdtype):
    """ops/precision.py on the card (cuBLAS with an fp32 output from bf16
    operands at "default", else fp32 with TF32 off; cuDNN and batched matmul
    in TF32 on the rounded operands at "default", where it is exact) against
    the plain versions on the CPU, fp32 out, whatever the global TF32 flags
    say (cuDNN's is on, torch's default, matmul's off), and the flags left
    as they were (cuDNN's put back after the test)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _precision_routes_match_plain(cuda, precision, wdtype)
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _precision_routes_match_plain(cuda, precision, wdtype):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(3, 256, 1280, generator=gen)
    w = (torch.randn(640, 1280, generator=gen) / 36).to(wdtype)
    b = torch.randn(640, generator=gen).to(wdtype)
    got = P.linear(x.to(cuda), w.to(cuda), b.to(cuda), precision)
    assert got.dtype == torch.float32 and got.shape == (3, 256, 640)
    assert (got.cpu() - P.linear_plain(x, w, b, precision)).abs().max().item() <= _PRECISION_ROUTE_TOL
    img = torch.randn(2, 128, 20, 24, generator=gen)
    k = (torch.randn(96, 64, 3, 3, generator=gen) / 24).to(wdtype)
    got = P.conv2d(img.to(cuda), k.to(cuda), None, 2, 1, 1, 2, precision)
    assert got.dtype == torch.float32
    assert (got.cpu() - P.conv2d_plain(img, k, None, 2, 1, 1, 2, precision)).abs().max().item() <= _PRECISION_ROUTE_TOL
    a, m = torch.randn(4, 133, 128, generator=gen), torch.randn(4, 128, 133, generator=gen) / 11
    got = P.matmul(a.to(cuda), m.to(cuda), precision)
    assert (got.cpu() - P.matmul_plain(a, m, precision)).abs().max().item() <= _PRECISION_ROUTE_TOL
    if precision == "default":   # the rounding happened: not the fp32 product
        assert (got.cpu() - P.matmul_plain(a, m, "highest")).abs().max().item() > 1e-3
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


# K5 against its plain version: fp32 sums of at most 48 x 56 taps a bin in
# another order, on features of order 1
_ROI_TOL = 2e-5


def _roi_inputs(gen, batch, canvas, channels, n_rois):
    """A packed pyramid of unit-scale features for ``batch`` canvases, random
    proposals on their canonical levels, and over-span boxes (wider than the
    56-column window) on p2."""
    H, W = canvas
    feats = [torch.randn(batch, channels, H // s, W // s, generator=gen) for s in (4, 8, 16, 32)]
    xy = torch.rand(batch, n_rois, 2, generator=gen) * torch.tensor([W, H]) * 0.9
    wh = 4 + torch.rand(batch, n_rois, 2, generator=gen) ** 2 * torch.tensor([W, H]) * 0.5
    boxes = torch.cat([xy, xy + wh], dim=-1)
    boxes[:, :4] = torch.tensor([[0.0, 40.0, W - 1.0, 60.0], [8.0, 0.0, W * 0.8, 12.0],
                                 [W * 0.5, H * 0.5, W * 1.0, H * 0.5 + 6], [3.0, 3.0, 3.0, 30.0]])
    levels = assign_fpn_levels(boxes)
    levels[:, :3] = 0
    return pack_pyramid(feats), boxes, levels


@pytest.mark.parametrize("batch,canvas,channels,n_rois", [(2, (768, 1344), 256, 1000), (3, (96, 160), 16, 37),
                                                          (2, (96, 160), 13, 37), (1, (96, 160), 260, 20)])
def test_roi_align_kernel_matches_plain(cuda, batch, canvas, channels, n_rois):
    """K5 on the detector's full canvas (p2..p5 packed into 360 x 336 x 256)
    and on a small one, in-span proposals and over-span boxes: within
    _ROI_TOL of the plain version, one launch a call."""
    gen = torch.Generator().manual_seed(7)
    (buf, offs, hw), boxes, levels = _roi_inputs(gen, batch, canvas, channels, n_rois)
    want = roi_align_pyramid_dma_plain(buf, offs, hw, (4, 8, 16, 32), boxes, levels)
    before = roi_align_pyramid_dma.launches
    got = roi_align_pyramid_dma(buf.to(cuda), offs, hw, (4, 8, 16, 32), boxes.to(cuda), levels.to(cuda))
    torch.cuda.synchronize()
    assert roi_align_pyramid_dma.launches == before + 1
    assert got.shape == (batch, n_rois, 7, 7, channels)
    assert (got.cpu() - want).abs().max().item() <= _ROI_TOL
    assert got[:, 3].abs().max().item() == 0.0            # the empty box


@pytest.mark.parametrize("batch,canvas,channels,n_rois,window", [
    (2, (768, 1344), 256, 1000, 32), (1, (768, 1344), 256, 300, 48), (3, (96, 160), 16, 37, 32),
    (2, (160, 224), 40, 64, 32), (2, (96, 160), 21, 37, 32), (1, (96, 160), 264, 20, 48)])
def test_roi_align_bf16_kernel_matches_plain(cuda, batch, canvas, channels, n_rois, window):
    """K5's bfloat16 instantiation (``RCNNConfig.fast()``'s pyramid, window 32
    or the exact 48) against its plain version on the same bfloat16 buffer:
    within _ROI_TOL (the cells widen exactly, the sums are float32 in
    another order), float32 out, one bfloat16 launch a call."""
    gen = torch.Generator().manual_seed(11)
    (buf, offs, hw), boxes, levels = _roi_inputs(gen, batch, canvas, channels, n_rois)
    buf = buf.bfloat16()
    want = roi_align_pyramid_dma_plain(buf, offs, hw, (4, 8, 16, 32), boxes, levels, window=window)
    before = dict(roi_align_pyramid_dma.launches_by_dtype)
    got = roi_align_pyramid_dma(buf.to(cuda), offs, hw, (4, 8, 16, 32), boxes.to(cuda), levels.to(cuda),
                                window=window)
    torch.cuda.synchronize()
    assert roi_align_pyramid_dma.launches_by_dtype == dict(before, bfloat16=before["bfloat16"] + 1)
    assert got.shape == (batch, n_rois, 7, 7, channels) and got.dtype == torch.float32
    assert (got.cpu() - want).abs().max().item() <= _ROI_TOL
    assert got[:, 3].abs().max().item() == 0.0            # the empty box


def _edge_boxes(canvas, batch):
    """Per image: zero-area boxes, boxes wider and taller than any window,
    boxes against the canvas's right and bottom edges and past them, all on
    p2 (where the windows clip most), and a few on p5."""
    H, W = canvas
    boxes = torch.tensor([
        [20.0, 30.0, 20.0, 30.0], [W * 0.3, 10.0, W * 0.3, 50.0], [5.0, H * 0.5, W - 5.0, H * 0.5],
        [0.0, 0.0, W * 1.0, H * 1.0], [10.0, 5.0, W - 1.0, 40.0], [4.0, 4.0, 60.0, H - 2.0],
        [W - 40.0, 10.0, W * 1.0, 70.0], [W - 3.0, H - 9.0, W - 1.0, H - 1.0], [W - 20.0, 20.0, W + 30.0, 36.0],
        [W * 0.5, H - 30.0, W * 0.6, H + 20.0], [-30.0, -20.0, 12.0, 9.0], [W - 8.0, 0.0, W * 1.0, 3.0],
    ])
    levels = torch.zeros(len(boxes), dtype=torch.int32)
    levels[-3:] = 3
    return boxes.expand(batch, -1, -1).contiguous(), levels.expand(batch, -1).contiguous()


# K5 at the edges, both pyramid types: a channel count that is no multiple of
# the 16-byte vector (the scalar tail), zero-area, over-span and right- and
# bottom-edge boxes; two calls bitwise equal (fixed-order sums, no atomics)
@pytest.mark.parametrize("dtype,window", [(torch.float32, 48), (torch.bfloat16, 32), (torch.bfloat16, 48)])
@pytest.mark.parametrize("channels", [256, 13, 21, 40])
def test_roi_align_kernel_edges_and_repeatable(cuda, dtype, window, channels):
    gen = torch.Generator().manual_seed(channels)
    (buf, offs, hw), boxes, levels = _roi_inputs(gen, 2, (160, 288), channels, 24)
    edge, edge_levels = _edge_boxes((160, 288), 2)
    boxes, levels = torch.cat([boxes, edge], 1), torch.cat([levels, edge_levels], 1)
    buf = buf.to(dtype)
    want = roi_align_pyramid_dma_plain(buf, offs, hw, (4, 8, 16, 32), boxes, levels, window=window)
    args = (buf.to(cuda), offs, hw, (4, 8, 16, 32), boxes.to(cuda), levels.to(cuda))
    got = roi_align_pyramid_dma(*args, window=window)
    again = roi_align_pyramid_dma(*args, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max().item() <= _ROI_TOL
    assert torch.equal(got, again)
    assert got[:, 24].abs().max().item() == 0.0 and got[:, 25].abs().max().item() == 0.0   # zero area


def test_roi_align_kernel_refuses(cuda):
    gen = torch.Generator().manual_seed(8)
    (buf, offs, hw), boxes, levels = _roi_inputs(gen, 1, (96, 160), 16, 5)
    buf, boxes, levels = buf.to(cuda), boxes.to(cuda), levels.to(cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        roi_align_pyramid_dma(buf.half(), offs, hw, (4, 8, 16, 32), boxes, levels)
    with pytest.raises(ValueError, match="7 x 7"):
        roi_align_pyramid_dma(buf, offs, hw, (4, 8, 16, 32), boxes, levels, out_size=5)
    with pytest.raises(ValueError, match="one device"):
        roi_align_pyramid_dma(buf, offs, hw, (4, 8, 16, 32), boxes.cpu(), levels)


def test_rcnn_on_card_matches_cpu(cuda):
    """The small R-CNN with seeded weights, K5 pinned on both sides (its
    plain version on the CPU): levels within 1e-4 of the largest, equal
    valid counts and classes, boxes within 5e-3."""
    import dataclasses

    from video_gen_evals_tpu_torch.models.rcnn import FasterRCNN, RCNNConfig, init_rcnn_weights_

    cfg = dataclasses.replace(RCNNConfig.small(), roi_impl="dma")
    cpu = FasterRCNN(cfg).eval()
    init_rcnn_weights_(cpu, torch.Generator().manual_seed(9))
    card = FasterRCNN(cfg).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(10)) * 50
    with torch.inference_mode():
        want_f, got_f = cpu.backbone_features(x), card.backbone_features(x.to(cuda))
        want, before = cpu(x), roi_align_pyramid_dma.launches
        got = card(x.to(cuda))
    torch.cuda.synchronize()
    assert roi_align_pyramid_dma.launches == before + 1
    for g, w in zip(got_f, want_f):
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * max(1.0, w.abs().max().item())
    v = want["valid"]
    assert torch.equal(got["valid"].cpu(), v) and torch.equal(got["classes"].cpu()[v], want["classes"][v])
    if v.any():
        assert (got["boxes"].cpu()[v] - want["boxes"][v]).abs().max().item() <= 5e-3


def test_rcnn_matmul_pool_refused_on_card(cuda):
    """On CUDA tensors the detector pools with K5 or raises: the matmul
    pool is the CPU's."""
    import dataclasses

    from video_gen_evals_tpu_torch.models.rcnn import FasterRCNN, RCNNConfig

    model = FasterRCNN(dataclasses.replace(RCNNConfig.small(), roi_impl="matmul")).eval().to(cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="matmul"):
        model(torch.zeros(1, 64, 96, 3, device=cuda))


def test_activation_diff_harness_on_card(cuda, tmp_path, capsys):
    """The activation-diff harness on the card (its default device) against
    a tiny port ViT's own fp32 CPU activations: every row within 1e-5, and
    K6 launched once a block."""
    import numpy as np

    from video_gen_evals_tpu_torch.models.vit import ViTBackbone, ViTConfig
    from video_gen_evals_tpu_torch.ops import launch_counts
    from video_gen_evals_tpu_torch.pipelines import activation_diff as ad

    over = dict(img_size=[32, 24], patch_size=8, embed_dim=128, depth=3, num_heads=4)
    torch.manual_seed(11)
    ref = ViTBackbone(ViTConfig(**{**over, "img_size": (32, 24)})).eval()
    with torch.no_grad():
        ref.pos_embed.normal_(std=0.02)
    x = np.random.default_rng(11).normal(size=(2, 32, 24, 3)).astype(np.float32)
    acts = ad.torch_module_activations(ref, torch.from_numpy(x))
    sd = {k: v.numpy() for k, v in ref.state_dict().items()}
    rows = ad.run_diff("vit", sd, x, acts, over)
    assert [r.status for r in rows] == ["ok"] * (over["depth"] + 2)
    assert max(r.max_abs for r in rows) <= 1e-5, [(r.torch_name, r.max_abs) for r in rows]
    np.savez(tmp_path / "sd.npz", **sd)
    np.save(tmp_path / "x.npy", x)
    np.savez(tmp_path / "acts.npz", **acts)
    before = launch_counts()["mha_core"]
    rc = ad.main(["--network", "vit", "--state-dict", str(tmp_path / "sd.npz"), "--input", str(tmp_path / "x.npy"),
                  "--acts", str(tmp_path / "acts.npz"), "--tol", "1e-5", "--config-json", json.dumps(over)])
    torch.cuda.synchronize()
    assert rc == 0, capsys.readouterr().out
    assert launch_counts()["mha_core"] - before == over["depth"]
