"""Host-side preparation of the tensor-core conv kernels (K3 and K10 at
"high", K4's forward and backward at "default") and of the FMA conv kernels
(K3 and K4's forward and backward at "highest"), on the CPU: the bf16 weight planes the
tensor-core kernels read, held bitwise against split_bf16 and _round, and the
launch plans (windows a block, shared memory, partial rows, row ranges), which
cover every batch, fit Hopper's shared memory and depend on the shape alone."""

import math

import pytest
import torch

from video_gen_evals_tpu_torch.ops.conv_kernel import (
    SMEM_LIMIT,
    TcPlan,
    fma_plan,
    high_weight_planes,
    split_bf16,
    tc_plan,
)
from video_gen_evals_tpu_torch.ops.conv_kernel_train import _round, _transposed, train_weight_planes

_T = (8, 16, 32)
_C = (64, 128, 256)
_BATCHES = (1, 5, 37, 255, 256, 512, 513, 768, 960)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, channels, lead=()):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(*lead, 5, channels, channels, generator=gen) / math.sqrt(5 * channels)
                 for _ in range(2))


# lead (): K3's two convs; (S,): K10's S stages, each stage's planes K3's
@pytest.mark.parametrize("lead", [(), (2,), (4,)])
@pytest.mark.parametrize("channels", _C)
def test_high_weight_planes_are_split_bf16(channels, lead):
    w1, w2 = _weights(channels, channels, lead)
    planes = high_weight_planes(w1, w2)
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    assert tuple(planes.shape) == lead + (2, 2, 5, channels, channels)
    stages = [(planes, w1, w2)] if not lead else list(zip(planes, w1, w2))
    for stage_planes, sw1, sw2 in stages:
        for conv, w in enumerate((sw1, sw2)):
            hi, lo = split_bf16(w)
            assert torch.equal(stage_planes[conv, 0], hi)
            assert torch.equal(stage_planes[conv, 1], lo)


# convs 2: the forward's w1, w2; 4: the backward window kernel's w1, w2, w2t, w1t
@pytest.mark.parametrize("convs", [2, 4])
@pytest.mark.parametrize("channels", _C)
def test_train_weight_planes_are_rounded_and_transposed(channels, convs):
    w1, w2 = _weights(channels + 1, channels)
    planes = train_weight_planes(w1, w2, convs)
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    assert tuple(planes.shape) == (convs, 5, channels, channels)
    want = (w1, w2, _transposed(w2), _transposed(w1))[:convs]
    for got, w in zip(planes, want):
        assert torch.equal(got.float(), _round(w, "default"))
    if convs == 4:
        # the transposed planes are the rounded weights transposed: rounding
        # and transposing commute
        assert torch.equal(planes[2].float(), _transposed(_round(w2, "default")))
        assert torch.equal(planes[3].float(), _transposed(_round(w1, "default")))


@pytest.mark.parametrize("kind", ["block_high", "train_fwd", "train_bwd"])
@pytest.mark.parametrize("channels", _C)
@pytest.mark.parametrize("t_len", _T)
def test_tc_plan_covers_every_batch_and_fits(t_len, channels, kind):
    for batch in _BATCHES:
        plan = tc_plan(t_len, channels, batch, kind)
        W = plan.windows_per_block
        assert W * t_len == 128, plan                       # a block owns whole windows, 128 rows
        assert plan.blocks * W >= batch > (plan.blocks - 1) * W, (batch, plan)
        assert 0 < plan.smem_bytes <= SMEM_LIMIT, plan
        if kind != "train_bwd":
            assert (plan.slabs, plan.splits, plan.grad_smem_bytes) == (0, 0, 0)
            continue
        assert t_len % plan.slabs == 0 and plan.slabs >= 1, plan
        assert 0 < plan.grad_smem_bytes <= SMEM_LIMIT, plan
        rows = batch * t_len
        assert 1 <= plan.splits <= 16, plan
        rows_per_split = math.ceil(math.ceil(rows / plan.splits) / 64) * 64   # as the C side rounds
        assert plan.splits * rows_per_split >= rows, plan   # the row ranges cover every row
        assert (plan.splits - 1) * rows_per_split < rows, plan   # and none is empty past the end


@pytest.mark.parametrize("kind", ["block_high", "train_fwd", "train_bwd"])
def test_tc_plan_depends_on_the_shape_alone(kind, monkeypatch):
    """Same shape, same plan, and the plan never asks the device."""
    want = {(t, c, b): tc_plan(t, c, b, kind) for t in _T for c in _C for b in _BATCHES}

    def no_device(*_a, **_k):
        raise AssertionError("tc_plan asked the device")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    for (t, c, b), plan in want.items():
        assert tc_plan(t, c, b, kind) == plan


@pytest.mark.parametrize("t_len,channels,batch,kind,want", [
    # the main paths' shapes: the scoring batch (K3, K10) and the training
    # step (K4 forward and backward)
    (32, 256, 512, "block_high", TcPlan(4, 128, 220_736)),
    (32, 256, 256, "block_high", TcPlan(4, 64, 220_736)),
    (32, 128, 513, "block_high", TcPlan(4, 129, 113_728)),
    (32, 256, 960, "train_fwd", TcPlan(4, 240, 203_312)),
    (8, 64, 37, "train_fwd", TcPlan(16, 3, 55_472)),
    (32, 256, 960, "train_bwd", TcPlan(4, 240, 203_312, slabs=1, splits=15, grad_smem_bytes=104_448)),
    (16, 64, 5, "train_bwd", TcPlan(8, 1, 55_472, slabs=2, splits=1, grad_smem_bytes=55_296)),
    (32, 64, 37, "train_bwd", TcPlan(4, 10, 55_472, slabs=4, splits=1, grad_smem_bytes=55_296)),
    (8, 256, 37, "train_bwd", TcPlan(16, 3, 203_312, slabs=1, splits=1, grad_smem_bytes=104_448)),
])
def test_tc_plan_at_known_shapes(t_len, channels, batch, kind, want):
    """The plan the kernels' own geometry gives (csrc/conv_tile.cuh TcConv:
    planes of 129 rows of C + 8 bf16 (hi and lo at "high"), a weight ring of 5
    stages of 16 input channels ("high") or 4 of 64 ("default"), a float for
    each of 8 warps; TcEpi: 8T / C threads of a window share a channel)."""
    assert tc_plan(t_len, channels, batch, kind) == want


@pytest.mark.parametrize("args", [(12, 64, 4, "block_high"), (32, 96, 4, "train_bwd"),
                                  (32, 64, 0, "block_high"), (32, 64, 4, "high")])
def test_tc_plan_refuses_unbuilt_shapes(args):
    with pytest.raises(ValueError):
        tc_plan(*args)


@pytest.mark.parametrize("kind", ["block", "train_fwd", "train_bwd"])
@pytest.mark.parametrize("channels", _C)
@pytest.mark.parametrize("t_len", _T)
def test_fma_plan_covers_every_batch_and_fits(t_len, channels, kind):
    for batch in _BATCHES:
        plan = fma_plan(t_len, channels, batch, kind)
        W = plan.windows_per_block
        assert W * t_len == 128, plan                       # a block owns whole windows, 128 rows
        assert plan.blocks * W >= batch > (plan.blocks - 1) * W, (batch, plan)
        assert 0 < plan.smem_bytes <= SMEM_LIMIT, plan
        if kind != "train_bwd":
            assert (plan.slabs, plan.splits, plan.grad_smem_bytes) == (0, 0, 0)
            continue
        assert plan.slabs == 0, plan   # one dgamma and dbeta partial row a window, always
        assert 0 < plan.grad_smem_bytes <= SMEM_LIMIT // 2, plan   # two weight-gradient blocks an SM
        assert 1 <= plan.splits <= 16, plan
        # each tap's rows whose shifted row stays inside the window, B * (T - |o|),
        # cut into `splits` ranges as the C side cuts them: every row in one range
        for dilation in (1, 2, 4, 8):
            for j in range(5):
                span = t_len - abs((j - 2) * dilation)
                if span <= 0:
                    continue
                total = batch * span
                per = -(-total // plan.splits)
                ranges = [(min(total, s * per), min(total, s * per + per)) for s in range(plan.splits)]
                assert ranges[0][0] == 0 and ranges[-1][1] == total, (plan, dilation, j)
                assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), (plan, dilation, j)


@pytest.mark.parametrize("kind", ["block", "train_fwd", "train_bwd"])
def test_fma_plan_depends_on_the_shape_alone(kind, monkeypatch):
    """Same shape, same plan, and the plan never asks the device."""
    want = {(t, c, b): fma_plan(t, c, b, kind) for t in _T for c in _C for b in _BATCHES}

    def no_device(*_a, **_k):
        raise AssertionError("fma_plan asked the device")

    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    for (t, c, b), plan in want.items():
        assert fma_plan(t, c, b, kind) == plan


@pytest.mark.parametrize("t_len,channels,batch,kind,want", [
    # the main paths' shapes: the scoring batch (K3) and the training step
    # (K4's forward and backward); K4's forward is K3's kernel, so its plan
    (32, 256, 512, "block", TcPlan(4, 128, 198_192)),
    (32, 256, 960, "train_fwd", TcPlan(4, 240, 198_192)),
    (8, 64, 37, "train_fwd", TcPlan(16, 3, 49_968)),
    (16, 128, 961, "train_fwd", TcPlan(8, 121, 99_376)),
    (32, 256, 256, "block", TcPlan(4, 64, 198_192)),
    (32, 128, 513, "block", TcPlan(4, 129, 99_376)),
    (8, 64, 37, "block", TcPlan(16, 3, 49_968)),
    (32, 256, 960, "train_bwd", TcPlan(4, 240, 198_192, splits=13, grad_smem_bytes=98_304)),
    (16, 64, 5, "train_bwd", TcPlan(8, 1, 49_968, splits=1, grad_smem_bytes=49_152)),
    (8, 256, 37, "train_bwd", TcPlan(16, 3, 198_192, splits=1, grad_smem_bytes=98_304)),
    (32, 128, 5000, "train_bwd", TcPlan(4, 1250, 99_376, splits=16, grad_smem_bytes=98_304)),
])
def test_fma_plan_at_known_shapes(t_len, channels, batch, kind, want):
    """The plan the FMA body's own geometry gives (csrc/conv_tile.cuh FmaConv:
    the input tile, 129 rows of C + 1 floats to 16 bytes; a weight ring of 4 stages of 16
    input channels of C floats; a float for each of 8 warps; GradFma: 3 stages
    of 32 rows of a and g, 128 wide (64 at C = 64))."""
    assert fma_plan(t_len, channels, batch, kind) == want


@pytest.mark.parametrize("args", [(12, 64, 4, "block"), (32, 96, 4, "train_bwd"),
                                  (32, 64, 0, "block"), (32, 64, 4, "highest"),
                                  (32, 64, 4, "block_high"), (24, 256, 960, "train_fwd"),
                                  (32, 256, 0, "train_fwd")])
def test_fma_plan_refuses_unbuilt_shapes(args):
    with pytest.raises(ValueError):
        fma_plan(*args)
