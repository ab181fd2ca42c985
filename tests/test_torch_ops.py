"""The port's ops (``video_gen_evals_tpu_torch.ops``) against the JAX package
on the CPU: the geometry deltas, and the plain versions of the two Hopper
kernels — K1 (window gather) and K3 (fused conv stage) — against the JAX
Pallas kernels run in interpret mode. Inputs are made with numpy from a seed
and handed to both; each test states its tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_gen_evals_tpu.data.features import gather_windows_sliced as jax_gather_sliced
from video_gen_evals_tpu.ops import deltas as jax_deltas
from video_gen_evals_tpu.ops import procrustes as jax_procrustes
from video_gen_evals_tpu.ops import so3 as jax_so3
from video_gen_evals_tpu.ops.conv_kernel import fused_temporal_block as jax_block
from video_gen_evals_tpu.ops.conv_kernel import split_bf16 as jax_split_bf16
from video_gen_evals_tpu.ops.window_kernel import pad_bank_lanes, pallas_gather_windows_burst
from video_gen_evals_tpu.data.fixtures import _random_rotmats

from video_gen_evals_tpu_torch.ops import deltas, procrustes, so3
from video_gen_evals_tpu_torch.ops.conv_kernel import (
    fused_temporal_block,
    fused_temporal_block_plain,
    split_bf16,
)
from video_gen_evals_tpu_torch.ops.window_kernel import gather_windows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for the whole module, module fixtures included:
    the suite runs in several workers, and torch's default threads in each
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near_identity_rotmats(rng, T):
    """Consecutive frames that differ by angles from 1e-3 down to exactly 0."""
    angles = np.array([0.0, 1e-3, 1e-5, 1e-7, 0.0, 1e-4] * T)[:T]
    axis = rng.normal(size=(T, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    a = np.cumsum(angles[:, None] * axis, axis=0)[:, None, :]   # [T, 1, 3]
    return np.asarray(jax_so3.axis_angle_to_matrix(jnp.asarray(a.astype(np.float32))))


def _axis_angles(rng, T, J, angles):
    """``[T, 3J]`` axis-angle vectors: random unit axes scaled by ``angles``."""
    axis = rng.normal(size=(T, J, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * np.resize(angles, (T, J))[..., None]).reshape(T, 3 * J).astype(np.float32)


def _axis_angle_motion(rng, T, start, step=0.05):
    """A pose sequence ``[T, 3J]`` from the axis-angles ``start [1, 3J]``, each
    frame moving every component by up to ``step`` rad, as a 30 fps SMPL pose
    does. The log map's error grows as 1 / sin(theta) of the frame-to-frame
    turn, so consecutive frames turning by nearly pi would hold both packages
    only to their float32 rounding over sin(theta): real motion turns a joint
    by far less between frames."""
    return (start + np.cumsum(rng.uniform(-step, step, size=(T, start.shape[1])), axis=0)
            ).astype(np.float32)


def _axis_angle_pose_near_zero_and_pi(rng, T=30):
    """Joints turned by pi, just under and just over it (a global orientation
    often is), moving across pi; a joint at exact zero and under the 1e-8
    clamp in every frame, and one moving by 1e-6 rad a frame."""
    near_pi = _axis_angle_motion(
        rng, T, _axis_angles(rng, 1, 3, [np.pi, np.pi - 1e-4, np.pi + 1e-3]))
    tiny = np.zeros((T, 9), np.float32)
    tiny[1::2, 0:3] = 1e-9
    tiny[:, 3:6] = _axis_angle_motion(rng, T, np.zeros((1, 3)), step=1e-6)
    tiny[:, 6:9] = 0.0
    return np.concatenate([near_pi, tiny], axis=1)


def _reflected_keypoints(rng, T, K=60):
    """Alternate frames mirrored in x, so det(H) < 0 for every pair."""
    kp = rng.uniform(0.2, 0.8, size=(T, K, 2)).astype(np.float32)
    kp[1::2, :, 0] = 1.0 - kp[1::2, :, 0]
    return kp.reshape(T, 2 * K)


GEOMETRY_CASES = {
    "vit_delta": lambda rng: (
        jax_deltas.vit_delta, deltas.vit_delta,
        rng.normal(size=(40, 64)).astype(np.float32)),
    "betas_delta": lambda rng: (
        jax_deltas.betas_delta, deltas.betas_delta,
        rng.normal(size=(40, 10)).astype(np.float32)),
    "rotmat_delta": lambda rng: (
        jax_so3.rotmat_delta, so3.rotmat_delta, _random_rotmats(rng, (40, 23))),
    "rotmat_delta_near_identity": lambda rng: (
        jax_so3.rotmat_delta, so3.rotmat_delta, _near_identity_rotmats(rng, 30)),
    "axis_angle_to_matrix": lambda rng: (
        jax_so3.axis_angle_to_matrix, so3.axis_angle_to_matrix,
        _axis_angles(rng, 40, 1, [0.0, 1e-9, 1e-6, 1e-3, 0.5, 2.0, np.pi - 1e-4, np.pi, np.pi + 1e-3, 5.0]
                     ).reshape(40, 3)),
    "axis_angle_delta": lambda rng: (
        jax_so3.axis_angle_delta, so3.axis_angle_delta,
        _axis_angle_motion(rng, 40, _axis_angles(rng, 1, 23, rng.uniform(0.0, np.pi, size=23)))),
    "axis_angle_delta_near_zero_and_pi": lambda rng: (
        jax_so3.axis_angle_delta, so3.axis_angle_delta, _axis_angle_pose_near_zero_and_pi(rng)),
    "procrustes_kp_delta": lambda rng: (
        jax_procrustes.procrustes_kp_delta, procrustes.procrustes_kp_delta,
        (rng.uniform(0.2, 0.8, size=(1, 120))
         + np.cumsum(rng.normal(scale=0.01, size=(40, 120)), axis=0)).astype(np.float32)),
    "procrustes_kp_delta_det_negative": lambda rng: (
        jax_procrustes.procrustes_kp_delta, procrustes.procrustes_kp_delta,
        _reflected_keypoints(rng, 20)),
    "kabsch_rotation_2d": lambda rng: (
        jax_procrustes.kabsch_rotation_2d, procrustes.kabsch_rotation_2d,
        rng.normal(size=(500, 2, 2)).astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_matches_jax(rng, case):
    """atol 1e-5: float32 elementwise math, different libm and reductions."""
    jax_fn, torch_fn, x = GEOMETRY_CASES[case](rng)
    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x)))
    got = torch_fn(torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=1e-5)


# --- K1: window gather -------------------------------------------------------

_ROWS = (48, 16, 40)   # per-video bank rows (8-aligned, as the bank builder makes them)
_D, _OPR, _CLIP = 40, 24, 16


def _gather_args(rng, video_idx, starts):
    offsets = np.cumsum((0,) + _ROWS[:-1]).astype(np.int32)
    row_limit = (np.array(_ROWS) - 1).astype(np.int32)
    bank = rng.normal(size=(sum(_ROWS), _D)).astype(np.float32)
    z0 = rng.normal(size=(_D - _OPR,)).astype(np.float32)
    return (bank, offsets, row_limit, z0, _OPR,
            np.asarray(video_idx, np.int32), np.asarray(starts, np.int32), _CLIP)


_ENUMERATED = ([0, 0, 0, 0, 1, 2, 2, 2], [0, 8, 16, 24, 0, 0, 8, 16])
_CLIPPED = ([0, 0, 1, 1, 2, 2, 0, 2], [-5, 100, -1, 3, 23, 1000, 31, -64])


@pytest.mark.parametrize("starts_kind", ["enumerated", "clipped"])
def test_gather_plain_matches_jax_burst_and_sliced(rng, starts_kind):
    """Exactly equal: a gather copies values."""
    vi, st = _ENUMERATED if starts_kind == "enumerated" else _CLIPPED
    args = _gather_args(rng, vi, st)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    burst = np.asarray(pallas_gather_windows_burst(
        pad_bank_lanes(jargs[0]), *jargs[1:], out_dim=_D, interpret=True))
    sliced = np.asarray(jax_gather_sliced(*jargs))
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    got = gather_windows(*targs).numpy()
    assert got.shape == (len(vi), _CLIP, _D)
    np.testing.assert_array_equal(got, burst)
    np.testing.assert_array_equal(got, sliced)


def test_gather_refuses_int64_indices(rng):
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in _gather_args(rng, *_ENUMERATED)]
    args[5] = args[5].long()
    with pytest.raises(TypeError, match="int32"):
        gather_windows(*args)


# --- K3: fused conv stage ----------------------------------------------------


def _block_inputs(rng, B=4, T=16, C=32):
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w1, w2 = ((rng.normal(size=(5, C, C)) / np.sqrt(5 * C)).astype(np.float32) for _ in range(2))
    gs = (1.0 + 0.1 * rng.normal(size=(C,))).astype(np.float32)
    gb = (0.1 * rng.normal(size=(C,))).astype(np.float32)
    return x, w1, w2, gs, gb


@pytest.mark.parametrize("dilation", [1, 8])
@pytest.mark.parametrize(
    "precision,variant,atol",
    [("highest", "slice", 2e-5), ("high", "mm_first", 1e-4)],
)
def test_block_plain_matches_jax_kernel(rng, dilation, precision, variant, atol):
    """B=4, T=16, C=32; at d=8 the outer taps (offset 16 = T) fall outside
    the window and must contribute zero. atol: 2e-5 for fp32 (sum order),
    1e-4 for bf16x3 (JAX's kernel and the plain version split alike but sum
    in another order)."""
    x, w1, w2, gs, gb = _block_inputs(rng)
    want = np.asarray(jax_block(
        *(jnp.asarray(a) for a in (x, w1, w2, gs, gb)), dilation=dilation,
        block_windows=4, precision=precision, variant=variant, interpret=True))
    got = fused_temporal_block(
        *(torch.from_numpy(a) for a in (x, w1, w2, gs, gb)), dilation, precision).numpy()
    np.testing.assert_allclose(got, want, atol=atol)


def test_split_bf16_matches_jax(rng):
    """Exactly equal: both round to nearest even."""
    w = rng.normal(size=(5, 32, 32)).astype(np.float32)
    want_hi, want_lo = (np.asarray(p.astype(jnp.float32)) for p in jax_split_bf16(jnp.asarray(w)))
    hi, lo = (p.float().numpy() for p in split_bf16(torch.from_numpy(w)))
    np.testing.assert_array_equal(hi, want_hi)
    np.testing.assert_array_equal(lo, want_lo)


def test_block_rejects_unknown_precision_and_shapes(rng):
    x, w1, w2, gs, gb = (torch.from_numpy(a) for a in _block_inputs(rng))
    with pytest.raises(ValueError, match="precision"):
        fused_temporal_block(x, w1, w2, gs, gb, 1, "tf32")
    with pytest.raises(ValueError, match="w1"):
        fused_temporal_block(x, w1[:3], w2, gs, gb, 1, "high")
    # the wrapper's CPU route is the plain version itself
    np.testing.assert_array_equal(
        fused_temporal_block(x, w1, w2, gs, gb, 2, "high").numpy(),
        fused_temporal_block_plain(x, w1, w2, gs, gb, 2, "high").numpy(),
    )
