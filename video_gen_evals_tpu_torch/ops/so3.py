"""SO(3) geometry: Rodrigues, the log map, per-frame relative rotations of
rotation matrices and of axis-angle poses, and the 6D representation.

Port of ``video_gen_evals_tpu/ops/so3.py`` (ref ``utils.py:112-174``). The
clamping constants match the reference, so the log map stays finite at the
identity: the trace clamp keeps ``theta`` off zero and the ``2 sin(theta)``
floor keeps the division bounded, while the skew part is exactly zero there.
"""

from __future__ import annotations

import torch

_THETA_MIN = 1e-8      # ref utils.py:116 clamp_min on |axis-angle|
_TRACE_EPS = 1e-6      # ref utils.py:132 trace clamp margin
_SIN_MIN = 1e-6        # ref utils.py:134 clamp_min on 2*sin(theta)


def axis_angle_to_matrix(a: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle ``[..., 3]`` -> rotation matrix ``[..., 3, 3]``."""
    theta = torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(_THETA_MIN)
    kx, ky, kz = (a / theta).unbind(-1)
    zero = torch.zeros_like(kx)
    # K is the cross-product (skew) matrix of the unit axis
    K = torch.stack([
        torch.stack([zero, -kz, ky], dim=-1),
        torch.stack([kz, zero, -kx], dim=-1),
        torch.stack([-ky, kx, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(a.shape[:-1] + (3, 3))
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    return eye + s * K + (1.0 - c) * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` -> axis-angle ``[..., 3]``."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    tr = tr.clamp(-1.0 + _TRACE_EPS, 3.0 - _TRACE_EPS)
    theta = torch.arccos((tr - 1.0) / 2.0)
    denom = (2.0 * torch.sin(theta)).clamp_min(_SIN_MIN)[..., None]
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    ) / denom
    return theta[..., None] * v


def rotmat_delta(R: torch.Tensor) -> torch.Tensor:
    """``log(R_{t-1}^T R_t)`` per frame; frame 0 pairs with itself.

    ``R``: ``[T, J, 3, 3]`` or ``[T, 3, 3]`` (time leading). Returns the same
    leading dims with a trailing 3.
    """
    R_prev = torch.cat([R[:1], R[:-1]], dim=0)
    R_rel = R_prev.transpose(-1, -2) @ R
    return log_so3(R_rel)


def axis_angle_delta(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle pose ``[T, 3J]`` -> per-joint ``log(R_{t-1}^T R_t)``
    ``[T, 3J]``; frame 0 pairs with itself (ref ``utils.py:149-159``)."""
    Tlen, D = aa.shape
    return rotmat_delta(axis_angle_to_matrix(aa.reshape(Tlen, D // 3, 3))).reshape(Tlen, D)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> rotation matrix (Zhou et al.), as used by
    TokenHMR's decoder head (ref ``modifications/token_head.py:227-231``).

    ``x``: ``[..., 6]`` (two 3-vectors, column convention) -> ``[..., 3, 3]``.
    Columns: b1 = norm(a1); b2 = norm(a2 - (b1.a2) b1); b3 = b1 x b2.
    """
    a1, a2 = x[..., 0:3], x[..., 3:6]
    eps = 1e-12
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(eps)
    a2p = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2p / torch.linalg.norm(a2p, dim=-1, keepdim=True).clamp_min(eps)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)
