"""Window gather of the scoring path (K1), and its 8-row sub-block form (K2),
CUDA kernels for Hopper.

:func:`gather_windows` (K1) replaces
``video_gen_evals_tpu/ops/window_kernel.py::pallas_gather_windows_burst``. It
gives ``::pallas_gather_windows``' output only where a window's base row
``offsets[v] + start`` (start clipped) is a multiple of 8: that kernel floors
the base to an 8-row block, and K1 does not. :func:`gather_windows_subblock`
(K2) is the port of ``::pallas_gather_windows`` with that floor. Kernel
source: ``csrc/window_gather.cu``.

Window ``b`` of video ``v = video_idx[b]`` is the contiguous row run
``bank[base : base + clip_len]`` of the sentinel-padded bank
(``data/features.py``), with ``base = offsets[v] + clip(start, 0,
max(rows_v - clip_len, 0))`` kept inside the bank; row 0's diff block
``[one_pass_raw, one_pass_raw + len(z0_diff))`` is then overwritten with
``z0_diff``. This is the sliced/burst clip (JAX ``window_kernel.py:159-161``,
``features.py:492-497``), which the scoring path runs; the ``take`` form
differs from it only for negative starts, which the enumerator never makes.

Bound on the H100: bytes — a batched copy of ``2 * B * clip_len * D * 4``
bytes read and written (340 MB at B = 512, D = 2596). Design: one block per
window streams its run with 16-byte loads where alignment allows (any start
when D % 4 == 0), then writes ``z0_diff`` behind a block barrier. Offsets and starts are
arbitrary and D keeps its true width: the TPU's 8-row, 128-lane contract
does not carry over.

K2 (:func:`gather_windows_subblock`) reads window ``b`` as ``clip_len / 8``
sub-blocks of 8 rows from ``base = ((offsets[v] + start) // 8) * 8``, start
clipped as above, each sub-block's first row kept inside the bank
(``clip(base + 8 j, 0, N - 8)``), then writes ``z0_diff`` to row 0; it needs
``clip_len % 8 == 0``, as in JAX. For a clipped start that is not a multiple
of 8 (a video of 37 rows, clip 32, start 8 clips to 5) it reads from the
aligned row below, where K1 reads from the start. The TPU's 128-lane padding
of the bank is not needed; ``out_dim`` slices the feature dim as in JAX.
Bound: bytes, as K1. Design: one block per (window, sub-block), 16-byte
copies, the ``z0_diff`` write behind a barrier in the block of sub-block 0.
No pipeline calls K2, as in the JAX package.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(:func:`gather_windows_plain`, :func:`gather_windows_subblock_plain`) for CPU
tensors; ``gather_windows.launches`` and ``gather_windows_subblock.launches``
count kernel launches.
"""

from __future__ import annotations

import typing as T

import torch

from .cuda_lib import check, load_library, stream_handle


def gather_windows_plain(
    bank: torch.Tensor,       # [N, D] float32
    offsets: torch.Tensor,    # [V] int32
    row_limit: torch.Tensor,  # [V] int32, last row of each video's bank
    z0_diff: torch.Tensor,    # [D_diff] float32
    one_pass_raw: int,
    video_idx: torch.Tensor,  # [B] int32
    starts: torch.Tensor,     # [B] int32
    clip_len: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``[B, clip_len, D]``."""
    n_rows = bank.shape[0]
    v = video_idx.long().clamp(0, offsets.shape[0] - 1)
    rows_v = row_limit[v].long() + 1
    start = torch.minimum(starts.long().clamp_min(0), (rows_v - clip_len).clamp_min(0))
    base = (offsets[v].long() + start).clamp(0, n_rows - clip_len)
    rows = base[:, None] + torch.arange(clip_len, device=bank.device)[None, :]
    out = bank[rows]
    out[:, 0, one_pass_raw : one_pass_raw + z0_diff.shape[0]] = z0_diff
    return out


def _validate(bank, offsets, row_limit, z0_diff, one_pass_raw, video_idx,
              starts, clip_len) -> None:
    if bank.ndim != 2 or bank.dtype != torch.float32:
        raise ValueError(f"bank must be [N, D] float32, got {tuple(bank.shape)} {bank.dtype}")
    for name, t in (("offsets", offsets), ("row_limit", row_limit),
                    ("video_idx", video_idx), ("starts", starts)):
        if t.dtype != torch.int32:
            # int64 indices are refused rather than truncated
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.ndim != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    if z0_diff.dtype != torch.float32 or z0_diff.ndim != 1:
        raise ValueError("z0_diff must be a 1-D float32 vector")
    if offsets.shape != row_limit.shape or offsets.shape[0] == 0:
        raise ValueError("offsets and row_limit must be the same non-empty [V]")
    if video_idx.shape != starts.shape:
        raise ValueError("video_idx and starts must both be [B]")
    if not 0 < clip_len <= bank.shape[0]:
        raise ValueError(f"clip_len {clip_len} must be in [1, {bank.shape[0]}]")
    if not 0 <= one_pass_raw <= bank.shape[1] - z0_diff.shape[0]:
        raise ValueError("the diff block [one_pass_raw, +len(z0_diff)) must lie inside D")
    devices = {t.device for t in (bank, offsets, row_limit, z0_diff, video_idx, starts)}
    if len(devices) != 1:
        raise ValueError(f"all arguments must be on one device, got {devices}")


def gather_windows(
    bank: torch.Tensor,
    offsets: torch.Tensor,
    row_limit: torch.Tensor,
    z0_diff: torch.Tensor,
    one_pass_raw: int,
    video_idx: torch.Tensor,
    starts: torch.Tensor,
    clip_len: int,
) -> torch.Tensor:
    """Assemble ``[B, clip_len, D]`` windows (signature of the JAX gathers)."""
    _validate(bank, offsets, row_limit, z0_diff, one_pass_raw, video_idx,
              starts, clip_len)
    if bank.device.type == "cpu":
        return gather_windows_plain(bank, offsets, row_limit, z0_diff,
                                    one_pass_raw, video_idx, starts, clip_len)
    if bank.device.type != "cuda":
        raise ValueError(f"gather_windows runs on CUDA or CPU tensors, not {bank.device}")
    bank, offsets, row_limit, z0_diff, video_idx, starts = (
        t.contiguous() for t in (bank, offsets, row_limit, z0_diff, video_idx, starts)
    )
    B = video_idx.shape[0]
    n_rows, d = bank.shape
    out = torch.empty((B, clip_len, d), dtype=torch.float32, device=bank.device)
    lib = load_library().lib
    code = lib.vge_gather_windows(
        bank.device.index, bank.data_ptr(), n_rows, d, offsets.data_ptr(),
        row_limit.data_ptr(), offsets.shape[0], z0_diff.data_ptr(),
        one_pass_raw, z0_diff.shape[0], video_idx.data_ptr(), starts.data_ptr(),
        B, clip_len, out.data_ptr(), stream_handle(bank.device),
    )
    check(code, "gather_windows launch")
    gather_windows.launches += 1
    return out


gather_windows.launches = 0


_ALIGN = 8   # rows a sub-block of K2


def gather_windows_subblock_plain(
    bank: torch.Tensor,       # [N, D] float32
    offsets: torch.Tensor,    # [V] int32
    row_limit: torch.Tensor,  # [V] int32
    z0_diff: torch.Tensor,    # [D_diff] float32
    one_pass_raw: int,
    video_idx: torch.Tensor,  # [B] int32
    starts: torch.Tensor,     # [B] int32
    clip_len: int,
    out_dim: T.Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2: ``[B, clip_len, out_dim or D]``."""
    n_rows = bank.shape[0]
    out_dim = bank.shape[1] if out_dim is None else out_dim
    v = video_idx.long().clamp(0, offsets.shape[0] - 1)
    rows_v = row_limit[v].long() + 1
    start = torch.minimum(starts.long().clamp_min(0), (rows_v - clip_len).clamp_min(0))
    base = (offsets[v].long() + start) // _ALIGN * _ALIGN
    sub = base[:, None] + _ALIGN * torch.arange(clip_len // _ALIGN, device=bank.device)[None, :]
    sub = sub.clamp(0, n_rows - _ALIGN)
    rows = (sub[:, :, None] + torch.arange(_ALIGN, device=bank.device)).reshape(-1, clip_len)
    out = bank[rows, :out_dim]
    out[:, 0, one_pass_raw : one_pass_raw + z0_diff.shape[0]] = z0_diff
    return out


def gather_windows_subblock(
    bank: torch.Tensor,
    offsets: torch.Tensor,
    row_limit: torch.Tensor,
    z0_diff: torch.Tensor,
    one_pass_raw: int,
    video_idx: torch.Tensor,
    starts: torch.Tensor,
    clip_len: int,
    out_dim: T.Optional[int] = None,
) -> torch.Tensor:
    """K2: windows from 8-row sub-blocks, the base floored to 8 rows
    (signature of the JAX ``pallas_gather_windows``)."""
    if clip_len % _ALIGN != 0:
        raise ValueError(f"clip_len {clip_len} must be a multiple of {_ALIGN}")
    _validate(bank, offsets, row_limit, z0_diff, one_pass_raw, video_idx, starts, clip_len)
    d = bank.shape[1]
    out_dim = d if out_dim is None else int(out_dim)
    if not 0 < out_dim <= d:
        raise ValueError(f"out_dim {out_dim} must be in [1, {d}]")
    if one_pass_raw + z0_diff.shape[0] > out_dim:
        raise ValueError("the diff block [one_pass_raw, +len(z0_diff)) must lie inside out_dim")
    if bank.device.type == "cpu":
        return gather_windows_subblock_plain(bank, offsets, row_limit, z0_diff, one_pass_raw,
                                             video_idx, starts, clip_len, out_dim)
    if bank.device.type != "cuda":
        raise ValueError(f"gather_windows_subblock runs on CUDA or CPU tensors, not {bank.device}")
    bank, offsets, row_limit, z0_diff, video_idx, starts = (
        t.contiguous() for t in (bank, offsets, row_limit, z0_diff, video_idx, starts)
    )
    B = video_idx.shape[0]
    out = torch.empty((B, clip_len, out_dim), dtype=torch.float32, device=bank.device)
    lib = load_library().lib
    code = lib.vge_gather_windows_subblock(
        bank.device.index, bank.data_ptr(), bank.shape[0], d, out_dim, offsets.data_ptr(),
        row_limit.data_ptr(), offsets.shape[0], z0_diff.data_ptr(), one_pass_raw,
        z0_diff.shape[0], video_idx.data_ptr(), starts.data_ptr(), B, clip_len,
        out.data_ptr(), stream_handle(bank.device),
    )
    check(code, "gather_windows_subblock launch")
    gather_windows_subblock.launches += 1
    return out


gather_windows_subblock.launches = 0
