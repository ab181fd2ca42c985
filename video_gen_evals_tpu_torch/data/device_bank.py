"""Device-resident feature-bank assembly.

Port of ``video_gen_evals_tpu/data/device_bank.py``. The host builder
(``features.assemble_video_bank`` + ``finalize_feature_bank``) runs the
diffs, z-score, sentinel padding and concat per video in numpy, so every
extraction output crosses to the host and the finished bank crosses back.
This module keeps the whole assembly on the device the extractor ran on,
over per-modality *streams* (every video's rows concatenated):

1. diffs over the stream: every delta op is consecutive-frame-local
   (``ops/deltas.py``, ``ops/so3.py::rotmat_delta``,
   ``ops/procrustes.py::procrustes_kp_delta``), so the only cross-video
   value is the row at each video's start, which the per-video ops define
   as 0; one start-row mask restores the per-video result;
2. z-score with the train stats;
3. sentinel padding and concat by one precomputed row index a modality:
   bank row t of video v reads stream row ``off_m[v] + min(t, L_m - 1)``,
   and diff rows at ``t >= L_m`` take the normalized-zero vector, the
   slice-or-pad rule the host builder bakes in (ref ``utils.py:366-514``).

Gather, normalize and concat are plain torch indexing and arithmetic, as
JAX computes them in XLA outside any Pallas kernel. The ``FeatureBank`` it
returns holds the bank as a device tensor, which ``WindowEncoder.upload``
takes without a host copy.

Stats: :func:`stream_stats` accumulates per-dim sums and sums of squares in
float32 on the device and finalizes them in float64 on the host, as JAX
does. That is not the reference's float64 per-row accumulation (ref
``utils.py:589-593``), so it serves self-normalized runs only; the parity
configuration passes precomputed host stats.
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch

from ..ops.deltas import betas_delta, vit_delta
from ..ops.procrustes import procrustes_kp_delta
from ..ops.so3 import rotmat_delta
from .features import _NORM_EPS, _ROW_ALIGN, FeatureBank

if T.TYPE_CHECKING:
    from .stats import ModalityStats


def _stream_delta(m: str, X: torch.Tensor, start_mask: torch.Tensor) -> torch.Tensor:
    """Diff features of a whole stream, zero at each video's first row (the
    per-video ops give an exact +0.0 there)."""
    Tn = X.shape[0]
    if m in ("vit", "clip", "dino"):
        d = vit_delta(X)
    elif m in ("global", "pose"):
        d = rotmat_delta(X.reshape(Tn, -1, 3, 3)).reshape(Tn, -1)
    elif m == "beta":
        d = betas_delta(X)
    elif m == "kp2d":
        d = procrustes_kp_delta(X)
    else:
        raise KeyError(m)
    return torch.where(start_mask[:, None], torch.zeros((), dtype=d.dtype, device=d.device), d)


class StreamSet(T.NamedTuple):
    """Per-modality streams and their diffs, shared by :func:`stream_stats`
    and :func:`build_bank_device` so the delta pass runs once."""

    mods: T.Tuple[str, ...]
    lengths: T.List[T.Dict[str, int]]
    streams: T.Dict[str, torch.Tensor]
    diffs: T.Dict[str, torch.Tensor]


def _starts(lengths: T.Sequence[T.Dict[str, int]], m: str) -> T.Tuple[np.ndarray, np.ndarray]:
    """(per-video length, per-video first stream row) of modality ``m``."""
    L = np.array([lm[m] for lm in lengths], np.int64)
    return L, np.concatenate([[0], np.cumsum(L)[:-1]]).astype(np.int64)


def _as_device(a, device: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=torch.float32)


def build_streams(arrays_list: T.Sequence[T.Mapping[str, T.Any]], mods: T.Sequence[str],
                  device: T.Union[str, torch.device, None] = None) -> StreamSet:
    """One stream a modality on ``device`` (default: where the first video's
    arrays are, the CPU for numpy) and its diff stream."""
    if device is None:
        first = arrays_list[0][mods[0]]
        device = first.device if isinstance(first, torch.Tensor) else "cpu"
    device = torch.device(device)
    lengths = [{m: int(a[m].shape[0]) for m in mods} for a in arrays_list]
    streams = {m: torch.cat([_as_device(a[m], device).reshape(a[m].shape[0], -1) for a in arrays_list])
               for m in mods}
    diffs = {}
    with torch.no_grad():
        for m in mods:
            L, off = _starts(lengths, m)
            mask = torch.zeros(int(L.sum()), dtype=torch.bool)
            mask[torch.from_numpy(off)] = True
            diffs[m] = _stream_delta(m, streams[m], mask.to(device))
    return StreamSet(tuple(mods), lengths, streams, diffs)


def _bank_geometry(lengths: T.Sequence[T.Dict[str, int]], mods: T.Sequence[str], min_rows: int
                   ) -> T.Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(per-video n_rows, bank offsets, row_limit): the host builder's
    integer layout."""
    n_rows = np.empty(len(lengths), np.int64)
    for v, lm in enumerate(lengths):
        r = max(max(lm[m] for m in mods) + 1, min_rows)
        n_rows[v] = (r + _ROW_ALIGN - 1) // _ROW_ALIGN * _ROW_ALIGN
    offsets = np.concatenate([[0], np.cumsum(n_rows)[:-1]]).astype(np.int32)
    return n_rows, offsets, (n_rows - 1).astype(np.int32)


def _gather_indices(lengths: T.Sequence[T.Dict[str, int]], mods: T.Sequence[str], n_rows: np.ndarray
                    ) -> T.Tuple[T.Dict[str, np.ndarray], T.Dict[str, np.ndarray]]:
    """Per modality: the stream row of every bank row ``[R]`` (clamped to the
    video's last row) and the bank rows whose diff is the normalized zero
    (``t >= L_m``)."""
    src: T.Dict[str, np.ndarray] = {}
    pad: T.Dict[str, np.ndarray] = {}
    for m in mods:
        L, off = _starts(lengths, m)
        rows, pads = [], []
        for v, nr in enumerate(n_rows):
            t = np.arange(nr)
            rows.append(off[v] + np.minimum(t, L[v] - 1))
            pads.append(t >= L[v])
        src[m] = np.concatenate(rows)
        pad[m] = np.concatenate(pads)
    return src, pad


def build_bank_device(
    arrays_list: T.Sequence[T.Mapping[str, T.Any]],
    names: T.Sequence[str],
    classes: T.Sequence[str],
    stats: "ModalityStats",
    min_rows: int = 40,
    streams: T.Optional[StreamSet] = None,
    device: T.Union[str, torch.device, None] = None,
) -> FeatureBank:
    """The device-resident counterpart of ``pipelines.full.bank_from_arrays``.
    Per-video arrays may be device tensors (the extraction's outputs, left
    there) or numpy; the bank is built on ``device`` (default: where the
    arrays, or ``streams``, are) and returned there as a tensor."""
    mods = stats.modalities
    missing = [(names[i], [m for m in mods if m not in a])
               for i, a in enumerate(arrays_list) if any(m not in a for m in mods)]
    if missing:
        raise FileNotFoundError(f"videos missing modalities (device bank): {missing[:4]}")
    empty = [(names[i], m) for i, a in enumerate(arrays_list) for m in mods if a[m].shape[0] == 0]
    if empty:
        raise ValueError(f"zero-frame modalities (truncated extraction?): {empty[:4]}")
    if streams is None or not all(m in streams.streams for m in mods):
        streams = build_streams(arrays_list, mods, device)
    dev = streams.streams[mods[0]].device
    n_rows, offsets, row_limit = _bank_geometry(streams.lengths, mods, min_rows)
    src, pad = _gather_indices(streams.lengths, mods, n_rows)
    const = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)   # noqa: E731
    raw_parts, diff_parts, z0_parts = [], [], []
    with torch.no_grad():
        for m in mods:
            mean_r, std_r, mean_d, std_d = (const(s[m]) for s in
                                            (stats.mean_raw, stats.std_raw, stats.mean_diff, stats.std_diff))
            rows = torch.from_numpy(src[m]).to(dev)
            raw_parts.append((streams.streams[m][rows] - mean_r[None, :]) / (std_r[None, :] + _NORM_EPS))
            z0 = (torch.zeros_like(mean_d) - mean_d) / (std_d + _NORM_EPS)
            dn = (streams.diffs[m][rows] - mean_d[None, :]) / (std_d[None, :] + _NORM_EPS)
            diff_parts.append(torch.where(torch.from_numpy(pad[m]).to(dev)[:, None], z0[None, :], dn))
            z0_parts.append((np.zeros(stats.mean_diff[m].shape[0], np.float32) - stats.mean_diff[m])
                            / (stats.std_diff[m] + _NORM_EPS))
        bank = torch.cat(raw_parts + diff_parts, dim=1)
    return FeatureBank(
        bank=bank,
        offsets=offsets,
        row_limit=row_limit,
        z0_diff=np.concatenate(z0_parts).astype(np.float32),
        one_pass_raw=sum(int(stats.mean_raw[m].shape[0]) for m in mods),
        classes=list(classes),
        names=list(names),
    )


def stream_stats(
    arrays_list: T.Sequence[T.Mapping[str, T.Any]],
    eps: float = 1e-6,
    streams: T.Optional[StreamSet] = None,
    device: T.Union[str, torch.device, None] = None,
) -> T.Tuple["ModalityStats", StreamSet]:
    """Normalization stats of the modalities every video has: float32 sums on
    the device, a float64 finalize on the host (not the reference's float64
    pass; see the module docstring). Returns the stats and the
    :class:`StreamSet` they came from, for :func:`build_bank_device`."""
    from .stats import MODALITIES, ModalityStats

    mods = [m for m in arrays_list[0] if all(m in a for a in arrays_list)]
    if streams is None or not all(m in streams.streams for m in mods):
        streams = build_streams(arrays_list, mods, device)
    with torch.no_grad():
        sums = {m: [x.sum(dim=0) for x in (streams.streams[m], streams.streams[m] ** 2,
                                           streams.diffs[m], streams.diffs[m] ** 2)]
                for m in mods}
    sums = {m: [s.cpu().numpy().astype(np.float64) for s in ss] for m, ss in sums.items()}
    stats = ModalityStats({}, {}, {}, {})
    for m in MODALITIES:
        if m not in mods:
            continue
        n = max(1, sum(lm[m] for lm in streams.lengths))
        s_r, ss_r, s_d, ss_d = sums[m]
        for s, ss, mean_out, std_out in ((s_r, ss_r, stats.mean_raw, stats.std_raw),
                                         (s_d, ss_d, stats.mean_diff, stats.std_diff)):
            mean = s / n
            var = ss / n - mean ** 2
            mean_out[m] = mean.astype(np.float32)
            std_out[m] = np.sqrt(np.maximum(var, 0.0) + eps).astype(np.float32)
    return stats, streams
