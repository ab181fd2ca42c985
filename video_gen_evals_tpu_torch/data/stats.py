"""Per-modality normalization statistics.

Port of ``video_gen_evals_tpu/data/stats.py`` (ref ``utils.py:570-801``): one
streaming pass over the train videos accumulating per-dim sum and sum of
squares in float64 numpy, for raw and diff streams;
``std = sqrt(max(var, 0) + eps)`` with eps inside the sqrt (ref
``utils.py:749``). Diff features come from the same torch code as the bank,
so stats and features agree. :func:`compute_stats_cached` keeps the stats in
an npz in the JAX package's format, under a fingerprint of the source files
(``features.source_fingerprint``) with the JAX tag, so either package's
cache is a hit for the other.
"""

from __future__ import annotations

import dataclasses
import os
import typing as T

import numpy as np

from ..utils.native_npz import load_npz_many
from .features import (
    CACHE_COUNTS,
    ModalityPaths,
    compute_modality_diffs,
    load_bank_fingerprint,
    load_video_arrays,
    read_if_unchanged,
    source_fingerprint,
)

# canonical modality order == concatenation order (ref train.py:29-48)
MODALITIES: T.Tuple[str, ...] = ("vit", "global", "pose", "beta", "kp2d", "clip", "dino")


@dataclasses.dataclass
class ModalityStats:
    """mean/std per dim for each available modality, raw and diff streams."""

    mean_raw: T.Dict[str, np.ndarray]
    std_raw: T.Dict[str, np.ndarray]
    mean_diff: T.Dict[str, np.ndarray]
    std_diff: T.Dict[str, np.ndarray]

    @property
    def modalities(self) -> T.List[str]:
        return [m for m in MODALITIES if m in self.mean_raw]

    def dims_map_raw(self) -> T.Dict[str, int]:
        return {m: int(self.mean_raw[m].shape[0]) for m in self.modalities}

    def dims_map_diff(self) -> T.Dict[str, int]:
        return {m: int(self.mean_diff[m].shape[0]) for m in self.modalities}

    def save(self, path: str, fingerprint: T.Optional[str] = None) -> None:
        """One npz, ``<kind>_<modality>`` members (the JAX package's), written
        to a temporary name and renamed."""
        arrs = {}
        for m in self.modalities:
            arrs[f"mean_raw_{m}"] = self.mean_raw[m]
            arrs[f"std_raw_{m}"] = self.std_raw[m]
            arrs[f"mean_diff_{m}"] = self.mean_diff[m]
            arrs[f"std_diff_{m}"] = self.std_diff[m]
        if fingerprint is not None:
            arrs["fingerprint"] = np.array(fingerprint)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrs)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ModalityStats":
        out = cls({}, {}, {}, {})
        with np.load(path) as npz:
            for key in npz.files:
                if key == "fingerprint":
                    continue
                kind, m = key.rsplit("_", 1)
                getattr(out, kind)[m] = npz[key]
        return out


class _Acc:
    """float64 sum / sum^2 / count accumulator (ref ``utils.py:589-593``)."""

    def __init__(self):
        self.s: T.Optional[np.ndarray] = None
        self.ss: T.Optional[np.ndarray] = None
        self.n = 0

    def update(self, X: np.ndarray) -> None:
        X64 = X.astype(np.float64)
        if self.s is None:
            self.s = np.zeros(X.shape[1], np.float64)
            self.ss = np.zeros(X.shape[1], np.float64)
        self.s += X64.sum(axis=0)
        self.ss += (X64**2).sum(axis=0)
        self.n += X.shape[0]

    def finalize(self, eps: float) -> T.Tuple[np.ndarray, np.ndarray]:
        n = max(1, self.n)
        mean = self.s / n
        var = self.ss / n - mean**2
        std = np.sqrt(np.maximum(var, 0.0) + eps)
        return mean.astype(np.float32), std.astype(np.float32)


def compute_stats(
    items: T.Sequence,
    paths: ModalityPaths,
    eps: float = 1e-6,
) -> ModalityStats:
    """One streaming pass over train videos -> per-dim mean/std. Missing
    kp/clip/dino side files are skipped (ref ``utils.py:668-704``)."""
    if len(items) == 0:
        raise ValueError("compute_stats: empty item list")
    accs_raw = {m: _Acc() for m in MODALITIES}
    accs_diff = {m: _Acc() for m in MODALITIES}
    items = list(items)
    # the mesh files open on the native reader's thread pool; a file it could
    # not open (None) goes to the one-file loader for its own error
    npzs = load_npz_many([it.path for it in items], n_threads=8)
    for it, z in zip(items, npzs):
        arrays = load_video_arrays(it, paths, strict_kp=False, npz=z)
        diffs = compute_modality_diffs(arrays)
        for m, X in arrays.items():
            accs_raw[m].update(X)
        for m, X in diffs.items():
            accs_diff[m].update(X)

    stats = ModalityStats({}, {}, {}, {})
    for m in MODALITIES:
        if accs_raw[m].n > 0:
            stats.mean_raw[m], stats.std_raw[m] = accs_raw[m].finalize(eps)
            stats.mean_diff[m], stats.std_diff[m] = accs_diff[m].finalize(eps)
    return stats


# the stats cache's fingerprint is the bank's reader of the same member
load_stats_fingerprint = load_bank_fingerprint


def compute_stats_cached(
    items: T.Sequence,
    paths: ModalityPaths,
    eps: float = 1e-6,
    cache_path: T.Optional[str] = None,
    write: bool = True,
) -> ModalityStats:
    """:func:`compute_stats` with an on-disk cache at ``cache_path``, keyed by
    ``source_fingerprint`` of the train files (any touched, added or removed
    file, or another path configuration, rebuilds). The bank cache needs the
    stats before it can validate, so they are cached apart. ``write=False``:
    read a cache, never write one (a data-parallel rank other than 0)."""
    if cache_path is None:
        return compute_stats(items, paths, eps=eps)
    fp = source_fingerprint(items, paths, tag=f"stats-v1|eps={eps!r}")
    out = read_if_unchanged(cache_path, fp, ModalityStats.load)
    if out is not None:
        CACHE_COUNTS["hit"] += 1
        return out
    CACHE_COUNTS["miss"] += 1
    stats = compute_stats(items, paths, eps=eps)
    if write:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        stats.save(cache_path, fingerprint=fp)
    return stats
