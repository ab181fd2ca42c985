"""Per-video feature banks, their window gathers and their on-disk cache.

Port of ``video_gen_evals_tpu/data/features.py``. The bank is assembled on
the host (``impl="host"``, the JAX ``bank_impl="auto"`` route) or on the
device (``impl="device"``, ``data/device_bank.py``):

1. Per video, raw and temporal-diff features for every modality, normalized
   with train stats (diffs in torch on the CPU, float32).
2. One ``[N_v, D]`` block per video: rows past the last real frame hold the
   video's sentinel row (edge-repeated raw features, normalized-zero diffs),
   and ``N_v`` is rounded up to 8 rows, as in the JAX bank.
3. Blocks concatenate into one ``[N, D]`` bank; a window is the contiguous
   run ``bank[offset_v + start : + clip_len]`` with row 0's diff block set
   to the normalized-zero vector (``ops/window_kernel.py``).

This reproduces the reference's per-window slice-or-pad -> deltas -> z-score
-> concat (ref ``utils.py:366-514``); see the JAX module for the argument.

Windows come out of a bank by K1 (``ops/window_kernel.py``), or by the two
torch gathers JAX computes outside Pallas: :func:`gather_windows_sliced`
(one contiguous slice a window: K1's plain version) and :func:`gather_windows`
(``take``: a clamped row index a window row, exact for any start).

:func:`build_feature_bank_cached` keeps a built bank in one npz under a
fingerprint of everything it depends on (:func:`bank_fingerprint`), with
the JAX package's member names and fingerprint strings, so a cache either
package wrote is a hit for the other. Mesh npz files are read by the native
reader (``utils/native_npz.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import typing as T
import zipfile

import numpy as np
import torch

from ..ops.deltas import betas_delta, vit_delta
from ..ops.procrustes import procrustes_kp_delta
from ..ops.so3 import rotmat_delta
# The sliced gather is K1's plain version; it lives beside the kernel.
from ..ops.window_kernel import gather_windows_plain as gather_windows_sliced
from ..utils.native_npz import load_npz, load_npz_many

if T.TYPE_CHECKING:
    from .stats import ModalityStats

__all__ = [
    "ModalityPaths",
    "load_video_arrays",
    "compute_modality_diffs",
    "VideoFeatures",
    "compute_video_features",
    "assemble_video_bank",
    "FeatureBank",
    "build_feature_bank",
    "finalize_feature_bank",
    "gather_windows",
    "gather_windows_sliced",
    "bank_fingerprint",
    "source_fingerprint",
    "save_feature_bank",
    "load_feature_bank",
    "load_bank_fingerprint",
    "build_feature_bank_cached",
    "CACHE_COUNTS",
]

_NORM_EPS = 1e-6  # eps added to std at normalization time (ref utils.py:473)
_ROW_ALIGN = 8    # per-video bank rows round up to a multiple of 8, as in JAX

# (modality, ModalityPaths attr, per-video file name): the one source of the
# side files' names for both the loader and the cache fingerprints, so a
# fingerprint stats the files a bank read
_SIDE_FILES = (
    ("kp2d", "keypoint_dir", "keypoints.npy"),
    ("clip", "clip_dir", "clip_embeddings.npz"),
    ("dino", "dino_dir", "dino_embeddings.npz"),
)


@dataclasses.dataclass(frozen=True)
class ModalityPaths:
    """Side-file locations for optional modalities.

    ``layout``: ``"real"`` -> ``<dir>/<class>/<vid_stem>/<file>``;
    ``"generated"`` -> ``<dir>/<vid_stem>/<file>``; ``"auto"`` -> the
    reference's rule: generated iff the *keypoint* dir name contains
    ``SAVE_GEN`` / ``SAVE_NEW`` / ``generated_kps`` (ref
    ``utils.py:411-414,429-432,443-446``).
    """

    keypoint_dir: T.Optional[str] = None
    clip_dir: T.Optional[str] = None
    dino_dir: T.Optional[str] = None
    layout: str = "auto"

    def _is_generated(self) -> bool:
        if self.layout == "generated":
            return True
        if self.layout == "real":
            return False
        kd = str(self.keypoint_dir)
        return any(tok in kd for tok in ("SAVE_GEN", "SAVE_NEW", "generated_kps"))

    def resolve(self, base_dir: str, cls: str, vid_stem: str, fname: str) -> str:
        if self._is_generated():
            return os.path.join(base_dir, vid_stem, fname)
        return os.path.join(base_dir, cls, vid_stem, fname)


def load_video_arrays(
    item,
    paths: ModalityPaths,
    strict_kp: bool = True,
    npz: T.Optional[T.Dict[str, np.ndarray]] = None,
) -> T.Dict[str, np.ndarray]:
    """Raw per-modality arrays of one video (float32, flattened):
    ``vit [T,Dv]``, ``global [T,9]``, ``pose [T,9J]``, ``beta [T,10]``, and
    where configured ``kp2d [T',120]``, ``clip [T'',512]``, ``dino [T'',768]``.

    Missing keypoints with ``strict_kp`` raise (ref ``utils.py:416-417``);
    missing or unreadable clip/dino files are skipped (ref ``utils.py:427-452``).
    """
    if npz is None:
        npz = load_npz(item.path)
    Tlen = npz["pose"].shape[0]
    out: T.Dict[str, np.ndarray] = {
        "vit": npz["vit"].astype(np.float32),
        "global": npz["global_orient"].astype(np.float32).reshape(Tlen, -1),
        "pose": npz["pose"].astype(np.float32).reshape(Tlen, -1),
        "beta": npz["betas"].astype(np.float32),
    }
    vid_stem = os.path.splitext(os.path.basename(item.path))[0]

    if paths.keypoint_dir is not None:
        kp_path = paths.resolve(paths.keypoint_dir, item.cls, vid_stem, "keypoints.npy")
        if not os.path.exists(kp_path):
            if strict_kp:
                raise FileNotFoundError(
                    f"Expected keypoints at '{kp_path}' for video '{vid_stem}' "
                    "but file does not exist."
                )
        else:
            kp = np.load(kp_path).astype(np.float32)
            if kp.ndim == 2 and kp.shape[0] > 0:
                out["kp2d"] = kp
            elif strict_kp:
                raise ValueError(
                    f"Keypoint file '{kp_path}' is empty or malformed: {kp.shape}"
                )

    for m, attr, fname in _SIDE_FILES:
        base = getattr(paths, attr)
        if m == "kp2d" or base is None:
            continue
        p = paths.resolve(base, item.cls, vid_stem, fname)
        if not os.path.exists(p):
            continue
        try:
            with np.load(p) as z:
                out[m] = z["embeddings"].astype(np.float32)
        except (OSError, KeyError, ValueError):
            pass  # unreadable side file: skipped like a missing one
    return out


def compute_modality_diffs(arrays: T.Dict[str, np.ndarray]) -> T.Dict[str, np.ndarray]:
    """Full-video diff features per modality (float32, torch on the CPU)."""
    diffs: T.Dict[str, np.ndarray] = {}
    with torch.no_grad():
        for m, X in arrays.items():
            x = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
            Tlen = x.shape[0]
            if m in ("vit", "clip", "dino"):
                d = vit_delta(x)
            elif m in ("global", "pose"):
                d = rotmat_delta(x.reshape(Tlen, -1, 3, 3)).reshape(Tlen, -1)
            elif m == "beta":
                d = betas_delta(x)
            elif m == "kp2d":
                d = procrustes_kp_delta(x)
            else:
                raise KeyError(m)
            diffs[m] = d.numpy().astype(np.float32, copy=False)
    return diffs


def _normalize(X: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (X - mean[None, :]) / (std[None, :] + _NORM_EPS)


@dataclasses.dataclass
class VideoFeatures:
    """One video's normalized bank ``[N_v, D]``: ``N_v = round_up(max(height
    + 1, min_rows), 8)``, and the rows from ``height`` on hold the video's
    sentinel row (edge-repeated raw features, normalized-zero diffs), so a
    window past the last real frame reads the reference's tail padding."""

    bank: np.ndarray       # [N_v, D] float32, normalized, sentinel-padded
    height: int            # number of real frames (sentinel rows start here)
    cls: str
    name: str


def compute_video_features(
    item,
    paths: ModalityPaths,
    stats: "ModalityStats",
    modalities: T.Optional[T.Sequence[str]] = None,
    min_rows: int = 40,
    npz: T.Optional[T.Dict[str, np.ndarray]] = None,
) -> VideoFeatures:
    """The normalized bank of one video: :func:`load_video_arrays` (keypoints
    required) and :func:`assemble_video_bank`. ``modalities`` defaults to
    the stats' modalities, and each must load for this video; ``min_rows``
    must be at least the largest ``clip_len`` that will be gathered."""
    arrays = load_video_arrays(item, paths, strict_kp=True, npz=npz)
    mods = list(modalities) if modalities is not None else stats.modalities
    bank, height = assemble_video_bank(arrays, mods, stats, min_rows, item.name)
    return VideoFeatures(bank=bank, height=height, cls=item.cls, name=item.name)


def assemble_video_bank(
    arrays: T.Dict[str, np.ndarray],
    mods: T.Sequence[str],
    stats: "ModalityStats",
    min_rows: int,
    name: str,
    diffs: T.Optional[T.Dict[str, np.ndarray]] = None,
) -> T.Tuple[np.ndarray, int]:
    """Normalize and sentinel-pad one video's arrays into ``[n_rows, D]``.
    Returns ``(bank_2d, height)``."""
    missing = [m for m in mods if m not in arrays]
    if missing:
        raise FileNotFoundError(
            f"video '{name}': missing modalities {missing} "
            f"(available: {sorted(arrays)})"
        )
    empty = [m for m in mods if arrays[m].shape[0] == 0]
    if empty:
        # a 0-row modality would give a 0-row bank whose windows read the
        # previous video's rows
        raise ValueError(
            f"video '{name}': modalities {empty} have zero frames "
            "(truncated/failed extraction?)"
        )
    arrays = {m: arrays[m] for m in mods}
    if diffs is None:
        diffs = compute_modality_diffs(arrays)

    height = max(arrays[m].shape[0] for m in mods)
    n_rows = max(height + 1, min_rows)
    n_rows = (n_rows + _ROW_ALIGN - 1) // _ROW_ALIGN * _ROW_ALIGN
    raw_blocks: T.List[np.ndarray] = []
    diff_blocks: T.List[np.ndarray] = []
    for m in mods:
        raw = _normalize(arrays[m], stats.mean_raw[m], stats.std_raw[m])
        diff = _normalize(diffs[m], stats.mean_diff[m], stats.std_diff[m])
        z0 = _normalize(
            np.zeros((1, diff.shape[1]), np.float32),
            stats.mean_diff[m],
            stats.std_diff[m],
        )
        pad = n_rows - raw.shape[0]
        # raw: edge-pad with the last real row; diff: normalized zero
        raw_blocks.append(np.concatenate([raw, np.repeat(raw[-1:], pad, axis=0)], axis=0))
        diff_blocks.append(np.concatenate([diff, np.repeat(z0, pad, axis=0)], axis=0))

    bank = np.concatenate(raw_blocks + diff_blocks, axis=1).astype(np.float32)
    return bank, height


@dataclasses.dataclass
class FeatureBank:
    """Concatenated per-video banks plus gather metadata.

    ``bank``      : [N, D] float32 (normalized, sentinel-padded per video)
    ``offsets``   : [V] int32 row offset of each video's bank
    ``row_limit`` : [V] int32 last row index of each video's bank
    ``z0_diff``   : [D_diff] float32 normalized-zero diff vector (row-0 override)
    """

    bank: np.ndarray
    offsets: np.ndarray
    row_limit: np.ndarray
    z0_diff: np.ndarray
    one_pass_raw: int
    classes: T.List[str]
    names: T.List[str]

    @property
    def feature_dim(self) -> int:
        return int(self.bank.shape[1])

    @property
    def num_videos(self) -> int:
        return len(self.offsets)

    def validate_clip_len(self, clip_len: int) -> None:
        """Every video's bank must hold >= ``clip_len`` rows: a shorter one
        would hand the window's tail to the next video's rows."""
        if len(self.offsets) == 0:
            return
        shortest = int(np.min(self.row_limit)) + 1
        if shortest < clip_len:
            raise ValueError(
                f"feature bank has a video with only {shortest} rows < "
                f"clip_len={clip_len} — rebuild with min_rows >= {clip_len} "
                "(windows would silently read the next video's rows)"
            )


def build_feature_bank(
    items: T.Sequence,
    paths: ModalityPaths,
    stats: "ModalityStats",
    modalities: T.Optional[T.Sequence[str]] = None,
    min_rows: int = 40,
    impl: str = "host",
    device: T.Union[str, torch.device, None] = None,
) -> FeatureBank:
    """The normalized window bank for ``items``.

    ``modalities`` defaults to the stats' modalities; each must be loadable
    for every video. ``min_rows`` must be >= the largest clip_len gathered.
    ``impl``: ``"host"`` (numpy assembly) or ``"device"`` (the whole
    delta / normalize / pad / concat pass on ``device``,
    ``data/device_bank.py``; the bank stays there as a tensor).
    """
    if impl not in ("host", "device"):
        raise ValueError(f"unknown bank impl {impl!r}")
    mods = list(modalities) if modalities is not None else stats.modalities
    items = list(items)
    npzs = load_npz_many([it.path for it in items], n_threads=8)
    for it, z in zip(items, npzs):
        if z is None:
            raise IOError(f"could not open mesh npz '{it.path}'")
    if impl == "device":
        from .device_bank import build_bank_device
        from .stats import ModalityStats

        sub = ModalityStats(*({m: d[m] for m in mods}
                              for d in (stats.mean_raw, stats.std_raw, stats.mean_diff, stats.std_diff)))
        arrays_list = [load_video_arrays(it, paths, strict_kp=True, npz=z) for it, z in zip(items, npzs)]
        return build_bank_device(arrays_list, [it.name for it in items], [it.cls for it in items], sub,
                                 min_rows=min_rows, device=device)
    banks = [compute_video_features(it, paths, stats, mods, min_rows, npz=z).bank
             for it, z in zip(items, npzs)]
    return finalize_feature_bank(banks, [it.name for it in items], [it.cls for it in items], stats, mods)


def finalize_feature_bank(
    banks: T.Sequence[np.ndarray],
    names: T.Sequence[str],
    classes: T.Sequence[str],
    stats: "ModalityStats",
    mods: T.Sequence[str],
) -> FeatureBank:
    """Concatenate per-video blocks into a :class:`FeatureBank` with gather
    metadata (offsets, last-row limits, z0 override)."""
    offsets = np.zeros(len(banks), np.int32)
    row_limit = np.zeros(len(banks), np.int32)
    row = 0
    for i, b in enumerate(banks):
        offsets[i] = row
        row_limit[i] = b.shape[0] - 1
        row += b.shape[0]
    z0_parts = [
        _normalize(
            np.zeros((1, stats.mean_diff[m].shape[0]), np.float32),
            stats.mean_diff[m],
            stats.std_diff[m],
        )[0]
        for m in mods
    ]
    return FeatureBank(
        bank=np.concatenate(list(banks), axis=0),
        offsets=offsets,
        row_limit=row_limit,
        z0_diff=np.concatenate(z0_parts).astype(np.float32),
        one_pass_raw=sum(int(stats.mean_raw[m].shape[0]) for m in mods),
        classes=list(classes),
        names=list(names),
    )


def gather_windows(
    bank: torch.Tensor,       # [N, D]
    offsets: torch.Tensor,    # [V] int32
    row_limit: torch.Tensor,  # [V] int32, last row of each video's bank
    z0_diff: torch.Tensor,    # [D_diff]
    one_pass_raw: int,
    video_idx: torch.Tensor,  # [B] int32
    starts: torch.Tensor,     # [B] int32
    clip_len: int,
) -> torch.Tensor:
    """``[B, clip_len, D]`` windows by one row gather (JAX ``take``): row i
    of a window reads ``offsets[v] + clip(start + i, 0, row_limit[v])``, and
    a negative start reads the video's row 0 for the whole window, so every
    start follows the reference's slice-or-pad rule exactly
    (``windows.py``)."""
    v = video_idx.long()
    st = starts.long()[:, None]
    i = torch.arange(clip_len, device=bank.device)[None, :]
    row = torch.minimum((st + i).clamp_min(0), row_limit[v].long()[:, None])
    row = torch.where(st < 0, torch.zeros_like(row), row)
    out = bank[offsets[v].long()[:, None] + row]
    out[:, 0, one_pass_raw:] = z0_diff.to(out.dtype)
    return out


# cache hits and misses of this process's bank and stats caches
CACHE_COUNTS = {"hit": 0, "miss": 0}


def _file_identity(add, p: str) -> None:
    try:
        st = os.stat(p)
        add(f"{p}|{st.st_size}|{st.st_mtime_ns}")
    except OSError:
        add(f"{p}|missing")


def _hasher():
    h = hashlib.sha256()

    def add(s: str) -> None:
        h.update(s.encode())
        h.update(b"\x00")

    return h, add


def bank_fingerprint(
    items: T.Sequence,
    paths: ModalityPaths,
    stats: "ModalityStats",
    modalities: T.Optional[T.Sequence[str]] = None,
    min_rows: int = 40,
) -> str:
    """Hash of everything a cached bank's contents depend on: the
    normalization stats, the modality subset and order, ``min_rows``, the
    side-file configuration, and each source file's path, size and mtime
    (the mesh npz and each configured keypoint / clip / dino file). The
    same string as the JAX package's ``bank_fingerprint``."""
    mods = list(modalities) if modalities is not None else stats.modalities
    h, add = _hasher()
    add("v2")  # v2: per-item class labels joined the hash
    add(",".join(mods))
    add(str(int(min_rows)))
    add(f"{paths.keypoint_dir}|{paths.clip_dir}|{paths.dino_dir}|{paths.layout}")
    for m in mods:
        for arr in (stats.mean_raw[m], stats.std_raw[m], stats.mean_diff[m], stats.std_diff[m]):
            h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
    _add_source_files(add, items, paths)
    return h.hexdigest()


def _add_source_files(add, items, paths: ModalityPaths) -> None:
    """Every source file a bank or stats pass reads, into a fingerprint: each
    item's name and class (a relabel invalidates: AC centroids follow
    ``bank.classes``), its mesh npz and its configured side files."""
    for it in items:
        add(f"{it.name}|{it.cls}")
        _file_identity(add, it.path)
        vid_stem = os.path.splitext(os.path.basename(it.path))[0]
        for _m, attr, fname in _SIDE_FILES:
            base = getattr(paths, attr)
            if base is not None:
                _file_identity(add, paths.resolve(base, it.cls, vid_stem, fname))


def source_fingerprint(items, paths: ModalityPaths, tag: str) -> str:
    """Hash of the source files and the path configuration alone (no stats):
    the key of caches of what is derived from the files, e.g. the stats pass
    (``data/stats.py::compute_stats_cached``)."""
    h, add = _hasher()
    add(tag)
    add(f"{paths.keypoint_dir}|{paths.clip_dir}|{paths.dino_dir}|{paths.layout}")
    _add_source_files(add, items, paths)
    return h.hexdigest()


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_feature_bank(bank: FeatureBank, path: str, fingerprint: T.Optional[str] = None) -> None:
    """One compressed npz of the bank (a device bank is fetched once), with
    the JAX package's member names. Written to a temporary name and renamed:
    a crash, or several writers racing on one cache directory, never leaves
    a torn file at ``path``."""
    extra = {} if fingerprint is None else {"fingerprint": np.array(fingerprint)}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(
        tmp,
        bank=_host(bank.bank),
        offsets=_host(bank.offsets),
        row_limit=_host(bank.row_limit),
        z0_diff=_host(bank.z0_diff),
        one_pass_raw=np.int64(bank.one_pass_raw),
        classes=np.array(bank.classes),
        names=np.array(bank.names),
        **extra,
    )
    os.replace(tmp, path)


def load_feature_bank(path: str) -> FeatureBank:
    z = load_npz(path)
    if "classes" not in z or "names" not in z:   # the native reader skips strings
        with np.load(path, allow_pickle=False) as f:
            z["classes"], z["names"] = f["classes"], f["names"]
    return FeatureBank(
        bank=z["bank"],
        offsets=z["offsets"],
        row_limit=z["row_limit"],
        z0_diff=z["z0_diff"],
        one_pass_raw=int(z["one_pass_raw"]),
        classes=[str(c) for c in z["classes"]],
        names=[str(n) for n in z["names"]],
    )


def load_bank_fingerprint(path: str) -> T.Optional[str]:
    """The ``fingerprint`` member of a cached npz (a few dozen bytes), or
    None for a file without one or that does not read."""
    try:
        with np.load(path, allow_pickle=False) as f:
            if "fingerprint" in f.files:
                return str(f["fingerprint"])
    except (OSError, EOFError, ValueError, zipfile.BadZipFile):
        pass
    return None


def read_if_unchanged(path: str, fingerprint: str, load: T.Callable[[str], T.Any]) -> T.Optional[T.Any]:
    """``load(path)`` when the file's fingerprint is ``fingerprint`` and the
    file was not replaced while it was read, else None. The fingerprint and
    the payload come from separate opens, so a concurrent writer of another
    configuration could rename its file in between: the reads are bracketed
    by ``stat`` and need an unchanged inode, mtime and size (a rename
    changes the inode)."""
    if not os.path.exists(path):
        return None
    try:
        before = os.stat(path)
        if load_bank_fingerprint(path) != fingerprint:
            return None
        out = load(path)
        after = os.stat(path)
    except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
        return None   # unreadable or torn: rebuilt by the caller
    same = (before.st_ino, before.st_mtime_ns, before.st_size) == (after.st_ino, after.st_mtime_ns, after.st_size)
    return out if same else None


def build_feature_bank_cached(
    items: T.Sequence,
    paths: ModalityPaths,
    stats: "ModalityStats",
    modalities: T.Optional[T.Sequence[str]] = None,
    min_rows: int = 40,
    cache_path: T.Optional[str] = None,
    impl: str = "host",
    device: T.Union[str, torch.device, None] = None,
    write: bool = True,
) -> FeatureBank:
    """:func:`build_feature_bank` with an on-disk cache at ``cache_path``.

    A cache whose fingerprint (:func:`bank_fingerprint`) matches and whose
    video names and classes are ``items``' (same order) loads through the
    native reader instead of the normalize / delta pass; a stale, mismatched
    or fingerprint-less one is rebuilt and overwritten (unless ``write`` is
    False: a data-parallel rank other than 0 reads, and never writes). A hit
    is a host bank, whatever ``impl``."""
    names = [it.name for it in items]
    fp = bank_fingerprint(items, paths, stats, modalities, min_rows=min_rows)
    if cache_path:
        bank = read_if_unchanged(cache_path, fp, load_feature_bank)
        if bank is not None and bank.names == names and bank.classes == [it.cls for it in items]:
            CACHE_COUNTS["hit"] += 1
            return bank
        CACHE_COUNTS["miss"] += 1
    bank = build_feature_bank(items, paths, stats, modalities, min_rows=min_rows, impl=impl, device=device)
    if cache_path and write:
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        save_feature_bank(bank, cache_path, fingerprint=fp)
    return bank
