"""The full pipeline: video frames -> mesh and keypoint extraction -> feature
bank -> fusion encoder -> TAG scores, in one process (BASELINE config 4).

Port of ``video_gen_evals_tpu/pipelines/full.py``. The reference runs three
scripts with a filesystem contract between them (``extract_mesh.py`` ->
``process_video.py`` -> ``eval.py``); here the extractor's outputs feed the
feature bank directly, with no npz round trip:

  Extractor.process_videos_streamed (detect, crops, ViT-H with K6, SMPL head,
  RTMPose) -> per-modality arrays -> stats and the bank
  -> WindowEncoder.encode_bank_segsum (K1 gather, K3 conv stages, per-video
  sums on the device) -> AC / TC.

``bank_impl`` ("auto" and "host", as in JAX, or "device") says where the bank
is assembled: on the host (``data/features.py``), or on the extractor's
device from outputs that never leave it (``data/device_bank.py``), with the
stats of these videos accumulated there when none are given.
"""

from __future__ import annotations

import dataclasses
import time
import typing as T

import numpy as np
import torch

from ..data.device_bank import build_bank_device, stream_stats
from ..data.features import FeatureBank, assemble_video_bank, compute_modality_diffs, finalize_feature_bank
from ..data.manifest import VideoItem, VideoManifest
from ..data.stats import MODALITIES, ModalityStats, _Acc
from ..data.windows import enumerate_windows
from ..metrics.scores import finalize_video_scores
from ..models import HumanActionScorer
from ..utils.names import infer_class_from_name
from .extract import Extractor
from .score import ScoreConfig, WindowEncoder

BANK_IMPLS = ("auto", "host", "device")


def arrays_from_extraction(mesh: T.Dict[str, np.ndarray], kp: T.Optional[T.Dict[str, np.ndarray]] = None,
                           kp_bug_compat: bool = True) -> T.Dict[str, np.ndarray]:
    """Extractor outputs -> the per-modality raw arrays of the npz contract,
    without the disk: ``vit``, ``global``, ``pose``, ``beta`` and, where a
    keypoint row is kept (only the valid rows with ``kp_bug_compat``),
    ``kp2d``. Numpy arrays in, numpy out; device tensors (the extraction's
    ``fetch_arrays=False``) stay on the device."""
    f32 = lambda a: a.float() if isinstance(a, torch.Tensor) else a.astype(np.float32)   # noqa: E731
    n = mesh["pose"].shape[0]
    out = {
        "vit": f32(mesh["vit"]),
        "global": f32(mesh["global_orient"]).reshape(n, -1),
        "pose": f32(mesh["pose"]).reshape(n, -1),
        "beta": f32(mesh["betas"]),
    }
    if kp is not None:
        rows = kp["kp120"]
        if kp_bug_compat:
            valid = kp["valid"]
            rows = rows[torch.from_numpy(valid).to(rows.device) if isinstance(rows, torch.Tensor) else valid]
        if rows.shape[0] > 0:
            out["kp2d"] = f32(rows)
    return out


def stats_from_arrays(per_video_arrays: T.Sequence[T.Dict[str, np.ndarray]], eps: float = 1e-6,
                      diffs_list: T.Optional[T.Sequence[T.Dict[str, np.ndarray]]] = None) -> ModalityStats:
    """``data/stats.py::compute_stats`` over arrays in memory (float64 sums
    of the raw and diff features). ``diffs_list``: each video's
    ``compute_modality_diffs``, when the caller has them already."""
    accs_raw = {m: _Acc() for m in MODALITIES}
    accs_diff = {m: _Acc() for m in MODALITIES}
    for vi, arrays in enumerate(per_video_arrays):
        diffs = diffs_list[vi] if diffs_list is not None else compute_modality_diffs(arrays)
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


def bank_from_arrays(per_video_arrays: T.Sequence[T.Dict[str, np.ndarray]], names: T.Sequence[str],
                     classes: T.Sequence[str], stats: ModalityStats, min_rows: int = 40,
                     diffs_list: T.Optional[T.Sequence[T.Dict[str, np.ndarray]]] = None) -> FeatureBank:
    """The feature bank of arrays in memory, assembled and checked as
    ``data/features.py::build_feature_bank`` does for files."""
    banks = [assemble_video_bank(arrays, stats.modalities, stats, min_rows, names[i],
                                 diffs=diffs_list[i] if diffs_list is not None else None)[0]
             for i, arrays in enumerate(per_video_arrays)]
    return finalize_feature_bank(banks, names, classes, stats, stats.modalities)


@dataclasses.dataclass
class FullPipelineResult:
    scores: T.Dict[str, T.Dict[str, float]]
    rejected: T.List[str]       # videos failing the single-person ratio test
    stats: ModalityStats


def score_videos_end_to_end(
    extractor: Extractor,
    model: HumanActionScorer,
    frames_by_video: T.Mapping[str, np.ndarray],   # name -> [T, H, W, 3] uint8
    centroids: np.ndarray,
    label_dict: T.Dict[str, int],
    stats: T.Optional[ModalityStats] = None,
    cfg: T.Optional[ScoreConfig] = None,
    with_keypoints: bool = True,
    encoder: T.Optional[WindowEncoder] = None,
    phase_times: T.Optional[T.Dict[str, float]] = None,
    bank_impl: T.Optional[str] = None,
) -> FullPipelineResult:
    """Frames to scores in one call: streamed extraction (detect, crops, mesh
    net and pose net) -> per-video arrays -> stats (from these videos unless
    ``stats`` is given) and the bank over the modalities every video has ->
    the encoder's window sweep on the extractor's device -> AC and TC.

    A video the single-person rule rejects is listed in ``rejected``. A video
    whose class no ``label_dict`` key names, or whose class has no centroid
    row, gets TC only, as the reference excludes it from AC (ref
    ``utils.py:1154-1159``, ``eval.py:246-248``). ``encoder``: a prebuilt
    WindowEncoder on the same model and geometry, kept across calls.
    ``phase_times`` receives the wall seconds ``extract_s``, ``bank_s`` and
    ``score_s``; each phase ends on host data (the extraction's fetches or
    masks, the bank's layout, the sweep's one fetch). ``bank_impl`` (default
    ``cfg.bank_impl``): ``"auto"`` and ``"host"`` build the bank on the host;
    ``"device"`` leaves the extraction's outputs on the extractor's device
    and builds the bank there (``data/device_bank.py``), with float32 stats
    of these videos (:func:`~..data.device_bank.stream_stats`) when ``stats``
    is None."""
    cfg = cfg or ScoreConfig()
    bank_impl = cfg.bank_impl if bank_impl is None else bank_impl
    if bank_impl not in BANK_IMPLS:
        raise ValueError(f"unknown bank_impl {bank_impl!r}")
    on_device = bank_impl == "device"
    t0 = time.perf_counter()
    items = list(frames_by_video.items())
    mesh_by_name, kp_by_name = extractor.process_videos_streamed(items, with_keypoints=with_keypoints,
                                                                 fetch_arrays=not on_device)
    arrays_list: T.List[T.Dict[str, np.ndarray]] = []
    names: T.List[str] = []
    rejected: T.List[str] = []
    for name, _frames in items:
        if mesh_by_name[name] is None:
            rejected.append(name)
            continue
        arrays_list.append(arrays_from_extraction(mesh_by_name[name], kp_by_name[name],
                                                  kp_bug_compat=extractor.cfg.kp_bug_compat))
        names.append(name)
    if phase_times is not None:
        phase_times["extract_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    if not arrays_list:
        return FullPipelineResult({}, rejected, stats or ModalityStats({}, {}, {}, {}))

    # only the modalities every video has (a video with no kept keypoint row has no kp2d)
    common = set.intersection(*(set(a) for a in arrays_list))
    arrays_list = [{m: a[m] for m in a if m in common} for a in arrays_list]
    diffs_list = streams = None
    if on_device:
        if stats is None:
            # the streams it builds feed the bank below, so the deltas run once
            stats, streams = stream_stats(arrays_list)
    else:
        diffs_list = [compute_modality_diffs(a) for a in arrays_list]
        if stats is None:
            stats = stats_from_arrays(arrays_list, diffs_list=diffs_list)
    used = [m for m in stats.modalities if m in common]
    stats = ModalityStats(*({m: d[m] for m in used}
                            for d in (stats.mean_raw, stats.std_raw, stats.mean_diff, stats.std_diff)))

    classes = [infer_class_from_name(n, label_dict.keys()) for n in names]
    has_label = np.array([c is not None and label_dict[c] < len(centroids) for c in classes])
    bank_classes = [c or "" for c in classes]
    if on_device:
        bank = build_bank_device(arrays_list, names, bank_classes, stats, streams=streams,
                                 device=extractor.device)
        if bank.bank.is_cuda:   # the phase ends where the bank is complete
            torch.cuda.synchronize(bank.bank.device)
    else:
        bank = bank_from_arrays(arrays_list, names, bank_classes, stats, diffs_list=diffs_list)
    manifest = VideoManifest([VideoItem(cls=c, name=n, path="", length=a["vit"].shape[0], vit_dim=a["vit"].shape[1])
                              for c, n, a in zip(bank_classes, names, arrays_list)])
    windows = enumerate_windows(manifest, cfg.clip_len, cfg.stride)
    if phase_times is not None:
        phase_times["bank_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
    if encoder is None:
        encoder = WindowEncoder(model, cfg.batch_size, cfg.clip_len, cfg.precision, extractor.device,
                                cfg.encoder_impl, gather_impl=cfg.gather_impl)
    seq_sum, tc_sum, count = encoder.encode_bank_segsum(bank, windows, [v for v, _s in windows], len(names))
    # a label without a centroid row is masked by has_label; the gather stays in range
    video_label = np.array([label_dict[c] if h else 0 for c, h in zip(classes, has_label)], np.int64)
    ac_v, tc_v = (t.numpy() for t in finalize_video_scores(
        torch.from_numpy(seq_sum), torch.from_numpy(tc_sum), torch.from_numpy(count),
        torch.from_numpy(video_label), torch.from_numpy(np.asarray(centroids, np.float32))))
    if phase_times is not None:
        phase_times["score_s"] = time.perf_counter() - t0
    scores: T.Dict[str, T.Dict[str, float]] = {}
    for i, n in enumerate(names):
        entry = {"tc": float(tc_v[i])}
        if has_label[i]:
            entry["ac"] = float(ac_v[i])
        scores[n] = entry
    return FullPipelineResult(scores, rejected, stats)
