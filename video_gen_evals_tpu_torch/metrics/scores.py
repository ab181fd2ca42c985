"""TAG scores: per-window temporal coherence and the AC/TC finalize.

Port of ``video_gen_evals_tpu/metrics/scores.py`` (SURVEY C20-C21/C24):
- :func:`tc_per_window`         <- ref ``eval.py:209-226``: mean consecutive
  L2 distance between per-frame embeddings, CLS excluded;
- :func:`build_centroids`       <- ref ``utils.py:1018-1045``: the class
  centroids (normalized mean window embedding, NaN for a class with no
  windows) from per-window embeddings;
- :func:`video_ac_scores`       <- ref ``eval.py:229-257``: AC is the L2
  distance of a video's normalized mean window embedding to its class
  centroid;
- :func:`video_tc_scores`       <- the per-video mean of the window TCs;
- :func:`finalize_centroids` / :func:`finalize_video_scores`: the same math
  applied to per-segment sums.

The scoring sweep takes its per-segment sums on the device by a one-hot GEMM
a batch (``pipelines/score.py::WindowEncoder``) and finalizes them here; the
functions on per-window values (``WindowEncoder.encode_bank``'s outputs) sum
by a one-hot product too (:func:`segment_mean`).
"""

from __future__ import annotations

import typing as T

import torch

from ..ops.deltas import l2_normalize

# rows of the one-hot product a step: [S, 8192] float64 is 64 KiB a segment
_SEGMENT_ROWS = 8192


def _segment_sums(
    values: torch.Tensor,                  # [N, ...]
    segment_ids: torch.Tensor,             # [N] int
    num_segments: int,
    weights: T.Optional[torch.Tensor],     # [N] 0/1 mask, or None
) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """``(sums [S, ...], counts [S])``: the rows of ``values`` (times their
    weight) and the weights summed per segment, as ``jax.ops.segment_sum``
    sums them (ids outside ``[0, S)`` are dropped). One-hot products in
    float64, rounded once to ``values``' dtype: the same order on every call
    and device (``index_add_`` on CUDA adds with atomics, and two calls could
    differ in their last bits), and TF32 never applies. A non-finite row
    makes every segment's sum non-finite (0 x inf)."""
    n = values.shape[0]
    w = (torch.ones(n, dtype=values.dtype, device=values.device) if weights is None
         else weights.to(values.dtype))
    flat = torch.cat([values.reshape(n, -1) * w[:, None], w[:, None]], dim=1).to(torch.float64)
    ids = torch.arange(num_segments, device=values.device)[:, None]
    out = torch.zeros((num_segments, flat.shape[1]), dtype=torch.float64, device=values.device)
    for lo in range(0, n, _SEGMENT_ROWS):
        onehot = (segment_ids[None, lo : lo + _SEGMENT_ROWS] == ids).to(torch.float64)
        out += onehot @ flat[lo : lo + _SEGMENT_ROWS]
    out = out.to(values.dtype)
    return out[:, :-1].reshape((num_segments,) + tuple(values.shape[1:])), out[:, -1]


def segment_mean(
    values: torch.Tensor,                        # [N, ...] per-window values
    segment_ids: torch.Tensor,                   # [N] int video index
    num_segments: int,
    weights: T.Optional[torch.Tensor] = None,    # [N] 0/1 validity mask
) -> torch.Tensor:
    """Mean of ``values`` per segment (count clamped to >= 1)."""
    sums, counts = _segment_sums(values, segment_ids, num_segments, weights)
    return sums / counts.clamp_min(1.0).reshape((-1,) + (1,) * (values.ndim - 1))


def build_centroids(
    embeddings: torch.Tensor,                    # [N, D] window CLS embeddings (normalized)
    labels: torch.Tensor,                        # [N] int class ids
    num_classes: int,
    weights: T.Optional[torch.Tensor] = None,    # [N] 0/1 validity mask
) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """``(centroids [C, D], counts [C])``: each class's normalized mean
    embedding, NaN for a class with zero windows."""
    sums, counts = _segment_sums(embeddings, labels, num_classes, weights)
    return finalize_centroids(sums, counts), counts


def tc_per_window(frame_embeds: torch.Tensor) -> torch.Tensor:
    """``[B, T+1, D]`` normalized frame embeddings (CLS at index 0) -> ``[B]``."""
    frames = frame_embeds[:, 1:, :]
    diffs = frames[:, 1:, :] - frames[:, :-1, :]
    return torch.sqrt(torch.sum(diffs * diffs, dim=-1)).mean(dim=-1)


def finalize_centroids(seq_sum: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``[C, D]`` per-class embedding sums and ``[C]`` window counts -> the
    L2-normalized class centroids; NaN rows for classes with zero windows
    (a zero centroid would give every video of that class ac = 1.0)."""
    mean = seq_sum / count.clamp_min(1.0)[:, None]
    centroids = torch.where(count[:, None] > 0, mean, torch.full_like(mean, float("nan")))
    return l2_normalize(centroids, axis=-1)


def finalize_video_scores(
    seq_sum: torch.Tensor,      # [V, D] per-video embedding sums
    tc_sum: torch.Tensor,       # [V] per-video window-TC sums
    count: torch.Tensor,        # [V] window counts
    video_label: torch.Tensor,  # [V] class id per video
    centroids: torch.Tensor,    # [C, D]
) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """``(ac [V], tc [V])`` from per-video sums."""
    cnt = count.clamp_min(1.0)
    tc_v = tc_sum / cnt
    z_mean = l2_normalize(seq_sum / cnt[:, None], axis=-1)
    d = z_mean - centroids[video_label.long()]
    return torch.sqrt(torch.sum(d * d, dim=-1)), tc_v


def video_tc_scores(
    window_tc: torch.Tensor,                     # [N]
    window_video: torch.Tensor,                  # [N] video index per window
    num_videos: int,
    weights: T.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[V]`` mean window TC per video."""
    return segment_mean(window_tc, window_video, num_videos, weights)


def video_ac_scores(
    seq_embeds: torch.Tensor,                    # [N, D] window CLS embeddings
    window_video: torch.Tensor,                  # [N] video index per window
    video_label: torch.Tensor,                   # [V] class id per video
    centroids: torch.Tensor,                     # [C, D]
    weights: T.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[V]`` L2 distance from each video's normalized mean window embedding
    to its class centroid."""
    sums, counts = _segment_sums(seq_embeds, window_video, video_label.shape[0], weights)
    return finalize_video_scores(sums, torch.zeros_like(counts), counts, video_label, centroids)[0]
