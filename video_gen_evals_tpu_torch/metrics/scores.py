"""TAG scores: per-window temporal coherence and the AC/TC finalize.

Port of ``video_gen_evals_tpu/metrics/scores.py`` (SURVEY C20-C21/C24):
- :func:`tc_per_window`         <- ref ``eval.py:209-226``: mean consecutive
  L2 distance between per-frame embeddings, CLS excluded;
- :func:`finalize_centroids`    <- ref ``utils.py:1018-1045`` applied to
  per-class sums: normalized mean embedding, NaN for a class with no windows;
- :func:`finalize_video_scores` <- ref ``eval.py:229-257``: AC is the L2
  distance of a video's normalized mean embedding to its class centroid, TC
  the mean of its window TCs.

The per-segment sums these finalize are taken on the device by a one-hot
GEMM a batch (``pipelines/score.py::WindowEncoder``).
"""

from __future__ import annotations

import typing as T

import torch

from ..ops.deltas import l2_normalize


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
