"""Metrics: AC/TC from per-window values or per-segment sums, class
centroids, rank correlations."""

from .correlation import match_and_correlate, pearson, spearman
from .scores import (
    build_centroids,
    finalize_centroids,
    finalize_video_scores,
    segment_mean,
    tc_per_window,
    video_ac_scores,
    video_tc_scores,
)

__all__ = [
    "build_centroids",
    "tc_per_window",
    "segment_mean",
    "video_ac_scores",
    "video_tc_scores",
    "spearman",
    "pearson",
    "match_and_correlate",
    "finalize_centroids",
    "finalize_video_scores",
]
