"""Data layer: manifests, window enumeration, modality statistics, the
feature bank (host- or device-built, cached on disk), its window gathers and
the PK batch sampler."""

from .features import (
    FeatureBank,
    ModalityPaths,
    build_feature_bank,
    build_feature_bank_cached,
    finalize_feature_bank,
    gather_windows,
    gather_windows_sliced,
)
from .manifest import (
    VideoItem,
    VideoManifest,
    scan_class_tree,
    scan_generated_flat,
    train_test_split,
)
from .sampler import PKBatchSampler
from .stats import ModalityStats, compute_stats, compute_stats_cached
from .windows import enumerate_windows

__all__ = [
    "FeatureBank",
    "ModalityPaths",
    "build_feature_bank",
    "build_feature_bank_cached",
    "finalize_feature_bank",
    "gather_windows",
    "gather_windows_sliced",
    "VideoItem",
    "VideoManifest",
    "scan_class_tree",
    "scan_generated_flat",
    "train_test_split",
    "PKBatchSampler",
    "ModalityStats",
    "compute_stats",
    "compute_stats_cached",
    "enumerate_windows",
]
