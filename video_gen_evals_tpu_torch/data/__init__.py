"""Data layer: manifests, window enumeration, modality statistics, the
host-built feature bank and the PK batch sampler."""

from .features import (
    FeatureBank,
    ModalityPaths,
    build_feature_bank,
    finalize_feature_bank,
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
from .stats import ModalityStats, compute_stats
from .windows import enumerate_windows

__all__ = [
    "FeatureBank",
    "ModalityPaths",
    "build_feature_bank",
    "finalize_feature_bank",
    "gather_windows_sliced",
    "VideoItem",
    "VideoManifest",
    "scan_class_tree",
    "scan_generated_flat",
    "train_test_split",
    "PKBatchSampler",
    "ModalityStats",
    "compute_stats",
    "enumerate_windows",
]
