"""Shared utilities: canonical names and npz reading."""

from .names import ACTION_CLASSES, canonicalize_class, infer_class_from_name, norm_name

__all__ = [
    "ACTION_CLASSES",
    "canonicalize_class",
    "norm_name",
    "infer_class_from_name",
]
