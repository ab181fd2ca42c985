"""Human-study layer: the MOS rater-filtering pipeline (``mos``)."""

from .mos import (
    compute_mos_and_normalize,
    process_human_scores,
    stage1_repeated_video_consistency,
    stage2_subject_rejection,
    stage3_inter_rater_reliability,
)

__all__ = [
    "stage1_repeated_video_consistency",
    "stage2_subject_rejection",
    "stage3_inter_rater_reliability",
    "compute_mos_and_normalize",
    "process_human_scores",
]
