"""Training of the fusion encoder: losses, the step, checkpoints, the experiment."""

from .losses import (
    arc_margin_logits,
    hard_neg_infonce,
    margin_hard_negatives,
    supcon_hard_negatives,
    tcl_loss,
)

__all__ = [
    "tcl_loss",
    "supcon_hard_negatives",
    "hard_neg_infonce",
    "arc_margin_logits",
    "margin_hard_negatives",
]
