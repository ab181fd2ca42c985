"""Contrastive losses for the fusion encoder, as pure tensor functions.

Port of ``video_gen_evals_tpu/train/losses.py`` (reference ``losses.py``):

- :func:`tcl_loss`              <- ``TCL``                      (ref ``losses.py:6-34``)
- :func:`supcon_hard_negatives` <- ``SupConWithHardNegatives``  (ref ``losses.py:37-56``)
- :func:`hard_neg_infonce`      <- ``HardNegInfoNCE``           (ref ``losses.py:60-99``)
- :func:`arc_margin_logits`     <- ``ArcMarginProduct``         (ref ``losses.py:102-128``)
- :func:`margin_hard_negatives` <- ``MarginHardNegativesLoss``  (ref ``losses.py:131-156``)

All are stateless (weights passed explicitly). :func:`tcl_loss` divides by
each anchor's number of positives, as the JAX function does: an anchor with
none makes the loss NaN, which the training step's skip guard relies on.
"""

from __future__ import annotations

import math
import typing as T

import torch
import torch.nn.functional as F

from ..ops.deltas import l2_normalize


def tcl_loss(
    projections: torch.Tensor,   # [B, D] L2-normalized embeddings
    targets: torch.Tensor,       # [B] int labels
    temperature: float = 0.1,
    k1: float = 5000.0,
    k2: float = 1.0,
) -> torch.Tensor:
    """Tuned supervised contrastive loss. Denominator per anchor: sum over
    positives of exp(sim/tau) + k1 * sum over positives of exp(-sim) + k2 *
    sum over negatives of exp(sim/tau); numerator each positive pair's
    exp(sim/tau) (ref ``losses.py:31``)."""
    sim = projections @ projections.t()
    exp_t = torch.exp(sim / temperature)
    exp_n = torch.exp(-sim)
    same = targets[:, None] == targets[None, :]
    eye = torch.eye(projections.shape[0], dtype=torch.bool, device=sim.device)
    mask_pos = (same & ~eye).to(sim.dtype)
    mask_neg = (~same).to(sim.dtype)
    n_pos = mask_pos.sum(dim=1)
    denom = (
        (exp_t * mask_pos).sum(dim=1)
        + k1 * (exp_n * mask_pos).sum(dim=1)
        + k2 * (exp_t * mask_neg).sum(dim=1)
    )
    per_anchor = (-torch.log(exp_t / denom[:, None]) * mask_pos).sum(dim=1) / n_pos
    return per_anchor.mean()


def _ce_first_class(logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with the true class at index 0, mean over the batch."""
    return (torch.logsumexp(logits, dim=-1) - logits[:, 0]).mean()


def supcon_hard_negatives(
    anchor: torch.Tensor,         # [B, D]
    positive: torch.Tensor,       # [B, D]
    hard_negative: torch.Tensor,  # [B, D]
    temperature: float = 0.07,
) -> torch.Tensor:
    """2-way CE over (anchor.pos, anchor.hardneg) / tau (ref ``losses.py:37-56``)."""
    sim_ap = (anchor * positive).sum(dim=-1) / temperature
    sim_ah = (anchor * hard_negative).sum(dim=-1) / temperature
    return _ce_first_class(torch.stack([sim_ap, sim_ah], dim=1))


def hard_neg_infonce(
    anchor: torch.Tensor,                       # [B, D]
    negatives: torch.Tensor,                    # [B, D] or [B, K, D]
    positive: T.Optional[torch.Tensor] = None,  # optional [B, D]
    temperature: float = 0.07,
    neg_margin: float = 0.0,
    detach_neg: bool = True,
) -> torch.Tensor:
    """Anchor-vs-hard-negatives InfoNCE (ref ``losses.py:60-99``)."""
    p = anchor if positive is None else positive
    n = negatives if negatives.ndim == 3 else negatives[:, None, :]
    if detach_neg:
        n = n.detach()
    sim_ap = (anchor * p).sum(dim=-1, keepdim=True)                       # [B, 1]
    sim_an = torch.einsum("bd,bkd->bk", anchor, n) + neg_margin           # [B, K]
    return _ce_first_class(torch.cat([sim_ap, sim_an], dim=1) / temperature)


def arc_margin_logits(
    x: torch.Tensor,        # [B, D]
    labels: torch.Tensor,   # [B] int
    weight: torch.Tensor,   # [C, D] class prototypes
    s: float = 30.0,
    m: float = 0.30,
) -> torch.Tensor:
    """ArcFace margin logits (ref ``losses.py:102-128``); feed to CE."""
    cos = l2_normalize(x, axis=-1) @ l2_normalize(weight, axis=-1).t()    # [B, C]
    sin = torch.sqrt(1.0 - cos**2 + 1e-7)
    phi = cos * math.cos(m) - sin * math.sin(m)                           # cos(theta + m)
    one_hot = F.one_hot(labels.long(), weight.shape[0]).to(cos.dtype)
    return (one_hot * phi + (1.0 - one_hot) * cos) * s


def margin_hard_negatives(
    anchor: torch.Tensor,
    pos: torch.Tensor,
    neg: torch.Tensor,
    margin: float = 0.15,
    reduction: str = "mean",
) -> torch.Tensor:
    """Hinge max(0, margin - s_pos + s_neg) on cosine sims (ref ``losses.py:131-156``)."""
    loss = F.relu(margin - (anchor * pos).sum(dim=-1) + (anchor * neg).sum(dim=-1))
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
