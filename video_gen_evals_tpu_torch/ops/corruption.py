"""Temporal corruptions of window batches: the training step's hard negatives.

Port of ``video_gen_evals_tpu/ops/corruption.py`` (ref ``utils.py:65-95``).
The shuffle is split in two so that both packages can be fed the same
indices: :func:`draw_shuffle_indices` draws, per sample, ``n = max(1,
int(f * T))`` distinct frame positions and a permutation of them, and
:func:`apply_partial_shuffle` is the pure function that moves the frames.
The draw is ``B x n`` integers: it always comes from a CPU generator and is
moved to the batch's device, so a CPU run and a card run of one seed see
the same corruption. The numbers differ from ``jax.random``'s for the same
seed; the distribution is the same.
"""

from __future__ import annotations

import typing as T

import torch


def draw_shuffle_indices(
    batch: int, t_len: int, generator: torch.Generator, shuffle_fraction: float = 0.7
) -> T.Tuple[torch.Tensor, torch.Tensor]:
    """``(positions [B, n], order [B, n])`` int64 on the CPU: the frames at
    ``positions[b]`` are replaced by those at ``positions[b][order[b]]``.
    ``n = 0`` for ``T = 1`` (nothing to shuffle)."""
    if generator.device.type != "cpu":
        raise ValueError("the shuffle indices are drawn with a CPU generator")
    n = max(1, int(shuffle_fraction * t_len)) if t_len > 1 else 0
    # a uniform random permutation per row: the argsort of iid uniforms
    positions = torch.rand((batch, t_len), generator=generator).argsort(dim=1)[:, :n]
    order = torch.rand((batch, n), generator=generator).argsort(dim=1)
    return positions, order


def apply_partial_shuffle(
    seqs: torch.Tensor, positions: torch.Tensor, order: torch.Tensor
) -> torch.Tensor:
    """``out[b, positions[b, i]] = seqs[b, positions[b, order[b, i]]]``, every
    other frame unchanged (JAX ``seq.at[positions].set(seq[positions][perm])``)."""
    positions = positions.to(seqs.device)
    source = torch.gather(positions, 1, order.to(seqs.device))
    rows = torch.arange(seqs.shape[0], device=seqs.device)[:, None]
    out = seqs.clone()
    out[rows, positions] = seqs[rows, source]
    return out


def partial_shuffle_within_window(
    seqs: torch.Tensor, generator: torch.Generator, shuffle_fraction: float = 0.7
) -> torch.Tensor:
    """Shuffle a random ``shuffle_fraction`` subset of frames within each
    window ``[B, T, D]`` (ref ``utils.py:65-75``)."""
    positions, order = draw_shuffle_indices(
        seqs.shape[0], seqs.shape[1], generator, shuffle_fraction)
    if positions.shape[1] == 0:
        return seqs
    return apply_partial_shuffle(seqs, positions, order)


def reverse_sequence(seqs: torch.Tensor) -> torch.Tensor:
    """Reverse along time (ref ``utils.py:78-86``)."""
    return seqs.flip(1)


def static_window(seqs: torch.Tensor) -> torch.Tensor:
    """Replace every frame with frame 0 (ref ``utils.py:88-95``)."""
    return seqs[:, :1, :].expand_as(seqs)
