"""Geometry deltas, temporal corruptions and the port's Hopper kernels.

``window_kernel.gather_windows`` (K1) and ``.gather_windows_subblock`` (K2),
``conv_kernel.fused_temporal_block`` (K3) and
``.fused_temporal_block_stacked`` (K9), ``chain_kernel.fused_temporal_chain``
(K10), ``conv_kernel_train.fused_temporal_block_train`` (K4, forward and
backward), ``attention_core.mha_core`` / ``.mha_head_batched`` (K6, K7) and
``attention.flash_attention`` (K8) launch CUDA kernels built from ``csrc/``
for CUDA tensors and run their plain PyTorch versions for CPU tensors.
Each wrapper counts its kernel launches; :func:`launch_counts` reads the
counts of the kernels a data-parallel rank runs."""

from .corruption import partial_shuffle_within_window, reverse_sequence, static_window
from .deltas import betas_delta, l2_normalize, vit_delta
from .procrustes import procrustes_kp_delta
from .so3 import axis_angle_delta, axis_angle_to_matrix, log_so3, rotmat_delta


def launch_counts() -> dict:
    """This process's kernel launches so far: K1, K3, K4's forward and
    backward (3 launches a call), K5 and K6, by wrapper name."""
    from .attention_core import mha_core
    from .conv_kernel import fused_temporal_block
    from .conv_kernel_train import fused_temporal_block_train
    from .roi_align import roi_align_pyramid_dma
    from .window_kernel import gather_windows

    return {
        "gather_windows": gather_windows.launches,
        "fused_temporal_block": fused_temporal_block.launches,
        "fused_temporal_block_train": fused_temporal_block_train.launches,
        "fused_temporal_block_train_bwd": fused_temporal_block_train.launches_bwd,
        "roi_align_pyramid_dma": roi_align_pyramid_dma.launches,
        "mha_core": mha_core.launches,
    }


__all__ = [
    "launch_counts",
    "betas_delta",
    "l2_normalize",
    "vit_delta",
    "procrustes_kp_delta",
    "axis_angle_to_matrix",
    "log_so3",
    "rotmat_delta",
    "axis_angle_delta",
    "partial_shuffle_within_window",
    "reverse_sequence",
    "static_window",
]
