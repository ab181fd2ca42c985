"""Geometry deltas, temporal corruptions and the port's Hopper kernels.

``window_kernel.gather_windows`` (K1) and ``.gather_windows_subblock`` (K2),
``conv_kernel.fused_temporal_block`` (K3) and
``.fused_temporal_block_stacked`` (K9), ``chain_kernel.fused_temporal_chain``
(K10), ``conv_kernel_train.fused_temporal_block_train`` (K4, forward and
backward), ``attention_core.mha_core`` / ``.mha_head_batched`` (K6, K7) and
``attention.flash_attention`` (K8) launch CUDA kernels built from ``csrc/``
for CUDA tensors and run their plain PyTorch versions for CPU tensors."""

from .deltas import betas_delta, l2_normalize, vit_delta
from .procrustes import procrustes_kp_delta
from .so3 import log_so3, rotmat_delta

__all__ = [
    "betas_delta",
    "l2_normalize",
    "vit_delta",
    "procrustes_kp_delta",
    "log_so3",
    "rotmat_delta",
]
