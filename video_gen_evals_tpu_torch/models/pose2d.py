"""Frozen BatchNorm of the extraction networks.

Port of ``video_gen_evals_tpu/models/pose2d.py::BatchNormInference``, here
only what the Faster R-CNN uses; YOLOX and RTMPose extend this module when
they are ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNormInference(nn.Module):
    """detectron2's ``FrozenBatchNorm2d`` on NCHW input: ``(x - mean) *
    (weight * rsqrt(var + eps)) + bias``, the statistics fixed buffers
    with detectron2's names (``weight``, ``bias``, ``running_mean``,
    ``running_var``). The JAX module computes the same affine map on NHWC."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_statistics(self) -> None:
        """The identity map: weight and variance one, bias and mean zero."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
