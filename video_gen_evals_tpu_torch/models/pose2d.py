"""Frozen BatchNorm and the conv blocks of the extraction networks.

Port of the building blocks of ``video_gen_evals_tpu/models/pose2d.py``:
:class:`BatchNormInference`, :class:`ConvBN` and :class:`SPPBottleneck`, here
what the Faster R-CNN and YOLOX use; RTMPose's blocks join them when the 2D
pose net is ported (ROADMAP.md, Queue 1). The JAX modules work on NHWC; these
work on NCHW, with the published torch checkpoints' names.
"""

from __future__ import annotations

import typing as T

import torch
import torch.nn.functional as F
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


class TrackedBatchNorm(BatchNormInference):
    """:class:`BatchNormInference` under ``nn.BatchNorm2d``'s state_dict
    names, which include the training counter ``num_batches_tracked``
    (loaded, never read), so that mmcv and Megvii checkpoints load strictly."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(channels, eps)
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))


class ConvBN(nn.Module):
    """mmcv ``ConvModule`` / Megvii ``BaseConv``: ``Conv2d(bias=False)``, the
    frozen norm, SiLU; padding ``kernel // 2``. Names ``conv.*`` and ``bn.*``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = TrackedBatchNorm(cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling: a 1x1 conv to half the channels, max pools of
    ``kernel_sizes`` at stride 1 (padded with -inf, as flax's ``max_pool``
    pads), the input and the pools concatenated, a 1x1 conv to ``cout``.
    Megvii's names: ``conv1``, ``conv2`` (its ``m`` pools hold no weights)."""

    def __init__(self, cin: int, cout: int, kernel_sizes: T.Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        mid = cin // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvBN(cin, mid, kernel=1)
        self.conv2 = ConvBN(mid * (len(self.kernel_sizes) + 1), cout, kernel=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, stride=1, padding=k // 2) for k in self.kernel_sizes]
        return self.conv2(torch.cat([x, *pools], dim=1))
