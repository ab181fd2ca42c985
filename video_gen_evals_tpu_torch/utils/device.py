"""Device and matmul-precision checks shared by the port's entry points."""

from __future__ import annotations

import typing as T

import torch


def resolve_device(device: T.Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the entry points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def disable_tf32() -> None:
    """fp32 matmuls outside the kernels: TF32 would be a coarser class than
    any of the kernels' precision modes, so both flags are set off and checked."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled")
