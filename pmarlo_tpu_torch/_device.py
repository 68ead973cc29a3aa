"""Default device for the plain-PyTorch analysis functions."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU (as JAX picks
    its default backend). Used by functions whose callers pass no device,
    such as the MSM stack under ``analysis.discretize``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


__all__ = ["default_device"]
