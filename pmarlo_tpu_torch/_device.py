"""Default device for the plain-PyTorch analysis functions, and small host
constants kept on a device."""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS = {}


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU (as JAX picks
    its default backend). Used by functions whose callers pass no device,
    such as the MSM stack under ``analysis.discretize``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def host_constant(values, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``values`` (a box, cell or mesh counts, a lattice matrix) as a tensor
    of ``like``'s device and dtype (or ``dtype``), copied there once and
    kept: a copy from the host waits for the card's stream, which a loop
    that reads nothing back must not do on every call."""
    a = np.asarray(values, np.float64)
    dtype = like.dtype if dtype is None else dtype
    key = (a.tobytes(), a.shape, dtype, like.device)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=like.device)
    return _CONSTANTS[key]


__all__ = ["default_device", "host_constant"]
