"""Trajectory featurization entry point (reference: src/pmarlo/features/featurize.py:17).

Port of ``pmarlo_tpu/features/featurize.py``: the feature matrix is a
tensor on the device the features were computed on. A tensor is featurized
on its own device, a host array on ``device`` or, when that is None, on
``_device.default_device()`` (the card when there is one), as JAX computes
on its default backend whatever array it is given. Takes a (T, N, 3)
coordinate tensor (device or host), a spec, and topology info; concatenates
all requested feature blocks into one (T, K) matrix with per-column
periodicity flags.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import default_device
from .base import FeatureSpec, TopologyInfo, get_feature, parse_feature_spec
from .builtins import as_frames, trig_expand_periodic


def frames_on_device(traj, device=None) -> torch.Tensor:
    """``traj`` as (T, N, 3) frames: a tensor on its own device or, when
    ``device`` is given, moved there; a host array as float32 on ``device``,
    else on ``default_device()``. The placement rule of every entry point
    that takes frames (``featurize_trajectory``, the structure features)."""
    if isinstance(traj, torch.Tensor):
        return as_frames(traj if device is None else traj.to(device))
    device = torch.device(device) if device is not None else default_device()
    return as_frames(torch.as_tensor(np.asarray(traj), dtype=torch.float32, device=device))


def featurize_trajectory(
    traj,
    spec: "str | Sequence[str] | Sequence[FeatureSpec]",
    top: TopologyInfo,
    *,
    cos_sin_expand: bool = False,
    device=None,
) -> Tuple[torch.Tensor, Dict]:
    """Compute features for a trajectory.

    Returns ``(X, info)`` where ``X`` is (T, K) and ``info`` carries
    ``columns`` (feature names), ``periodic`` flags, and the canonical spec.
    With ``cos_sin_expand`` periodic columns are replaced by (cos, sin)
    pairs (reference api/features.py:138 trig_expand_periodic).

    A tensor ``traj`` is featurized on its own device (on ``device`` when
    one is given); a host array on ``device``, or on
    ``_device.default_device()`` when ``device`` is None. That matches
    JAX's placement: its features run on the default backend.
    """
    if spec and isinstance(spec, (list, tuple)) and isinstance(spec[0], FeatureSpec):
        specs = list(spec)
    else:
        specs = parse_feature_spec(spec)  # type: ignore[arg-type]
    traj = frames_on_device(traj, device)
    blocks: List[torch.Tensor] = []
    periodic: List[np.ndarray] = []
    columns: List[str] = []
    for fs in specs:
        feature = get_feature(fs.name, *fs.args)
        x = feature(traj, top)
        if x.ndim != 2 or x.shape[0] != traj.shape[0]:
            raise ValueError(
                f"feature {fs.canonical()} returned shape {x.shape}, expected "
                f"({traj.shape[0]}, K)"
            )
        blocks.append(x)
        p = feature.periodic(top)
        periodic.append(p)
        columns.extend(
            f"{fs.canonical()}[{i}]" if x.shape[1] > 1 else fs.canonical()
            for i in range(x.shape[1])
        )
    X = torch.cat(blocks, dim=1)
    per = np.concatenate(periodic)
    if cos_sin_expand and per.any():
        idx_per = np.where(per)[0]
        idx_aper = np.where(~per)[0]
        expanded = trig_expand_periodic(X[:, idx_per])
        X = torch.cat([X[:, idx_aper], expanded], dim=1)
        columns = (
            [columns[i] for i in idx_aper]
            + [f"cos({columns[i]})" for i in idx_per]
            + [f"sin({columns[i]})" for i in idx_per]
        )
        per = np.zeros(X.shape[1], dtype=bool)
    info = {
        "columns": columns,
        "periodic": per,
        "spec": [fs.canonical() for fs in specs],
    }
    return X, info


__all__ = ["featurize_trajectory"]
