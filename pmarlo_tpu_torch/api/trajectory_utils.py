"""Trajectory utility API (reference: src/pmarlo/api/trajectory_utils.py:14).

Host copy of ``pmarlo_tpu/api/trajectory_utils.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..features.base import TopologyInfo
from ..io.pdb import write_pdb
from ..io.trajectory import TrajectoryReader


def extract_last_frame_to_pdb(
    trajectory: "str | Path | np.ndarray",
    top: TopologyInfo,
    output_pdb: "str | Path",
) -> Path:
    """Write the final frame of a trajectory as a PDB
    (reference api/trajectory_utils.py:14) — the restart-seed pattern."""
    if isinstance(trajectory, (str, Path)):
        coords = TrajectoryReader(trajectory).load()
    else:
        coords = np.asarray(trajectory)
    if coords.ndim != 3 or coords.shape[0] == 0:
        raise ValueError(f"expected non-empty (T, N, 3) trajectory, got {coords.shape}")
    return write_pdb(
        output_pdb, coords[-1], top.atom_names, top.residue_names, top.residue_ids
    )


__all__ = ["extract_last_frame_to_pdb"]
