"""Demultiplexing: replica-major trajectories -> constant-temperature ones.

Rebuild of the removed ``pmarlo.demultiplexing.demux`` (reference
CHANGELOG.md:633,757-758: streaming demux of replica trajectories by
temperature, replaying the exchange history).

The in-memory engine (remd/remd.py) records rung-major — demuxed by
construction — so this module serves the *file-level* contract: given
replica-major trajectory files (one per walker) plus the exchange-history
permutation, stitch per-temperature trajectories; and the inverse.

Host copy of ``pmarlo_tpu/remd/demux.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..io.trajectory import TrajectoryReader, TrajectoryWriter


def demux_frames(
    replica_frames: np.ndarray,     # (F, R, N, 3) replica-major
    replica_ids: np.ndarray,        # (A+1, R): replica at rung r after attempt a
    frames_per_attempt: Optional[int] = None,
) -> np.ndarray:
    """Reorder replica-major frames into rung-major (per-temperature).

    ``replica_ids[a, r]`` is the walker simulating rung r during attempt
    chunk a (the state BEFORE attempt a's closing swap).
    """
    replica_frames = np.asarray(replica_frames)
    replica_ids = np.asarray(replica_ids)
    F, R = replica_frames.shape[:2]
    n_attempts = max(replica_ids.shape[0] - 1, 1)
    fpc = frames_per_attempt or max(F // n_attempts, 1)
    out = np.empty_like(replica_frames)
    for f in range(F):
        a = min(f // fpc, n_attempts - 1)
        perm = replica_ids[a]               # rung -> replica id
        out[f] = replica_frames[f, perm]
    return out


def remux_frames(
    rung_frames: np.ndarray,
    replica_ids: np.ndarray,
    frames_per_attempt: Optional[int] = None,
) -> np.ndarray:
    """Inverse of demux_frames: rung-major -> replica-major."""
    rung_frames = np.asarray(rung_frames)
    replica_ids = np.asarray(replica_ids)
    F, R = rung_frames.shape[:2]
    n_attempts = max(replica_ids.shape[0] - 1, 1)
    fpc = frames_per_attempt or max(F // n_attempts, 1)
    out = np.empty_like(rung_frames)
    for f in range(F):
        a = min(f // fpc, n_attempts - 1)
        perm = replica_ids[a]
        inv = np.empty(R, dtype=np.int64)
        inv[perm] = np.arange(R)
        out[f] = rung_frames[f, inv]
    return out


def demux_trajectory_files(
    replica_files: Sequence["str | Path"],
    replica_ids: np.ndarray,
    temperatures: Sequence[float],
    output_dir: "str | Path",
    *,
    frames_per_attempt: Optional[int] = None,
    chunk: int = 1000,
) -> List[Path]:
    """Streaming file-level demux (reference CHANGELOG.md:633).

    ``replica_files[i]`` holds walker i's frames. Writes one npz per
    temperature rung, streaming in chunks so no full trajectory
    materializes (the reference's streaming requirement).
    """
    readers = [TrajectoryReader(p) for p in replica_files]
    lengths = {r.probe_length() for r in readers}
    if len(lengths) != 1:
        raise ValueError(f"replica trajectories differ in length: {sorted(lengths)}")
    F = lengths.pop()
    R = len(readers)
    replica_ids = np.asarray(replica_ids)
    n_attempts = max(replica_ids.shape[0] - 1, 1)
    fpc = frames_per_attempt or max(F // n_attempts, 1)

    output_dir = Path(output_dir)
    writers = [
        TrajectoryWriter(
            output_dir / f"demux_T{temperatures[r]:g}.npz",
            metadata={"temperature_K": float(temperatures[r]), "rung": r},
        )
        for r in range(R)
    ]
    iters = [r.iter_frames(chunk=chunk) for r in readers]
    frame_offset = 0
    try:
        for chunks in zip(*iters):
            size = chunks[0].shape[0]
            stacked = np.stack(chunks, axis=1)  # (size, R, N, 3)
            for local in range(size):
                f = frame_offset + local
                a = min(f // fpc, n_attempts - 1)
                perm = replica_ids[a]
                for rung in range(R):
                    writers[rung].write_frames(stacked[local, perm[rung]][None])
            frame_offset += size
    finally:
        paths = [w.close() for w in writers]
    return paths


__all__ = ["demux_frames", "remux_frames", "demux_trajectory_files"]
