"""Native trajectory store: time-major npz tensors + JSON metadata.

The reference streams DCD via mdtraj's C plugins with fd-level log
suppression and chunked atomic rewrites (src/pmarlo/io/trajectory.py:136,
trajectory_writer.py:192,295). The TPU-native framework's canonical format
is npz: device arrays dump straight to it, it is seekable via memory
mapping, and it needs no C parser. The reader/writer protocols mirror the
reference's (io/trajectory_reader.py:31, trajectory_writer.py:146).

Host copy of ``pmarlo_tpu/io/trajectory.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TrajectoryWriter:
    """Buffered npz trajectory writer with atomic finalize.

    Frames are (N, 3) float32 nm. ``flush_interval`` bounds the host-memory
    buffer by spilling to intermediate part-files that ``close`` merges —
    the append-safety role of the reference's chunked rewrite
    (io/trajectory_writer.py:295) without the quadratic rewrite cost.
    """

    path: Path
    metadata: Dict = dataclasses.field(default_factory=dict)
    flush_interval: int = 10_000
    _frames: list = dataclasses.field(default_factory=list)
    _parts: list = dataclasses.field(default_factory=list)
    _closed: bool = False
    _part_n_atoms: "int | None" = None

    def __post_init__(self):
        self.path = Path(self.path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write_frames(self, frames: np.ndarray) -> None:
        if self._closed:
            raise RuntimeError("writer already closed")
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        if frames.ndim != 3 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be (T, N, 3), got {frames.shape}")
        prev = None
        if self._frames:
            prev = self._frames[-1].shape[1]
        elif self._parts:
            prev = self._part_n_atoms
        if prev is not None and frames.shape[1] != prev:
            raise ValueError(
                f"atom count changed mid-trajectory: {frames.shape[1]} "
                f"vs {prev}"
            )
        self._part_n_atoms = frames.shape[1]
        self._frames.append(frames)
        if sum(f.shape[0] for f in self._frames) >= self.flush_interval:
            self._spill()

    def _spill(self) -> None:
        if not self._frames:
            return
        part = self.path.with_suffix(f".part{len(self._parts)}.npy")
        np.save(part, np.concatenate(self._frames, axis=0))
        self._parts.append(part)
        self._frames = []

    def close(self) -> Path:
        if self._closed:
            return self.path
        chunks = [np.load(p) for p in self._parts] + (
            [np.concatenate(self._frames, axis=0)] if self._frames else []
        )
        coords = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.zeros((0, 0, 3), dtype=np.float32)
        )
        tmp = self.path.with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp, coordinates=coords, metadata=json.dumps(self.metadata)
        )
        tmp.replace(self.path)
        for p in self._parts:
            p.unlink(missing_ok=True)
        self._frames, self._parts = [], []
        self._closed = True
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass
class TrajectoryReader:
    """Reader over npz (native), DCD, XTC, TRR, and Amber NetCDF
    trajectories, selected by extension (the backend-registry role of
    reference io/trajectory_reader.py:128 — the full extension set of
    reference :187)."""

    path: Path

    def __post_init__(self):
        self.path = Path(self.path)
        if not self.path.exists():
            raise FileNotFoundError(self.path)
        self._fmt = {
            ".dcd": "dcd", ".xtc": "xtc", ".trr": "trr", ".nc": "nc"
        }.get(self.path.suffix.lower(), "npz")

    def load(self) -> np.ndarray:
        if self._fmt == "dcd":
            from .dcd import read_dcd

            return read_dcd(self.path)
        if self._fmt == "xtc":
            from .xtc import read_xtc

            return read_xtc(self.path)
        if self._fmt == "trr":
            from .trr import read_trr

            return read_trr(self.path)
        if self._fmt == "nc":
            from .netcdf import read_netcdf

            return read_netcdf(self.path)
        with np.load(self.path) as data:
            return np.asarray(data["coordinates"])

    def metadata(self) -> Dict:
        if self._fmt != "npz":
            return {"format": self._fmt}
        with np.load(self.path) as data:
            if "metadata" in data:
                return json.loads(str(data["metadata"]))
        return {}

    def probe_length(self) -> int:
        """Frame count without materializing coordinates
        (reference io/trajectory_reader.py:269)."""
        if self._fmt == "dcd":
            from .dcd import probe_dcd

            return probe_dcd(self.path)[0]
        if self._fmt == "xtc":
            from .xtc import probe_xtc

            return probe_xtc(self.path)[0]
        if self._fmt == "trr":
            from .trr import probe_trr

            return probe_trr(self.path)[0]
        if self._fmt == "nc":
            from .netcdf import probe_netcdf

            return probe_netcdf(self.path)[0]
        with np.load(self.path) as data:
            return int(data["coordinates"].shape[0])

    def iter_frames(
        self, chunk: int = 1000, stride: int = 1, start: int = 0, stop: Optional[int] = None
    ) -> Iterator[np.ndarray]:
        coords = self.load()[start:stop:stride]
        for off in range(0, coords.shape[0], chunk):
            yield coords[off : off + chunk]


def iterload(
    path: "str | Path", chunk: int = 1000, stride: int = 1
) -> Iterator[np.ndarray]:
    """Chunked coordinate iteration (reference io/trajectory.py:136)."""
    yield from TrajectoryReader(Path(path)).iter_frames(chunk=chunk, stride=stride)


def get_reader(path: "str | Path") -> TrajectoryReader:
    return TrajectoryReader(Path(path))


def _cell_for_frames(metadata: Dict, n_frames: int):
    """(box, tilt) for a format writer: static (3,) tuples, or
    per-frame (T, 3) arrays when the metadata carries an NPT
    ``box_trace`` — the evolving lattice must land in the file, not
    the build-time cell (density/wrapping read from the file would
    otherwise be wrong for every frame after the first accepted volume
    move). Tilt scales with the traced diagonal via the invariant
    ratios (md/box.py tilt_ratios)."""
    box = metadata.get("box")
    tilt = metadata.get("tilt")
    trace = metadata.get("box_trace")
    if box is None:
        return None, None
    if trace is not None:
        tr = np.asarray(trace, np.float64)
        if tr.ndim == 2 and tr.shape == (n_frames, 3):
            if tilt is None:
                return tr, None
            s = tr[:, :1] / float(box[0])
            return tr, s * np.asarray(tilt, np.float64)
    return tuple(box), (tuple(tilt) if tilt is not None else None)


@dataclasses.dataclass
class DCDTrajectoryWriter:
    """Buffered DCD writer (native C++ codec via io.dcd)."""

    path: Path
    metadata: Dict = dataclasses.field(default_factory=dict)
    _frames: list = dataclasses.field(default_factory=list)
    _closed: bool = False

    def __post_init__(self):
        self.path = Path(self.path)

    def write_frames(self, frames: np.ndarray) -> None:
        if self._closed:
            raise RuntimeError("writer already closed")
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        self._frames.append(frames)

    def close(self) -> Path:
        if self._closed:
            return self.path
        from .dcd import write_dcd

        coords = (
            np.concatenate(self._frames, axis=0)
            if self._frames else np.zeros((0, 0, 3), np.float32)
        )
        box, tilt = _cell_for_frames(self.metadata, coords.shape[0])
        write_dcd(
            self.path, coords,
            dt_ps=float(self.metadata.get("dt_ps", 0.002)),
            save_interval=int(self.metadata.get("report_interval", 1)),
            box=box, tilt=tilt,
        )
        self._frames = []
        self._closed = True
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass
class XTCTrajectoryWriter:
    """Buffered XTC writer (native C++ codec via io.xtc)."""

    path: Path
    metadata: Dict = dataclasses.field(default_factory=dict)
    _frames: list = dataclasses.field(default_factory=list)
    _closed: bool = False

    def __post_init__(self):
        self.path = Path(self.path)

    def write_frames(self, frames: np.ndarray) -> None:
        if self._closed:
            raise RuntimeError("writer already closed")
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 2:
            frames = frames[None]
        self._frames.append(frames)

    def close(self) -> Path:
        if self._closed:
            return self.path
        from .xtc import write_xtc

        coords = (
            np.concatenate(self._frames, axis=0)
            if self._frames else np.zeros((0, 0, 3), np.float32)
        )
        dt = float(self.metadata.get("dt_ps", 0.002))
        interval = int(self.metadata.get("report_interval", 1))
        T = coords.shape[0]
        box, tilt = _cell_for_frames(self.metadata, T)
        if box is not None:
            from ..md.box import box_matrix

            box_np = np.atleast_2d(np.asarray(box, np.float64))
            if box_np.shape[0] == 1:
                box_nm = np.asarray(box_matrix(box_np[0], tilt), np.float32)
            else:
                tilt_np = (np.asarray(tilt, np.float64)
                           if tilt is not None else None)
                box_nm = np.stack([
                    np.asarray(box_matrix(
                        box_np[k],
                        None if tilt_np is None else tilt_np[k],
                    ), np.float32)
                    for k in range(box_np.shape[0])
                ])
        else:
            box_nm = None
        write_xtc(
            self.path, coords,
            steps=np.arange(T, dtype=np.int32) * interval,
            times_ps=np.arange(T, dtype=np.float32) * (dt * interval),
            box_nm=box_nm,
        )
        self._frames = []
        self._closed = True
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def get_writer(path: "str | Path", metadata: Optional[Dict] = None):
    """Writer dispatch by extension: .dcd -> native DCD codec, .xtc -> native
    XTC codec, else npz (the backend-registry role of reference
    io/trajectory_writer.py:123)."""
    path = Path(path)
    if path.suffix.lower() == ".dcd":
        return DCDTrajectoryWriter(path, metadata=metadata or {})
    if path.suffix.lower() == ".xtc":
        return XTCTrajectoryWriter(path, metadata=metadata or {})
    return TrajectoryWriter(path, metadata=metadata or {})


__all__ = [
    "TrajectoryWriter",
    "TrajectoryReader",
    "DCDTrajectoryWriter",
    "XTCTrajectoryWriter",
    "iterload",
    "get_reader",
    "get_writer",
]
