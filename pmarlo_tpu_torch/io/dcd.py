"""DCD trajectory interop: native C++ codec with pure-Python fallback.

The reference reads/writes DCD through mdtraj's C plugin (src/pmarlo/io/
trajectory.py:100, trajectory_writer.py:192). Here the codec is
first-party: ``native/dcd.cpp`` compiled on demand (ctypes, no pybind11
needed), with a NumPy struct-level fallback when no compiler is available.
Coordinates are nm on the Python side, Angstrom on disk (DCD convention).

Host copy of ``pmarlo_tpu/io/dcd.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import ctypes
import logging
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("pmarlo_tpu")

_lib: Optional[ctypes.CDLL] = None
_native_failed = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile native/dcd.cpp on demand (shared recipe: _native_build)."""
    global _lib, _native_failed
    if _lib is not None or _native_failed:
        return _lib
    from ._native_build import build_native

    lib = build_native("dcd.cpp", "libpmarlo_dcd")
    if lib is None:
        _native_failed = True
        return None
    try:
        lib.pmarlo_dcd_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
        ]
        lib.pmarlo_dcd_write.restype = ctypes.c_int
        lib.pmarlo_dcd_write_cells.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.pmarlo_dcd_write_cells.restype = ctypes.c_int
        lib.pmarlo_dcd_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pmarlo_dcd_probe.restype = ctypes.c_int
        lib.pmarlo_dcd_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.pmarlo_dcd_read.restype = ctypes.c_int
        _lib = lib
    except OSError as exc:
        logger.info("native DCD codec unavailable (%s); using Python fallback", exc)
        _native_failed = True
    return _lib


# --- pure-Python fallback -------------------------------------------------------

def _py_write(path: Path, coords_ang: np.ndarray, dt_ps: float,
              save_interval: int, cell: "np.ndarray | None" = None):
    """``cell``: optional X-PLOR/CHARMM unit-cell record(s)
    [a, cos(gamma), b, cos(beta), cos(alpha), c] in Angstrom (the VMD
    dcdplugin heuristic reads values in [-1, 1] as cosines) — a (6,)
    constant cell or (T, 6) per-frame cells (NPT traces)."""
    n_frames, n_atoms = coords_ang.shape[:2]
    if cell is not None:
        cell = np.asarray(cell, dtype="<f8")
        if cell.ndim == 1:
            cell = np.broadcast_to(cell, (n_frames, 6))
        elif cell.shape != (n_frames, 6):
            raise ValueError(
                f"cell must be (6,) or (T, 6); got {cell.shape} for "
                f"{n_frames} frames"
            )
    with path.open("wb") as f:
        def rec(payload: bytes):
            f.write(struct.pack("<i", len(payload)))
            f.write(payload)
            f.write(struct.pack("<i", len(payload)))

        icntrl = [0] * 20
        icntrl[0] = n_frames
        icntrl[1] = 1
        icntrl[2] = save_interval
        icntrl[3] = n_frames * save_interval
        delta = struct.unpack("<i", struct.pack("<f", dt_ps / 0.0488882129))[0]
        icntrl[9] = delta
        icntrl[10] = 0 if cell is None else 1
        icntrl[19] = 24
        rec(b"CORD" + struct.pack("<20i", *icntrl))
        title = b"Created by pmarlo_tpu python DCD writer".ljust(80)
        rec(struct.pack("<i", 1) + title)
        rec(struct.pack("<i", n_atoms))
        for t, frame in enumerate(coords_ang):
            if cell is not None:
                rec(np.ascontiguousarray(cell[t]).tobytes())
            for d in range(3):
                rec(frame[:, d].astype("<f4").tobytes())


def _iter_records(data: bytes):
    """Walk Fortran length-prefixed records — the ONE parser both
    _py_read and read_dcd_box use (two hand-rolled offset walkers would
    silently drift apart)."""
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<i", data, off)
        off += 4
        payload = data[off : off + n]
        off += n
        (n2,) = struct.unpack_from("<i", data, off)
        off += 4
        if n2 != n:
            raise ValueError("corrupt DCD record")
        yield payload


def _py_read(path: Path) -> np.ndarray:
    records = _iter_records(path.read_bytes())
    header = next(records)
    if header[:4] != b"CORD":
        raise ValueError(f"{path} is not a DCD file")
    icntrl = struct.unpack_from("<20i", header, 4)
    has_cell = icntrl[10] != 0
    next(records)  # title
    (n_atoms,) = struct.unpack("<i", next(records))
    frames = []
    for rec0 in records:
        if has_cell:
            rec0 = next(records)  # skip the cell, take X
        axes = [np.frombuffer(rec0, dtype="<f4")] + [
            np.frombuffer(next(records), dtype="<f4") for _ in range(2)
        ]
        frames.append(np.stack(axes, axis=1))
    if not frames:
        # a header-only file (writer died before frame 1) must still
        # report its atom count and a (0, N, 3) shape, not a (0,) array
        return np.zeros((0, n_atoms, 3), dtype=np.float32)
    return np.asarray(frames)


# --- public API --------------------------------------------------------------------

def write_dcd(
    path: "str | Path",
    coordinates_nm: np.ndarray,
    *,
    dt_ps: float = 0.002,
    save_interval: int = 1,
    box: "Tuple[float, float, float] | None" = None,
    tilt: "Tuple[float, float, float] | None" = None,
) -> Path:
    """Write (T, N, 3) nm coordinates as a DCD file.

    ``box``/``tilt`` (nm, md/box.py convention; each may be a single
    (3,) cell or (T, 3) per-frame values for NPT traces) emit
    per-frame X-PLOR/CHARMM unit-cell records [a, cos(gamma), b,
    cos(beta), cos(alpha), c] in Angstrom — the layout VMD/mdtraj
    read. Cell writing uses the Python path (the native fast path
    handles the no-cell layout only; the native READER skips cell
    records fine)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    coords = np.ascontiguousarray(
        np.asarray(coordinates_nm, dtype=np.float32) * 10.0
    )
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coordinates must be (T, N, 3), got {coords.shape}")
    if box is not None:
        from ..md.box import to_lengths_angles

        box_arr = np.atleast_2d(np.asarray(box, np.float64))     # (T|1, 3)
        tilt_arr = (np.atleast_2d(np.asarray(tilt, np.float64))
                    if tilt is not None else None)

        def one_cell(k):
            tk = None
            if tilt_arr is not None:
                tk = tilt_arr[min(k, tilt_arr.shape[0] - 1)]
            a, b, c, al, be, ga = to_lengths_angles(
                box_arr[min(k, box_arr.shape[0] - 1)], tk
            )
            return [a * 10.0, np.cos(np.deg2rad(ga)), b * 10.0,
                    np.cos(np.deg2rad(be)), np.cos(np.deg2rad(al)),
                    c * 10.0]

        if box_arr.shape[0] == 1 and (tilt_arr is None
                                      or tilt_arr.shape[0] == 1):
            cell = np.array(one_cell(0))
        else:
            cell = np.array([one_cell(k) for k in range(coords.shape[0])])
        lib = _load_native()
        if lib is not None and hasattr(lib, "pmarlo_dcd_write_cells"):
            cells = np.ascontiguousarray(
                np.broadcast_to(cell, (coords.shape[0], 6)), np.float64
            )
            rc = lib.pmarlo_dcd_write_cells(
                str(path).encode(),
                coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                coords.shape[0], coords.shape[1], dt_ps, save_interval,
                cells.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            if rc != 0:
                raise IOError(f"native DCD write failed with code {rc}")
        else:
            _py_write(path, coords, dt_ps, save_interval, cell=cell)
        return path
    lib = _load_native()
    if lib is not None:
        rc = lib.pmarlo_dcd_write(
            str(path).encode(),
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            coords.shape[0], coords.shape[1], dt_ps, save_interval,
        )
        if rc != 0:
            raise IOError(f"native DCD write failed with code {rc}")
    else:
        _py_write(path, coords, dt_ps, save_interval)
    return path


def probe_dcd(path: "str | Path") -> Tuple[int, int]:
    """(n_frames, n_atoms) without reading coordinates."""
    path = Path(path)
    lib = _load_native()
    if lib is not None:
        nf = ctypes.c_int64()
        na = ctypes.c_int64()
        hc = ctypes.c_int32()
        rc = lib.pmarlo_dcd_probe(str(path).encode(), ctypes.byref(nf),
                                  ctypes.byref(na), ctypes.byref(hc))
        if rc != 0:
            raise IOError(f"native DCD probe failed with code {rc}")
        return int(nf.value), int(na.value)
    arr = _py_read(path)
    return arr.shape[0], arr.shape[1]


def read_dcd_box(
    path: "str | Path",
) -> "Tuple[Tuple[float, float, float], Tuple[float, float, float] | None] | None":
    """(box, tilt) in nm from the FIRST frame's unit-cell record, or
    None for cell-less files. Applies the VMD dcdplugin heuristic:
    angle slots in [-1, 1] are cosines, otherwise degrees."""
    path = Path(path)
    records = _iter_records(path.read_bytes())
    header = next(records)
    if header[:4] != b"CORD":
        raise ValueError(f"{path} is not a DCD file")
    icntrl = struct.unpack_from("<20i", header, 4)
    if icntrl[10] == 0:
        return None
    next(records)  # title
    next(records)  # natoms
    payload = next(records)
    if len(payload) != 48:
        raise ValueError(f"unexpected unit-cell record size {len(payload)}")
    cell = np.frombuffer(payload, dtype="<f8", count=6)

    def ang(v):
        return float(np.rad2deg(np.arccos(np.clip(v, -1.0, 1.0)))
                     if abs(v) <= 1.0 else v)

    a, b, c = cell[0] / 10.0, cell[2] / 10.0, cell[5] / 10.0
    gamma, beta, alpha = ang(cell[1]), ang(cell[3]), ang(cell[4])
    from ..md.box import from_lengths_angles

    return from_lengths_angles(a, b, c, alpha, beta, gamma)


def read_dcd(
    path: "str | Path", start: int = 0, count: Optional[int] = None
) -> np.ndarray:
    """Read (T, N, 3) coordinates in nm."""
    path = Path(path)
    lib = _load_native()
    if lib is not None:
        n_frames, n_atoms = probe_dcd(path)
        if count is None:
            count = n_frames - start
        count = max(min(count, n_frames - start), 0)
        if count == 0:
            # the native reader rejects count <= 0; an empty selection
            # (or a header-only file) is still a valid (0, N, 3) result
            return np.zeros((0, n_atoms, 3), dtype=np.float32)
        out = np.empty((count, n_atoms, 3), dtype=np.float32)
        rc = lib.pmarlo_dcd_read(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            start, count, n_atoms,
        )
        if rc != 0:
            raise IOError(f"native DCD read failed with code {rc}")
        return out / 10.0
    arr = _py_read(path)
    arr = arr[start : None if count is None else start + count]
    return arr.astype(np.float32) / 10.0


__all__ = ["write_dcd", "read_dcd", "read_dcd_box", "probe_dcd"]
