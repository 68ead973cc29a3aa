"""TRR (GROMACS full-precision) trajectory interop, pure Python.

The reference lists ``.trr`` among its topology-requiring trajectory formats
(src/pmarlo/io/trajectory_reader.py:187) and reads it through mdtraj.
TRR is plain XDR (big-endian) with no compression: a per-frame header of
section byte-sizes followed by box / positions / velocities / forces blocks,
single or double precision. Coordinates are nm, layout (T, N, 3).

Host copy of ``pmarlo_tpu/io/trr.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

TRR_MAGIC = 1993
_VERSION = b"GMX_trn_file"


def _write_xdr_string(out: bytearray, s: bytes) -> None:
    n = len(s) + 1  # includes NUL, GROMACS convention
    out += struct.pack(">i", n)
    payload = s + b"\x00"
    out += payload + b"\x00" * (-len(payload) % 4)


def _read_xdr_string(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from(">i", buf, off)
    off += 4
    s = buf[off : off + n].rstrip(b"\x00")
    off += n + (-n % 4)
    return s, off


def write_trr(
    path: "str | Path",
    coordinates_nm: np.ndarray,
    *,
    velocities: Optional[np.ndarray] = None,
    forces: Optional[np.ndarray] = None,
    steps: Optional[np.ndarray] = None,
    times_ps: Optional[np.ndarray] = None,
    box_nm: Optional[np.ndarray] = None,
    lambdas: Optional[np.ndarray] = None,
) -> Path:
    """Write (T, N, 3) nm coordinates (optionally v, f) as a TRR file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    x = np.asarray(coordinates_nm, dtype=np.float32)
    if x.ndim != 3 or x.shape[-1] != 3:
        raise ValueError(f"coordinates must be (T, N, 3), got {x.shape}")
    T, N = x.shape[:2]
    v = None if velocities is None else np.asarray(velocities, np.float32)
    f = None if forces is None else np.asarray(forces, np.float32)
    for name, arr in (("velocities", v), ("forces", f)):
        if arr is not None and arr.shape != x.shape:
            raise ValueError(f"{name} shape {arr.shape} != coordinates {x.shape}")
    steps_arr = np.arange(T) if steps is None else np.asarray(steps)
    times_arr = np.zeros(T) if times_ps is None else np.asarray(times_ps)
    lambdas_arr = np.zeros(T) if lambdas is None else np.asarray(lambdas)
    if box_nm is None:
        box_arr = None
    else:
        box_arr = np.asarray(box_nm, dtype=np.float32).reshape(-1, 9)
        if box_arr.shape[0] == 1:
            box_arr = np.broadcast_to(box_arr, (T, 9))

    out = bytearray()
    vec_size = N * 3 * 4
    for i in range(T):
        out += struct.pack(">i", TRR_MAGIC)
        _write_xdr_string(out, _VERSION)
        sizes = (
            0,                                    # ir_size
            0,                                    # e_size
            36 if box_arr is not None else 0,     # box_size
            0,                                    # vir_size
            0,                                    # pres_size
            0,                                    # top_size
            0,                                    # sym_size
            vec_size,                             # x_size
            vec_size if v is not None else 0,     # v_size
            vec_size if f is not None else 0,     # f_size
            N,                                    # natoms
            int(steps_arr[i]),                    # step
            0,                                    # nre
        )
        out += struct.pack(">13i", *sizes)
        out += struct.pack(">2f", float(times_arr[i]), float(lambdas_arr[i]))
        if box_arr is not None:
            out += np.asarray(box_arr[i], dtype=">f4").tobytes()
        out += np.ascontiguousarray(x[i], dtype=">f4").tobytes()
        if v is not None:
            out += np.ascontiguousarray(v[i], dtype=">f4").tobytes()
        if f is not None:
            out += np.ascontiguousarray(f[i], dtype=">f4").tobytes()
    path.write_bytes(bytes(out))
    return path


def _frame_header(buf: bytes, off: int) -> Tuple[Dict, int]:
    (magic,) = struct.unpack_from(">i", buf, off)
    if magic != TRR_MAGIC:
        raise ValueError(f"corrupt TRR: bad magic {magic}")
    version, off = _read_xdr_string(buf, off + 4)
    if version != _VERSION:
        raise ValueError(f"corrupt TRR: bad version string {version!r}")
    keys = (
        "ir_size", "e_size", "box_size", "vir_size", "pres_size",
        "top_size", "sym_size", "x_size", "v_size", "f_size",
        "natoms", "step", "nre",
    )
    vals = struct.unpack_from(">13i", buf, off)
    off += 52
    h = dict(zip(keys, vals))
    # float width: any vector section of 9*8 / natoms*3*8 bytes means double
    n = h["natoms"]
    if h["box_size"] == 72 or (n > 0 and h["x_size"] == n * 24):
        h["float_size"] = 8
    else:
        h["float_size"] = 4
    fw = ">d" if h["float_size"] == 8 else ">f"
    h["time"], h["lambda"] = struct.unpack_from(f">2{fw[-1]}", buf, off)
    off += 2 * h["float_size"]
    return h, off


def probe_trr(path: "str | Path") -> Tuple[int, int]:
    """(n_frames, n_atoms) by scanning frame headers."""
    buf = Path(path).read_bytes()
    off = 0
    n_frames = 0
    natoms = 0
    while off < len(buf):
        h, off = _frame_header(buf, off)
        natoms = h["natoms"]
        off += (
            h["ir_size"] + h["e_size"] + h["box_size"] + h["vir_size"]
            + h["pres_size"] + h["top_size"] + h["sym_size"]
            + h["x_size"] + h["v_size"] + h["f_size"]
        )
        n_frames += 1
    return n_frames, natoms


def read_trr(
    path: "str | Path",
    start: int = 0,
    count: Optional[int] = None,
    *,
    return_metadata: bool = False,
):
    """Read (T, N, 3) nm coordinates; with metadata returns a dict that also
    carries velocities/forces/box/steps/times when present in the file."""
    buf = Path(path).read_bytes()
    off = 0
    frames, vels, fors, boxes, steps, times = [], [], [], [], [], []
    idx = 0
    while off < len(buf):
        h, off = _frame_header(buf, off)
        fdt = ">f8" if h["float_size"] == 8 else ">f4"
        n = h["natoms"]
        off += h["ir_size"] + h["e_size"]
        box = None
        if h["box_size"]:
            box = np.frombuffer(buf, dtype=fdt, count=9, offset=off).astype(np.float32)
            off += h["box_size"]
        off += h["vir_size"] + h["pres_size"] + h["top_size"] + h["sym_size"]
        want = idx >= start and (count is None or idx < start + count)

        def _vec(section_size: int):
            nonlocal off
            if not section_size:
                return None
            arr = None
            if want:
                arr = np.frombuffer(buf, dtype=fdt, count=n * 3, offset=off)
                arr = arr.reshape(n, 3).astype(np.float32)
            off += section_size
            return arr

        xi = _vec(h["x_size"])
        vi = _vec(h["v_size"])
        fi = _vec(h["f_size"])
        if want:
            frames.append(xi)
            vels.append(vi)
            fors.append(fi)
            boxes.append(box)
            steps.append(h["step"])
            times.append(h["time"])
        idx += 1
        if count is not None and idx >= start + count:
            break
    coords = np.asarray(frames, dtype=np.float32)
    if not return_metadata:
        return coords
    meta = {
        "steps": np.asarray(steps, dtype=np.int64),
        "times_ps": np.asarray(times, dtype=np.float32),
        "velocities": (
            np.asarray(vels, np.float32) if vels and vels[0] is not None else None
        ),
        "forces": (
            np.asarray(fors, np.float32) if fors and fors[0] is not None else None
        ),
        "box": (
            np.asarray(boxes, np.float32).reshape(-1, 3, 3)
            if boxes and boxes[0] is not None else None
        ),
    }
    return coords, meta


__all__ = ["write_trr", "read_trr", "probe_trr"]
