"""Amber NetCDF trajectory interop: first-party NetCDF-classic codec.

The reference lists ``.nc`` among its trajectory formats
(src/pmarlo/io/trajectory_reader.py:187) and reads it through mdtraj's
netcdf plugin. Here the classic (CDF-1/CDF-2) container format is
implemented directly — header parse/emit plus fixed and record variable
layout — with thin wrappers for the AMBER trajectory convention
(Conventions="AMBER", coordinates in Angstrom on disk, nm in memory).

Host copy of ``pmarlo_tpu/io/netcdf.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE = 1, 2, 3, 4, 5, 6
_TAG_DIM, _TAG_VAR, _TAG_ATT = 0x0A, 0x0B, 0x0C
_ABSENT = (0, 0)

_DTYPES = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
}
_SIZES = {NC_BYTE: 1, NC_CHAR: 1, NC_SHORT: 2, NC_INT: 4, NC_FLOAT: 4, NC_DOUBLE: 8}


# --- generic classic-format reader ------------------------------------------------

class _Parser:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def i4(self) -> int:
        (v,) = struct.unpack_from(">i", self.buf, self.off)
        self.off += 4
        return v

    def i8(self) -> int:
        (v,) = struct.unpack_from(">q", self.buf, self.off)
        self.off += 8
        return v

    def name(self) -> str:
        n = self.i4()
        s = self.buf[self.off : self.off + n].decode("ascii")
        self.off += n + (-n % 4)
        return s

    def values(self, nc_type: int, nelems: int):
        size = _SIZES[nc_type] * nelems
        arr = np.frombuffer(self.buf, dtype=_DTYPES[nc_type], count=nelems,
                            offset=self.off)
        self.off += size + (-size % 4)
        if nc_type == NC_CHAR:
            return arr.tobytes().decode("ascii", errors="replace")
        return arr

    def att_list(self) -> Dict:
        tag = self.i4()
        count = self.i4()
        if (tag, count) == _ABSENT:
            return {}
        if tag != _TAG_ATT:
            raise ValueError(f"corrupt NetCDF: bad attribute tag {tag}")
        atts = {}
        for _ in range(count):
            aname = self.name()
            atype = self.i4()
            nelems = self.i4()
            atts[aname] = self.values(atype, nelems)
        return atts


def read_netcdf_raw(path: "str | Path") -> Tuple[Dict, Dict, Dict]:
    """Parse a classic NetCDF file -> (dims, global_atts, variables).

    ``variables`` maps name -> {"data": ndarray, "dimensions": [names],
    "attributes": {...}}. Record variables come back with the record
    dimension as the leading axis.
    """
    buf = Path(path).read_bytes()
    if buf[:3] != b"CDF" or buf[3] not in (1, 2):
        raise ValueError(f"{path} is not a classic NetCDF file")
    version = buf[3]
    p = _Parser(buf)
    p.off = 4
    numrecs = p.i4()

    tag = p.i4()
    count = p.i4()
    dims: List[Tuple[str, int]] = []
    if (tag, count) != _ABSENT:
        if tag != _TAG_DIM:
            raise ValueError(f"corrupt NetCDF: bad dimension tag {tag}")
        for _ in range(count):
            dname = p.name()
            dims.append((dname, p.i4()))

    gatts = p.att_list()

    tag = p.i4()
    count = p.i4()
    raw_vars = []
    if (tag, count) != _ABSENT:
        if tag != _TAG_VAR:
            raise ValueError(f"corrupt NetCDF: bad variable tag {tag}")
        for _ in range(count):
            vname = p.name()
            ndims = p.i4()
            dimids = [p.i4() for _ in range(ndims)]
            vatts = p.att_list()
            nc_type = p.i4()
            vsize = p.i4()
            begin = p.i8() if version == 2 else p.i4()
            raw_vars.append((vname, dimids, vatts, nc_type, vsize, begin))

    rec_vars = [v for v in raw_vars if v[1] and dims[v[1][0]][1] == 0]
    recsize = sum(v[4] for v in rec_vars)
    if len(rec_vars) == 1:
        recsize = rec_vars[0][4]  # single record var: no per-record padding

    variables: Dict[str, Dict] = {}
    for vname, dimids, vatts, nc_type, vsize, begin in raw_vars:
        dnames = [dims[d][0] for d in dimids]
        is_record = bool(dimids) and dims[dimids[0]][1] == 0
        if is_record:
            inner = [dims[d][1] for d in dimids[1:]]
            n_inner = int(np.prod(inner)) if inner else 1
            item = _DTYPES[nc_type]
            out = np.empty((numrecs, n_inner), dtype=item)
            per_rec = n_inner * _SIZES[nc_type]
            if len(rec_vars) == 1:
                flat = np.frombuffer(buf, dtype=item, count=numrecs * n_inner,
                                     offset=begin)
                out = flat.reshape(numrecs, n_inner).copy()
            else:
                for r in range(numrecs):
                    off = begin + r * recsize
                    out[r] = np.frombuffer(buf, dtype=item, count=n_inner,
                                           offset=off)
            data = out.reshape([numrecs] + inner)
        else:
            shape = [dims[d][1] for d in dimids]
            n = int(np.prod(shape)) if shape else 1
            data = np.frombuffer(buf, dtype=_DTYPES[nc_type], count=n,
                                 offset=begin).reshape(shape).copy()
        if nc_type == NC_CHAR:
            variables[vname] = {
                "data": data, "dimensions": dnames, "attributes": vatts,
            }
        else:
            variables[vname] = {
                "data": data.astype(data.dtype.newbyteorder("=")),
                "dimensions": dnames, "attributes": vatts,
            }
    dim_map = {name: (numrecs if length == 0 else length) for name, length in dims}
    return dim_map, gatts, variables


# --- generic classic-format writer ------------------------------------------------

def _emit_name(out: bytearray, s: str) -> None:
    b = s.encode("ascii")
    out += struct.pack(">i", len(b))
    out += b + b"\x00" * (-len(b) % 4)


def _emit_values(out: bytearray, nc_type: int, values) -> None:
    if nc_type == NC_CHAR:
        b = values.encode("ascii") if isinstance(values, str) else bytes(values)
        out += struct.pack(">2i", nc_type, len(b))
        out += b + b"\x00" * (-len(b) % 4)
    else:
        arr = np.atleast_1d(np.asarray(values)).astype(_DTYPES[nc_type])
        out += struct.pack(">2i", nc_type, arr.size)
        raw = arr.tobytes()
        out += raw + b"\x00" * (-len(raw) % 4)


def _emit_atts(out: bytearray, atts: Dict) -> None:
    if not atts:
        out += struct.pack(">2i", 0, 0)
        return
    out += struct.pack(">2i", _TAG_ATT, len(atts))
    for aname, aval in atts.items():
        _emit_name(out, aname)
        if isinstance(aval, str):
            _emit_values(out, NC_CHAR, aval)
        elif isinstance(aval, (int, np.integer)):
            _emit_values(out, NC_INT, aval)
        elif isinstance(aval, (float, np.floating)):
            _emit_values(out, NC_DOUBLE, aval)
        else:
            arr = np.asarray(aval)
            t = {"f4": NC_FLOAT, "f8": NC_DOUBLE, "i4": NC_INT,
                 "i2": NC_SHORT, "i1": NC_BYTE}.get(arr.dtype.str[1:], NC_DOUBLE)
            _emit_values(out, t, arr)


def write_netcdf_raw(
    path: "str | Path",
    dims: Dict[str, Optional[int]],
    global_atts: Dict,
    variables: Dict[str, Dict],
) -> Path:
    """Write a classic (CDF-1) NetCDF file.

    ``dims`` maps name -> length (None = the record dimension).
    ``variables`` maps name -> {"data": array, "dimensions": [dim names],
    "attributes": {...}, "nc_type": optional}. Record variables must have
    the record dimension first; all must agree on the record count.
    """
    path = Path(path)
    dim_names = list(dims)
    dim_index = {n: i for i, n in enumerate(dim_names)}
    record_dim = next((n for n, v in dims.items() if v is None), None)

    numrecs = 0
    fixed, record = [], []
    for vname, spec in variables.items():
        data = np.asarray(spec["data"])
        nc_type = spec.get("nc_type")
        if nc_type is None:
            nc_type = {
                "f4": NC_FLOAT, "f8": NC_DOUBLE, "i4": NC_INT, "i2": NC_SHORT,
                "i1": NC_BYTE, "S1": NC_CHAR, "U": NC_CHAR,
            }.get(data.dtype.str[1:], None)
            if nc_type is None and data.dtype.kind in "SU":
                nc_type = NC_CHAR
            if nc_type is None:
                raise ValueError(f"unsupported dtype {data.dtype} for {vname}")
        is_record = bool(spec["dimensions"]) and spec["dimensions"][0] == record_dim
        if is_record:
            numrecs = max(numrecs, data.shape[0])
            record.append((vname, spec, data, nc_type))
        else:
            fixed.append((vname, spec, data, nc_type))

    def _per_item_bytes(spec, data, nc_type, skip_first: bool) -> int:
        shape = data.shape[1:] if skip_first else data.shape
        n = int(np.prod(shape)) if shape else 1
        raw = n * _SIZES[nc_type]
        return raw + (-raw % 4)

    # header with placeholder begins first to learn its size, then re-emit
    def emit(begins: Dict[str, int]) -> bytearray:
        out = bytearray(b"CDF\x01")
        out += struct.pack(">i", numrecs)
        if dims:
            out += struct.pack(">2i", _TAG_DIM, len(dims))
            for n in dim_names:
                _emit_name(out, n)
                out += struct.pack(">i", 0 if dims[n] is None else int(dims[n]))
        else:
            out += struct.pack(">2i", 0, 0)
        _emit_atts(out, global_atts)
        allv = fixed + record
        if allv:
            out += struct.pack(">2i", _TAG_VAR, len(allv))
            for vname, spec, data, nc_type in allv:
                _emit_name(out, vname)
                out += struct.pack(">i", len(spec["dimensions"]))
                for dn in spec["dimensions"]:
                    out += struct.pack(">i", dim_index[dn])
                _emit_atts(out, spec.get("attributes", {}))
                is_rec = spec["dimensions"] and spec["dimensions"][0] == record_dim
                vsize = _per_item_bytes(spec, data, nc_type, bool(is_rec))
                out += struct.pack(">i", nc_type)
                out += struct.pack(">i", vsize)
                out += struct.pack(">i", begins.get(vname, 0))
        else:
            out += struct.pack(">2i", 0, 0)
        return out

    header_len = len(emit({}))
    begins: Dict[str, int] = {}
    off = header_len
    for vname, spec, data, nc_type in fixed:
        begins[vname] = off
        off += _per_item_bytes(spec, data, nc_type, False)
    rec_start = off
    rec_off = 0
    per_rec: Dict[str, int] = {}
    for vname, spec, data, nc_type in record:
        begins[vname] = rec_start + rec_off
        per_rec[vname] = _per_item_bytes(spec, data, nc_type, True)
        rec_off += per_rec[vname]
    recsize = rec_off

    out = emit(begins)
    assert len(out) == header_len
    for vname, spec, data, nc_type in fixed:
        if nc_type == NC_CHAR:
            raw = data.astype("S1").tobytes()
        else:
            raw = np.ascontiguousarray(data, dtype=_DTYPES[nc_type]).tobytes()
        out += raw + b"\x00" * (-len(raw) % 4)
    for r in range(numrecs):
        for vname, spec, data, nc_type in record:
            if nc_type == NC_CHAR:
                raw = data[r].astype("S1").tobytes()
            else:
                raw = np.ascontiguousarray(
                    data[r], dtype=_DTYPES[nc_type]
                ).tobytes()
            out += raw + b"\x00" * (per_rec[vname] - len(raw))
    del recsize  # layout is implied by per-var begins + strides
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(bytes(out))
    return path


# --- AMBER trajectory convention ----------------------------------------------------

def write_netcdf(
    path: "str | Path",
    coordinates_nm: np.ndarray,
    *,
    times_ps: Optional[np.ndarray] = None,
    cell_lengths_nm: Optional[np.ndarray] = None,
    cell_angles_deg: Optional[np.ndarray] = None,
    title: str = "pmarlo_tpu trajectory",
) -> Path:
    """Write (T, N, 3) nm coordinates as an AMBER-convention NetCDF file."""
    coords = np.asarray(coordinates_nm, dtype=np.float32)
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coordinates must be (T, N, 3), got {coords.shape}")
    T, N = coords.shape[:2]
    times = (
        np.arange(T, dtype=np.float32) if times_ps is None
        else np.asarray(times_ps, dtype=np.float32)
    )
    dims: Dict[str, Optional[int]] = {"frame": None, "spatial": 3, "atom": N}
    variables: Dict[str, Dict] = {
        "spatial": {
            "data": np.frombuffer(b"xyz", dtype="S1"),
            "dimensions": ["spatial"], "attributes": {},
        },
        "time": {
            "data": times, "dimensions": ["frame"],
            "attributes": {"units": "picosecond"},
        },
        "coordinates": {
            "data": coords * 10.0,  # nm -> Angstrom (AMBER convention)
            "dimensions": ["frame", "atom", "spatial"],
            "attributes": {"units": "angstrom"},
        },
    }
    if cell_lengths_nm is not None:
        dims["cell_spatial"] = 3
        dims["cell_angular"] = 3
        lengths = np.asarray(cell_lengths_nm, dtype=np.float64).reshape(-1, 3)
        if lengths.shape[0] == 1:
            lengths = np.broadcast_to(lengths, (T, 3))
        angles = (
            np.full((T, 3), 90.0) if cell_angles_deg is None
            else np.asarray(cell_angles_deg, dtype=np.float64).reshape(-1, 3)
        )
        if angles.shape[0] == 1:
            angles = np.broadcast_to(angles, (T, 3))
        variables["cell_lengths"] = {
            "data": lengths * 10.0, "dimensions": ["frame", "cell_spatial"],
            "attributes": {"units": "angstrom"},
        }
        variables["cell_angles"] = {
            "data": angles, "dimensions": ["frame", "cell_angular"],
            "attributes": {"units": "degree"},
        }
    gatts = {
        "Conventions": "AMBER",
        "ConventionVersion": "1.0",
        "program": "pmarlo_tpu",
        "programVersion": "0.2",
        "title": title,
    }
    return write_netcdf_raw(Path(path), dims, gatts, variables)


def probe_netcdf(path: "str | Path") -> Tuple[int, int]:
    """(n_frames, n_atoms) from the header."""
    dims, _, _ = read_netcdf_raw(path)
    return int(dims.get("frame", 0)), int(dims.get("atom", 0))


def read_netcdf(
    path: "str | Path",
    start: int = 0,
    count: Optional[int] = None,
    *,
    return_metadata: bool = False,
):
    """Read (T, N, 3) nm coordinates from an AMBER-convention NetCDF file."""
    dims, gatts, variables = read_netcdf_raw(path)
    if "coordinates" not in variables:
        raise ValueError(f"{path}: no 'coordinates' variable (not a trajectory)")
    coords = np.asarray(variables["coordinates"]["data"], dtype=np.float32)
    units = variables["coordinates"]["attributes"].get("units", "angstrom")
    scale = 0.1 if str(units).startswith("angstrom") else 1.0
    coords = coords * scale
    stop = None if count is None else start + count
    coords = coords[start:stop]
    if not return_metadata:
        return coords
    meta = {"conventions": gatts.get("Conventions", ""), "dims": dims}
    if "time" in variables:
        meta["times_ps"] = np.asarray(
            variables["time"]["data"], dtype=np.float32
        )[start:stop]
    if "cell_lengths" in variables:
        meta["cell_lengths_nm"] = (
            np.asarray(variables["cell_lengths"]["data"], dtype=np.float64)
            * 0.1
        )[start:stop]
    if "cell_angles" in variables:
        meta["cell_angles_deg"] = np.asarray(
            variables["cell_angles"]["data"], dtype=np.float64
        )[start:stop]
    return coords, meta


__all__ = [
    "write_netcdf", "read_netcdf", "probe_netcdf",
    "write_netcdf_raw", "read_netcdf_raw",
]
