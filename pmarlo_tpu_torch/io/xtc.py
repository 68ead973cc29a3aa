"""XTC (GROMACS) trajectory interop: native C++ codec + pure-Python fallback.

The reference reads ``.xtc`` through mdtraj's C plugin
(src/pmarlo/io/trajectory_reader.py:187,214). Here the codec is first-party:
``native/xtc.cpp`` compiled on demand into the user cache dir (ctypes), with
a faithful pure-Python implementation of the same XDR/3dfcoord compression
when no compiler is available. Both paths are cross-checked byte-for-byte in
tests. Coordinates are float32 nm (the native XTC unit), layout (T, N, 3).

Host copy of ``pmarlo_tpu/io/xtc.py``; tests/unit/test_torch_host_copies.py holds the two equal.
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

XTC_MAGIC = 1995
DEFAULT_PRECISION = 1000.0

_MAGICINTS = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 827031,
    1048576, 1321122, 1664510, 2097152, 2642245, 3329021, 4194304,
    5284491, 6658042, 8388607, 10568983, 13316085, 16777216,
)
_FIRSTIDX = 9
_LASTIDX = len(_MAGICINTS)  # 73


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile native/xtc.cpp on demand (shared recipe: _native_build)."""
    global _lib, _native_failed
    if _lib is not None or _native_failed:
        return _lib
    from ._native_build import build_native

    lib = build_native("xtc.cpp", "libpmarlo_xtc")
    if lib is None:
        _native_failed = True
        return None
    try:
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.pmarlo_xtc_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pmarlo_xtc_probe.restype = ctypes.c_int
        lib.pmarlo_xtc_read.argtypes = [
            ctypes.c_char_p, fp, ip, fp, fp,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.pmarlo_xtc_read.restype = ctypes.c_int
        lib.pmarlo_xtc_write.argtypes = [
            ctypes.c_char_p, fp, ip, fp, fp,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ]
        lib.pmarlo_xtc_write.restype = ctypes.c_int
        _lib = lib
    except OSError as exc:
        logger.info("native XTC codec unavailable (%s); using Python fallback", exc)
        _native_failed = True
    return _lib


# --- pure-Python 3dfcoord codec (mirror of native/xtc.cpp) ---------------------

class _BitWriter:
    __slots__ = ("data", "lastbits", "lastbyte")

    def __init__(self):
        self.data = bytearray()
        self.lastbits = 0
        self.lastbyte = 0

    def sendbits(self, num_of_bits: int, num: int) -> None:
        lastbyte, lastbits = self.lastbyte, self.lastbits
        data = self.data
        while num_of_bits >= 8:
            lastbyte = ((lastbyte << 8) | ((num >> (num_of_bits - 8)) & 0xFF)) & 0xFFFFFFFF
            data.append((lastbyte >> lastbits) & 0xFF)
            num_of_bits -= 8
        if num_of_bits > 0:
            lastbyte = ((lastbyte << num_of_bits) | (num & ((1 << num_of_bits) - 1))) & 0xFFFFFFFF
            lastbits += num_of_bits
            if lastbits >= 8:
                lastbits -= 8
                data.append((lastbyte >> lastbits) & 0xFF)
        self.lastbyte, self.lastbits = lastbyte, lastbits

    def sendints(self, num_of_ints, num_of_bits, sizes, nums) -> None:
        nbytes = []
        tmp = nums[0]
        while True:
            nbytes.append(tmp & 0xFF)
            tmp >>= 8
            if tmp == 0:
                break
        for i in range(1, num_of_ints):
            tmp = nums[i]
            for bytecnt in range(len(nbytes)):
                tmp = nbytes[bytecnt] * sizes[i] + tmp
                nbytes[bytecnt] = tmp & 0xFF
                tmp >>= 8
            while tmp != 0:
                nbytes.append(tmp & 0xFF)
                tmp >>= 8
        n = len(nbytes)
        if num_of_bits >= n * 8:
            for b in nbytes:
                self.sendbits(8, b)
            self.sendbits(num_of_bits - n * 8, 0)
        else:
            for b in nbytes[:-1]:
                self.sendbits(8, b)
            self.sendbits(num_of_bits - (n - 1) * 8, nbytes[-1])

    def flush(self) -> bytes:
        out = bytes(self.data)
        if self.lastbits > 0:
            out += bytes([(self.lastbyte << (8 - self.lastbits)) & 0xFF])
        return out


class _BitReader:
    __slots__ = ("data", "cnt", "lastbits", "lastbyte")

    def __init__(self, data: bytes):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def receivebits(self, num_of_bits: int) -> int:
        mask = (1 << num_of_bits) - 1
        lastbyte, lastbits = self.lastbyte, self.lastbits
        data, cnt = self.data, self.cnt
        num = 0
        while num_of_bits >= 8:
            lastbyte = ((lastbyte << 8) | data[cnt]) & 0xFFFFFFFF
            cnt += 1
            num |= (lastbyte >> lastbits) << (num_of_bits - 8)
            num_of_bits -= 8
        if num_of_bits > 0:
            if lastbits < num_of_bits:
                lastbits += 8
                lastbyte = ((lastbyte << 8) | data[cnt]) & 0xFFFFFFFF
                cnt += 1
            lastbits -= num_of_bits
            num |= (lastbyte >> lastbits) & ((1 << num_of_bits) - 1)
        self.lastbyte, self.lastbits, self.cnt = lastbyte, lastbits, cnt
        return num & mask

    def receiveints(self, num_of_ints, num_of_bits, sizes) -> list:
        nbytes = []
        while num_of_bits > 8:
            nbytes.append(self.receivebits(8))
            num_of_bits -= 8
        if num_of_bits > 0:
            nbytes.append(self.receivebits(num_of_bits))
        while len(nbytes) < 4:
            nbytes.append(0)
        nums = [0] * num_of_ints
        for i in range(num_of_ints - 1, 0, -1):
            num = 0
            for j in range(len(nbytes) - 1, -1, -1):
                num = (num << 8) | nbytes[j]
                p = num // sizes[i]
                nbytes[j] = p
                num -= p * sizes[i]
            nums[i] = num
        nums[0] = nbytes[0] | (nbytes[1] << 8) | (nbytes[2] << 16) | (nbytes[3] << 24)
        return nums


def _sizeofint(size: int) -> int:
    num, bits = 1, 0
    while size >= num and bits < 32:
        bits += 1
        num <<= 1
    return bits


def _sizeofints(num_of_ints: int, sizes) -> int:
    nbytes = [1]
    for i in range(num_of_ints):
        tmp = 0
        for bytecnt in range(len(nbytes)):
            tmp = nbytes[bytecnt] * sizes[i] + tmp
            nbytes[bytecnt] = tmp & 0xFF
            tmp >>= 8
        while tmp != 0:
            nbytes.append(tmp & 0xFF)
            tmp >>= 8
    num, bits = 1, 0
    while nbytes[-1] >= num:
        bits += 1
        num *= 2
    return bits + (len(nbytes) - 1) * 8


def _py_encode_coords(frame_nm: np.ndarray, precision: float) -> bytes:
    """Encode one frame (N, 3) float nm -> the XDR 3dfcoord block bytes."""
    size = frame_nm.shape[0]
    out = bytearray(struct.pack(">i", size))
    if size <= 9:
        out += frame_nm.astype(">f4").tobytes()
        return bytes(out)
    out += struct.pack(">f", precision)

    scaled = np.asarray(frame_nm, dtype=np.float64) * precision
    lip = np.where(scaled >= 0, scaled + 0.5, scaled - 0.5).astype(np.int64)
    if np.abs(lip).max() > 2**31 - 2:
        raise OverflowError("coordinate exceeds XTC quantization range")
    lip = lip.astype(np.int32)
    minint = lip.min(axis=0)
    maxint = lip.max(axis=0)
    diffs = np.abs(np.diff(lip.astype(np.int64), axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if len(diffs) else 2**31 - 1
    out += struct.pack(">3i", *minint)
    out += struct.pack(">3i", *maxint)

    sizeint = [int(maxint[d]) - int(minint[d]) + 1 for d in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(3, sizeint)

    smallidx = _FIRSTIDX
    while smallidx < _LASTIDX - 1 and _MAGICINTS[smallidx] < mindiff:
        smallidx += 1
    out += struct.pack(">i", smallidx)

    maxidx = min(_LASTIDX - 1, smallidx + 8)
    minidx = maxidx - 8
    larger = _MAGICINTS[maxidx] // 2
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3

    w = _BitWriter()
    lip_list = [int(v) for v in lip.ravel()]
    prevrun = -1
    prevcoord = [0, 0, 0]
    i = 0
    while i < size:
        is_small = False
        base = i * 3
        this = lip_list[base : base + 3]
        if (
            smallidx < maxidx and i >= 1
            and abs(this[0] - prevcoord[0]) < larger
            and abs(this[1] - prevcoord[1]) < larger
            and abs(this[2] - prevcoord[2]) < larger
        ):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0
        if i + 1 < size:
            nxt = lip_list[base + 3 : base + 6]
            if (
                abs(this[0] - nxt[0]) < smallnum
                and abs(this[1] - nxt[1]) < smallnum
                and abs(this[2] - nxt[2]) < smallnum
            ):
                # interchange first with second atom (water-pair heuristic)
                lip_list[base : base + 3] = nxt
                lip_list[base + 3 : base + 6] = this
                this = nxt
                is_small = True
        tmpc = [this[d] - int(minint[d]) for d in range(3)]
        if bitsize == 0:
            for d in range(3):
                w.sendbits(bitsizeint[d], tmpc[d])
        else:
            w.sendints(3, bitsize, sizeint, tmpc)
        prevcoord = this[:]
        i += 1

        run = 0
        runvals = []
        if not is_small and is_smaller == -1:
            is_smaller = 0
        while is_small and run < 8 * 3:
            cbase = i * 3
            cur = lip_list[cbase : cbase + 3]
            if is_smaller == -1 and (
                (cur[0] - prevcoord[0]) ** 2
                + (cur[1] - prevcoord[1]) ** 2
                + (cur[2] - prevcoord[2]) ** 2
                >= smaller * smaller
            ):
                is_smaller = 0
            runvals.extend(cur[d] - prevcoord[d] + smallnum for d in range(3))
            run += 3
            prevcoord = cur[:]
            i += 1
            is_small = False
            if i < size:
                nxt = lip_list[i * 3 : i * 3 + 3]
                if (
                    abs(nxt[0] - prevcoord[0]) < smallnum
                    and abs(nxt[1] - prevcoord[1]) < smallnum
                    and abs(nxt[2] - prevcoord[2]) < smallnum
                ):
                    is_small = True
        if run != prevrun or is_smaller != 0:
            prevrun = run
            w.sendbits(1, 1)
            w.sendbits(5, run + is_smaller + 1)
        else:
            w.sendbits(1, 0)
        for k in range(0, run, 3):
            w.sendints(3, smallidx, sizesmall, runvals[k : k + 3])
        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = _MAGICINTS[smallidx - 1] // 2
            else:
                smaller = smallnum
                smallnum = _MAGICINTS[smallidx] // 2
            sizesmall = [_MAGICINTS[smallidx]] * 3

    payload = w.flush()
    out += struct.pack(">i", len(payload))
    out += payload
    out += b"\x00" * (-len(payload) % 4)
    return bytes(out)


def _py_decode_coords(buf: bytes, off: int, size: int) -> Tuple[np.ndarray, int]:
    """Decode one 3dfcoord block at ``off``; returns ((N,3) nm, new offset)."""
    (lsize,) = struct.unpack_from(">i", buf, off)
    off += 4
    if lsize != size:
        raise ValueError(f"corrupt XTC: lsize {lsize} != natoms {size}")
    if size <= 9:
        coords = np.frombuffer(buf, dtype=">f4", count=size * 3, offset=off)
        return coords.reshape(size, 3).astype(np.float32), off + size * 12
    (precision,) = struct.unpack_from(">f", buf, off)
    off += 4
    minint = list(struct.unpack_from(">3i", buf, off)); off += 12
    maxint = list(struct.unpack_from(">3i", buf, off)); off += 12
    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(3, sizeint)
    (smallidx,) = struct.unpack_from(">i", buf, off)
    off += 4
    if not (_FIRSTIDX <= smallidx < _LASTIDX):
        raise ValueError(f"corrupt XTC: smallidx {smallidx}")
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3
    (nbytes,) = struct.unpack_from(">i", buf, off)
    off += 4
    data = buf[off : off + nbytes]
    off += nbytes + (-nbytes % 4)

    r = _BitReader(data)
    inv = 1.0 / precision
    out = np.empty((size, 3), dtype=np.float32)
    run = 0
    i = 0
    prevcoord = [0, 0, 0]
    while i < size:
        if bitsize == 0:
            this = [r.receivebits(bitsizeint[d]) for d in range(3)]
        else:
            this = r.receiveints(3, bitsize, sizeint)
        write_at = i
        i += 1
        this = [this[d] + minint[d] for d in range(3)]
        prevcoord = this[:]

        flag = r.receivebits(1)
        is_smaller = 0
        if flag == 1:
            v = r.receivebits(5)
            is_smaller = v % 3
            run = v - is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                if i >= size:
                    raise ValueError("corrupt XTC: run overruns atom count")
                cur = r.receiveints(3, smallidx, sizesmall)
                cur = [cur[d] + prevcoord[d] - smallnum for d in range(3)]
                if k == 0:
                    # undo the encoder's first/second interchange
                    cur, prevcoord = prevcoord, cur
                    out[write_at] = np.asarray(prevcoord, np.float64) * inv
                else:
                    prevcoord = cur[:]
                out[i] = np.asarray(cur, np.float64) * inv
                i += 1
        else:
            out[write_at] = np.asarray(this, np.float64) * inv
        smallidx += is_smaller
        if is_smaller < 0:
            smallnum = smaller
            smaller = _MAGICINTS[smallidx - 1] // 2 if smallidx > _FIRSTIDX else 0
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = _MAGICINTS[smallidx] // 2
        sizesmall = [_MAGICINTS[smallidx]] * 3
        if sizesmall[0] == 0:
            raise ValueError("corrupt XTC: smallidx underflow")
    return out, off


def _py_iter_frames(buf: bytes):
    off = 0
    while off < len(buf):
        magic, natoms, step = struct.unpack_from(">3i", buf, off)
        if magic != XTC_MAGIC:
            raise ValueError(f"corrupt XTC: bad magic {magic}")
        (time,) = struct.unpack_from(">f", buf, off + 12)
        box = np.frombuffer(buf, dtype=">f4", count=9, offset=off + 16).astype(np.float32)
        coords, off = _py_decode_coords(buf, off + 52, natoms)
        yield coords, step, time, box


def _py_write(path: Path, coords, steps, times, box, precision: float) -> None:
    with path.open("wb") as f:
        for i in range(coords.shape[0]):
            f.write(struct.pack(">3i", XTC_MAGIC, coords.shape[1], int(steps[i])))
            f.write(struct.pack(">f", float(times[i])))
            f.write(np.asarray(box[i], dtype=">f4").tobytes())
            f.write(_py_encode_coords(coords[i], precision))


# --- public API -----------------------------------------------------------------

def write_xtc(
    path: "str | Path",
    coordinates_nm: np.ndarray,
    *,
    steps: Optional[np.ndarray] = None,
    times_ps: Optional[np.ndarray] = None,
    box_nm: Optional[np.ndarray] = None,
    precision: float = DEFAULT_PRECISION,
) -> Path:
    """Write (T, N, 3) nm coordinates as a GROMACS XTC file.

    ``box_nm`` may be (T, 3, 3), (3, 3), or None (zero box — the convention
    for non-periodic systems). Precision is the XTC quantization factor
    (1000 = 0.001 nm resolution, the GROMACS default).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    coords = np.ascontiguousarray(np.asarray(coordinates_nm, dtype=np.float32))
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coordinates must be (T, N, 3), got {coords.shape}")
    T, N = coords.shape[:2]
    steps_arr = (
        np.arange(T, dtype=np.int32) if steps is None
        else np.ascontiguousarray(np.asarray(steps, dtype=np.int32))
    )
    times_arr = (
        np.zeros(T, dtype=np.float32) if times_ps is None
        else np.ascontiguousarray(np.asarray(times_ps, dtype=np.float32))
    )
    if box_nm is None:
        box_arr = np.zeros((T, 9), dtype=np.float32)
    else:
        box_arr = np.asarray(box_nm, dtype=np.float32).reshape(-1, 9)
        if box_arr.shape[0] == 1:
            box_arr = np.broadcast_to(box_arr, (T, 9))
        box_arr = np.ascontiguousarray(box_arr)
    if len(steps_arr) != T or len(times_arr) != T or box_arr.shape[0] != T:
        raise ValueError("steps/times/box length must match n_frames")

    lib = _load_native()
    if lib is not None:
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        rc = lib.pmarlo_xtc_write(
            str(path).encode(), coords.ctypes.data_as(fp),
            steps_arr.ctypes.data_as(ip), times_arr.ctypes.data_as(fp),
            box_arr.ctypes.data_as(fp), T, N, precision,
        )
        if rc != 0:
            raise IOError(f"native XTC write failed with code {rc}")
    else:
        _py_write(path, coords, steps_arr, times_arr, box_arr, precision)
    return path


def probe_xtc(path: "str | Path") -> Tuple[int, int]:
    """(n_frames, n_atoms) by scanning frame headers (no decompression)."""
    path = Path(path)
    lib = _load_native()
    if lib is not None:
        nf = ctypes.c_int64()
        na = ctypes.c_int64()
        rc = lib.pmarlo_xtc_probe(str(path).encode(), ctypes.byref(nf), ctypes.byref(na))
        if rc != 0:
            raise IOError(f"native XTC probe failed with code {rc}")
        return int(nf.value), int(na.value)
    buf = path.read_bytes()
    n_frames = 0
    n_atoms = 0
    off = 0
    while off < len(buf):
        magic, natoms = struct.unpack_from(">2i", buf, off)
        if magic != XTC_MAGIC:
            raise ValueError(f"corrupt XTC: bad magic {magic}")
        n_atoms = natoms
        if natoms <= 9:
            off += 52 + 4 + natoms * 12
        else:
            (nbytes,) = struct.unpack_from(">i", buf, off + 52 + 4 + 4 + 24 + 4)
            off += 52 + 36 + 4 + nbytes + (-nbytes % 4)
        n_frames += 1
    return n_frames, n_atoms


def read_xtc(
    path: "str | Path",
    start: int = 0,
    count: Optional[int] = None,
    *,
    return_metadata: bool = False,
):
    """Read (T, N, 3) nm coordinates; optionally (coords, steps, times, box)."""
    path = Path(path)
    n_frames, n_atoms = probe_xtc(path)
    if count is None:
        count = n_frames - start
    count = max(min(count, n_frames - start), 0)
    lib = _load_native()
    if lib is not None:
        coords = np.empty((count, n_atoms, 3), dtype=np.float32)
        steps = np.empty(count, dtype=np.int32)
        times = np.empty(count, dtype=np.float32)
        box = np.empty((count, 9), dtype=np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        rc = lib.pmarlo_xtc_read(
            str(path).encode(), coords.ctypes.data_as(fp),
            steps.ctypes.data_as(ip), times.ctypes.data_as(fp),
            box.ctypes.data_as(fp), start, count, n_atoms,
        )
        if rc != 0:
            raise IOError(f"native XTC read failed with code {rc}")
    else:
        frames, steps_l, times_l, boxes_l = [], [], [], []
        for idx, (c, s, t, b) in enumerate(_py_iter_frames(path.read_bytes())):
            if idx < start:
                continue
            if idx >= start + count:
                break
            frames.append(c)
            steps_l.append(s)
            times_l.append(t)
            boxes_l.append(b)
        coords = (
            np.asarray(frames, dtype=np.float32)
            if frames else np.empty((0, n_atoms, 3), np.float32)
        )
        steps = np.asarray(steps_l, dtype=np.int32)
        times = np.asarray(times_l, dtype=np.float32)
        box = (
            np.asarray(boxes_l, dtype=np.float32).reshape(-1, 9)
            if boxes_l else np.empty((0, 9), np.float32)
        )
    if return_metadata:
        return coords, steps, times, box.reshape(-1, 3, 3)
    return coords


__all__ = ["write_xtc", "read_xtc", "probe_xtc", "DEFAULT_PRECISION"]
