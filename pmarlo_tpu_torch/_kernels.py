"""Build and load the port's CUDA kernel library.

Every ``pmarlo_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process, all started together, into an object file; one more ``nvcc``
links them into a shared library with a plain C interface, which
``ctypes`` loads. The library goes into ``build/pmarlo_tpu_torch/`` beside
the package, keyed by a hash of the sources and flags, at first use, with
the compiler's output beside it (``build_log``).
Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "pmarlo_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
#: whether this process ran nvcc for the library (False: it was in the
#: build directory already; None: not asked for yet)
compiled: Optional[bool] = None


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels need it")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (once per source
    hash) and return its path. Raises with the compiler's output on
    failure."""
    global _build_log, compiled
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = _BUILD_DIR / f"libpmarlo_kernels_{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        _build_log = log.read_text()
        compiled = False
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    units = [s for s in _sources() if s.suffix == ".cu"]
    objs = [_BUILD_DIR / f"{s.stem}.{tag}.o" for s in units]
    procs = [
        subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for s, o in zip(units, objs)
    ]
    logs, failed = [], []
    for s, p in zip(units, procs):
        text, _ = p.communicate()
        logs.append(f"--- {s.name}\n{text}")
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode})")
    _build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{_build_log}")
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(tmp), *[str(o) for o in objs]],
        capture_output=True, text=True,
    )
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}"
        )
    log_tmp = log.with_name(f"{log.stem}.{os.getpid()}.tmp.log")
    log_tmp.write_text(_build_log)
    os.replace(log_tmp, log)
    os.replace(tmp, out)
    compiled = True
    return out


def build_log() -> str:
    """The compiler's output of the library's build (``-Xptxas -v``:
    registers, shared memory, spills per kernel), kept beside the library
    and read back when it was cached; empty before ``build_library``."""
    return _build_log


def loaded() -> bool:
    """Whether the library is loaded in this process."""
    return _lib is not None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Callers set the
    ``argtypes`` of the functions they call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.pmarlo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pmarlo_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().pmarlo_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


__all__ = ["build_library", "build_log", "library", "loaded", "check_launch"]
