"""Shared compile-on-demand loader for the C++ codecs (dcd.cpp, xtc.cpp).

One copy of the build recipe: a fix to compiler flags, cache naming, or
error handling applies to every codec at once (the dcd/xtc modules used
to carry near-verbatim duplicates that could silently diverge).

The binary is keyed by a content hash of the source, so stale builds can
never shadow an edited source (mtimes are unreliable after git checkout)
and the package directory is never written to (works on read-only
installs). No prebuilt binaries ship in the repo.

Copy of ``pmarlo_tpu/io/_native_build.py`` but for ``cache_dir``, which
builds under the checkout instead of the user's cache;
tests/unit/test_torch_host_copies.py holds ``build_native`` and
``NATIVE_DIR`` equal to their sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

logger = logging.getLogger("pmarlo_tpu")

#: repo-level directory holding the C++ sources
NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"


def cache_dir() -> Path:
    """Where the built codecs go: ``PMARLO_CACHE_DIR`` when set, else
    ``build/pmarlo_tpu_torch/native`` under the checkout (a directory git
    ignores), so that nothing is written outside the repository."""
    base = os.environ.get("PMARLO_CACHE_DIR")
    if base:
        return Path(base) / "pmarlo_tpu"
    return Path(__file__).resolve().parents[2] / "build" / "pmarlo_tpu_torch" / "native"


def build_native(src_name: str, lib_prefix: str) -> Optional[ctypes.CDLL]:
    """Compile ``native/<src_name>`` into the user cache dir and load it.

    Returns the CDLL, or None when the toolchain/source is unavailable
    (callers fall back to their pure-Python codecs). Builds go to a temp
    name + atomic rename so concurrent importers never load a
    half-written .so.
    """
    src = NATIVE_DIR / src_name
    try:
        if not src.exists():
            raise OSError(f"native source missing: {src}")
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so_path = cache_dir() / f"{lib_prefix}-{digest}.so"
        if not so_path.exists():
            so_path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(so_path.parent))
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, str(src)],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        return ctypes.CDLL(str(so_path))
    except (OSError, subprocess.SubprocessError) as exc:
        logger.info(
            "native codec %s unavailable (%s); using Python fallback",
            src_name, exc,
        )
        return None


__all__ = ["NATIVE_DIR", "build_native", "cache_dir"]
