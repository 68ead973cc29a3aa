"""Path helpers (reference: src/pmarlo/utils/path_utils.py).

Host copy of ``pmarlo_tpu/utils/path_utils.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import re
import time
from pathlib import Path


def ensure_directory(path: "str | Path") -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def resolve_project_path(path: "str | Path", base: "str | Path | None" = None) -> Path:
    p = Path(path)
    if p.is_absolute():
        return p
    return (Path(base) if base is not None else Path.cwd()) / p


def coerce_path_list(paths) -> "list[Path]":
    """Normalize an iterable of str/Path inputs to resolved Paths
    (reference: src/pmarlo/utils/path_utils.py:115)."""
    return [Path(p).resolve() for p in paths]


def relativize(path: "str | Path", base: "str | Path") -> str:
    """Relative path from ``base`` to ``path``; falls back to the
    absolute path when they share no common ancestor (reference:
    src/pmarlo/utils/path_utils.py:148)."""
    p = Path(path).resolve()
    try:
        return str(p.relative_to(Path(base).resolve()))
    except ValueError:
        return str(p)


def slugify(text: str) -> str:
    text = re.sub(r"[^A-Za-z0-9._-]+", "-", text.strip())
    return re.sub(r"-{2,}", "-", text).strip("-").lower()


def timestamp_slug() -> str:
    return time.strftime("%Y%m%d-%H%M%S")


__all__ = [
    "ensure_directory", "resolve_project_path", "slugify", "timestamp_slug",
    "coerce_path_list", "relativize",
]
