"""JSON sanitize/write helpers (reference: src/pmarlo/utils/json_io.py).

Host copy of ``pmarlo_tpu/utils/json_io.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np


def sanitize_for_json(obj: Any) -> Any:
    """Recursively convert numpy/JAX scalars and arrays to JSON-safe types."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        value = float(obj)
        return value if np.isfinite(value) else None
    if isinstance(obj, Path):
        return str(obj)
    if hasattr(obj, "tolist") and hasattr(obj, "shape"):  # ndarray / jax array
        return sanitize_for_json(np.asarray(obj).tolist())
    if isinstance(obj, dict):
        return {str(k): sanitize_for_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [sanitize_for_json(v) for v in obj]
    if hasattr(obj, "to_dict"):
        return sanitize_for_json(obj.to_dict())
    return str(obj)


def write_json(path: "str | Path", data: Any, indent: int = 2) -> Path:
    """Atomically write sanitized JSON."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(sanitize_for_json(data), indent=indent))
    tmp.replace(path)
    return path


def read_json(path: "str | Path") -> Any:
    return json.loads(Path(path).read_text())


__all__ = ["sanitize_for_json", "write_json", "read_json"]
