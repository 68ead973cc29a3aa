"""Small shared helpers: array glue, scalar coercion, naming, validation.

Covers the reference's utils/array.py, utils/coercion.py, utils/naming.py
and utils/validation.py surfaces in one module (each is a handful of
functions; the split files added no structure worth keeping).

Host copy of ``pmarlo_tpu/utils/misc.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import re
from datetime import datetime
from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np

# --- array (reference utils/array.py:9) -----------------------------------


def concatenate_or_empty(
    parts: Iterable[np.ndarray],
    *,
    dtype,
    shape: Optional[Sequence[int]] = None,
    copy: bool = False,
) -> np.ndarray:
    """Concatenate ``parts``; an empty iterable yields an empty array of
    the given dtype (``shape`` required then)."""
    parts = [np.asarray(p) for p in parts]
    if not parts:
        if shape is None:
            raise ValueError("shape required for empty concatenation")
        return np.zeros(tuple(shape), dtype=dtype)
    return np.concatenate(parts, axis=0).astype(dtype, copy=copy)


# --- coercion (reference utils/coercion.py:11) ----------------------------


def coerce_finite_float(value: Any) -> Optional[float]:
    """float(value) when finite, else None (non-numeric -> None)."""
    try:
        out = float(value)
    except (TypeError, ValueError):
        return None
    return out if np.isfinite(out) else None


def coerce_finite_float_with_default(value: Any, *, default: float) -> float:
    out = coerce_finite_float(value)
    return default if out is None else out


# --- naming (reference utils/naming.py:21) --------------------------------


def base_shape_str(shape: Tuple[int, ...]) -> str:
    """"d0xd1x..." deterministic shape identifier."""
    return "x".join(str(int(d)) for d in shape)


def permutation_name(mapping: Tuple[int, ...]) -> str:
    """Stable "i0-i1-..." name for a permutation."""
    return "-".join(str(int(i)) for i in mapping)


def timestamp() -> str:
    """"YYYYMMDD-HHMMSS" for file naming / log stamping."""
    return datetime.now().strftime("%Y%m%d-%H%M%S")


def slugify(label: Optional[str]) -> Optional[str]:
    """Deterministic lowercase filename-safe slug (None/empty -> None)."""
    if not label:
        return None
    slug = re.sub(r"[^a-z0-9_-]+", "_", str(label).strip().lower())
    slug = re.sub(r"_+", "_", slug).strip("_")
    return slug or None


# --- validation (reference utils/validation.py:12) ------------------------


def require(condition: bool, message: str) -> None:
    """Raise ValueError(message) unless condition holds."""
    if not condition:
        raise ValueError(message)


def all_finite(values: Any) -> bool:
    arr = np.asarray(values, dtype=np.float64)
    return bool(np.isfinite(arr).all())


def any_finite(values: Any) -> bool:
    arr = np.asarray(values, dtype=np.float64)
    return bool(np.isfinite(arr).any())


def finite_or_none(value: Any) -> Optional[float]:
    return coerce_finite_float(value)


__all__ = [
    "concatenate_or_empty",
    "coerce_finite_float",
    "coerce_finite_float_with_default",
    "base_shape_str",
    "permutation_name",
    "timestamp",
    "slugify",
    "require",
    "all_finite",
    "any_finite",
    "finite_or_none",
]
