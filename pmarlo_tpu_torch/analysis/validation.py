"""Feature-matrix validation (reference: src/pmarlo/analysis/validation.py).

Host copy of ``pmarlo_tpu/analysis/validation.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def validate_features(X: np.ndarray, name: str = "features") -> np.ndarray:
    """Require a finite 2D float matrix; raise with specifics otherwise."""
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"{name} must be 2D (T, K), got shape {X.shape}")
    if X.shape[0] == 0 or X.shape[1] == 0:
        raise ValueError(f"{name} is empty: shape {X.shape}")
    if not np.issubdtype(X.dtype, np.floating):
        X = X.astype(np.float64)
    bad = ~np.isfinite(X)
    if bad.any():
        rows = np.unique(np.where(bad)[0])
        raise ValueError(
            f"{name} contains {int(bad.sum())} non-finite values "
            f"in rows {rows[:10].tolist()}{'...' if len(rows) > 10 else ''}"
        )
    return X


def feature_schema_fingerprint(columns: Sequence[str], n_features: int) -> str:
    """Stable fingerprint of a feature schema (reference discretize.py uses
    it to reject mixed-schema shard sets)."""
    import hashlib
    import json

    payload = json.dumps({"columns": list(columns), "k": int(n_features)},
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


__all__ = ["validate_features", "feature_schema_fingerprint"]
