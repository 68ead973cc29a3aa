"""CV output whitening: unit-covariance transform with strict metadata.

Reference: src/pmarlo/ml/deeptica/whitening.py:13-176 (strict flag
coercion, apply stored mean/W, re-center, enforce unit batch covariance via
Cholesky solve) and core/model.py:152 (apply_output_whitening from shrunk
covariance with eigenvalue floor).

Host copy of ``pmarlo_tpu/ml/whitening.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.errors import WhiteningError


def estimate_whitening(
    Y: np.ndarray,
    shrinkage: float = 0.1,
    eig_floor: float = 1e-8,
) -> Dict[str, np.ndarray]:
    """Whitening metadata from CV outputs: mean + W with W^T C W = I.

    Shrunk covariance (reference core/model.py:152 uses sklearn
    ShrunkCovariance) with an eigenvalue floor.
    """
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim != 2 or Y.shape[0] < 2:
        raise WhiteningError(f"need (T>=2, k) outputs, got {Y.shape}")
    mean = Y.mean(axis=0)
    Yc = Y - mean
    C = Yc.T @ Yc / (Y.shape[0] - 1)
    k = C.shape[0]
    mu = np.trace(C) / k
    C = (1.0 - shrinkage) * C + shrinkage * mu * np.eye(k)
    evals, evecs = np.linalg.eigh(0.5 * (C + C.T))
    evals = np.maximum(evals, eig_floor)
    W = evecs @ np.diag(evals**-0.5) @ evecs.T
    return {
        "mean": mean,
        "transform": W,
        "applied": np.asarray(True),
        "shrinkage": np.asarray(shrinkage),
    }


def _coerce_bool_flag(value) -> bool:
    """Strict truthiness for metadata flags (reference whitening.py:13):
    only real booleans / 0-1 ints / 'true'/'false' strings are accepted."""
    if isinstance(value, (bool, np.bool_)):
        return bool(value)
    if isinstance(value, (int, np.integer)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.lower() in ("true", "false"):
        return value.lower() == "true"
    if isinstance(value, np.ndarray) and value.shape == ():
        return _coerce_bool_flag(value.item())
    raise WhiteningError(f"cannot coerce whitening flag from {value!r}")


def apply_output_transform(
    Y: np.ndarray,
    metadata: Dict,
    enforce_unit_covariance: bool = False,
) -> np.ndarray:
    """Apply stored whitening: (Y - mean) @ W, optionally re-enforcing unit
    batch covariance via a Cholesky solve (reference whitening.py:80)."""
    if "mean" not in metadata or "transform" not in metadata:
        raise WhiteningError(
            f"whitening metadata missing mean/transform keys: {sorted(metadata)}"
        )
    if "applied" in metadata and not _coerce_bool_flag(metadata["applied"]):
        raise WhiteningError("whitening metadata marked as not applied")
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim != 2:
        raise WhiteningError(f"Y must be 2D (T, k); got shape {Y.shape}")
    mean = np.asarray(metadata["mean"], dtype=np.float64)
    W = np.asarray(metadata["transform"], dtype=np.float64)
    if mean.shape[0] != Y.shape[1] or W.shape != (Y.shape[1], Y.shape[1]):
        raise WhiteningError(
            f"whitening shapes inconsistent: Y {Y.shape}, mean {mean.shape}, W {W.shape}"
        )
    out = (Y - mean) @ W
    if enforce_unit_covariance:
        if out.shape[0] <= out.shape[1]:
            # the sample covariance of T <= k rows is singular — the
            # requested enforcement is IMPOSSIBLE, not skippable ("no
            # silent fallbacks": downstream discretization assumes unit
            # covariance)
            raise WhiteningError(
                f"enforce_unit_covariance needs more samples than CVs "
                f"(got T={out.shape[0]}, k={out.shape[1]})"
            )
        outc = out - out.mean(axis=0)
        C = outc.T @ outc / (out.shape[0] - 1)
        L = np.linalg.cholesky(C + 1e-10 * np.eye(C.shape[0]))
        out = outc @ np.linalg.inv(L).T
    return out


__all__ = ["estimate_whitening", "apply_output_transform", "_coerce_bool_flag"]
