"""Whitening-from-metadata with applied-flag bookkeeping
(reference: src/pmarlo/analysis/project_cv.py:15).

Host copy of ``pmarlo_tpu/analysis/project_cv.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..ml.whitening import apply_output_transform
from ..utils.errors import WhiteningError


def apply_whitening_from_metadata(
    X: np.ndarray, metadata: Dict
) -> Tuple[np.ndarray, Dict]:
    """Apply stored CV whitening to a feature/CV matrix, returning the
    transformed matrix and updated bookkeeping (applied flag)."""
    out = apply_output_transform(X, metadata)
    meta = dict(metadata)
    meta["applied"] = True
    return out, meta


def project_dataset_cvs(
    dataset: Sequence[Dict], whitening: Dict
) -> Sequence[Dict]:
    """Whiten every shard's features in place-copy fashion."""
    out = []
    for shard in dataset:
        if "features" not in shard:
            raise WhiteningError("shard without features cannot be projected")
        new = dict(shard)
        new["features"], _ = apply_whitening_from_metadata(
            shard["features"], whitening
        )
        out.append(new)
    return out


__all__ = ["apply_whitening_from_metadata", "project_dataset_cvs"]
