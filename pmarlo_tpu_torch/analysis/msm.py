"""Whitening-aware MSM preparation over shard datasets
(reference: src/pmarlo/analysis/msm.py:53 prepare_msm_discretization,
:18 ensure_msm_inputs_whitened, artifact propagation :85-104).

Host copy of ``pmarlo_tpu/analysis/msm.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..utils.errors import WhiteningError
from .discretize import MSMDiscretizationResult, discretize_dataset
from .project_cv import apply_whitening_from_metadata


def ensure_msm_inputs_whitened(
    dataset: Sequence[Dict], whitening: Optional[Dict]
) -> Sequence[Dict]:
    """Apply CV whitening to dataset features exactly once.

    Shards whose metadata already records applied whitening pass through;
    mixing applied and unapplied shards is an error (no silent fallbacks).
    """
    if whitening is None:
        return list(dataset)
    out = []
    states = set()
    for shard in dataset:
        meta = dict(shard.get("metadata") or {})
        already = bool(meta.get("whitening_applied", False))
        states.add(already)
        if already:
            out.append(shard)
            continue
        new = dict(shard)
        new["features"], _ = apply_whitening_from_metadata(
            np.asarray(shard["features"]), whitening
        )
        meta["whitening_applied"] = True
        new["metadata"] = meta
        out.append(new)
    if len(states) > 1:
        raise WhiteningError(
            "dataset mixes whitened and unwhitened shards — refusing to guess"
        )
    return out


def prepare_msm_discretization(
    dataset: Sequence[Dict],
    *,
    whitening: Optional[Dict] = None,
    n_states: "int | str" = 50,
    lag: int = 10,
    seed: int = 0,
    min_state_count: int = 0,
) -> MSMDiscretizationResult:
    """Whiten (if metadata given) then discretize; artifacts propagate."""
    prepared = ensure_msm_inputs_whitened(dataset, whitening)
    result = discretize_dataset(
        prepared, n_states=n_states, lag=lag, seed=seed,
        min_state_count=min_state_count,
    )
    result.artifacts["whitening_applied"] = whitening is not None
    return result


__all__ = ["prepare_msm_discretization", "ensure_msm_inputs_whitened"]
