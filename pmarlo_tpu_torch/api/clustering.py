"""Public clustering facade (reference src/pmarlo/api/clustering.py:13).

Returns per-frame integer labels, matching the reference wrapper's
surface. The reference's minibatch-vs-full switch is moot here — the
device k-means (msm/clustering.py) is batched Lloyd iteration on the
accelerator either way — so ``method`` is accepted and logged for
call-site compatibility but does not change the algorithm.

Host copy of ``pmarlo_tpu/api/clustering.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

from ..msm.clustering import cluster_microstates as _cluster

logger = logging.getLogger("pmarlo_tpu")


def cluster_microstates(
    Y: "np.ndarray | Sequence[np.ndarray]",
    method: str = "auto",
    n_states: "int | str" = "auto",
    random_state: "int | None" = 42,
    **kwargs,
) -> np.ndarray:
    """Labels per frame (concatenated when Y is a list of trajectories).

    ``n_states="auto"`` selects k by silhouette (reference behavior).
    """
    if method not in ("auto", "kmeans", "minibatchkmeans"):
        raise ValueError(f"unknown clustering method {method!r}")
    logger.info(
        "[clustering] microstate clustering: method=%s n_states=%s seed=%s",
        method, n_states, random_state,
    )
    result = _cluster(
        Y, n_states, seed=0 if random_state is None else int(random_state),
        **kwargs,
    )
    return np.concatenate(
        [np.asarray(l, dtype=np.int64) for l in result.labels_per_traj]
    )


__all__ = ["cluster_microstates"]
