"""MSMBuilder facade: embeddings -> clusters -> skeletal MSM
(reference: src/pmarlo/markov_state_model/msm_builder.py:39 MSMBuilder.fit).

Host copy of ``pmarlo_tpu/msm/msm_builder.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .clustering import ClusteringResult, cluster_microstates
from .estimation import MSMResult, build_msm


@dataclasses.dataclass
class MSMBuilder:
    n_states: "int | str" = 50
    lag: int = 10
    seed: int = 0
    reversible: bool = True

    clustering: Optional[ClusteringResult] = None
    msm: Optional[MSMResult] = None

    def fit(self, embeddings: "np.ndarray | Sequence[np.ndarray]") -> "MSMBuilder":
        self.clustering = cluster_microstates(
            embeddings, self.n_states, seed=self.seed
        )
        self.msm = build_msm(
            self.clustering.labels_per_traj, self.lag,
            self.clustering.n_states, reversible=self.reversible,
        )
        return self

    def transform(self, features: np.ndarray) -> np.ndarray:
        from .clustering import assign_to_centers

        if self.clustering is None:
            raise RuntimeError("fit() first")
        return assign_to_centers(features, self.clustering.centers)


__all__ = ["MSMBuilder"]
