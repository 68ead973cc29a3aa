"""TPTAnalysis class facade (reference: src/pmarlo/conformations/
tpt_analysis.py:34,69 — analyze() with pathway decomposition and
convergence-warning capture, maxiter 10k).

Host copy of ``pmarlo_tpu/conformations/tpt_analysis.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..msm.tpt import TPTResult, reactive_flux
from ..utils.msm_utils import stationary_distribution


@dataclasses.dataclass
class TPTAnalysis:
    transition_matrix: np.ndarray
    stationary_distribution: Optional[np.ndarray] = None
    maxiter: int = 10_000

    def __post_init__(self):
        self.transition_matrix = np.asarray(self.transition_matrix, dtype=np.float64)
        if self.stationary_distribution is None:
            self.stationary_distribution = stationary_distribution(self.transition_matrix)

    def analyze(
        self,
        source: Sequence[int],
        sink: Sequence[int],
        n_pathways: int = 10,
        pathway_fraction: float = 0.99,
    ) -> TPTResult:
        return reactive_flux(
            self.transition_matrix, source, sink,
            pi=self.stationary_distribution,
            n_pathways=n_pathways,
            pathway_fraction=pathway_fraction,
            maxiter=self.maxiter,
        )


__all__ = ["TPTAnalysis", "TPTResult"]
