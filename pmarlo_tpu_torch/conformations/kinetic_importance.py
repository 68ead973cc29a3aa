"""Kinetic importance score: KIS(i) = pi_i * sum_k phi_k(i)^2.

Reference: src/pmarlo/conformations/kinetic_importance.py:17,47,76-80 —
score over the slow eigenvectors, auto k via timescale gap, bootstrap
ranking stability.

Host copy of ``pmarlo_tpu/conformations/kinetic_importance.py``; tests/unit/test_torch_host_copies.py holds the two equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..msm.estimation import build_msm
from ..utils.errors import EstimationError
from ..utils.msm_utils import stationary_distribution
from .results import KISResult


@dataclasses.dataclass
class KineticImportanceScore:
    n_slow_modes: Optional[int] = None     # None -> auto by timescale gap
    max_modes: int = 5

    def _slow_eigenvectors(self, T: np.ndarray, pi: np.ndarray, k: int):
        sqrt_pi = np.sqrt(np.maximum(pi, 1e-300))
        T_sym = sqrt_pi[:, None] * T / sqrt_pi[None, :]
        T_sym = 0.5 * (T_sym + T_sym.T)
        evals, evecs = np.linalg.eigh(T_sym)
        order = np.argsort(evals)[::-1]
        phis = evecs[:, order[1 : k + 1]] / sqrt_pi[:, None]
        return evals[order], phis

    def _auto_k(self, evals: np.ndarray) -> int:
        """Largest relative gap in the nontrivial spectrum (reference auto k
        via timescale gap)."""
        lams = np.clip(np.abs(evals[1 : self.max_modes + 2]), 1e-12, 1 - 1e-12)
        ts = -1.0 / np.log(lams)
        if len(ts) < 2:
            return max(len(ts), 1)
        gaps = ts[:-1] / np.maximum(ts[1:], 1e-12)
        return int(np.argmax(gaps)) + 1

    def compute(
        self, T: np.ndarray, pi: Optional[np.ndarray] = None
    ) -> KISResult:
        T = np.asarray(T, dtype=np.float64)
        if pi is None:
            pi = stationary_distribution(T)
        evals, _ = self._slow_eigenvectors(T, pi, self.max_modes)
        k = self.n_slow_modes or self._auto_k(evals)
        k = max(1, min(k, T.shape[0] - 1))
        _, phis = self._slow_eigenvectors(T, pi, k)
        scores = pi * np.sum(phis**2, axis=1)   # KIS formula (reference :76-80)
        ranking = np.argsort(-scores)
        return KISResult(scores=scores, n_slow_modes=k, ranking=ranking)

    def bootstrap_stability(
        self,
        dtrajs: Sequence[np.ndarray],
        lag: int,
        n_states: int,
        n_bootstrap: int = 20,
        seed: int = 0,
    ) -> float:
        """Mean Spearman correlation between bootstrap KIS rankings and the
        full-data ranking (reference bootstrap ranking stability)."""
        rng = np.random.default_rng(seed)
        base_msm = build_msm(list(dtrajs), lag, n_states)
        base = self.compute(base_msm.restricted_T(),
                            base_msm.stationary_distribution[base_msm.active_states])
        base_rank = np.argsort(np.argsort(-base.scores))
        corrs = []
        for _ in range(n_bootstrap):
            idx = rng.integers(0, len(dtrajs), len(dtrajs))
            sample = [dtrajs[i] for i in idx]
            try:
                m = build_msm(sample, lag, n_states)
                if len(m.active_states) != len(base_msm.active_states):
                    continue
                r = self.compute(
                    m.restricted_T(),
                    m.stationary_distribution[m.active_states],
                )
                rank = np.argsort(np.argsort(-r.scores))
                corrs.append(np.corrcoef(base_rank, rank)[0, 1])
            except EstimationError:
                continue
        return float(np.mean(corrs)) if corrs else float("nan")


__all__ = ["KineticImportanceScore"]
